"""A cell's files, found by name under the benchmark's folder.

Everything that belongs to one cell, configuration, traffic mix, UDF
set, reference, source or metric is a file of its own:

* ``workloads/<cell>.json``: ``config``, ``traffic`` and ``why``;
* ``configs/<config>.json``: the sizes, the UDF set, the inputs and
  the limits of the comparison;
* ``traffic/<traffic>.json``: the source kind and the workers;
* ``udfsets/<set>.py`` (the program's UDFs), ``reference/<set>.py``
  (the plain reference), ``sources/<kind>.py``, ``metrics/<name>.py``.

Which metrics a cell reports, ``BENCHMARK.json`` beside the benchmark's
folder says.  A later cell, configuration, source or metric is a new
file (and its entries there); no file that is here needs an edit for
it.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class CellError(Exception):
    """A name that no file answers, or a file that is malformed."""


@dataclass
class Cell:
    name: str
    why: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict

    @property
    def devices(self) -> list:
        """The card index of every worker (a card may repeat)."""
        return [int(i) for i in self.traffic["tpus"]]

    @property
    def cards(self) -> list:
        """The distinct cards the cell uses, in order."""
        return sorted(set(self.devices))


def _path(root: Path, kind: str, name: str, suffix: str) -> Path:
    if not NAME.fullmatch(name):
        raise CellError(f"{name!r} is not a name of the benchmark")
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise CellError(f"no {kind}/{name}{suffix} under {root}")
    return path


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = _path(root, kind, name, ".json")
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise CellError(f"{path}: {e}") from None
    if not isinstance(data, dict):
        raise CellError(f"{path} does not hold a JSON object")
    return data


def load_cell(name: str, root: Path = ROOT) -> Cell:
    work = load_json("workloads", name, root)
    for key in ("config", "traffic", "why"):
        if key not in work:
            raise CellError(f"workloads/{name}.json has no {key!r}")
    return Cell(
        name=name, why=work["why"],
        config_name=work["config"],
        config=load_json("configs", work["config"], root),
        traffic_name=work["traffic"],
        traffic=load_json("traffic", work["traffic"], root),
    )


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``<kind>/<name>.py`` as a module of its own (a name may hold a
    dot, so it is loaded from its file, not imported by name)."""
    path = _path(root, kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(cell: str, trace: bool, root: Path = ROOT) -> dict:
    """``{name: unit}`` of the metrics that ``BENCHMARK.json`` (beside
    the folder ``root``) has the cell report: with ``trace`` its
    per-layer metrics, else its end-to-end ones.  A metric with a
    ``workloads`` list is the listed cells'; one without is every
    cell's that reports the end-to-end metric it ``moves`` (an
    end-to-end one without a list, every cell's)."""
    path = root.parent / "BENCHMARK.json"
    try:
        spec = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CellError(f"{path}: {e}") from None

    def listed(metric, default):
        return (cell in metric["workloads"] if "workloads" in metric
                else default)

    ends = {m["name"]: m["unit"] for m in spec.get("end_to_end", [])
            if listed(m, True)}
    if not trace:
        return ends
    return {m["name"]: m["unit"] for m in spec.get("per_layer", [])
            if listed(m, m.get("moves") in ends)}
