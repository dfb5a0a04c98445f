"""``BENCHMARK.json`` agrees with the files the harness finds by name:
every cell, configuration and metric it names has its file, with the
same config, traffic, why and source; names and units are of the
allowed characters."""
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from yardstick import cells  # noqa: E402

SPEC = BENCH.parent / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@pytest.fixture(scope="module")
def spec():
    if not SPEC.is_file():
        pytest.skip("no BENCHMARK.json beside the benchmark")
    return json.loads(SPEC.read_text())


def test_cells_and_configs_have_their_files(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        assert NAME.fullmatch(w["name"]) and w["chips"] in (1, 4)
        cell = cells.load_cell(w["name"])
        assert (cell.config_name, cell.traffic_name, cell.why) == (
            w["config"], w["traffic"], w["why"])
        assert len(cell.cards) == w["chips"]
        used.add(w["config"])
    assert used == set(configs)
    for name, c in configs.items():
        assert c["file"] == f"portbench/configs/{name}.json"
        data = cells.load_json("configs", name)
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_metrics_have_their_readers(spec):
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
            assert callable(cells.load_module("metrics", m["name"]).read)
            names.add(m["name"])
            if kind == "per_layer":
                assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
                assert set(m["workloads"]) <= {
                    w["name"] for w in spec["workloads"]}
    assert "setup_s" in names
    # every reader is in the spec: none is a file that no cell reads
    assert {p.stem for p in (BENCH / "metrics").glob("*.py")} == names
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
