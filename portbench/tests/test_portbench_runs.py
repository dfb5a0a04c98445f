"""Whole runs of the harness on the CPU at a tiny scan (nav 8 x 16, the
cells' own 128 x 128 frames), the look for a card skipped: a sound run
is correct; the reference in a lower precision put in the program's
place, and the program broken underneath, are not; a cell, a
configuration, a traffic mix and a metric added as files are found by
name, and a metric added for one cell is not read in another; a run
without a card exits non-zero and prints no result."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from yardstick import cells, runner  # noqa: E402

SPEC = BENCH.parent / "BENCHMARK.json"
CELLS = tuple(w["name"] for w in json.loads(SPEC.read_text())["workloads"])
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    """A copy of the benchmark, with its ``BENCHMARK.json``, whose
    configurations scan 8 x 16."""
    root = tmp_path_factory.mktemp("bench") / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(SPEC, root.parent / SPEC.name)
    for path in (root / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["nav"] = [8, 16]
        path.write_text(json.dumps(config))
    return root


def _run(root, cell, seed=SEED, seconds=0.3):
    return runner.run(cell, seed, seconds, False, t_start=time.perf_counter(),
                      root=root, device_type="cpu", log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    result, checks, notes = _run(tiny, cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    # the window is traced in every run; on the CPU no card ran, so the
    # card's time is silent
    assert set(result["metrics"]) == {"setup_s"}
    assert notes["pass_s"] and notes["trace_read_s"] >= 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"masks", "com", "sum", "sumsig",
                                     "stddev"}


def _in_programs_place(monkeypatch, root, cell, precision):
    """The reference computed in ``precision``, handed back by every pass
    in the program's place."""
    c = cells.load_cell(cell, root)
    reference = cells.load_module("reference", c.config["udfset"], root)
    inputs = runner.data.make_inputs(c.config, SEED, "cpu")
    low = reference.expected(c.config, inputs, precision, "cpu")
    monkeypatch.setattr(runner, "one_pass", lambda *a: low)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, monkeypatch, cell):
    # the u16 counts, 0/1 masks and integer CoM grids are exact in TF32:
    # bfloat16 is the lower precision that tells
    _in_programs_place(monkeypatch, tiny, cell, "bf16")
    result, checks, _ = _run(tiny, cell)
    assert not result["correct"]
    assert not all(held for *_, held in checks)


def _step_unchanged(monkeypatch, base):
    monkeypatch.setattr(base.UDFRunner, "_fused_step",
                        lambda self, *a, **k: None)


def _half_the_batch(monkeypatch, base):
    step = base.UDFRunner._fused_step

    def half(self, prep, state, part_state, block, goff, valid):
        return step(self, prep, state, part_state, block, goff, valid // 2)
    monkeypatch.setattr(base.UDFRunner, "_fused_step", half)


def _no_exchange(monkeypatch, base):
    make = base.UDFRunner._make_sharded_fold

    def first_only(self, prep, workers):
        fold = make(self, prep, workers)
        return lambda states: fold({min(states): states[min(states)]})
    monkeypatch.setattr(base.UDFRunner, "_make_sharded_fold", first_only)


def _answer_altered(monkeypatch, base):
    fused = base.fused_moments

    def altered(*args, **kwargs):
        y, colsum, colvar = fused(*args, **kwargs)
        y[0] *= 1.01
        return y, colsum, colvar
    monkeypatch.setattr(base, "fused_moments", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_step_unchanged, _half_the_batch,
                                   _no_exchange, _answer_altered])
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    import libertem_tpu_torch.udf.base as base

    fault(monkeypatch, base)
    result, checks, _ = _run(tiny, cell)
    assert not result["correct"], checks


def _copy(tiny, tmp_path) -> Path:
    root = tmp_path / "bench" / "portbench"
    shutil.copytree(tiny.parent, root.parent)
    return root


def _add_to_spec(root, kind, entry):
    path = root.parent / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec[kind].append(entry)
    path.write_text(json.dumps(spec))


def test_files_added_by_name(tiny, tmp_path):
    """A cell, configuration, traffic mix and metric added as files and
    entries of ``BENCHMARK.json``, in a copy, with no edit elsewhere."""
    root = _copy(tiny, tmp_path)
    config = json.loads((root / "configs" / "vdet-u16.json").read_text())
    config["nav"] = [4, 8]
    (root / "configs" / "vdet-u16-small.json").write_text(
        json.dumps(config))
    traffic = json.loads((root / "traffic" / "mem-w4.json").read_text())
    traffic["tpus"] = [0, 0]
    (root / "traffic" / "mem-w2.json").write_text(json.dumps(traffic))
    (root / "workloads" / "vdet-u16-small-mem-w2.json").write_text(
        json.dumps({"config": "vdet-u16-small", "traffic": "mem-w2",
                    "why": "a test"}))
    (root / "metrics" / "passes_done.py").write_text(
        "def read(rec):\n    return float(len(rec.spans))\n")
    _add_to_spec(root, "end_to_end", {
        "name": "passes_done", "unit": "passes", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["vdet-u16-small-mem-w2"]})
    result, _, _ = _run(root, "vdet-u16-small-mem-w2")
    assert result["correct"]
    assert result["metrics"]["passes_done"]["value"] == result["attempted"]
    assert result["metrics"]["passes_done"]["unit"] == "passes"
    with pytest.raises(cells.CellError):
        cells.load_cell("no-such-cell", root)
    with pytest.raises(cells.CellError):
        cells.load_cell("../escape", root)


def test_a_metric_added_for_one_cell_leaves_the_others_alone(tiny,
                                                             tmp_path):
    """A metric whose ``workloads`` list names another cell is not read
    in this one, and a reader that fails leaves out its own metric
    alone."""
    root = _copy(tiny, tmp_path)
    (root / "metrics" / "elsewhere.py").write_text(
        "def read(rec):\n    raise AssertionError('read')\n")
    (root / "metrics" / "broken.py").write_text(
        "def read(rec):\n    raise RuntimeError('a broken reader')\n")
    _add_to_spec(root, "end_to_end", {
        "name": "elsewhere", "unit": "s", "better": "lower",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["another-cell"]})
    _add_to_spec(root, "end_to_end", {
        "name": "broken", "unit": "s", "better": "lower",
        "bound": 0.25, "source": "host_clock"})
    result, _, _ = _run(root, CELLS[0])
    assert result["correct"]
    assert set(result["metrics"]) == {"setup_s"}


def test_a_cell_reads_the_metrics_its_spec_gives_it(tiny):
    spec = json.loads(SPEC.read_text())
    for w in spec["workloads"]:
        ends = cells.cell_metrics(w["name"], False, tiny)
        layers = cells.cell_metrics(w["name"], True, tiny)
        assert "setup_s" in ends and len(ends) >= 2 and layers
        for m in spec["per_layer"]:
            assert (m["name"] in layers) == (w["name"] in m["workloads"])
    with pytest.raises(cells.CellError):
        cells.cell_metrics(CELLS[0], False, tiny / "workloads")


def test_inputs_follow_the_seed():
    config = json.loads((BENCH / "configs" / "vdet-u16.json").read_text())
    config["nav"] = [2, 3]
    a = runner.data.make_inputs(config, 2**33 + 1, "cpu")
    b = runner.data.make_inputs(config, 2**33 + 1, "cpu")
    c = runner.data.make_inputs(config, 2**33 + 2, "cpu")
    assert np.array_equal(a.frames, b.frames)
    assert not np.array_equal(a.frames, c.frames)
    assert a.frames.dtype == np.uint16 and a.frames.shape == (2, 3, 128, 128)
    assert a.dark is None and a.gain is None and a.excluded is None


def test_correction_inputs_follow_the_seed():
    # float32 frames over a dark level, a gain map and excluded pixels,
    # as a configuration with corrections states them
    config = {"nav": [2, 3], "sig": [16, 16],
              "frames": {"dtype": "float32", "poisson": 8.0,
                         "dark": [1.5, 0.3]},
              "corrections": {"gain": [1.0, 0.1], "excluded_pixels": 5}}
    a = runner.data.make_inputs(config, 2**33 + 1, "cpu")
    b = runner.data.make_inputs(config, 2**33 + 1, "cpu")
    c = runner.data.make_inputs(config, 2**33 + 2, "cpu")
    assert np.array_equal(a.frames, b.frames)
    assert np.array_equal(a.excluded, b.excluded)
    assert not np.array_equal(a.frames, c.frames)
    assert a.frames.dtype == np.float32 and a.excluded.sum() == 5
    assert 1.0 <= a.gain.min() and a.gain.max() <= 1.1


def test_run_without_a_card_exits_non_zero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
    assert "no result" in proc.stderr
