"""The ``strain-u16-mem-w4`` cell: its three readers against hand
figures (and silent where a program without the correlation's spans,
or a run without a card, leaves them nothing), its files found by name,
whole runs of the harness at a cut size on the CPU (a sound run is
correct; the reference in bfloat16, and the program broken underneath,
are not), and on the card the program at the cell's own size within
its limit where the bfloat16 control is not."""
import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from yardstick import (  # noqa: E402
    cells, compare, data, roofline, runner, trace)

CELL = "strain-u16-mem-w4"
SEED = 2**31 + 4242
SPANS = ("libertem.correlate", "libertem.refine")


def _reader(name):
    return cells.load_module("metrics", name)


def _config():
    return cells.load_json("configs", "strain-u16")


def _rec(**kw):
    base = dict(cell=SimpleNamespace(config=_config()), spans=[], feeds=[],
                sharded=[], trace=None, pass_bytes=2**31, frames=16384,
                kernel_itemsize=2, traced_passes=0, traced_launches=0,
                setup_s=1.0, first_pass_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


def _summary(kernel_s, **kw):
    """A window with one kernel of ``kernel_s`` on card 0, a copy under
    it and a memset after it."""
    ivs = [(0.0, kernel_s, "kernel", "fft"),
           (0.0, kernel_s / 2, "gpu_memcpy", "Memcpy HtoD"),
           (kernel_s, kernel_s + 0.001, "gpu_memset", "Memset")]
    return trace.Summary(window_s=1.0, busy_s={0: kernel_s + 0.001},
                         intervals={0: ivs}, **kw)


def test_correlation_bytes_by_hand():
    count = _reader("correlation_roofline").correlation_bytes
    # 16384 frames of 256x256 u16 read once, 49 windows a frame of two
    # centres (2 float32 each) and a peak value written once
    assert count(16384, 65536, 2, 49) == (16384 * 65536 * 2
                                          + 16384 * 49 * 20)


def test_correlation_roofline_by_hand():
    read = _reader("correlation_roofline").read
    # three passes in 0.3 s of kernels and 1 ms of memset (the copy
    # under the kernel not counted): 0.301 / 3 s a pass
    rec = _rec(trace=_summary(0.3), traced_passes=3)
    want_s = (16384 * 65536 * 2 + 16384 * 49 * 20) / roofline.HBM_BYTES_PER_S
    assert read(rec) == pytest.approx(100.0 * want_s / (0.301 / 3))


@pytest.mark.parametrize("factor", [1.0, 1.5, 10.0, 1000.0])
def test_correlation_roofline_never_passes_100(factor):
    # a kernel time that is not below the bytes bound reads at most 100%
    read = _reader("correlation_roofline").read
    bound = (16384 * 65536 * 2 + 16384 * 49 * 20) / roofline.HBM_BYTES_PER_S
    kernel = bound * factor - 0.001
    rec = _rec(trace=_summary(kernel), traced_passes=1)
    assert 0 < read(rec) <= 100.0 + 1e-9


def test_correlation_roofline_silent():
    read = _reader("correlation_roofline").read
    assert read(_rec()) is None
    assert read(_rec(trace=_summary(0.3))) is None
    empty = trace.Summary(window_s=1.0, busy_s={0: 0.0}, intervals={0: []})
    assert read(_rec(trace=empty, traced_passes=3)) is None
    copies = trace.Summary(window_s=1.0, busy_s={0: 0.5}, intervals={
        0: [(0.0, 0.5, "gpu_memcpy", "Memcpy HtoD")]})
    assert read(_rec(trace=copies, traced_passes=3)) is None
    # a configuration without a lattice (vdet-u16) has nothing to count
    vdet = SimpleNamespace(config=cells.load_json("configs", "vdet-u16"))
    assert read(_rec(cell=vdet, trace=_summary(0.3),
                     traced_passes=3)) is None


def test_idle_correlate_share_by_hand():
    read = _reader("idle_correlate_share").read
    idle = {"libertem.correlate": 0.1, "libertem.refine": 0.05,
            "libertem.feed_wait": 0.25, "aten::_fft_c2c": 0.1}
    rec = _rec(trace=_summary(0.3, idle_by_host=idle))
    assert read(rec) == pytest.approx(30.0)
    one = {"libertem.refine": 0.2, "libertem.feed_wait": 0.6}
    assert read(_rec(trace=_summary(0.3, idle_by_host=one))) == \
        pytest.approx(25.0)


def test_idle_correlate_share_silent():
    read = _reader("idle_correlate_share").read
    assert read(_rec()) is None
    # a program without the spans: its idle time is named otherwise
    parent = {"libertem.step": 0.3, "aten::_fft_c2c": 0.1}
    assert read(_rec(trace=_summary(0.3, idle_by_host=parent))) is None


def _feed(correlate=0.020, refine=0.005):
    return {"wait_s": 0.01, "spans": {
        "libertem.run": [1, 0.1], "libertem.step": [64, 0.03],
        "libertem.udf_process": [64, 0.028],
        "libertem.correlate": [64, correlate],
        "libertem.refine": [64, refine]}}


def test_correlate_ms_span_by_hand():
    read = _reader("correlate_ms.span").read
    rec = _rec(feeds=[_feed(), _feed(0.030, 0.010)])
    # (25 + 40) ms over two passes
    assert read(rec) == pytest.approx(32.5)


def test_correlate_ms_span_silent():
    read = _reader("correlate_ms.span").read
    assert read(_rec()) is None
    old = _feed()
    del old["spans"]["libertem.correlate"], old["spans"]["libertem.refine"]
    assert read(_rec(feeds=[old])) is None
    assert read(_rec(feeds=[_feed(), old])) is None
    assert read(_rec(feeds=[{"wait_s": 0.0}])) is None


def test_the_cells_files_load_by_name():
    cell = cells.load_cell(CELL)
    assert (cell.config_name, cell.traffic_name) == ("strain-u16", "mem-w4")
    assert cell.cards == [0] and len(cell.devices) == 4
    assert cell.config["reduced"] == []
    assert cell.config["sig"] == [256, 256] and cell.config["nav"] == [128,
                                                                        128]
    limit = cell.config["limits"]["correlation"]
    # one centre a pixel off reads 1 / (the largest centre) > 1 / 255
    assert 0 < limit < 1 / 255
    assert callable(cells.load_module("udfsets", "strain").build)
    reference = cells.load_module("reference", "strain")
    assert reference.PRECISIONS == ("float64", "float32", "bf16")
    ends = cells.cell_metrics(CELL, False)
    assert set(ends) == {"card_ms_per_pass", "setup_s"}
    layers = cells.cell_metrics(CELL, True)
    assert {"correlation_roofline", "idle_correlate_share",
            "correlate_ms.span", "card_kernel_ms_per_pass",
            "device_idle_share", "h2d_GBps", "scan_GBps.host",
            "pass_p90_s.host", "reader_GBps", "feed_wait_share",
            "idle_feed_wait_share", "pass_overhead_ms", "fold_wrap_ms.span",
            "first_pass_s"} == set(layers)
    # and the vdet cell reads none of the new three
    assert not {"correlation_roofline", "idle_correlate_share",
                "correlate_ms.span"} & set(cells.cell_metrics(
                    "vdet-u16-mem-w4", True))


@pytest.fixture(scope="module")
def cut(tmp_path_factory) -> Path:
    """A copy of the benchmark whose strain configuration scans 8 x 16."""
    root = tmp_path_factory.mktemp("strain") / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(BENCH.parent / "BENCHMARK.json",
                root.parent / "BENCHMARK.json")
    path = root / "configs" / "strain-u16.json"
    config = json.loads(path.read_text())
    config["nav"] = [8, 16]
    path.write_text(json.dumps(config))
    return root


def _run(root, trace_=False):
    return runner.run(CELL, SEED, 0.3, trace_, t_start=time.perf_counter(),
                      root=root, device_type="cpu", log=lambda *a: None)


def test_sound_run_is_correct(cut):
    result, checks, notes = _run(cut)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s"}
    assert set(result["checks"]) == {"correlation"}
    assert result["checks"]["correlation"]["value"] < 1e-6


def test_traced_run_reads_the_programs_spans(cut):
    result, checks, _ = _run(cut, True)
    assert result["correct"], checks
    # no card: the card's metrics are silent, the host's are read
    assert result["metrics"]["correlate_ms.span"]["value"] > 0
    assert "correlation_roofline" not in result["metrics"]


def test_bf16_control_is_not_correct(cut, monkeypatch):
    c = cells.load_cell(CELL, cut)
    reference = cells.load_module("reference", "strain", cut)
    inputs = data.make_inputs(c.config, SEED, "cpu")
    low = reference.expected(c.config, inputs, "bf16", "cpu")
    monkeypatch.setattr(runner, "one_pass", lambda *a: low)
    result, checks, _ = _run(cut)
    assert not result["correct"]
    assert checks[0][1] > c.config["limits"]["correlation"]


def _a_window_off(monkeypatch):
    import libertem_tpu_torch.udf.blobfinder as blob

    process = blob.SparseCorrelationUDF.process_tile

    def shifted(self, tile):
        process(self, tile.roll(1, dims=-1))
    monkeypatch.setattr(blob.SparseCorrelationUDF, "process_tile", shifted)


def _half_the_batch(monkeypatch):
    import libertem_tpu_torch.udf.base as base

    step = base.UDFRunner._generic_step

    def half(self, prep, state, part_state, block, goff, coords, valid,
             loff=None):
        step(self, prep, state, part_state, block, goff, coords,
             valid // 2, loff=loff)
    monkeypatch.setattr(base.UDFRunner, "_generic_step", half)


def _spectrum_rounded(monkeypatch):
    import torch

    import libertem_tpu_torch.udf.blobfinder as blob

    correlate = blob._correlate

    def low(tile, spectrum):
        return correlate(tile.to(torch.bfloat16).to(torch.float32),
                         spectrum)
    monkeypatch.setattr(blob, "_correlate", low)


@pytest.mark.parametrize("fault", [_a_window_off, _half_the_batch,
                                   _spectrum_rounded])
def test_fault_is_not_correct(cut, monkeypatch, fault):
    fault(monkeypatch)
    result, checks, _ = _run(cut)
    assert not result["correct"], checks


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"


@pytest.mark.cuda
def test_limit_holds_where_the_control_fails_on_the_card(card):
    """At the cell's own size: the program within the limit, its spans
    counted a block each, and the bfloat16 control beyond it."""
    import libertem_tpu_torch as lt

    c = cells.load_cell(CELL)
    try:
        runner.check_cards(c)
    except runner.NoCard as e:
        pytest.skip(str(e))
    config = c.config
    reference = cells.load_module("reference", "strain")
    inputs = data.make_inputs(config, SEED, card)
    want = reference.expected(config, inputs, "float64", card)
    groups, udfs, corrections = cells.load_module(
        "udfsets", "strain").build(lt, config, inputs)
    ctx = runner.make_context(lt, c, "cuda")
    ds = cells.load_module("sources", "memory").open_dataset(
        lt, ctx, inputs, config)
    got = runner.one_pass(ctx, ds, udfs, corrections, groups)
    spans = ctx.feed_stats["spans"]
    ctx.close()
    limit = config["limits"]["correlation"]
    errors = compare.group_errors(got, want, reference.SCALES)
    assert errors["correlation"] <= limit
    assert np.array_equal(got["correlation"]["centers"],
                          want["correlation"]["centers"])
    steps = spans["libertem.step"][0]
    assert all(spans[s][0] == steps for s in SPANS + (
        "libertem.udf_process",))
    low = compare.group_errors(
        reference.expected(config, inputs, "bf16", card), want)
    assert low["correlation"] > limit
