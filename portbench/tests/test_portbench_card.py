"""On the card (``cuda`` marker; each skips without one): the inputs
made on the card follow the seed, the trace reader reads a real
profile, and at a cell's own size (where the call has its cards) the
program passes its limits where the reference computed in bfloat16
fails them (the program's own one-TF32-pass mode gives the same bits
on u16 counts)."""
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from yardstick import cells, compare, data, runner, trace  # noqa: E402


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"


@pytest.mark.cuda
def test_inputs_on_the_card_follow_the_seed(card):
    config = cells.load_json("configs", "vdet-u16")
    config["nav"] = [4, 4]
    a = data.make_inputs(config, 2**31 + 5, card)
    b = data.make_inputs(config, 2**31 + 5, card)
    c = data.make_inputs(config, 2**31 + 6, card)
    assert np.array_equal(a.frames, b.frames)
    assert not np.array_equal(a.frames, c.frames)


@pytest.mark.cuda
def test_trace_reads_a_real_profile(card, tmp_path):
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    host = torch.ones(64 << 20, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty_like(host, device=card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("w"):
            dev.copy_(host, non_blocking=True)
            total = dev.float().sum()
            torch.cuda.synchronize()
    assert float(total) == 64 << 20
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    s = trace.summarize(json.loads(path.read_text())["traceEvents"], "w",
                        [0])
    assert s.h2d_bytes == 64 << 20
    assert 0 < s.busy_s[0] <= s.window_s
    assert s.h2d_s > 0 and s.matching_s("reduce|sum") > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vdet-u16-mem-w4"])
def test_control_fails_at_the_cells_size(card, cell, monkeypatch):
    import libertem_tpu_torch as lt

    c = cells.load_cell(cell)
    try:
        runner.check_cards(c)
    except runner.NoCard as e:
        pytest.skip(str(e))
    config = c.config
    reference = cells.load_module("reference", config["udfset"])
    inputs = data.make_inputs(config, 2**31 + 99, card)
    want = reference.expected(config, inputs, "float64", card)

    def held(got):
        errors = compare.group_errors(got, want, reference.SCALES)
        return all(h for *_, h in compare.checks(errors, config["limits"]))

    groups, udfs, corrections = cells.load_module(
        "udfsets", config["udfset"]).build(lt, config, inputs)
    ctx = runner.make_context(lt, c, "cuda")
    ds = cells.load_module("sources", c.traffic["source"]).open_dataset(
        lt, ctx, inputs, config)
    monkeypatch.setenv(runner.PRECISION_ENV, config["matmul_precision"])
    assert held(runner.one_pass(ctx, ds, udfs, corrections, groups))
    monkeypatch.setenv(runner.PRECISION_ENV, "default")
    one_pass = runner.one_pass(ctx, ds, udfs, corrections, groups)
    ctx.close()
    # u16 counts, 0/1 masks and integer CoM grids are exact in TF32:
    # one pass gives the same bits there, and bfloat16 is the lower
    # precision that tells
    assert held(one_pass)
    assert not held(reference.expected(config, inputs, "bf16", card))
