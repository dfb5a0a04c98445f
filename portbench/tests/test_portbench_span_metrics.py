"""The readers of the program's spans and counters against hand
figures: each over a made-up record of three passes, and silent (None)
over the records of a program without those spans and counters."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

from yardstick import cells, trace  # noqa: E402

NAMES = ("idle_feed_wait_share", "pass_overhead_ms", "fold_wrap_ms.span")


def _reader(name):
    return cells.load_module("metrics", name)


def _rec(**kw):
    cell = SimpleNamespace(config={"sig": [128, 128], "M": 6})
    base = dict(cell=cell, spans=[], feeds=[], sharded=[], trace=None,
                pass_bytes=0, frames=65536, kernel_itemsize=2,
                traced_passes=0, traced_launches=0, setup_s=1.0,
                first_pass_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


def _feed():
    """One pass of the multi-device loop: 64 blocks, 16 super-steps."""
    return {
        "wait_s": 0.08, "read_s": 0.5, "blocks": 64,
        "spans": {
            "libertem.run": [1, 0.250],
            "libertem.prepare": [1, 0.020],
            "libertem.feed_wait": [17, 0.080],
            "libertem.step": [64, 0.060],
            "libertem.fused_moments": [64, 0.010],
            "libertem.state_update": [64, 0.030],
            "libertem.fold": [1, 0.004],
            "libertem.wrap": [1, 0.006],
            "libertem.close": [1, 0.002],
        },
    }


def _program_record():
    summary = trace.Summary(
        window_s=1.0, busy_s={0: 0.2},
        idle_by_host={"libertem.feed_wait": 0.3, "libertem.run": 0.1,
                      "aten::add_": 0.1, "portbench.traced (no host event)":
                      0.3})
    return _rec(feeds=[_feed()] * 3, trace=summary,
                traced_passes=3, traced_launches=192)


@pytest.mark.parametrize("name, want", [
    # 0.3 s of the 0.8 s idle under the consumer's wait for blocks
    ("idle_feed_wait_share", 37.5),
    # 250 ms less 80 + 60 + 4 + 6 ms, each pass
    ("pass_overhead_ms", 100.0),
    # fold and wrap, 4 + 6 ms a pass
    ("fold_wrap_ms.span", 10.0),
])
def test_span_readers(name, want):
    assert _reader(name).read(_program_record()) == pytest.approx(want)


def test_host_step_counts_as_engine_time():
    rec = _program_record()
    for feed in rec.feeds:
        feed["spans"] = dict(feed["spans"],
                             **{"libertem.host_step": [16, 0.030]})
    got = _reader("pass_overhead_ms").read(rec)
    assert got == pytest.approx(70.0)


def _parent_record():
    """What a program without the spans and counters leaves: the
    feeds' old keys, a trace whose idle time has no program span."""
    feed = {"wait_s": 0.08, "read_s": 0.5, "slot_wait_s": 0.0,
            "blocks": 64, "h2d_bytes": 2**31, "host_s": 0.0,
            "workers": []}
    summary = trace.Summary(
        window_s=1.0, busy_s={0: 0.2}, op_s={"moments_partials": 0.01},
        idle_by_host={"portbench.traced (no host event)": 0.6,
                      "aten::add_": 0.2})
    return _rec(feeds=[feed] * 3, trace=summary, traced_passes=3,
                traced_launches=192)


@pytest.mark.parametrize("name", NAMES)
def test_silent_without_the_programs_spans(name):
    assert _reader(name).read(_parent_record()) is None
    assert _reader(name).read(_rec()) is None


def test_a_pass_without_spans_silences_the_window():
    # one pass of the window without the totals: no figure from the rest
    rec = _program_record()
    rec.feeds = rec.feeds[:2] + [_parent_record().feeds[0]]
    for name in NAMES[1:]:
        assert _reader(name).read(rec) is None, name
