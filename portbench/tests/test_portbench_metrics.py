"""The benchmark's arithmetic against hand figures: the interval union
and idle gaps of a trace, the cards' kernel time, the percentile over
all passes, the rate over all the window's bytes and time, the quartile
spread, the fused-moments roofline count, and the metric readers over a
made-up record; and a trace recorded on the card read to the numbers
recorded beside it."""
import gzip
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

from yardstick import cells, roofline, stats, trace  # noqa: E402

METRICS = sorted(p.stem for p in (HERE.parent / "metrics").glob("*.py"))


def _readers():
    return {name: cells.load_module("metrics", name) for name in METRICS}


def test_union_counts_overlapping_copies_and_kernels_once():
    # a kernel, a copy under it on a side stream, a later kernel
    ivs = [(10.0, 30.0), (20.0, 40.0), (60.0, 70.0)]
    assert trace.merge(ivs) == [(10.0, 40.0), (60.0, 70.0)]
    assert trace.union_length(ivs) == 40.0
    assert trace.union_length(ivs) < sum(b - a for a, b in ivs)
    assert trace.gaps(ivs, 0.0, 100.0) == [
        (0.0, 10.0), (40.0, 60.0), (70.0, 100.0)]
    assert trace.gaps([(-5.0, 5.0), (90.0, 120.0)], 0.0, 100.0) == [
        (5.0, 90.0)]


def _x(cat, name, ts, dur, **kw):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)


def test_summary_of_a_trace():
    dev = dict(pid=0, tid=7)
    events = [
        _x("user_annotation", "portbench.traced", 1000.0, 100.0,
           pid=1, tid=11),
        _x("kernel", "moments_partials<x>", 1010.0, 20.0,
           args={"device": 0}, **dev),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1020.0, 20.0,
           args={"device": 0, "bytes": 1000}, **dev),
        # a copy that the window cuts in half counts half its bytes
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1090.0, 20.0,
           args={"device": 0, "bytes": 64 << 20}, **dev),
        _x("kernel", "moments_combine", 1060.0, 10.0,
           args={"device": 0}, **dev),
        # outside the window, and on another thread of the host
        _x("kernel", "moments_partials<x>", 1150.0, 10.0,
           args={"device": 0}, **dev),
        _x("cpu_op", "aten::foo", 1045.0, 10.0, pid=1, tid=11),
        _x("cpu_op", "aten::bar", 1075.0, 25.0, pid=1, tid=11),
        _x("cpu_op", "aten::other_thread", 1000.0, 100.0, pid=1, tid=12),
    ]
    s = trace.summarize(events, "portbench.traced", [0])
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s[0] == pytest.approx(50e-6)
    # a copy inside the window counts its bytes exactly
    assert s.h2d_bytes == 1000 + (32 << 20)
    assert s.h2d_s == pytest.approx(30e-6)
    assert s.matching_s(r"moments_partials|moments_combine") == \
        pytest.approx(30e-6)
    assert s.idle_by_host == pytest.approx({
        "portbench.traced (no host event)": 10e-6,
        "aten::foo": 20e-6, "aten::bar": 20e-6})


def test_overlapping_copies_take_the_union_of_their_time():
    # two cards; on card 0 four copies on side streams, two of them
    # under the others, on card 1 one copy: the link's time is each
    # card's union, so more overlap reads as a faster link
    events = [_x("user_annotation", "w", 0.0, 100.0, pid=1, tid=1)]
    for start, dur, dev in [(0.0, 20.0, 0), (10.0, 20.0, 0),
                            (15.0, 5.0, 0), (50.0, 10.0, 0),
                            (40.0, 30.0, 1)]:
        events.append(_x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)",
                         start, dur, args={"device": dev, "bytes": 1000},
                         pid=dev, tid=7))
    s = trace.summarize(events, "w", [0, 1])
    assert s.h2d_bytes == 5000
    assert s.h2d_s == pytest.approx((30.0 + 10.0 + 30.0) * 1e-6)
    assert s.busy_s == pytest.approx({0: 40e-6, 1: 30e-6})


def test_kernel_time_is_the_union_of_kernels_and_memsets():
    # card 0: two kernels on two streams that overlap, a memset beside
    # them, a kernel under a copy, a copy alone and a kernel cut by the
    # window; card 1: one kernel under a copy
    events = [_x("user_annotation", "w", 0.0, 100.0, pid=1, tid=1)]
    for cat, name, start, dur, dev in [
            ("kernel", "a", 0.0, 10.0, 0),
            ("kernel", "b", 5.0, 10.0, 0),
            ("gpu_memset", "Memset (Device)", 20.0, 4.0, 0),
            ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 30.0, 20.0, 0),
            ("kernel", "c", 35.0, 5.0, 0),
            ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 60.0, 10.0,
             0),
            ("kernel", "d", 95.0, 10.0, 0),
            ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10.0, 30.0, 1),
            ("kernel", "e", 20.0, 5.0, 1)]:
        args = {"device": dev}
        if cat == "gpu_memcpy":
            args["bytes"] = 1000
        events.append(_x(cat, name, start, dur, args=args, pid=dev, tid=7))
    s = trace.summarize(events, "w", [0, 1])
    # each card's intervals, clipped to the window, from its start
    assert [iv[2:] for iv in s.intervals[1]] == [
        ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)"), ("kernel", "e")]
    assert s.intervals[1][0][:2] == pytest.approx((10e-6, 40e-6))
    assert s.intervals[0][-1][:2] == pytest.approx((95e-6, 100e-6))
    # the copies count in the card's busy time
    assert s.busy_s == pytest.approx({0: 54e-6, 1: 30e-6})
    rec = _rec(trace=s, traced_passes=2)
    # card 0: 15 (a, b) + 4 (the memset) + 5 (c) + 5 (d, to the window's
    # end); card 1: 5 (e); over two passes
    assert _readers()["card_kernel_ms_per_pass"].read(rec) == \
        pytest.approx(34e-3 / 2)
    assert _readers()["card_ms_per_pass"].read(rec) == \
        pytest.approx(84e-3 / 2)
    # a window with copies alone leaves the kernels' time silent
    copies = trace.summarize(
        [e for e in events if e["cat"] in ("user_annotation", "gpu_memcpy")],
        "w", [0, 1])
    assert _readers()["card_kernel_ms_per_pass"].read(
        _rec(trace=copies, traced_passes=2)) is None


TRACES = HERE / "traces"


def test_recorded_trace_reads_as_recorded():
    """30 ms of one pass of ``vdet-u16-mem-w4`` recorded on an H100 (the
    device's kernels and copies, the consumer thread's host events, a
    window annotation put around them); the numbers beside it are what
    the trace reader and the readers gave before the device intervals were
    kept, which must not change."""
    events = json.loads(gzip.decompress(
        (TRACES / "vdet-u16-mem-w4.json.gz").read_bytes()))["traceEvents"]
    want = json.loads((TRACES / "vdet-u16-mem-w4.expected.json").read_text())
    s = trace.summarize(events, "portbench.traced", [0])
    ws = want["summary"]
    assert s.window_s == ws["window_s"]
    assert {str(k): v for k, v in s.busy_s.items()} == ws["busy_s"]
    assert s.op_s == ws["op_s"]
    assert (s.h2d_bytes, s.h2d_s) == (ws["h2d_bytes"], ws["h2d_s"])
    assert s.idle_by_host == ws["idle_by_host"]
    rec = _rec(trace=s, traced_passes=1)
    readers = _readers()
    for name, value in want["readings"].items():
        assert readers[name].read(rec) == value, name

    def top(d):
        return [[k, v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    assert {"device_ops": top(s.op_s), "idle_gaps": top(s.idle_by_host)} \
        == want["breakdown"]
    # the kernels' union, counted here by hand: every kernel clipped to
    # the window, merged, without a copy
    w = next(e for e in events if e["cat"] == "user_annotation")
    lo, hi = w["ts"], w["ts"] + w["dur"]
    ivs = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                 for e in events if e["cat"] == "kernel")
    total, end = 0.0, -math.inf
    for a, b in ivs:
        if b <= a:
            continue
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    got = readers["card_kernel_ms_per_pass"].read(rec)
    assert got == pytest.approx(total / 1e3, rel=1e-9)
    assert 0 < got < 1e3 * s.busy_s[0]


def test_percentile_over_every_pass():
    values = [float(v) for v in range(1, 101)]
    assert stats.percentile(values, 90) == pytest.approx(90.1)
    assert stats.percentile(list(reversed(values)), 90) == \
        pytest.approx(90.1)
    assert stats.percentile([3.0], 90) == 3.0


def test_rate_is_all_bytes_over_all_time():
    spans = [(0.0, 1.0), (1.0, 2.5), (2.5, 4.0)]
    assert stats.rate(2e9, spans) == pytest.approx(1.5e9)


def test_quartile_spread():
    assert stats.quartile_spread([1, 2, 3, 4, 5, 6]) == pytest.approx(1.0)
    assert stats.quartile_spread([10.0] * 6) == 0.0


@pytest.mark.parametrize("m, itemsize, want_bytes", [
    # a 256x256 scan: 2.147 GB of u16 frames, 64 calls of 6 mask rows
    (6, 2, 2147483648 + 64 * (6 * 16384 * 4 + 2 * 16384 * 4)
     + 65536 * 6 * 4),
    # a corrected float32 scan of the same frames, 12 mask rows
    (12, 4, 4294967296 + 64 * (12 * 16384 * 4 + 2 * 16384 * 4)
     + 65536 * 12 * 4),
])
def test_roofline_count(m, itemsize, want_bytes):
    seconds, by = roofline.fused_moments_bound_s(65536, 16384, m,
                                                 itemsize, 64)
    assert by == "bytes"
    assert seconds == pytest.approx(want_bytes / 3.35e12)
    assert want_bytes in (2182610944, 4356833280)


def test_roofline_count_bound_by_operations():
    seconds, by = roofline.fused_moments_bound_s(1000, 1000, 10000, 2, 1)
    assert by == "operations"
    assert seconds == pytest.approx(2e10 / 495e12 + 5e6 / 67e12)


def _rec(**kw):
    cell = SimpleNamespace(config={"sig": [128, 128], "M": 6})
    base = dict(cell=cell, spans=[], feeds=[], sharded=[], trace=None,
                pass_bytes=0, frames=65536, kernel_itemsize=2,
                traced_passes=0, traced_launches=0, setup_s=12.5,
                first_pass_s=7.5)
    base.update(kw)
    return SimpleNamespace(**base)


def test_metric_readers():
    readers = _readers()
    spans = [(0.0, 0.2), (0.2, 0.5), (0.5, 1.0)]
    feeds = [{"wait_s": 0.1, "workers": [
        {"h2d_bytes": 10**9, "read_s": 0.5},
        {"h2d_bytes": 10**9, "read_s": 0.5}]}] * 3
    sharded = [{"fold_s": 0.002, "wrap_s": 0.003, "step_s": 0.04,
                "n_steps": 16}] * 3
    bound, _ = roofline.fused_moments_bound_s(65536 * 3, 16384, 6, 2, 128)
    summary = trace.Summary(window_s=2.0, busy_s={0: 0.5},
                            op_s={"moments_partials<u16>": 2 * bound},
                            h2d_bytes=10**9, h2d_s=0.02,
                            intervals={0: [(0.0, 0.05, "kernel", "k"),
                                           (0.04, 0.06, "gpu_memset", "m"),
                                           (0.1, 0.5, "gpu_memcpy", "c")]})
    rec = _rec(spans=spans, feeds=feeds, sharded=sharded, trace=summary,
               pass_bytes=3 * 10**9, traced_passes=3, traced_launches=128)
    got = {name: r.read(rec) for name, r in readers.items()}
    assert got["scan_GBps.host"] == pytest.approx(9.0)
    # 0.5 s of the card's time over the window's three passes
    assert got["card_ms_per_pass"] == pytest.approx(500.0 / 3)
    # 0.06 s of it kernels and memsets
    assert got["card_kernel_ms_per_pass"] == pytest.approx(20.0)
    assert got["setup_s"] == 12.5
    assert got["first_pass_s"] == 7.5
    assert got["pass_p90_s.host"] == pytest.approx(0.46)
    assert got["fold_wrap_ms"] == pytest.approx(5.0)
    assert got["step_ms"] == pytest.approx(2.5)
    assert got["reader_GBps"] == pytest.approx(2.0)
    assert got["feed_wait_share"] == pytest.approx(30.0)
    assert got["h2d_GBps"] == pytest.approx(50.0)
    assert got["device_idle_share"] == pytest.approx(75.0)
    assert got["fused_moments_roofline"] == pytest.approx(50.0)


def test_readers_with_nothing_to_read_return_nothing():
    rec = _rec(setup_s=math.nan, first_pass_s=math.nan)
    for name, reader in _readers().items():
        if name not in ("setup_s", "first_pass_s"):
            assert reader.read(rec) is None, name
    # a trace without the kernel leaves its roofline silent, not at 0
    empty = trace.Summary(window_s=1.0, busy_s={0: 0.1})
    rec = _rec(trace=empty, traced_passes=1, traced_launches=64)
    assert _readers()["fused_moments_roofline"].read(rec) \
        is None
    # a window in which nothing ran on a card (the CPU) leaves the
    # card's time silent, not at 0
    idle = trace.Summary(window_s=1.0, busy_s={0: 0.0})
    rec = _rec(trace=idle, traced_passes=4)
    assert _readers()["card_ms_per_pass"].read(rec) is None
