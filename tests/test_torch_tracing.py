"""The port's spans and counters (``common/tracing.py``) on the CPU, and
on the card where one is there (``-m cuda``; imports no jax):

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda

On the CPU: under ``torch.profiler`` the consumer thread's trace nests
``libertem.run`` over ``libertem.step`` over ``libertem.fused_moments``,
beside ``libertem.feed_wait``, ``libertem.fold`` and ``libertem.wrap``,
in both loops; with no profiler and no export a span enters nothing;
with export on, only the run-level spans reach the tracer; a run's
``feed_stats`` hold ``spans`` beside its old keys, whose values the
spans time, and no time of the device's stream (nothing records an
event on it); a build is spanned, a cached library is not.  On the
card: every fused-moments launch inside its span.
"""
import json
import sys
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libertem_tpu_torch as lt
from libertem_tpu_torch.common import tracing
from libertem_tpu_torch.common.tracing import NOOP, RUN_SPANS, RunTrace, span
from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
from libertem_tpu_torch.ops import build

torch.set_num_threads(1)

# a span's category in the trace: the fast record function's or
# record_function's
SPAN_CATS = ("cpu_op", "user_annotation")

# the keys the loops' feed_stats had before the spans, each loop's
OLD_KEYS = {
    "single": {"read_s", "slot_wait_s", "wait_s", "blocks", "h2d_bytes",
               "host_s"},
    "sharded": {"read_s", "slot_wait_s", "wait_s", "blocks", "h2d_bytes",
                "host_s", "collective_s", "workers", "transport"},
}


def _data(nav=(8, 16), sig=(16, 16)):
    return np.random.default_rng(21).poisson(8, nav + sig).astype(np.uint16)


def _context(loop, device="cpu"):
    if loop == "sharded":
        return lt.Context(executor=ShardedJobExecutor(devices=[device] * 4))
    return lt.Context(device=device)


def _udfs():
    """The fused path's set: masks, CoM, SumSig, Sum, StdDev."""
    sig = (16, 16)
    disk = np.zeros(sig, np.float32)
    disk[4:12, 4:12] = 1
    return [lt.ApplyMasksUDF(mask_factories=[lambda: disk]),
            lt.CoMUDF.with_params(cx=8, cy=8, r=6), lt.SumSigUDF(),
            lt.SumUDF(), lt.StdDevUDF()]


def _run(loop, udfs=None, device="cpu", **kw):
    ctx = _context(loop, device)
    ds = ctx.load("memory", data=_data(), sig_dims=2, num_partitions=4)
    ctx.run_udf(ds, udfs or _udfs(), **kw)
    assert ctx.run_info["fused"] or udfs is not None
    return ctx


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _spans_by_thread(events):
    out = defaultdict(list)
    for e in events:
        if (e.get("cat") in SPAN_CATS
                and e["name"].startswith("libertem.")):
            start = float(e["ts"])
            out[(e.get("pid"), e.get("tid"))].append(
                (e["name"], start, start + float(e["dur"])))
    return out


def _inside(inner, outers):
    """Whether ``inner`` (name, start, end) lies in one of ``outers``."""
    return any(a <= inner[1] and inner[2] <= b for _, a, b in outers)


@pytest.mark.parametrize("loop", ["sharded", "single"])
def test_consumer_spans_nest_under_the_profiler(loop, tmp_path):
    ctx = _context(loop)
    ds = ctx.load("memory", data=_data(), sig_dims=2, num_partitions=4)
    udfs = _udfs()
    ctx.run_udf(ds, udfs)  # the first run's lazy set-up out of the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx.run_udf(ds, udfs)
    threads = _spans_by_thread(_trace_events(prof, tmp_path))
    consumer = [t for t, spans in threads.items()
                if any(n == "libertem.run" for n, _, _ in spans)]
    assert len(consumer) == 1
    spans = threads[consumer[0]]
    named = defaultdict(list)
    for s in spans:
        named[s[0]].append(s)
    run = named["libertem.run"]
    assert len(run) == 1
    steps = named["libertem.step"]
    assert len(steps) == ctx.feed_stats["blocks"] > 0
    assert all(_inside(s, run) for s in steps)
    assert len(named["libertem.fused_moments"]) == len(steps)
    assert all(_inside(s, steps) for s in named["libertem.fused_moments"])
    assert all(_inside(s, steps) for s in named["libertem.state_update"])
    for name in ("libertem.prepare", "libertem.feed_wait", "libertem.fold",
                 "libertem.wrap", "libertem.close", "libertem.open"):
        assert named[name] and all(_inside(s, run) for s in named[name]), \
            name
    if loop == "sharded":
        assert len(named["libertem.shard_plan"]) == 1
        assert _inside(named["libertem.shard_plan"][0], run)
        # a super-step holds its feed wait, its steps and its release
        supers = named["libertem.super_step"]
        assert supers and all(_inside(s, run) for s in supers)
        for name in ("libertem.feed_wait", "libertem.step",
                     "libertem.release"):
            assert all(_inside(s, supers) for s in named[name]), name
    # the readers' spans are on other threads, not recorded by a default
    # profile
    assert not named["libertem.read"]


class _Counting:
    """Stands in for ``record_function`` or the tracer and counts."""

    def __init__(self):
        self.names = []

    def __call__(self, name):
        self.names.append(name)
        return self

    def start_as_current_span(self, name, attributes=None, **kw):
        self.names.append((name, dict(attributes or {})))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attribute(self, key, value):
        self.names.append(("attr", key, value))


@pytest.mark.parametrize("loop", ["sharded", "single"])
def test_off_enters_no_profiler_and_no_otel_span(loop, monkeypatch):
    rf, tracer = _Counting(), _Counting()
    monkeypatch.setattr(tracing, "_record", rf)
    monkeypatch.setattr(tracing, "get_tracer", lambda *a: tracer)
    monkeypatch.setattr(tracing, "_TRACING_ACTIVE", False)
    assert not torch.autograd.profiler._is_profiler_enabled
    ctx = _run(loop)
    assert rf.names == [] and tracer.names == []
    # the counters are kept all the same
    assert ctx.feed_stats["spans"]["libertem.run"][0] == 1
    # with nothing to record, the one shared no-op
    assert span("libertem.h2d") is NOOP
    with span("libertem.h2d") as s:
        pass
    assert s.seconds == 0.0
    # a span whose time is read, or counted, is a span of its own
    with span("libertem.read", timed=True) as s:
        pass
    assert s is not NOOP and s.seconds >= 0.0


@pytest.mark.parametrize("loop", ["sharded", "single"])
def test_export_sends_the_run_level_spans_only(loop, monkeypatch):
    tracer = _Counting()
    monkeypatch.setattr(tracing, "_TRACER", tracer)
    monkeypatch.setattr(tracing, "_TRACING_ACTIVE", True)
    _run(loop)
    names = [n[0] for n in tracer.names if n[0] != "attr"]
    assert set(names) == {"libertem.run", "libertem.prepare",
                          "libertem.fold", "libertem.wrap"}
    assert set(names) <= RUN_SPANS
    assert names.count("libertem.run") == 1
    started = dict(n for n in tracer.names if n[0] != "attr")
    assert "ApplyMasksUDF" in started["libertem.run"]["udfs"]
    attrs = {n[1]: n[2] for n in tracer.names if n[0] == "attr"}
    assert attrs["frames"] == 128
    assert attrs["bytes"] == 128 * 16 * 16 * 2
    assert attrs["workers"] == (4 if loop == "sharded" else 1)
    if loop == "sharded":
        assert attrs["super_steps"] >= 1


@pytest.mark.parametrize("loop", ["sharded", "single"])
def test_feed_stats_hold_spans_and_stream_time(loop):
    ctx = _run(loop)
    fs = ctx.feed_stats
    # the spans beside the old keys, and no stream time: a run records
    # no event on the device's stream
    assert set(fs) == OLD_KEYS[loop] | {"spans"}
    spans = fs["spans"]
    assert spans["libertem.run"][0] == 1
    assert spans["libertem.step"][0] == fs["blocks"] > 0
    assert 0 < spans["libertem.fused_moments"][0] \
        <= spans["libertem.step"][0]
    assert spans["libertem.fused_moments"][1] <= spans["libertem.step"][1]
    # the spans are the timers of the old keys
    assert fs["wait_s"] == spans["libertem.feed_wait"][1]
    # the run holds its stretches, one after another
    parts = ("libertem.prepare", "libertem.open", "libertem.hooks",
             "libertem.feed_wait", "libertem.step", "libertem.fold",
             "libertem.wrap", "libertem.close")
    assert spans["libertem.run"][1] >= sum(spans[n][1] for n in parts)
    if loop == "sharded":
        assert len(fs["workers"]) == 4
        assert fs["blocks"] == sum(w["blocks"] for w in fs["workers"])
        assert all(set(w) == {"read_s", "slot_wait_s", "wait_s", "blocks",
                              "h2d_bytes"} for w in fs["workers"])
        inner = ("libertem.feed_wait", "libertem.step", "libertem.release")
        assert spans["libertem.super_step"][1] >= sum(
            spans[n][1] for n in inner)


class _HostSum(lt.UDF):
    """A sum over frames on the host engine."""

    def get_backends(self):
        return (self.BACKEND_NUMPY,)

    def get_result_buffers(self):
        return {"intensity": self.buffer(kind="sig", dtype="float64")}

    def process_tile(self, tile):
        self.results.intensity[:] += tile.sum(axis=0)

    def merge(self, dest, src):
        dest.intensity[:] += src.intensity


@pytest.mark.parametrize("loop", ["sharded", "single"])
def test_host_engine_time_is_its_span(loop):
    ctx = _run(loop, udfs=[_HostSum()])
    fs = ctx.feed_stats
    assert ctx.run_info["engines"] == ["host"]
    assert fs["host_s"] == fs["spans"]["libertem.host_step"][1] > 0
    assert "libertem.fused_moments" not in fs["spans"]


def test_run_trace_on_the_cpu():
    trace = RunTrace()
    # the run's span is the no-op until the run opens its own
    assert trace.run is NOOP
    for _ in range(2):
        with trace.span("libertem.step", timed=True) as s:
            sum(range(10000))
        assert s.seconds > 0
    count, seconds = trace.spans["libertem.step"]
    assert count == 2 and seconds >= s.seconds
    assert set(trace.spans) == {"libertem.step"}


def test_kernel_build_is_spanned_only_when_it_builds(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    # a compiler that writes its output, for the span alone
    fake = [sys.executable, "-c",
            "import sys; open(sys.argv[2], 'w').write('x')"]
    monkeypatch.setattr(build, "_command", lambda src: fake)
    seen = []
    real = build.span

    def spy(name, *a, **kw):
        seen.append((name, kw))
        return real(name, *a, **kw)
    monkeypatch.setattr(build, "span", spy)
    build.build(["decode"])
    assert build.library_path("decode").exists()
    assert seen == [("libertem.kernel_build", {"libraries": ["decode"]})]
    build.build(["decode"])
    assert len(seen) == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build.library_path("decode").unlink()
        build.build(["decode"])
    assert "libertem.kernel_build" in {e.name for e in prof.events()}


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["sharded", "single"])
def test_fused_moments_launches_inside_its_span_on_card(card, loop,
                                                        tmp_path):
    ctx = _context(loop, "cuda:0")
    ds = ctx.load("memory", data=_data(nav=(32, 32)), sig_dims=2,
                  num_partitions=4)
    udfs = _udfs()
    ctx.run_udf(ds, udfs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctx.run_udf(ds, udfs)
    events = _trace_events(prof, tmp_path)
    fs = ctx.feed_stats
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr:
            launches[corr] = e
    spans = _spans_by_thread(events)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and ("moments_partials" in e["name"]
                    or "moments_combine" in e["name"])]
    assert len(kernels) == 2 * fs["spans"]["libertem.fused_moments"][0]
    for k in kernels:
        h = launches[k["args"]["correlation"]]
        start = float(h["ts"])
        inner = ("launch", start, start + float(h["dur"]))
        fm = [s for s in spans[(h.get("pid"), h.get("tid"))]
              if s[0] == "libertem.fused_moments"]
        assert _inside(inner, fm), h["name"]
