"""The executors and what surrounds a run, of the port against the JAX
package's, on the CPU (counterparts of ``tests/test_misc.py``:
test_make_with_specs, test_executor_compat_names,
test_run_udf_async_via_loop, test_run_udf_sync_false,
test_progress_and_snooze, test_snooze_manager_wired_and_closeable,
test_debug_executor_pickle_safety; ``tests/test_api_parity.py``:
test_executor_utility_api, test_backends_scoped_per_run,
test_run_events_on_iter_and_balance_and_guess and the async iterator of
test_context_kwarg_sweep; ``tests/test_delayed.py``).

The same seeded numpy data goes through ``libertem_tpu_torch`` with
``InlineJobExecutor(device="cpu")`` (or ``Context.make_with`` with the
default device patched to the CPU inside the test) and through
``libertem_tpu`` with ``InlineJobExecutor()``: results within 1e-5
relative (float32 with other summation orders, absolute floor 1e-5 of
the largest magnitude), damage, events, exceptions and messages equal.
The four example scripts run against the port with their own asserts.
"""
import asyncio
import gc
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor as JaxInline
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet

import libertem_tpu_torch as port
import libertem_tpu_torch.executor.base as port_executor_base
import libertem_tpu_torch.udf.base as port_base
from libertem_tpu_torch.common.exceptions import ExecutorSpecException
from libertem_tpu_torch.executor import InlineJobExecutor

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
NAV, SIG = (6, 6), (10, 10)


def _data(seed=5, nav=NAV, sig=SIG):
    return np.random.default_rng(seed).poisson(7.0, nav + sig).astype(
        np.uint16)


def _both(data=None, parts=2):
    data = _data() if data is None else data
    ctx = port.Context(executor=InlineJobExecutor(device="cpu"))
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=parts)
    jctx = JaxContext(executor=JaxInline())
    jds = JaxMemoryDataSet(data=data, sig_dims=2,
                           num_partitions=parts).initialize()
    return ctx, ds, jctx, jds, data


def _close(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.nanmax(np.abs(b), initial=0.0)), 1.0)
    assert np.allclose(a, b, rtol=RTOL, atol=RTOL * scale, equal_nan=True)


def _udfs(lib):
    return [lib.udf.SumUDF(), lib.udf.SumSigUDF(), lib.udf.StdDevUDF()]


def _same_results(res, jres):
    assert len(res) == len(jres)
    for r, j in zip(res, jres):
        assert set(r) == set(j)
        for k in r:
            _close(r[k].data, j[k].data)


@pytest.fixture
def cpu_default(monkeypatch):
    """The port's default device (the card) patched to the CPU, for the
    entry points that take none (``make_with``, ``Context()``)."""
    orig = port_executor_base.resolve_device
    monkeypatch.setattr(port_executor_base, "resolve_device",
                        lambda d=None: orig("cpu" if d is None else d))


def _readers():
    return [t for t in threading.enumerate()
            if t.name.startswith("block-reader") and t.is_alive()]


def _readers_end(timeout=1.0) -> bool:
    t0 = time.perf_counter()
    while _readers() and time.perf_counter() - t0 < timeout:
        time.sleep(0.01)
    return not _readers()


# -- Part A: the two repairs ---------------------------------------------


def _unpicklable(lib):
    class Unpicklable(lib.udf.base.UDF):
        def __init__(self, **kwargs):
            kwargs.setdefault("lock", threading.Lock())
            super().__init__(**kwargs)

        def get_result_buffers(self):
            return {"x": self.buffer(kind="nav", dtype="float32")}

        def process_frame(self, frame):
            self.results.x = frame.sum()

    return Unpicklable()


def test_debug_pickle_check_like_jax():
    """InlineJobExecutor(debug=True) round-trips the UDFs through
    pickle before every run: SumUDF passes, a threading.Lock parameter
    raises UDFException in both packages; without debug both run it."""
    data = _data()
    ctx = port.Context(executor=InlineJobExecutor(device="cpu", debug=True))
    ds = ctx.load("memory", data=data, sig_dims=2)
    jctx = JaxContext(executor=JaxInline(debug=True))
    jds = JaxMemoryDataSet(data=data, sig_dims=2).initialize()
    _close(ctx.run_udf(ds, port.SumUDF())["intensity"].data,
           jctx.run_udf(jds, libertem_tpu.udf.SumUDF())["intensity"].data)
    from libertem_tpu.udf.base import UDFException as JaxUDFException
    with pytest.raises(port.UDFException, match="pickle-safe") as e:
        ctx.run_udf(ds, _unpicklable(port))
    with pytest.raises(JaxUDFException, match="pickle-safe") as je:
        jctx.run_udf(jds, _unpicklable(libertem_tpu))
    assert str(e.value).split(":")[0] == str(je.value).split(":")[0]
    out = port.Context(executor=InlineJobExecutor(device="cpu")).run_udf(
        ds, _unpicklable(port))
    jout = JaxContext(executor=JaxInline()).run_udf(
        jds, _unpicklable(libertem_tpu))
    _close(out["x"].data, jout["x"].data)


def _threads_udf(lib, seen):
    class Threads(lib.udf.base.UDF):
        def get_result_buffers(self):
            return {"s": self.buffer(kind="nav", dtype="float32")}

        def get_task_data(self):
            seen.append(self.meta.threads_per_worker)
            return {}

        def process_frame(self, frame):
            self.results.s = frame.sum()

    return Threads()


@pytest.mark.parametrize("inline_threads", [3, None])
def test_threads_per_worker_from_executor(inline_threads):
    """``meta.threads_per_worker`` is the executor's: ``inline_threads``
    where given, else one a core, in both packages."""
    data = _data()
    seen, jseen = [], []
    ctx = port.Context(executor=InlineJobExecutor(
        device="cpu", inline_threads=inline_threads))
    ds = ctx.load("memory", data=data, sig_dims=2)
    jctx = JaxContext(executor=JaxInline(inline_threads=inline_threads))
    jds = JaxMemoryDataSet(data=data, sig_dims=2).initialize()
    res = ctx.run_udf(ds, _threads_udf(port, seen))
    jres = jctx.run_udf(jds, _threads_udf(libertem_tpu, jseen))
    want = inline_threads or os.cpu_count()
    assert seen and set(seen) == {want}
    assert jseen and set(jseen) == {want}
    _close(res["s"].data, jres["s"].data)
    assert ctx.executor.threads_per_worker == \
        jctx.executor.threads_per_worker == want


# -- make_with ------------------------------------------------------------


@pytest.mark.parametrize("spec,cls_name", [
    ("inline", "InlineJobExecutor"),
    ("synchronous", "InlineJobExecutor"),
    ("threads", "ConcurrentJobExecutor"),
    ("concurrent", "ConcurrentJobExecutor"),
    ("sharded", "ShardedJobExecutor"),
    ("tpu", "ShardedJobExecutor"),
    ("dask", "ShardedJobExecutor"),
    ("dask-make-default", "ShardedJobExecutor"),
    ("dask-integration", "ShardedJobExecutor"),
    ("pipelined", "ShardedJobExecutor"),
    ("delayed", "DelayedJobExecutor"),
])
def test_make_with_specs(cpu_default, spec, cls_name):
    """Every spec the JAX package takes gives the same executor class,
    one device here, and a run that agrees with the JAX package's."""
    ctx = port.Context.make_with(spec)
    jctx = JaxContext.make_with(spec)
    assert type(ctx.executor).__name__ == cls_name
    assert type(jctx.executor).__name__ == cls_name
    assert len(ctx.executor.devices) == 1
    assert ctx.device == torch.device("cpu")
    data = _data()
    ds = ctx.load("memory", data=data, sig_dims=2)
    jds = jctx.load("memory", data=data, sig_dims=2)
    # max(4, 2 x workers): one device here, the JAX package's sharded
    # specs every virtual CPU device of its tests
    assert ds.get_num_partitions() == 4
    assert jds.get_num_partitions() == max(
        4, 2 * len(jctx.executor.get_available_workers()))
    _same_results(ctx.run_udf(ds, _udfs(port)),
                  jctx.run_udf(jds, _udfs(libertem_tpu)))
    ctx.close()
    jctx.close()


@pytest.mark.parametrize("spec,kw", [
    ("inline", {"cpus": 2}),
    ("synchronous", {"cpus": [0]}),
    ("dask-integration", {"cpus": 1}),
    ("delayed", {"cpus": 1}),
    ("inline", {"gpus": 1}),
    ("threads", {"gpus": [0]}),
    ("delayed", {"gpus": 1}),
    ("sharded", {"gpus": [0]}),
    ("bogus", {}),
])
def test_make_with_rejects_like_jax(cpu_default, spec, kw):
    """The same misuse raises ExecutorSpecException with the same
    message (no card here: ``gpus=`` finds none in either)."""
    from libertem_tpu.common.exceptions import (
        ExecutorSpecException as JaxSpecException,
    )
    with pytest.raises(ExecutorSpecException) as e:
        port.Context.make_with(spec, **kw)
    with pytest.raises(JaxSpecException) as je:
        JaxContext.make_with(spec, **kw)
    assert str(e.value) == str(je.value)


def test_make_with_main_process_gpu_needs_cuda(cpu_default):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from libertem_tpu.common.exceptions import (
        ExecutorSpecException as JaxSpecException,
    )
    for mpg in (True, 0):
        with pytest.raises(ExecutorSpecException, match="main_process_gpu"):
            port.Context.make_with("inline", main_process_gpu=mpg)
        with pytest.raises(JaxSpecException, match="main_process_gpu"):
            JaxContext.make_with("inline", main_process_gpu=mpg)
    # False and None ask for nothing
    port.Context.make_with("inline", main_process_gpu=False).close()


@pytest.mark.parametrize("make", [
    lambda: port.Context(),
    lambda: InlineJobExecutor(),
    lambda: port.Context.make_with("inline"),
    lambda: port.Context.make_with("sharded"),
    lambda: port.Context.make_with("delayed"),
])
def test_default_device_raises_without_a_card(make):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_device_or_executor():
    ctx = port.Context(device="cpu")
    assert isinstance(ctx.executor, InlineJobExecutor)
    assert ctx.device == ctx.executor.main_device == torch.device("cpu")
    with pytest.raises(ValueError, match="not both"):
        port.Context(device="cpu",
                     executor=InlineJobExecutor(device="cpu"))


def test_sharded_one_device_like_inline():
    """One device: the single-device loop, results as inline's and the
    JAX package's sharded executor's."""
    from libertem_tpu.executor.sharded import ShardedJobExecutor as JaxSh

    from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
    data = _data()
    ctx = port.Context(executor=ShardedJobExecutor(devices=["cpu"]))
    assert ctx._run_devices() is None
    ds = ctx.load("memory", data=data, sig_dims=2)
    ictx = port.Context(device="cpu")
    jctx = JaxContext(executor=JaxSh())
    jds = JaxMemoryDataSet(data=data, sig_dims=2).initialize()
    res = ctx.run_udf(ds, _udfs(port))
    _same_results(res, ictx.run_udf(ds, _udfs(port)))
    _same_results(res, jctx.run_udf(jds, _udfs(libertem_tpu)))
    assert ctx.run_info["fused"]


def test_several_devices_run_like_jax():
    """More than one device takes the multi-device loop: the same three
    calls (``run_udf``, ``run_udf_iter``, ``run_udf(sync=False)``) on
    two workers give the JAX package's sharded results over two
    devices, and leave no reader thread behind."""
    import jax
    from libertem_tpu.executor.sharded import ShardedJobExecutor as JaxSh

    from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
    data = _data()
    ctx = port.Context(executor=ShardedJobExecutor(devices=["cpu", "cpu"]))
    ds = ctx.load("memory", data=data, sig_dims=2)
    assert ds.get_num_partitions() == 4
    assert ctx._run_devices() == [torch.device("cpu")] * 2
    jctx = JaxContext(executor=JaxSh(devices=jax.devices()[:2]))
    jds = JaxMemoryDataSet(data=data, sig_dims=2).initialize()
    want = jctx.run_udf(jds, libertem_tpu.udf.SumUDF())["intensity"].data
    _close(ctx.run_udf(ds, port.SumUDF())["intensity"].data, want)
    last = None
    for last in ctx.run_udf_iter(ds, port.SumUDF()):
        pass
    _close(last.buffers[0]["intensity"].data, want)
    assert last.damage.data.all()
    _close(asyncio.run(ctx.run_udf(ds, port.SumUDF(), sync=False))
           ["intensity"].data, want)
    assert _readers_end()


def test_compat_names_like_jax(cpu_default):
    from libertem_tpu.executor import DaskJobExecutor as JaxDask

    from libertem_tpu_torch.executor import (
        ConcurrentJobExecutor,
        DaskJobExecutor,
        PipelinedExecutor,
        ShardedJobExecutor,
        get_dask_integration_executor,
    )
    assert ConcurrentJobExecutor().devices
    assert ConcurrentJobExecutor.make_local().devices
    assert isinstance(DaskJobExecutor(), ShardedJobExecutor)
    assert PipelinedExecutor().devices
    assert ShardedJobExecutor.make_local().devices
    assert isinstance(get_dask_integration_executor(), InlineJobExecutor)
    with pytest.raises(NotImplementedError, match="dask scheduler"):
        DaskJobExecutor.connect("tcp://localhost:8786")
    with pytest.raises(NotImplementedError, match="dask scheduler"):
        JaxDask.connect("tcp://localhost:8786")
    import libertem_tpu_torch.executor.base as b
    from libertem_tpu_torch.executor.async_adapter import AsyncAdapter
    assert b.AsyncAdapter is AsyncAdapter and b.AsyncJobExecutor is AsyncAdapter
    assert b.BaseJobExecutor is b.JobExecutor


def test_cli_message(capsys):
    from libertem_tpu_torch.executor import cli
    assert cli.main() == 2
    assert "libertem_tpu_torch" in capsys.readouterr().err


# -- the executor's utility API --------------------------------------------


def test_executor_utility_api_like_jax():
    ctx, ds, jctx, jds, _ = _both()
    for ex, d in ((ctx.executor, ds), (jctx.executor, jds)):
        assert ex.run_process_local(lambda a, b: a + b, (1, 2)) == 3
        assert ex.run_function(lambda a, b=0: a * b, 3, b=4) == 12
        assert ex.map(lambda x: x + 1, [1, 2]) == [2, 3]
        assert ex.run_each_host(lambda: 42) == {"localhost": 42}
        assert ex.run_each_worker(lambda: 7) == {"inline": 7}
        parts = list(d.get_partitions())
        assert sum(ex.run_each_partition(
            parts, lambda p: p.num_frames)) == 36
        with ex.scatter({"x": 1}) as handle:
            assert handle.get() == {"x": 1}
            ex.scatter_update(handle, {"x": 2})
            assert handle.get() == {"x": 2}

        class Patchable:
            v = 0

            def patch(self, p):
                self.v = p

        with ex.scatter(Patchable()) as h2:
            ex.scatter_update_patch(h2, 7)
            assert h2.get().v == 7
        assert ex.modify_buffer_type("b") == "b"
        assert ex.ensure_sync() is ex
        assert ex.snooze_manager is None
        with ex as same:
            assert same is ex
    assert ctx.executor.get_udf_runner() is port_base.UDFRunner
    workers = ctx.executor.get_available_workers()
    jworkers = jctx.executor.get_available_workers()
    assert len(workers) == len(jworkers) == 1
    w, jw = list(workers)[0], list(jworkers)[0]
    assert (w.name, w.host, w.resources) == \
        (jw.name, jw.host, jw.resources) == \
        ("inline", "localhost", {"compute": 1, "CPU": 1})
    assert ctx.executor.get_resource_details() == \
        jctx.executor.get_resource_details() == \
        [{"host": "localhost", "cpu": 1, "cuda": 0, "service": 1}]
    assert not workers.has_cuda() and not workers.has_tpu()
    assert workers.hosts() == {"localhost"}


def test_worker_set_and_scheduler():
    from libertem_tpu.common.scheduler import Scheduler as JaxScheduler
    from libertem_tpu.executor.base import Worker as JW, WorkerSet as JWS

    from libertem_tpu_torch.common.scheduler import Scheduler
    from libertem_tpu_torch.executor.base import Worker, WorkerSet

    class Task:
        def __init__(self, res):
            self.res = res

        def get_resources(self):
            return self.res

    def build(W, WS):  # noqa: N803
        return WS([
            W("a", "h1", resources={"compute": 1, "CUDA": 1}),
            W("b", "h1", resources={"compute": 1, "CPU": 1}),
            W("c", "h2", resources={"CPU": 1}),
        ])

    ws, jws = build(Worker, WorkerSet), build(JW, JWS)
    for S, w in ((Scheduler, ws), (JaxScheduler, jws)):  # noqa: N806
        s = S(w)
        assert [x.name for x in s.workers_for_task(Task({"CUDA": 1}))] \
            == ["a"]
        assert [x.name for x in s.workers_for_task(Task({"CPU": 1}))] \
            == ["b", "c"]
        assert len(s.workers_for_task(object())) == 3
        assert s.effective_worker_count() == 2
    assert ws.extend(ws).workers == ws.workers * 2
    assert ws.hosts() == jws.hosts() == {"h1", "h2"}
    cuda = WorkerSet([Worker("g", "h", device=torch.device("cuda", 0))])
    assert cuda.has_cuda() and not ws.has_cuda()


def test_make_canonical():
    from libertem_tpu_torch.executor.base import ResourceError, make_canonical
    assert make_canonical(None) is None and make_canonical(False) is None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        with pytest.raises(ResourceError, match="no CUDA device"):
            make_canonical(True)
    with pytest.raises(ResourceError, match="not present"):
        make_canonical(n)


def test_worker_queue_and_context_like_jax():
    from libertem_tpu.executor.base import (
        SimpleWorkerContext as JCtx,
        SimpleWorkerQueue as JQ,
        WorkerQueueEmpty as JEmpty,
    )

    from libertem_tpu_torch.executor.base import (
        SimpleWorkerContext,
        SimpleWorkerQueue,
        TaskCommHandler,
        WorkerQueueEmpty,
    )
    for Q, C, Empty in ((SimpleWorkerQueue, SimpleWorkerContext,  # noqa
                         WorkerQueueEmpty), (JQ, JCtx, JEmpty)):
        q = Q()
        q.put({"h": 1}, b"x")
        with q.put_nocopy({"h": 2}, 3) as mv:
            mv[:] = b"abc"
        assert q.size() == 2
        with q.get() as (h, p):
            assert h == {"h": 1} and p == b"x"
        with q.get() as (h, p):
            assert h == {"h": 2} and bytes(p) == b"abc"
        with pytest.raises(Empty):
            with q.get(block=False):
                pass
        c = C(q)
        assert c.get_worker_queue() is q
        c.signal("w0", "progress", {"n": 3})
        with q.get() as (header, _):
            assert header == ("progress", {"n": 3, "ident": "w0"})
        with pytest.raises(ValueError, match="reserved"):
            c.signal("w0", "t", {"ident": 1})
    # messages reach the subscribers through monitor()
    handler, q, got = TaskCommHandler(), SimpleWorkerQueue(), []
    handler.subscribe("progress", lambda t, m: got.append(m["n"]))
    with handler.monitor(q):
        SimpleWorkerContext(q).signal("w", "progress", {"n": 5})
        t0 = time.perf_counter()
        while not got and time.perf_counter() - t0 < 5:
            time.sleep(0.01)
    assert got == [5]


def test_devices_detect():
    from libertem_tpu_torch.utils.devices import detect, has_cupy
    d = detect()
    assert len(d["cpus"]) >= 1 and d["tpus"] == [] and not d["has_tpu"]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert d["cudas"] == list(range(n))
    assert d["has_cupy"] is False and has_cupy() is False


# -- subscriptions and run events ------------------------------------------


def test_subscription_manager_like_jax():
    from libertem_tpu.common.subscriptions import (
        SubscriptionManager as JaxSubs,
    )

    from libertem_tpu_torch.common.subscriptions import SubscriptionManager
    for S in (SubscriptionManager, JaxSubs):  # noqa: N806
        m, got = S(), []
        k = m.subscribe("t", lambda t, msg: got.append((t, msg)))
        m.subscribe("t", lambda t, msg: 1 / 0)  # logged, not raised
        m.send("t", 1)
        m.send("other", 2)
        assert got == [("t", 1)]
        assert m.unsubscribe(k) and not m.unsubscribe(k)
        m.send("t", 3)
        assert got == [("t", 1)]


def test_run_events_like_jax():
    """``run_udf:start``/``run_udf:end`` once each on run_udf,
    run_udf_iter (at its end) and the async paths, in both packages;
    the message names the UDFs and the dataset's shape."""
    ctx, ds, jctx, jds, _ = _both()

    def collect(c):
        events = []
        for topic in ("run_udf:start", "run_udf:end"):
            c.executor.subscribe(
                topic, lambda t, m, e=events: e.append((t, m)))
        return events

    ev, jev = collect(ctx), collect(jctx)

    async def drive(c, d, lib):
        async for _ in c.run_udf_iter(d, lib.udf.SumUDF(), sync=False):
            pass
        await c.run_udf(d, lib.udf.SumUDF(), sync=False)

    for c, d, lib, e in ((ctx, ds, port, ev),
                         (jctx, jds, libertem_tpu, jev)):
        SumUDF = lib.udf.SumUDF  # noqa: N806
        c.run_udf(d, [SumUDF(), lib.udf.SumSigUDF()])
        gen = c.run_udf_iter(d, SumUDF())
        assert [t for t, _ in e[2:]] == ["run_udf:start"]
        for _ in gen:
            pass
        asyncio.run(drive(c, d, lib))
    assert [t for t, _ in ev] == [t for t, _ in jev] == [
        "run_udf:start", "run_udf:end"] * 4
    assert ev[0][1] == jev[0][1] == {
        "udfs": ["SumUDF", "SumSigUDF"], "dataset_shape": NAV + SIG}
    assert ev[1][1] == jev[1][1] == {"udfs": ["SumUDF", "SumSigUDF"]}
    key = ctx.executor.subscribe("run_udf:start", lambda t, m: None)
    assert ctx.executor.unsubscribe(key)
    assert not ctx.executor.unsubscribe(key)


def test_iterator_closed_early_ends_the_run():
    ctx, ds, _, _, _ = _both()
    ev = []
    ctx.executor.subscribe("run_udf:end", lambda t, m: ev.append(t))
    gen = ctx.run_udf_iter(ds, port.SumUDF())
    next(gen)
    gen.close()
    gen.close()
    assert ev == ["run_udf:end"]
    assert _readers_end()


# -- async ------------------------------------------------------------------


def test_run_udf_async_like_jax():
    ctx, ds, jctx, jds, _ = _both()
    roi = np.zeros(NAV, bool)
    roi[1:4] = True
    for kw in ({}, {"roi": roi}):
        res = asyncio.run(ctx.run_udf(ds, _udfs(port), sync=False, **kw))
        jres = asyncio.run(jctx.run_udf(jds, _udfs(libertem_tpu),
                                        sync=False, **kw))
        _same_results(res, jres)
        single = asyncio.run(ctx.run_udf_async(ds, port.SumUDF(), **kw))
        jsingle = asyncio.run(jctx.run_udf_async(
            jds, libertem_tpu.udf.SumUDF(), **kw))
        _close(single["intensity"].data, jsingle["intensity"].data)
    assert ctx.run_info["fused"] and ctx.feed_stats["blocks"] > 0


def test_async_iterator_like_jax():
    """``run_udf_iter(sync=False)`` and ``run_udf_iter_async``: the same
    partials (damage and buffers) as the JAX package's, in order."""
    data = _data(nav=(8, 6))
    ctx, ds, jctx, jds, _ = _both(data, parts=3)

    async def drain(agen):
        out = []
        async for part in agen:
            out.append((np.array(part.damage.data),
                        [{k: np.array(b[k].data) for k in b}
                         for b in part.buffers]))
        return out

    got = asyncio.run(drain(ctx.run_udf_iter(ds, _udfs(port), sync=False)))
    want = asyncio.run(drain(jctx.run_udf_iter(
        jds, _udfs(libertem_tpu), sync=False)))
    via = asyncio.run(drain(ctx.run_udf_iter_async(ds, _udfs(port))))
    assert len(got) == len(want) == len(via) == 3
    for (d, bufs), (jd, jbufs), (vd, _) in zip(got, want, via):
        assert np.array_equal(d, jd) and np.array_equal(d, vd)
        for b, jb in zip(bufs, jbufs):
            for k in b:
                _close(b[k], jb[k])


def test_async_iterator_patch():
    ctx, ds, _, _, data = _both(_data(nav=(8, 6)), parts=3)

    async def drive():
        agen = ctx.run_udf_iter(ds, [port.ApplyMasksUDF(
            mask_factories=[lambda: np.ones(SIG, np.float32)])], sync=False)
        out = []
        async for part in agen:
            out.append(part)
            if len(out) == 1:
                await agen.update_parameters_experimental(
                    [{"mask_factories": [lambda: np.full(
                        SIG, 2.0, np.float32)]}])
        return out

    parts = asyncio.run(drive())
    final = parts[-1].buffers[0]["intensity"].data[..., 0].reshape(-1)
    sums = data.reshape(len(final), -1).sum(axis=1).astype(np.float64)
    ratio = final / sums
    # the first partition's rows before the patch; the producer may
    # have run ahead of it, so later rows hold either mask
    assert np.allclose(ratio[:16], 1.0)
    assert set(np.round(ratio, 5)) <= {1.0, 2.0}


@pytest.mark.parametrize("how", ["aclose", "break"])
def test_abandoned_async_iterator_stops_the_reader(how):
    """``aclose()`` after two partials reaches the run in the producer's
    thread: no block reader alive within 1 s, the run's end sent."""
    data = _data(nav=(16, 8))
    ctx, ds, _, _, _ = _both(data, parts=8)
    ev = []
    ctx.executor.subscribe("run_udf:end", lambda t, m: ev.append(t))

    async def drive():
        agen = ctx.run_udf_iter(ds, _udfs(port), sync=False)
        n = 0
        async for _ in agen:
            n += 1
            if n == 2:
                break
        if how == "aclose":
            await agen.aclose()
        return n

    assert asyncio.run(drive()) == 2
    assert _readers_end(1.0)
    t0 = time.perf_counter()
    while not ev and time.perf_counter() - t0 < 1.0:
        time.sleep(0.01)
    assert ev == ["run_udf:end"]


def test_async_iterator_closed_before_start():
    ctx, ds, _, _, _ = _both()
    ev = []
    ctx.executor.subscribe("run_udf:end", lambda t, m: ev.append(t))

    async def drive():
        agen = ctx.run_udf_iter(ds, port.SumUDF(), sync=False)
        await agen.aclose()

    asyncio.run(drive())
    assert ev == ["run_udf:end"]


def test_backends_on_the_async_paths_like_jax():
    """``backends=`` is per run and reaches the async paths."""
    ctx, ds, jctx, jds, _ = _both()

    def probe(lib, seen, device_backend):
        class Probe(lib.udf.base.UDF):
            def get_backends(self):
                return (device_backend, self.BACKEND_NUMPY)

            def get_result_buffers(self):
                return {"s": self.buffer(kind="nav", dtype="float32")}

            def process_frame(self, frame):
                seen.append(self.meta.array_backend)
                self.results.s = frame.sum()

        return Probe()

    for c, d, lib, dev in ((ctx, ds, port, "torch"),
                           (jctx, jds, libertem_tpu, "jax")):
        seen = []
        u = probe(lib, seen, dev)
        c.run_udf(d, u, backends=("numpy",))
        assert seen[-1] == "numpy"
        c.run_udf(d, u)
        assert seen[-1] == dev
        asyncio.run(c.run_udf_async(d, u, backends=("numpy",)))
        assert seen[-1] == "numpy"

        async def drive(c=c, d=d, u=u):
            async for _ in c.run_udf_iter(d, u, backends=("numpy",),
                                          sync=False):
                pass

        seen.clear()
        asyncio.run(drive())
        assert seen and seen[-1] == "numpy"


def test_async_utils_like_jax():
    from libertem_tpu.common import async_utils as ja

    from libertem_tpu_torch.common import async_utils as pa

    def gen(n):
        yield from range(n)

    for m in (pa, ja):
        assert m.run_gen_get_last(gen(4)) == 3
        with pytest.raises(RuntimeError, match="no items"):
            m.run_gen_get_last(gen(0))

        async def drive(m=m):
            lazy = [x async for x in m.async_generator(gen(3))]
            eager = [x async for x in m.async_generator_eager(gen(5),
                                                              queue_size=2)]
            last = await m.run_agen_get_last(m.async_generator(gen(2)))
            s = await m.sync_to_async(lambda a, b: a - b, 5, b=2)
            return lazy, eager, last, s

        assert asyncio.run(drive()) == ([0, 1, 2], [0, 1, 2, 3, 4], 1, 3)

        def boom():
            yield 1
            raise KeyError("x")

        async def failing(m=m):
            return [x async for x in m.async_generator_eager(boom())]

        with pytest.raises(KeyError):
            asyncio.run(failing())


def test_eager_generator_closes_source_on_its_thread():
    """An abandoned eager bridge closes the source generator on the
    producer thread, a producer blocked on a full queue included."""
    from libertem_tpu_torch.common.async_utils import async_generator_eager
    closed_on = []

    def source():
        try:
            for i in range(1000):
                yield i
        finally:
            closed_on.append(threading.current_thread().name)

    async def drive():
        agen = async_generator_eager(source(), queue_size=2)
        first = await agen.__anext__()
        await asyncio.sleep(0.05)  # the producer fills the queue
        await agen.aclose()
        return first

    assert asyncio.run(drive()) == 0
    t0 = time.perf_counter()
    while not closed_on and time.perf_counter() - t0 < 2:
        time.sleep(0.01)
    assert closed_on == ["async-generator-producer"]


def test_async_adapter():
    from libertem_tpu_torch.executor.async_adapter import AsyncAdapter
    ex = InlineJobExecutor(device="cpu")

    async def drive():
        a = ex.ensure_async()
        assert isinstance(a, AsyncAdapter) and a.ensure_async() is a
        assert a.ensure_sync() is ex
        assert a.devices == ex.devices and a.main_device == ex.main_device
        assert a.snooze_manager is None
        r = await a.run_function(lambda x, y=1: x + y, 2, y=3)
        w = await a.get_available_workers()
        d = await a.get_resource_details()
        await a.cancel("job")
        await a.close()
        return r, len(w), d

    r, n, d = asyncio.run(drive())
    assert (r, n) == (5, 1)
    assert d == [{"host": "localhost", "cpu": 1, "cuda": 0, "service": 1}]
    assert AsyncAdapter.make_pool()._max_workers == 4


# -- snooze --------------------------------------------------------------


def _idle_check(m):
    """The manager's idle check after an hour without activity (its
    timer checks once a second against the 3600 s timeout)."""
    m._last_activity -= 7200
    m._check()


def test_snooze_manager_like_jax():
    from libertem_tpu.common.snooze import SnoozeManager as JaxSnooze

    from libertem_tpu_torch.common.snooze import SnoozeManager, SnoozeMessage
    for S in (SnoozeManager, JaxSnooze):  # noqa: N806
        calls = []
        m = S(up=lambda: calls.append("up"),
              down=lambda: calls.append("down"), timeout=3600)
        m._check()
        assert calls == [] and not m.is_snoozing
        _idle_check(m)
        assert calls == ["down"] and m.is_snoozing
        m.touch()
        assert calls == ["down", "up"] and not m.is_snoozing
        with m.in_use():
            assert m.keep_alive == 1
            _idle_check(m)
            m.snooze()
            assert calls == ["down", "up"]
        assert m.keep_alive == 0
        # a touch callback may re-enter the manager
        m2 = S(up=lambda: m2.touch(), down=lambda: None, timeout=3600)
        _idle_check(m2)
        t = time.monotonic()
        m2.touch()
        assert time.monotonic() - t < 1.0
        m.close()
        m2.close()
        assert m._timer is None
        with pytest.raises(ValueError, match="timeout"):
            S(timeout=0)
    got = []
    m = SnoozeManager(timeout=3600)
    m.subscribe([SnoozeMessage.SNOOZE, SnoozeMessage.UNSNOOZE_DONE],
                lambda t, msg: got.append(t))
    _idle_check(m)
    m.touch()
    m.close()
    assert got == [SnoozeMessage.SNOOZE, SnoozeMessage.UNSNOOZE_DONE]


def test_context_snooze_held_by_runs(cpu_default):
    """``make_with(snooze_timeout=...)``: the manager snoozes when idle
    (here, on the CPU, ``down`` releases nothing); a run wakes it and
    holds it awake, ``run_udf_iter``'s generator until it ends."""
    ctx = port.Context.make_with("inline", snooze_timeout=3600)
    jctx = JaxContext.make_with("inline", snooze_timeout=3600)
    m = ctx.snooze_manager
    assert m is not None and ctx.executor.snooze_manager is m
    assert jctx.snooze_manager is not None

    ds = ctx.load("memory", data=_data(), sig_dims=2)
    _idle_check(m)
    assert m.is_snoozing
    ctx.run_udf(ds, port.SumUDF())
    assert not m.is_snoozing and m.keep_alive == 0
    gen = ctx.run_udf_iter(ds, port.SumUDF())
    assert m.keep_alive == 1
    next(gen)
    _idle_check(m)
    assert not m.is_snoozing
    for _ in gen:
        pass
    assert m.keep_alive == 0
    gen = ctx.run_udf_iter(ds, port.SumUDF())
    gen.close()
    assert m.keep_alive == 0
    _idle_check(m)
    assert m.is_snoozing
    asyncio.run(ctx.run_udf(ds, port.SumUDF(), sync=False))
    assert not m.is_snoozing and m.keep_alive == 0
    _idle_check(m)
    res = ctx.run(ctx.create_sum_analysis(ds))
    assert res["intensity"].raw_data is not None and not m.is_snoozing
    ctx.close()
    jctx.close()
    assert m._closed


def test_snooze_down_releases_cuda_cache_only_on_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append("empty"))
    port.Context(device="cpu")._snooze_down()
    assert calls == []
    ctx = port.Context(device="cpu")
    ctx.executor._devices = [torch.device("cuda", 0)]
    ctx._snooze_down()
    assert calls == ["empty"]


# -- delayed ---------------------------------------------------------------


def _count_runs(monkeypatch):
    calls = {"n": 0}
    orig = port_base.UDFRunner.run_for_dataset

    def counted(self, *args, **kwargs):
        calls["n"] += 1
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(port_base.UDFRunner, "run_for_dataset", counted)
    return calls


def _delayed_both(data, parts):
    from libertem_tpu_torch.executor.delayed import DelayedJobExecutor
    ctx = port.Context(executor=DelayedJobExecutor(device="cpu"))
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=parts)
    jctx = JaxContext.make_with("delayed")
    jds = JaxMemoryDataSet(data=data, sig_dims=2,
                           num_partitions=parts).initialize()
    return ctx, ds, jctx, jds


def test_delayed_lazy_single(monkeypatch):
    calls = _count_runs(monkeypatch)
    data = _data(nav=(6, 7), sig=(12, 12))
    ctx, ds, jctx, jds = _delayed_both(data, 3)
    res = ctx.run_udf(ds, port.SumUDF())
    jres = jctx.run_udf(jds, libertem_tpu.udf.SumUDF())
    assert calls["n"] == 0 and ctx.feed_stats is None
    assert res["intensity"].kind == jres["intensity"].kind == "sig"
    assert res["intensity"].dtype == jres["intensity"].dtype
    assert calls["n"] == 0
    got = res["intensity"].data
    assert calls["n"] == 1 and ctx.feed_stats["blocks"] > 0
    _close(got, jres["intensity"].data)
    _close(got, data.sum(axis=(0, 1)))
    _ = res["intensity"].data
    _ = np.asarray(res["intensity"])
    _ = res.intensity.raw_data
    assert calls["n"] == 1
    assert "DelayedBuffer" in repr(res["intensity"])


def test_delayed_multi_udf_single_pass(monkeypatch):
    calls = _count_runs(monkeypatch)
    data = _data(nav=(4, 5), sig=(8, 8))
    ctx, ds, jctx, jds = _delayed_both(data, 2)
    res = ctx.run_udf(ds, _udfs(port))
    jres = jctx.run_udf(jds, _udfs(libertem_tpu))
    assert calls["n"] == 0
    _close(res[1]["intensity"].data, jres[1]["intensity"].data)
    assert calls["n"] == 1
    for r, j in zip(res, jres):
        for k in j:
            _close(r[k].data, j[k].data)
    assert calls["n"] == 1


def test_delayed_compute_and_roi(monkeypatch):
    calls = _count_runs(monkeypatch)
    data = _data(nav=(4, 5), sig=(8, 8))
    ctx, ds, jctx, jds = _delayed_both(data, 2)
    roi = np.zeros(20, dtype=bool)
    roi[[1, 7, 13]] = True
    eager = ctx.run_udf(ds, port.SumUDF(), roi=roi).compute()
    jeager = jctx.run_udf(jds, libertem_tpu.udf.SumUDF(), roi=roi).compute()
    assert calls["n"] == 1
    _close(eager["intensity"].data, jeager["intensity"].data)
    assert np.array_equal(eager.damage.data, jeager.damage.data)


def test_delayed_two_threads_run_one_pass(monkeypatch):
    calls = _count_runs(monkeypatch)
    data = _data(nav=(8, 8), sig=(8, 8))
    ctx, ds, _, _ = _delayed_both(data, 4)
    res = ctx.run_udf(ds, [port.SumUDF(), port.SumSigUDF()])
    out = [None, None]
    barrier = threading.Barrier(2)

    def reach(i):
        barrier.wait()
        out[i] = res[i]["intensity"].data

    threads = [threading.Thread(target=reach, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert calls["n"] == 1
    _close(out[0], data.sum(axis=(0, 1)))
    _close(out[1], data.sum(axis=(2, 3)))


def test_delayed_to_dask_needs_dask():
    try:
        import dask  # noqa: F401
        pytest.skip("dask is installed")
    except ImportError:
        pass
    ctx, ds, _, _ = _delayed_both(_data(), 2)
    res = ctx.run_udf(ds, port.SumUDF())
    with pytest.raises(ImportError):
        res["intensity"].to_dask()


def test_delayed_unpack_like_jax():
    from libertem_tpu.executor.utils import delayed_unpack as jd

    from libertem_tpu_torch.executor.utils import delayed_unpack as pd
    cases = [
        1, [1, 2], (1, [2, 3]), {"a": 1, "b": (2, 3)}, [[], {}, ()],
        {"x": [np.float32(1), {"y": ()}]},
    ]
    for el in cases:
        flat, jflat = pd.flatten_nested(el), jd.flatten_nested(el)
        mapping, jmapping = pd.build_mapping(el), jd.build_mapping(el)
        assert [f is pd.IgnoreClass for f in flat] == \
            [f is jd.IgnoreClass for f in jflat]
        assert len(mapping) == len(jmapping) == len(flat)
        assert pd.rebuild_nested(flat, mapping) == el
        assert jd.rebuild_nested(jflat, jmapping) == el
    assert pd.build_mapping(5) == jd.build_mapping(5) == [None]


# -- tracing and threads ---------------------------------------------------


def test_tracing_off_without_endpoint(monkeypatch):
    from libertem_tpu.common import tracing as jt

    from libertem_tpu_torch.common import tracing as pt
    monkeypatch.delenv("LIBERTEM_TPU_TRACING_URL", raising=False)
    for m in (pt, jt):
        assert m.maybe_setup_tracing("test") is False
        with m.get_tracer().start_as_current_span("span") as span:
            span.set_attribute("k", 1)
    with pt._NoopTracer().start_as_current_span("x") as span:
        span.add_event("e")
        span.record_exception(ValueError())
    # off: the port's run-level span is the shared no-op, unless a run
    # counts it
    assert pt.span("libertem.run") is pt.NOOP
    totals = {}
    with pt.span("libertem.run", totals) as span:
        span.set_attributes(frames=1)
    assert totals == {"libertem.run": [1, span.seconds]}


def test_set_num_threads():
    from libertem_tpu.common.threading import set_num_threads as jset

    from libertem_tpu_torch.common.threading import (
        mitigations,
        set_num_threads,
        set_num_threads_env,
    )
    before = torch.get_num_threads()
    with set_num_threads(2):
        assert torch.get_num_threads() == 2
    assert torch.get_num_threads() == before
    for s in (set_num_threads, jset):
        with pytest.raises(ImportError, match="definitely_missing"):
            with s(2):
                import definitely_missing_module_xyz  # noqa: F401
    assert torch.get_num_threads() == before
    old = os.environ.get("OMP_NUM_THREADS")
    with set_num_threads_env(3):
        assert os.environ["OMP_NUM_THREADS"] == "3"
    assert os.environ.get("OMP_NUM_THREADS") == old
    with mitigations():
        pass


# -- the example scripts ------------------------------------------------


@pytest.mark.parametrize("name", [
    "custom_udf", "holography", "strain_mapping", "virtual_detector",
])
def test_example_runs_on_the_port(name, cpu_default, capsys):
    """Each example script, with ``libertem_tpu`` replaced by
    ``libertem_tpu_torch`` in its source, runs on the port (the default
    device patched to the CPU) and its own asserts hold."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    with open(path) as f:
        src = f.read().replace("libertem_tpu", "libertem_tpu_torch")
    import warnings
    with warnings.catch_warnings():
        # custom_udf's MaxFrameUDF goes to the host engine, with a warning
        warnings.simplefilter("ignore", UserWarning)
        exec(compile(src, path, "exec"),  # noqa: S102
             {"__name__": "__main__", "__file__": path})
    out = capsys.readouterr().out
    assert out
    if name == "strain_mapping":
        err = float(out.strip().splitlines()[-1].split(":")[1])
        assert err < 0.01


def test_results_pickle_and_gc():
    """Partial results hold host copies: they outlive the run and
    pickle."""
    ctx, ds, _, _, _ = _both()
    parts = list(ctx.run_udf_iter(ds, port.SumUDF()))
    gc.collect()
    data = pickle.loads(pickle.dumps(parts[0].buffers[0]["intensity"].data))
    assert data.shape == SIG
    assert not _readers()
