"""The multi-device loop of the port against the JAX package's, on the
CPU, part 1 (counterparts of ``tests/test_sharded.py``:
test_sharded_sum, test_sharded_stddev_masks, test_sharded_roi_pick,
test_sharded_partial_iter, test_sharded_roi_corrections,
test_io_backend_compat, test_sharded_partition_method,
test_sharded_fewer_frames_than_devices, test_sharded_single_frame,
test_sharded_param_patch_mid_run; ``tests/test_matrix_sharded.py``:
test_sharded_format_sums; ``tests/test_live.py``'s sharded live runs;
and the run paths of ``Context`` over several workers).

The same seeded numpy data goes through the JAX package's
``UDFRunner(...).run_for_dataset(ds, devices=jax.devices()[:n])`` (the
test configuration's virtual CPU devices) and through the port over
``[torch.device("cpu")] * n`` workers, for n in {2, 4}.  Against the
port's own single-device run, nav buffers agree within rtol 1e-6 and
PickUDF's frames and integer sums bit for bit; against both, sig and
single buffers agree within rtol 1e-5 with an absolute floor of 1e-5 of
the buffer's largest magnitude (float32 sums in another order).
``test_torch_sharded2.py`` holds part 2.
"""
import asyncio
import logging
import threading
import time

import jax
import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.sharded import ShardedJobExecutor as JaxSharded
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemory
from libertem_tpu.udf.base import UDFRunner as JaxRunner

import libertem_tpu_torch as port
from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet
from libertem_tpu_torch.udf.base import UDFRunner

from conftest import _mk_random
from test_matrix import MAKERS, built  # noqa: F401  (fixture)

torch.set_num_threads(1)

CPU = torch.device("cpu")
WORKERS = (2, 4)
NAV_RTOL = 1e-6
RTOL = 1e-5
SIG = (24, 24)


# -- helpers -------------------------------------------------------------


def close(a, b, rtol=RTOL):
    """Within ``rtol``, with an absolute floor of ``rtol`` of ``b``'s
    largest magnitude."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.nanmax(np.abs(b), initial=0.0)), 1.0)
    assert np.allclose(a, b, rtol=rtol, atol=rtol * scale, equal_nan=True)


def jax_run(udfs, ds, n, **kw):
    return JaxRunner(udfs).run_for_dataset(ds, devices=jax.devices()[:n],
                                           **kw)


def port_run(udfs, ds, n, **kw):
    return UDFRunner(udfs).run_for_dataset(ds, devices=[CPU] * n, **kw)


def port_single(udfs, ds, **kw):
    return UDFRunner(udfs).run_for_dataset(ds, CPU, **kw)


def data16():
    return _mk_random((16, 16) + SIG, dtype="float32")


def both_ds(data, parts=5):
    return (MemoryDataSet(data=data, sig_dims=2,
                          num_partitions=parts).initialize(),
            JaxMemory(data=data, sig_dims=2,
                      num_partitions=parts).initialize())


def check(res, jres, single, kinds):
    """``kinds``: per UDF, name -> "nav" | "sig" | "exact"."""
    for ui, names in enumerate(kinds):
        for name, kind in names.items():
            got = np.asarray(res.buffers[ui][name].data)
            one = np.asarray(single.buffers[ui][name].data)
            want = np.asarray(jres.buffers[ui][name].data)
            if kind == "exact":
                assert got.dtype == one.dtype
                assert np.array_equal(got, one), name
                assert np.array_equal(got, want), name
            elif kind == "nav":
                close(got, one, NAV_RTOL)
                close(got, want)
            else:
                close(got, one)
                close(got, want)
    assert np.array_equal(res.damage.data, single.damage.data)


def threads_alive():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("block-reader")]


def threads_end(timeout=1.0) -> bool:
    t0 = time.perf_counter()
    while threads_alive() and time.perf_counter() - t0 < timeout:
        time.sleep(0.01)
    return not threads_alive()


# -- counterparts of tests/test_sharded.py ---------------------------------


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_sum(n):
    data = data16()
    ds, jds = both_ds(data)
    res = port_run([port.SumUDF(), port.SumSigUDF()], ds, n)
    jres = jax_run([libertem_tpu.udf.SumUDF(), libertem_tpu.udf.SumSigUDF()],
                   jds, n)
    single = port_single([port.SumUDF(), port.SumSigUDF()], ds)
    check(res, jres, single, [{"intensity": "sig"}, {"intensity": "nav"}])
    close(res.buffers[0]["intensity"].data, data.sum(axis=(0, 1)))
    close(res.buffers[1]["intensity"].data, data.sum(axis=(2, 3)))


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_integer_sums_exact(n):
    """u16 data: the integer sums (float32 state of integer counts,
    exact below 2**24) agree bit for bit with the single-device run and
    the JAX package."""
    data = np.random.default_rng(3).poisson(9.0, (16, 16) + SIG).astype(
        np.uint16)
    ds, jds = both_ds(data)
    udfs = [port.SumUDF(), port.SumSigUDF()]
    res = port_run(udfs, ds, n)
    jres = jax_run([libertem_tpu.udf.SumUDF(), libertem_tpu.udf.SumSigUDF()],
                   jds, n)
    single = port_single([port.SumUDF(), port.SumSigUDF()], ds)
    check(res, jres, single, [{"intensity": "exact"},
                              {"intensity": "exact"}])
    assert np.array_equal(res.buffers[0]["intensity"].data,
                          data.sum(axis=(0, 1)).astype(np.float32))


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_stddev_masks(n):
    data = data16()
    ds, jds = both_ds(data)
    m0 = port.masks.circular(12, 12, 24, 24, 6)
    jm0 = libertem_tpu.masks.circular(12, 12, 24, 24, 6)
    res = port_run([port.StdDevUDF(),
                    port.ApplyMasksUDF(mask_factories=[lambda: m0])], ds, n)
    jres = jax_run([libertem_tpu.udf.StdDevUDF(),
                    libertem_tpu.udf.ApplyMasksUDF(
                        mask_factories=[lambda: jm0])], jds, n)
    single = port_single([port.StdDevUDF(),
                          port.ApplyMasksUDF(mask_factories=[lambda: m0])],
                         ds)
    check(res, jres, single, [
        {"num_frames": "exact", "sum": "sig", "var": "sig", "mean": "sig",
         "std": "sig", "varsum": "sig"},
        {"intensity": "nav"},
    ])
    flat = data.reshape(-1, *SIG).astype(np.float64)
    assert float(np.ravel(res.buffers[0]["num_frames"].data)[0]) \
        == flat.shape[0]
    close(res.buffers[0]["var"].data, flat.var(axis=0), 1e-4)


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_roi_pick(n):
    data = data16()
    ds, jds = both_ds(data)
    roi = np.zeros(16 * 16, dtype=bool)
    roi[[5, 100, 200, 255]] = True
    res = port_run([port.PickUDF()], ds, n, roi=roi)
    jres = jax_run([libertem_tpu.udf.PickUDF()], jds, n, roi=roi)
    single = port_single([port.PickUDF()], ds, roi=roi)
    check(res, jres, single, [{"intensity": "exact"}])
    assert np.array_equal(res.buffers[0]["intensity"].data,
                          data.reshape(-1, *SIG)[[5, 100, 200, 255]])


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_partial_iter(n):
    """One partial a super-step, then the final result: the damage
    grows, the nav rows merged so far are the single-device run's."""
    data = data16()
    ds, jds = both_ds(data)
    partials = [(np.array(p.damage.data),
                 np.array(p.buffers[0]["intensity"].data))
                for p in UDFRunner([port.SumSigUDF()]).run_for_dataset_iter(
                    ds, devices=[CPU] * n)]
    jpartials = list(JaxRunner([libertem_tpu.udf.SumSigUDF()])
                     .run_for_dataset_iter(jds, devices=jax.devices()[:n]))
    assert len(partials) == len(jpartials) >= 2
    single = port_single([port.SumSigUDF()], ds)
    want = np.asarray(single.buffers[0]["intensity"].data)
    prev = -1
    for k, ((damage, got), jp) in enumerate(zip(partials, jpartials)):
        assert np.array_equal(damage, np.asarray(jp.damage.data))
        # the last super-step's partial, then the final result
        assert damage.sum() > prev or k == len(partials) - 1
        prev = damage.sum()
        close(got[damage], want[damage], NAV_RTOL)
    assert partials[-1][0].all()
    close(partials[-1][1], data.sum(axis=(2, 3)))


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_roi_corrections(n):
    data = data16()
    ds, jds = both_ds(data)
    rng = np.random.default_rng(8)
    dark = rng.normal(size=SIG).astype(np.float32)
    gain = (1 + 0.05 * rng.random(SIG)).astype(np.float32)
    ex = np.zeros(SIG, dtype=bool)
    ex[5, 7] = True
    roi = rng.random(16 * 16) > 0.3
    corr = port.CorrectionSet(dark=dark, gain=gain, excluded_pixels=ex)
    from libertem_tpu.io.corrections import CorrectionSet as JaxCorr
    jcorr = JaxCorr(dark=dark, gain=gain, excluded_pixels=ex)
    res = port_run([port.SumUDF(), port.SumSigUDF()], ds, n, roi=roi,
                   corrections=corr)
    jres = jax_run([libertem_tpu.udf.SumUDF(), libertem_tpu.udf.SumSigUDF()],
                   jds, n, roi=roi, corrections=jcorr)
    single = port_single([port.SumUDF(), port.SumSigUDF()], ds, roi=roi,
                         corrections=corr)
    check(res, jres, single, [{"intensity": "sig"}, {"intensity": "nav"}])
    expected = corr.apply_numpy(data.reshape(-1, *SIG)[roi])
    close(res.buffers[0]["intensity"].data, expected.sum(axis=0), 1e-4)


def test_io_backend_compat():
    from libertem_tpu.io.dataset.base import IOBackend as JaxIOBackend

    from libertem_tpu_torch.io.dataset.base import (
        BufferedBackend,
        DirectBackend,
        IOBackend,
        MMapBackend,
    )
    for id_, cls in (("mmap", MMapBackend), ("buffered", BufferedBackend),
                     ("direct", DirectBackend)):
        b = IOBackend.from_json({"id": id_})
        assert isinstance(b, cls)
        assert type(b).__name__ == type(
            JaxIOBackend.from_json({"id": id_})).__name__


def _part_sum(lib):
    if lib is port:
        class PartSum(port.udf.UDF):
            def get_result_buffers(self):
                return {"intensity": self.buffer(kind="sig",
                                                 dtype="float32")}

            def process_partition(self, partition):
                vmask = self.meta.tile_valid.reshape(
                    (-1,) + (1,) * (partition.ndim - 1))
                self.results.intensity += (partition * vmask).sum(dim=0)

            def merge(self, dest, src):
                dest.intensity = dest.intensity + src.intensity
    else:
        class PartSum(libertem_tpu.udf.base.UDF):
            def get_result_buffers(self):
                return {"intensity": self.buffer(kind="sig",
                                                 dtype="float32")}

            def process_partition(self, partition):
                vmask = self.meta.tile_valid.reshape(
                    (-1,) + (1,) * (partition.ndim - 1))
                self.results.intensity += (partition * vmask).sum(axis=0)

            def merge(self, dest, src):
                dest.intensity = dest.intensity + src.intensity
    return PartSum()


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_partition_method(n, caplog):
    """process_partition UDFs run on the workers, each block playing
    the partition role, with the JAX package's warning."""
    data = data16()
    ds, jds = both_ds(data)
    with caplog.at_level(logging.WARNING):
        res = port_run([_part_sum(port)], ds, n)
        jres = jax_run([_part_sum(libertem_tpu)], jds, n)
    single = port_single([_part_sum(port)], ds)
    check(res, jres, single, [{"intensity": "sig"}])
    close(res.buffers[0]["intensity"].data, data.sum(axis=(0, 1)), 1e-4)
    msgs = {r.name.split(".")[0]: r.getMessage() for r in caplog.records
            if "process_partition" in r.getMessage()}
    assert msgs["libertem_tpu_torch"] == msgs["libertem_tpu"].replace(
        "—", "-")


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_fewer_frames_than_devices(n):
    """3 frames over n workers: some shards are empty."""
    data = _mk_random((3, 10, 10), dtype="float32")
    ds = MemoryDataSet(data=data, sig_dims=2).initialize()
    jds = JaxMemory(data=data, sig_dims=2).initialize()
    res = port_run([port.SumUDF(), port.SumSigUDF()], ds, n)
    jres = jax_run([libertem_tpu.udf.SumUDF(), libertem_tpu.udf.SumSigUDF()],
                   jds, n)
    single = port_single([port.SumUDF(), port.SumSigUDF()], ds)
    check(res, jres, single, [{"intensity": "sig"}, {"intensity": "nav"}])
    assert res.buffers[1]["intensity"].data.shape == (3,)
    close(res.buffers[0]["intensity"].data, data.sum(axis=0))


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_single_frame(n):
    data = _mk_random((1, 8, 8), dtype="float32")
    ds = MemoryDataSet(data=data, sig_dims=2).initialize()
    jds = JaxMemory(data=data, sig_dims=2).initialize()
    res = port_run([port.SumUDF()], ds, n)
    jres = jax_run([libertem_tpu.udf.SumUDF()], jds, n)
    single = port_single([port.SumUDF()], ds)
    check(res, jres, single, [{"intensity": "sig"}])
    close(res.buffers[0]["intensity"].data, data[0])


def _scaled_sum(lib):
    if lib is port:
        from libertem_tpu_torch.io import tiling
        base = port.udf.UDF
    else:
        from libertem_tpu.io import tiling
        base = libertem_tpu.udf.base.UDF

    class ScaledSumUDF(base):
        def __init__(self, scale=1.0):
            super().__init__(scale=scale)

        def get_result_buffers(self):
            return {"intensity": self.buffer(kind="nav", dtype="float32")}

        def get_tiling_preferences(self):
            # depth 4: several super-steps a shard
            return {"depth": 4, "total_size": tiling.TILE_SIZE_MAX}

        def process_tile(self, tile):
            flat = tile.reshape(tile.shape[0], -1)
            self.results.intensity += flat.sum(axis=1) * float(
                self.params.scale)

        def merge(self, dest, src):
            pass

    return ScaledSumUDF(scale=1.0)


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_param_patch_mid_run(n):
    """A patch after the first partial applies from the next
    super-step on, in both packages: the same frames at scale 1 and at
    scale 3."""
    data = data16()
    ds, jds = both_ds(data, parts=4)
    frame_sums = data.reshape(-1, SIG[0] * SIG[1]).sum(axis=1)
    ratios = []
    for runner, it in (
            (r := UDFRunner([_scaled_sum(port)]),
             r.run_for_dataset_iter(ds, devices=[CPU] * n)),
            (j := JaxRunner([_scaled_sum(libertem_tpu)]),
             j.run_for_dataset_iter(jds, devices=jax.devices()[:n]))):
        results = []
        for i, part in enumerate(it):
            results.append(part)
            if i == 0:
                runner.update_parameters_experimental([{"scale": 3.0}])
        final = np.asarray(results[-1].buffers[0]["intensity"].data)
        ratios.append(final.reshape(-1) / frame_sums)
    ratio, jratio = ratios
    assert set(np.round(ratio.astype(np.float64), 3)) <= {1.0, 3.0}
    assert np.isclose(ratio, 3.0, rtol=1e-3).any()
    assert np.isclose(ratio, 1.0, rtol=1e-3).any()
    assert np.array_equal(np.round(ratio, 3), np.round(jratio, 3))


# -- counterpart of tests/test_matrix_sharded.py::test_sharded_format_sums --


@pytest.mark.parametrize("fmt", sorted(MAKERS))
def test_sharded_format_sums(built, fmt):  # noqa: F811
    """Every format's reader under n workers: Sum and SumSig against
    numpy, the JAX package's sharded run and the port's single-device
    run."""
    loader, kwargs, flat = built(fmt)
    ref = flat.astype(np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    one = port.Context(device="cpu")
    single = one.run_udf(one.load(loader, **kwargs),
                         [port.SumUDF(), port.SumSigUDF()])
    for n in WORKERS:
        ctx = port.Context(executor=ShardedJobExecutor(devices=[CPU] * n))
        res = ctx.run_udf(ctx.load(loader, **kwargs),
                          [port.SumUDF(), port.SumSigUDF()])
        jctx = JaxContext(executor=JaxSharded(devices=jax.devices()[:n]))
        jres = jctx.run_udf(jctx.load(loader, **kwargs),
                            [libertem_tpu.udf.SumUDF(),
                             libertem_tpu.udf.SumSigUDF()])
        assert np.allclose(res[0]["intensity"].data, ref.sum(axis=0),
                           rtol=1e-4, atol=1e-5 * scale * len(ref)), fmt
        for got, want in ((res[0]["intensity"].data,
                           jres[0]["intensity"].data),
                          (res[0]["intensity"].data,
                           single[0]["intensity"].data)):
            close(got, want)
        close(res[1]["intensity"].data, single[1]["intensity"].data,
              NAV_RTOL)
        # a frame's float32 sum in the two packages' orders: 1.5e-5
        # apart over K2IS's 3.8 Mpx frames; held at the JAX matrix
        # test's own 1e-4
        close(res[1]["intensity"].data, jres[1]["intensity"].data, 1e-4)
        close(res[1]["intensity"].data.reshape(-1), ref.sum(axis=(1, 2)),
              1e-4)


# -- the live ring, block-cyclic (tests/test_live.py's sharded runs) -------


def _live(lib, data, ring=64, parts=3):
    if lib is port:
        from libertem_tpu_torch.io.dataset.live import LiveDataSet
    else:
        from libertem_tpu.io.dataset.live import LiveDataSet
    nav, sig = data.shape[:-2], data.shape[-2:]
    return LiveDataSet(nav_shape=nav, sig_shape=sig, dtype=data.dtype,
                       ring_capacity=ring, num_partitions=parts).initialize()


def _push(ds, flat, step=7, finish=True):
    def producer():
        for off in range(0, len(flat), step):
            ds.push_frames(flat[off:off + step])
            time.sleep(0.001)
        if finish:
            ds.finish()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    return t


def test_sharded_live_block_cyclic():
    """The live ring on 2 workers: block-cyclic shards read in order
    while a producer pushes; the results are the single-device run's
    and the JAX package's, and the producer never stalls."""
    data = _mk_random((12, 8, 8, 8), dtype="float32")
    flat = data.reshape(-1, 8, 8)
    results = []
    for lib, runner, kw in (
            (port, UDFRunner([port.SumUDF(), port.SumSigUDF(),
                              port.StdDevUDF()]), dict(devices=[CPU] * 2)),
            (port, UDFRunner([port.SumUDF(), port.SumSigUDF(),
                              port.StdDevUDF()]), dict(device=CPU)),
            (libertem_tpu, JaxRunner([libertem_tpu.udf.SumUDF(),
                                      libertem_tpu.udf.SumSigUDF(),
                                      libertem_tpu.udf.StdDevUDF()]),
             dict(devices=jax.devices()[:2]))):
        ds = _live(lib, data)
        t = _push(ds, flat)
        results.append(runner.run_for_dataset(ds, **kw))
        t.join(timeout=30)
        assert not t.is_alive()
        if kw.get("devices") is not None and lib is port:
            # the depth capped to fit 2 workers' blocks in the ring's
            # in-flight window (32 frames): 3 super-steps of 2 x 16
            assert [w["blocks"] for w in runner.feed_stats["workers"]] \
                == [3, 3]
    res, single, jres = results
    check(res, jres, single, [{"intensity": "sig"}, {"intensity": "nav"},
                              {"sum": "sig", "var": "sig",
                               "num_frames": "exact"}])
    assert res.damage.data.all()
    close(res.buffers[1]["intensity"].data, data.sum(axis=(2, 3)))


def test_sharded_live_early_finish_and_roi():
    """An early finish() on 2 workers: damage marks the frames that
    arrived; and a sparse roi over a live ring reads in order."""
    data = _mk_random((4, 4, 8, 8), dtype="float32")
    flat = data.reshape(-1, 8, 8)
    outs = []
    for lib, runner, kw in (
            (port, UDFRunner([port.SumSigUDF()]), dict(devices=[CPU] * 2)),
            (libertem_tpu, JaxRunner([libertem_tpu.udf.SumSigUDF()]),
             dict(devices=jax.devices()[:2]))):
        ds = _live(lib, data, parts=2)
        ds.push_frames(flat[:6])
        ds.finish()
        res = runner.run_for_dataset(ds, **kw)
        outs.append((np.asarray(res.buffers[0]["intensity"].data)
                     .reshape(-1), np.asarray(res.damage.data).reshape(-1)))
    (out, dmg), (jout, jdmg) = outs
    close(out[:6], flat[:6].sum(axis=(1, 2)), NAV_RTOL)
    assert np.allclose(out[6:], 0.0)
    assert dmg[:6].all() and not dmg[6:].any()
    assert np.array_equal(dmg, jdmg)
    close(out, jout)

    line = _mk_random((64, 8, 8), dtype="float32")
    roi = np.zeros(64, dtype=bool)
    roi[[3, 17, 18, 40, 63]] = True
    ds = _live(port, line, parts=2)
    t = _push(ds, line, step=16)
    res = UDFRunner([port.SumUDF()]).run_for_dataset(ds, roi=roi,
                                                     devices=[CPU] * 2)
    t.join(timeout=30)
    assert not t.is_alive(), "producer deadlocked"
    close(res.buffers[0]["intensity"].data,
          line[roi].astype(np.float64).sum(axis=0))


# -- the run paths of Context over several workers -------------------------


@pytest.mark.parametrize("n", WORKERS)
def test_context_paths_over_workers(n):
    """run_udf, run_udf_iter, both sync=False forms, Context.run,
    Context.map and the delayed executor over n workers give the
    single-device results and the JAX package's sharded ones."""
    from libertem_tpu_torch.executor.delayed import DelayedJobExecutor

    data = np.random.default_rng(11).poisson(7.0, (8, 8, 12, 12)).astype(
        np.uint16)
    ctx = port.Context(executor=ShardedJobExecutor(devices=[CPU] * n))
    ds = ctx.load("memory", data=data, sig_dims=2)
    assert ds.get_num_partitions() == max(4, 2 * n)
    one = port.Context(device="cpu")
    jctx = JaxContext(executor=JaxSharded(devices=jax.devices()[:n]))
    jds = jctx.load("memory", data=data, sig_dims=2)

    def udfs(lib):
        return [lib.udf.SumUDF(), lib.udf.SumSigUDF(), lib.udf.StdDevUDF()]

    want = one.run_udf(ds, udfs(port))
    jwant = jctx.run_udf(jds, udfs(libertem_tpu))

    def same(got):
        for r, w, j in zip(got, want, jwant):
            for k in r:
                close(r[k].data, w[k].data)
                close(r[k].data, j[k].data)

    same(ctx.run_udf(ds, udfs(port)))
    same(asyncio.run(ctx.run_udf(ds, udfs(port), sync=False)))
    last = None
    for last in ctx.run_udf_iter(ds, udfs(port)):
        pass
    same(last.buffers)

    async def drain():
        out = None
        async for p in ctx.run_udf_iter(ds, udfs(port), sync=False):
            out = p
        return out

    same(asyncio.run(drain()).buffers)
    com = ctx.run(ctx.create_com_analysis(ds, cx=6, cy=6, mask_radius=4))
    com1 = one.run(one.create_com_analysis(ds, cx=6, cy=6, mask_radius=4))
    close(com.x.raw_data, com1.x.raw_data, NAV_RTOL)
    mapped = ctx.map(ds, lambda frame: frame.sum())
    close(mapped.data, data.sum(axis=(2, 3)), NAV_RTOL)
    dctx = port.Context(executor=DelayedJobExecutor(
        wrapped=ShardedJobExecutor(devices=[CPU] * n)))
    lazy = dctx.run_udf(ds, udfs(port))
    assert dctx.feed_stats is None
    same([{k: r[k] for k in r} for r in lazy])
    assert len(dctx.feed_stats["workers"]) == n
    assert threads_end()


def test_abandoned_iterator_ends_readers():
    """An iterator abandoned after two partials leaves no block reader
    thread alive within 1 s, and releases every slot (blocks of 8
    frames: the reader still has steps to read)."""
    from libertem_tpu_torch.io.tiling import TILE_SIZE_MAX

    class SmallBlocks(port.SumUDF):
        def get_tiling_preferences(self):
            return {"depth": 8, "total_size": TILE_SIZE_MAX}

    data = data16()
    ds, _ = both_ds(data, parts=4)
    runner = UDFRunner([SmallBlocks(), port.SumSigUDF()])
    gen = runner.run_for_dataset_iter(ds, devices=[CPU] * 2)
    next(gen)
    next(gen)
    assert threads_alive()
    gen.close()
    assert threads_end(1.0), threads_alive()
    assert all(w["blocks"] > 0 for w in runner.feed_stats["workers"])


def test_sharded_stats_keys(monkeypatch):
    """LIBERTEM_TPU_SHARDED_STATS: the stage timings of the JAX
    package's loop, under its keys, and the port's collective time and
    transport (0 and None in one process)."""
    monkeypatch.setenv("LIBERTEM_TPU_SHARDED_STATS", "1")
    data = data16()
    ds, jds = both_ds(data)
    runner = UDFRunner([port.SumUDF(), port.StdDevUDF()])
    for _ in runner.run_for_dataset_iter(ds, devices=[CPU] * 2):
        pass
    jrunner = JaxRunner([libertem_tpu.udf.SumUDF(),
                         libertem_tpu.udf.StdDevUDF()])
    jrunner.run_for_dataset(jds, devices=jax.devices()[:2])
    stats = runner.last_sharded_stats
    assert set(stats) == set(jrunner.last_sharded_stats) | {
        "collective_s", "transport"}
    assert stats["collective_s"] == 0 and stats["transport"] is None
    assert stats["n_devices"] == 2 and stats["n_steps"] >= 1
    assert stats["step_s"] > 0 and stats["assembly_s"] > 0
    assert stats["fold_s"] > 0 and stats["wrap_s"] > 0
    monkeypatch.delenv("LIBERTEM_TPU_SHARDED_STATS")
    runner.run_for_dataset(ds, devices=[CPU] * 2)
    assert runner.last_sharded_stats is None
