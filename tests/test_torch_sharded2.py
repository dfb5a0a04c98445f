"""The multi-device loop of the port against the JAX package's, on the
CPU, part 2 (counterparts of ``tests/test_sharded.py``:
test_sharded_reader_overlap, test_sharded_aux_buffers,
test_sharded_postprocess_before_final_yield, test_sharded_kitchen_sink,
test_sharded_record_udf, test_sharded_record_with_roi_and_device_udf,
test_sharded_host_udf_matches_inline, test_sharded_preprocess_cadence,
test_sharded_preprocess_clone_isolation,
test_sharded_host_udf_aux_patch_mid_run; ``tests/test_matrix_sharded.py``:
test_sharded_format_validation, test_sharded_kitchen_sink;
``tests/test_live.py``: test_live_sharded_host_udf_custom_merge, the
host engine's ``merge_partition(runs=)``).

Data, workers and tolerances as in ``test_torch_sharded.py``: the JAX
package over ``jax.devices()[:n]``, the port over ``[cpu] * n``, n in
{2, 4}; nav buffers within rtol 1e-6 of the port's single-device run;
sig and single buffers within rtol 1e-5 (absolute floor 1e-5 of the
largest magnitude) of it and of the JAX package's.
"""
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
from libertem_tpu.io.corrections import CorrectionSet as JaxCorrectionSet
from libertem_tpu.udf.base import UDFRunner as JaxRunner

import libertem_tpu_torch as port
from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet
from libertem_tpu_torch.udf.base import UDFRunner

from conftest import _mk_random
from test_matrix import MAKERS, built  # noqa: F401  (fixture)
from test_torch_sharded import (
    CPU,
    SIG,
    WORKERS,
    _live,
    both_ds,
    check,
    close,
    data16,
    jax_run,
    port_run,
    port_single,
)
from utils import ValidationUDF as JaxValidationUDF

torch.set_num_threads(1)


def lib_base(lib):
    return port.udf.UDF if lib is port else libertem_tpu.udf.base.UDF


def lib_tiling(lib):
    if lib is port:
        from libertem_tpu_torch.io import tiling
    else:
        from libertem_tpu.io import tiling
    return tiling


# -- counterparts of tests/test_sharded.py ---------------------------------


def test_sharded_reader_overlap():
    """Each worker's chunk is read in the reader pool: a dataset whose
    reads sleep sees more than one read in flight, and each worker's
    feed did its share of the reads."""
    state = {"active": 0, "max_active": 0}
    lock = threading.Lock()

    class SlowReadDataSet(MemoryDataSet):
        def get_partitions(self):
            for p in super().get_partitions():
                orig = p.read_frames_into

                def slow_read(s, e, out, _orig=orig):
                    with lock:
                        state["active"] += 1
                        state["max_active"] = max(state["max_active"],
                                                  state["active"])
                    time.sleep(0.02)
                    try:
                        return _orig(s, e, out)
                    finally:
                        with lock:
                            state["active"] -= 1

                p.read_frames_into = slow_read
                yield p

    data = _mk_random((16, 8, 8, 8), dtype="float32")
    ds = SlowReadDataSet(data=data, sig_dims=2, num_partitions=8).initialize()
    runner = UDFRunner([port.SumUDF()])
    res = runner.run_for_dataset(ds, devices=[CPU] * 4)
    close(res.buffers[0]["intensity"].data, data.sum(axis=(0, 1)))
    assert state["max_active"] > 1, state
    assert all(w["read_s"] > 0 and w["blocks"] > 0
               for w in runner.feed_stats["workers"])


def _aux_scale(lib, weights):
    class AuxScaleUDF(lib_base(lib)):
        def get_result_buffers(self):
            return {"scaled": self.buffer(kind="nav", dtype="float32")}

        def process_frame(self, frame):
            self.results.scaled = frame.sum() * self.params.weights

    return AuxScaleUDF(weights=AuxScaleUDF.aux_data(
        weights, kind="nav", dtype="float32"))


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_aux_buffers(n):
    """Aux rows reach every worker's frames (each worker's device copy
    of the aux arrays, indexed by the block's global offset)."""
    data = data16()
    ds, jds = both_ds(data, parts=3)
    weights = np.linspace(1, 2, 256).astype(np.float32)
    res = port_run([_aux_scale(port, weights)], ds, n)
    jres = jax_run([_aux_scale(libertem_tpu, weights)], jds, n)
    single = port_single([_aux_scale(port, weights)], ds)
    check(res, jres, single, [{"scaled": "nav"}])
    expected = data.reshape(256, -1).astype(np.float64).sum(axis=1) * weights
    close(np.ravel(res.buffers[0]["scaled"].data), expected, 1e-4)


def _post_udf(lib):
    class PostUDF(lib_base(lib)):
        def __init__(self):
            super().__init__()
            self.post_ran = False

        def get_result_buffers(self):
            return {"intensity": self.buffer(kind="sig", dtype="float32")}

        def process_tile(self, tile):
            self.results.intensity += tile.sum(axis=0)

        def merge(self, dest, src):
            dest.intensity = dest.intensity + src.intensity

        def postprocess(self):
            self.post_ran = True

        def get_results(self):
            if self.post_ran:
                return {"intensity": self.results.intensity * 2.0}
            return {}

    return PostUDF()


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_postprocess_before_final_yield(n):
    """postprocess shows in the last result of a partial-results run
    (doubled there), in both packages."""
    data = data16()
    ds, jds = both_ds(data)
    last = jlast = None
    for last in UDFRunner([_post_udf(port)]).run_for_dataset_iter(
            ds, devices=[CPU] * n):
        pass
    for jlast in JaxRunner([_post_udf(libertem_tpu)]).run_for_dataset_iter(
            jds, devices=jax.devices()[:n]):
        pass
    got = last.buffers[0]["intensity"].data
    close(got, 2.0 * data.sum(axis=(0, 1)), 1e-4)
    close(got, jlast.buffers[0]["intensity"].data)


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_kitchen_sink(tmp_path, n):
    """A raw file, a sparse roi, corrections, three UDFs, partial
    results and a mask patch after the first one, on n workers: the
    same answers as the JAX package's (the patch at the same
    super-step), and numpy's."""
    rng = np.random.default_rng(0)
    nav, sig = (12, 10), (16, 16)
    raw = rng.integers(10, 1000, nav + sig).astype(np.uint16)
    path = str(tmp_path / "ks.raw")
    raw.tofile(path)
    roi = rng.random(nav) > 0.4
    dark = rng.normal(size=sig).astype(np.float32)
    gain = (1 + 0.05 * rng.random(sig)).astype(np.float32)
    mask_a = rng.random(sig).astype(np.float32)
    mask_b = rng.random(sig).astype(np.float32)
    lasts = []
    for lib, ctx, runner_cls, corr, kw in (
            (port, port.Context(device="cpu"), UDFRunner,
             port.CorrectionSet(dark=dark, gain=gain),
             dict(devices=[CPU] * n)),
            (libertem_tpu, JaxContext(), JaxRunner,
             JaxCorrectionSet(dark=dark, gain=gain),
             dict(devices=jax.devices()[:n]))):
        # many small partitions: a small block depth, several
        # super-steps
        ds = ctx.load("raw", path=path, dtype="uint16", nav_shape=nav,
                      sig_shape=sig, num_partitions=30)
        udfs = [lib.udf.SumUDF(), lib.udf.StdDevUDF(),
                lib.udf.ApplyMasksUDF(mask_factories=[lambda: mask_a])]
        runner = runner_cls(udfs)
        n_seen = 0
        for last in runner.run_for_dataset_iter(
                ds, roi=roi.reshape(-1), corrections=corr, **kw):
            if n_seen == 0:
                runner.update_parameters_experimental([
                    {}, {}, {"mask_factories": [lambda: mask_b]}])
            n_seen += 1
        assert n_seen >= 2
        lasts.append(last)
    last, jlast = lasts
    corrected = (raw.astype(np.float64) - dark) * gain
    sel = corrected.reshape((-1,) + sig)[roi.reshape(-1)]
    close(last.buffers[0]["intensity"].data, sel.sum(axis=0), 1e-4)
    close(last.buffers[1]["var"].data, sel.var(axis=0), 1e-3)
    for ui, name in ((0, "intensity"), (1, "var"), (1, "sum")):
        close(last.buffers[ui][name].data, jlast.buffers[ui][name].data)
    got = np.asarray(last.buffers[2]["intensity"].data).reshape(-1)
    close(got, np.asarray(jlast.buffers[2]["intensity"].data).reshape(-1))
    last_id = np.flatnonzero(roi.reshape(-1))[-1]
    assert np.isclose(got[last_id],
                      corrected.reshape((-1,) + sig)[last_id].reshape(-1)
                      @ mask_b.reshape(-1), rtol=1e-5)


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_record_udf(tmp_path, n):
    """RecordUDF on n workers writes every frame at its global offset:
    the file is the scan, as the JAX package's."""
    data = data16()
    ds, jds = both_ds(data, parts=3)
    out, jout = str(tmp_path / "rec.npy"), str(tmp_path / "jrec.npy")
    port_run([port.udf.RecordUDF(filename=out)], ds, n)
    jax_run([libertem_tpu.udf.record.RecordUDF(filename=jout)], jds, n)
    assert np.array_equal(np.load(out), data)
    assert np.array_equal(np.load(out), np.load(jout))


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_record_with_roi_and_device_udf(tmp_path, n):
    """RecordUDF on the host engine beside SumUDF on the device engine
    in one pass over a sparse roi."""
    data = data16()
    ds, jds = both_ds(data, parts=3)
    rng = np.random.default_rng(5)
    roi = np.zeros(16 * 16, dtype=bool)
    roi[rng.choice(roi.size, 40, replace=False)] = True
    out, jout = str(tmp_path / "rec.npy"), str(tmp_path / "jrec.npy")
    res = port_run([port.udf.RecordUDF(filename=out), port.SumUDF()], ds, n,
                   roi=roi)
    jres = jax_run([libertem_tpu.udf.record.RecordUDF(filename=jout),
                    libertem_tpu.udf.SumUDF()], jds, n, roi=roi)
    single = port_single([port.SumUDF()], ds, roi=roi)
    sel = data.reshape(-1, *SIG)[roi]
    assert np.array_equal(np.load(out), sel)
    assert np.array_equal(np.load(jout), sel)
    close(res.buffers[1]["intensity"].data, single.buffers[0]["intensity"]
          .data)
    close(res.buffers[1]["intensity"].data, jres.buffers[1]["intensity"].data)


def _host_sum(lib):
    class HostSum(lib_base(lib)):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"persig": self.buffer(kind="sig", dtype=np.float32),
                    "pernav": self.buffer(kind="nav", dtype=np.float32)}

        def process_tile(self, tile):
            self.results.persig[:] += np.asarray(
                tile, dtype=np.float64).sum(axis=0).astype(np.float32)
            self.results.pernav[:] = tile.sum(axis=(1, 2))

        def merge(self, dest, src):
            # a custom merge writes the nav buffers too
            dest.persig[:] += src.persig
            dest.pernav[:] = src.pernav

    return HostSum()


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_host_udf_matches_inline(n):
    """A numpy UDF with a custom merge on n workers: one partition
    buffer a shard, merged in shard order, as the single-device run
    and the JAX package."""
    data = data16()
    ds, jds = both_ds(data, parts=4)
    res = port_run([_host_sum(port)], ds, n)
    jres = jax_run([_host_sum(libertem_tpu)], jds, n)
    single = port_single([_host_sum(port)], ds)
    check(res, jres, single, [{"persig": "sig", "pernav": "nav"}])
    flat = data.reshape(-1, *SIG)
    close(res.buffers[0]["persig"].data, flat.sum(axis=0), 1e-4)


def _cadence(lib, calls):
    class Cadence(lib_base(lib)):
        def get_result_buffers(self):
            return {"x": self.buffer(kind="single", dtype=np.float32)}

        def process_tile(self, tile):
            pass

        def merge(self, dest, src):
            dest.x = src.x

        def preprocess(self):
            calls["pre"] += 1

        def postprocess(self):
            calls["post"] += 1

    return Cadence()


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_preprocess_cadence(n):
    """preprocess and postprocess once a shard, in both packages."""
    data = data16()
    ds, jds = both_ds(data)
    calls = {"pre": 0, "post": 0}
    jcalls = {"pre": 0, "post": 0}
    port_run([_cadence(port, calls)], ds, n)
    jax_run([_cadence(libertem_tpu, jcalls)], jds, n)
    assert calls == jcalls == {"pre": n, "post": n}


def _paired(lib, instances):
    class Paired(lib_base(lib)):
        def get_result_buffers(self):
            return {"x": self.buffer(kind="single", dtype="float32")}

        def process_tile(self, tile):
            pass

        def merge(self, dest, src):
            dest.x = src.x

        def preprocess(self):
            # a second call on one instance trips the postprocess
            self._opened = getattr(self, "_opened", 0) + 1
            instances.append(self)

        def postprocess(self):
            assert self._opened == 1, self._opened
            self._opened -= 1

        def cleanup(self):
            self.cleaned = True

    return Paired()


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_preprocess_clone_isolation(n):
    """Each shard's hooks run on its own instance: the real one for
    shard 0, clones for the others, each cleaned up after its
    postprocess (the real one at the run's end)."""
    data = data16()
    ds, jds = both_ds(data)
    instances, jinstances = [], []
    udf = _paired(port, instances)
    port_run([udf], ds, n)
    jax_run([_paired(libertem_tpu, jinstances)], jds, n)
    assert len(instances) == len(jinstances) == n
    assert len({id(i) for i in instances}) == n
    assert instances[0] is udf
    assert all(getattr(i, "cleaned", False) for i in instances)


def _host_aux(lib, weights):
    tiling = lib_tiling(lib)

    class HostAux(lib_base(lib)):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"scaled": self.buffer(kind="nav", dtype="float32")}

        def get_tiling_preferences(self):
            # several super-steps, so that the patch lands mid-run
            return {"depth": 4, "total_size": tiling.TILE_SIZE_MAX}

        def process_frame(self, frame):
            self.results.scaled = frame.sum() * self.params.weights

    return HostAux(weights=HostAux.aux_data(weights, kind="nav",
                                             dtype="float32"))


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_host_udf_aux_patch_mid_run(n):
    """An aux patch after the first partial reaches the host engine
    from the next super-step on: the same frames at weight 1 and 3 as
    in the JAX package."""
    data = data16()
    ds, jds = both_ds(data, parts=4)
    w1 = np.ones(256, dtype=np.float32)
    w2 = np.full(256, 3.0, dtype=np.float32)
    frame_sums = data.reshape(256, -1).sum(axis=1)
    ratios = []
    for lib, runner_cls, d, kw in (
            (port, UDFRunner, ds, dict(devices=[CPU] * n)),
            (libertem_tpu, JaxRunner, jds, dict(devices=jax.devices()[:n]))):
        udf = _host_aux(lib, w1)
        runner = runner_cls([udf])
        results = []
        for i, part in enumerate(runner.run_for_dataset_iter(d, **kw)):
            results.append(part)
            if i == 0:
                runner.update_parameters_experimental([{
                    "weights": type(udf).aux_data(w2, kind="nav",
                                                  dtype="float32")}])
        ratios.append(np.ravel(results[-1].buffers[0]["scaled"].data)
                      / frame_sums)
    ratio, jratio = ratios
    assert set(np.round(ratio.astype(np.float64), 3)) <= {1.0, 3.0}
    assert np.isclose(ratio, 3.0, rtol=1e-3).any()
    assert np.isclose(ratio, 1.0, rtol=1e-3).any()
    assert np.array_equal(np.round(ratio, 3), np.round(jratio, 3))


# -- counterparts of tests/test_matrix_sharded.py --------------------------


class ValidationUDF(port.udf.UDF):
    """The port's twin of ``tests/utils.py``'s ValidationUDF: on the
    host engine, each tile against the expected frames at its global
    offset."""

    def __init__(self, ref_flat, rtol=1e-6):
        super().__init__(ref_flat=ref_flat, rtol=rtol)

    def get_backends(self):
        return (self.BACKEND_NUMPY,)

    def get_result_buffers(self):
        return {"seen": self.buffer(kind="nav", dtype="float32")}

    def process_tile(self, tile):
        goff = int(self.meta.global_offset)
        expected = self.params.ref_flat[goff:goff + tile.shape[0]]
        assert expected.shape == tile.shape, (expected.shape, tile.shape)
        assert np.allclose(tile, expected.astype(tile.dtype),
                           rtol=self.params.rtol, atol=1e-4), (
            f"tile mismatch at offset {goff}")
        self.results.seen[:] = 1.0


def _contexts(n):
    return (port.Context(executor=ShardedJobExecutor(devices=[CPU] * n)),
            JaxContext(executor=JaxSharded(devices=jax.devices()[:n])))


@pytest.mark.parametrize("fmt", sorted(MAKERS))
def test_sharded_format_validation(built, fmt):  # noqa: F811
    """Every format's reader on n workers: each worker's blocks hold
    exactly the file's frames at their global offsets, shard tails
    included, as in the JAX package."""
    loader, kwargs, flat = built(fmt)
    for n in WORKERS:
        ctx, jctx = _contexts(n)
        res = ctx.run_udf(ctx.load(loader, **kwargs), ValidationUDF(
            ref_flat=flat.astype(np.float64), rtol=1e-6))
        jres = jctx.run_udf(jctx.load(loader, **kwargs), JaxValidationUDF(
            ref_flat=flat.astype(np.float64), rtol=1e-6))
        assert (res["seen"].raw_data == 1.0).all(), f"{fmt}: unvalidated"
        assert (jres["seen"].raw_data == 1.0).all()


@pytest.mark.parametrize("fmt", ["raw", "mib", "hdf5"])
def test_sharded_format_kitchen_sink(built, fmt):  # noqa: F811
    """A sync offset, a sparse roi and corrections at once, on n
    workers."""
    loader, kwargs, flat = built(fmt)
    kwargs = dict(kwargs, sync_offset=2)
    n_frames = len(flat)
    sig = flat.shape[1:]
    expected = np.zeros_like(flat, dtype=np.float64)
    expected[:n_frames - 2] = flat[2:]
    roi = np.zeros(n_frames, dtype=bool)
    roi[[1, n_frames // 2, n_frames - 2]] = True
    rng = np.random.default_rng(4)
    dark = rng.normal(2.0, 0.5, sig).astype(np.float32)
    gain = (1 + 0.1 * rng.random(sig)).astype(np.float32)
    expected = (expected[roi] - dark) * gain
    for n in WORKERS:
        ctx, jctx = _contexts(n)
        res = ctx.run_udf(
            ctx.load(loader, **kwargs),
            ValidationUDF(ref_flat=expected, rtol=1e-4), roi=roi,
            corrections=port.CorrectionSet(dark=dark, gain=gain))
        jres = jctx.run_udf(
            jctx.load(loader, **kwargs),
            JaxValidationUDF(ref_flat=expected, rtol=1e-4), roi=roi,
            corrections=JaxCorrectionSet(dark=dark, gain=gain))
        assert (res["seen"].raw_data == 1.0).all(), fmt
        assert (jres["seen"].raw_data == 1.0).all(), fmt


# -- block-cyclic host merges: merge_partition(runs=) ----------------------


def _host_scaled(lib):
    class HostScaled(lib_base(lib)):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"x": self.buffer(kind="nav", dtype="float32"),
                    "total": self.buffer(kind="single", dtype="float64",
                                         extra_shape=(1,))}

        def process_tile(self, tile):
            s = tile.reshape(tile.shape[0], -1).sum(axis=1)
            self.results.x[:] += 2.0 * s
            self.results.total[:] += s.sum()

        def merge(self, dest, src):
            dest.x[:] = src.x
            dest.total[:] += src.total

    return HostScaled()


def test_sharded_live_host_custom_merge():
    """A numpy UDF with a custom merge on a live ring over 2 workers:
    each block-cyclic shard's nav rows reach merge as the
    concatenation of its runs, written back run by run; the result is
    the single-device run's and the JAX package's."""
    data = _mk_random((6, 6, 8, 8), dtype="float32")
    flat = data.reshape(-1, 8, 8)
    outs = []
    for lib, runner_cls, kw in (
            (port, UDFRunner, dict(devices=[CPU] * 2)),
            (port, UDFRunner, dict(device=CPU)),
            (libertem_tpu, JaxRunner, dict(devices=jax.devices()[:2]))):
        ds = _live(lib, data, ring=64, parts=2)
        ds.push_frames(flat)
        ds.finish()
        outs.append(runner_cls([_host_scaled(lib)]).run_for_dataset(ds, **kw))
    res, single, jres = outs
    check(res, jres, single, [{"x": "nav", "total": "sig"}])
    close(np.ravel(res.buffers[0]["x"].data), 2.0 * flat.sum(axis=(1, 2)),
          1e-5)


def test_merge_partition_runs():
    """``merge_partition(runs=)`` of the host engine: a custom merge
    sees the runs' nav rows (and aux rows) concatenated, dest written
    back run by run; sig/single buffers merge once."""
    from libertem_tpu_torch.udf.host import HostUDFRunner

    seen = {}

    class Custom(port.udf.UDF):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"x": self.buffer(kind="nav", dtype="float32"),
                    "s": self.buffer(kind="single", dtype="float64")}

        def process_tile(self, tile):
            pass

        def merge(self, dest, src):
            seen["src_x"] = np.array(src.x)
            seen["aux"] = np.array(self.params.w)
            dest.x[:] = src.x + 100
            dest.s[:] += src.s

    data = np.zeros((10, 4, 4), np.float32)
    ds = MemoryDataSet(data=data, sig_dims=2).initialize()
    udf = Custom(w=Custom.aux_data(np.arange(10, dtype=np.float32),
                                   kind="nav", dtype="float32"))
    runner = UDFRunner([udf])
    prep = runner._prepare(ds, CPU)
    host = HostUDFRunner([(0, prep["plan"][0])], prep)
    glob = host.init_global()
    glob[0]["x"][:] = np.arange(10)
    part = host.init_partition()
    part[0]["s"][...] = 5.0
    runs = [(0, 2), (4, 2), (8, 2)]
    host.merge_partition(glob, part, runs=runs)
    assert np.array_equal(seen["src_x"], [0, 1, 4, 5, 8, 9])
    assert np.array_equal(seen["aux"], [0, 1, 4, 5, 8, 9])
    assert np.array_equal(glob[0]["x"], [100, 101, 2, 3, 104, 105, 6, 7,
                                         108, 109])
    assert np.ravel(glob[0]["s"])[0] == 5.0
    with pytest.raises(ValueError, match="not both"):
        host.merge_partition(glob, part, 0, 2, runs=runs)


def test_workers_stress():
    """Eight workers (more than this host's cores), a thread switch
    every few microseconds and blocks of 4 frames: every worker's slots
    and counts stay consistent (integer sums exact, each block counted
    once, every frame read once) and no reader thread outlives the
    run."""
    import sys

    from test_torch_sharded import threads_end

    data = np.random.default_rng(21).poisson(5.0, (20, 16, 8, 8)).astype(
        np.uint16)
    reads = []
    lock = threading.Lock()

    class Counted(MemoryDataSet):
        def get_partitions(self):
            for p in super().get_partitions():
                orig = p.read_frames_into

                def counted(s, e, out, _orig=orig):
                    with lock:
                        reads.extend(range(s, e))
                    return _orig(s, e, out)

                p.read_frames_into = counted
                yield p

    class SmallBlocks(port.SumUDF):
        def get_tiling_preferences(self):
            return {"depth": 4, "total_size": lib_tiling(port).TILE_SIZE_MAX}

    ds = Counted(data=data, sig_dims=2, num_partitions=6).initialize()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runner = UDFRunner([SmallBlocks(), port.SumSigUDF()])
        last = None
        for last in runner.run_for_dataset_iter(ds, devices=[CPU] * 8):
            pass
    finally:
        sys.setswitchinterval(old)
    assert np.array_equal(last.buffers[0]["intensity"].data,
                          data.sum(axis=(0, 1)).astype(np.float32))
    assert np.array_equal(last.buffers[1]["intensity"].data,
                          data.sum(axis=(2, 3)).astype(np.float32))
    blocks = [w["blocks"] for w in runner.feed_stats["workers"]]
    assert blocks == [10] * 8 and runner.feed_stats["blocks"] == 80
    assert sorted(reads) == list(range(320))
    assert threads_end()


def _hooked_udfs():
    class Halved(port.udf.UDF):
        """preprocess sets the scale process_tile uses; postprocess
        doubles the shard's rows and sums back (device engine)."""

        def get_backends(self):
            return (self.BACKEND_TORCH,)

        def get_result_buffers(self):
            return {"rows": self.buffer(kind="nav", dtype="float32"),
                    "total": self.buffer(kind="sig", dtype="float32")}

        def preprocess(self):
            self._scale = 0.5

        def process_tile(self, tile):
            self.results.rows += tile.sum(dim=(1, 2)) * self._scale
            self.results.total += tile.sum(dim=0) * self._scale

        def postprocess(self):
            self.results.rows[:] *= 2
            self.results.total[:] *= 2

        def merge(self, dest, src):
            dest.total = dest.total + src.total

    class Seeded(port.udf.UDF):
        """A numpy UDF whose preprocess seeds its nav rows and whose
        postprocess adds to them, on the views of its shard."""

        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"rows": self.buffer(kind="nav", dtype="float32")}

        def preprocess(self):
            self.results.rows[:] = 1.0

        def process_tile(self, tile):
            self.results.rows[:] += tile.sum(axis=(1, 2))

        def postprocess(self):
            self.results.rows[:] += 10.0

    return [Halved(), Seeded()]


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_hooks_see_shard_views(n):
    """Each shard's preprocess and postprocess see its own rows, as a
    partition's do in the single-device loop (the JAX package's
    sharded loop binds no buffers there): the device UDF's doubled
    rows and sums and the numpy UDF's seeded rows come out as in the
    single-device run, over contiguous shards and over a live ring's
    block-cyclic ones."""
    data = np.random.default_rng(2).poisson(4.0, (12, 8, 8, 8)).astype(
        np.float32)
    flat = data.reshape(-1, 8, 8)
    ds, _ = both_ds(data, parts=4)
    single = port_single(_hooked_udfs(), ds)
    for d in (ds, "live"):
        if d == "live":
            d = _live(port, data, ring=128, parts=2)
            d.push_frames(flat)
            d.finish()
        res = port_run(_hooked_udfs(), d, n)
        for ui, name in ((0, "rows"), (0, "total"), (1, "rows")):
            close(res.buffers[ui][name].data, single.buffers[ui][name].data)
    close(np.ravel(single.buffers[1]["rows"].data),
          flat.sum(axis=(1, 2)) + 11.0)
    close(np.ravel(single.buffers[0]["rows"].data), flat.sum(axis=(1, 2)))


def test_sharded_live_fewer_frames_than_workers():
    """A live ring of 4 frames on 4 workers: block-cyclic shards of
    which some are empty still run their hooks and merges, and the
    results are the single-device run's."""
    data = np.random.default_rng(4).poisson(4.0, (2, 2, 8, 8)).astype(
        np.float32)
    runs = []
    for kw in (dict(devices=[CPU] * 4), dict(device=CPU)):
        ds = _live(port, data, ring=64, parts=2)
        ds.push_frames(data.reshape(-1, 8, 8))
        ds.finish()
        runs.append(UDFRunner(_hooked_udfs() + [_host_scaled(port)])
                    .run_for_dataset(ds, **kw))
    res, single = runs
    for ui, name in ((0, "rows"), (0, "total"), (1, "rows"), (2, "x"),
                     (2, "total")):
        close(res.buffers[ui][name].data, single.buffers[ui][name].data)
    assert res.damage.data.all()


@pytest.mark.parametrize("n", WORKERS)
def test_sharded_raw_csr_crosses_as_entries(tmp_path, n, monkeypatch):
    """Raw CSR over n workers, with and without a roi: every block the
    feeds push is sparse, its own entries (as in the single-device
    loop; a worker's block may span partitions), and the results equal
    the single-device run's and the JAX package's bit for bit."""
    from libertem_tpu_torch.udf import base as port_base
    from test_torch_formats3 import NAV as CSR_NAV, _write_csr

    pushed = []
    push = port_base.HostFeed.push

    def recording(self, slot, block):
        pushed.append((block.sparse is not None, block.nnz, block.valid))
        return push(self, slot, block)

    monkeypatch.setattr(port_base.HostFeed, "push", recording)
    path, dense = _write_csr(tmp_path)
    entries = np.diff(np.fromfile(tmp_path / "indptr.bin", "<i8"))
    flat_roi = np.random.default_rng(6).random(len(dense)) > 0.3

    def udfs(lib):
        return [lib.udf.SumUDF(), lib.udf.SumSigUDF()]

    for sel in (None, flat_roi):
        roi = None if sel is None else sel.reshape(CSR_NAV)
        ds = port.Context(device="cpu").load("raw_csr", path=path,
                                             num_partitions=3)
        jds = JaxContext().load("raw_csr", path=path, num_partitions=3)
        single = port_single(udfs(port), ds, roi=roi)
        pushed.clear()
        res = port_run(udfs(port), ds, n, roi=roi)
        frames = dense if sel is None else dense[sel]
        assert pushed and all(sparse for sparse, _, _ in pushed)
        assert sum(valid for _, _, valid in pushed) == len(frames)
        assert sum(nnz for _, nnz, _ in pushed) == (
            entries if sel is None else entries[sel]).sum()
        jres = jax_run(udfs(libertem_tpu), jds, n, roi=roi)
        for ui in (0, 1):
            got = np.asarray(res.buffers[ui]["intensity"].data)
            assert np.array_equal(
                got, single.buffers[ui]["intensity"].data, equal_nan=True)
            assert np.array_equal(
                got, np.asarray(jres.buffers[ui]["intensity"].data),
                equal_nan=True)
        assert np.array_equal(res.buffers[0]["intensity"].data.reshape(-1),
                              frames.sum(axis=0))
