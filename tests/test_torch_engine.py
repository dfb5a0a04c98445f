"""The port's engine layer against the JAX package's, on the CPU: the
lifecycle hooks (preprocess, postprocess, cleanup, on_params_updated),
the roi forms of ``Context.run_udf``, backends and the host engine
(numpy UDFs, UDFs the device engine cannot run, 64-bit requests), and
mixed passes of both engines over one read.

The same seeded numpy data goes through ``libertem_tpu_torch.Context(
device="cpu")`` and ``libertem_tpu.api.Context``.  Host-engine results
are numpy on both sides: equal bit for bit, or within 1e-12 relative
where the summation order differs; device results within rtol 1e-5
(float32 with other summation orders), with an absolute floor of 1e-5
of the buffer's largest magnitude.  The probe that sends UDFs to the
host engine runs on meta tensors, as it does on the card.
"""
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet
from libertem_tpu.udf.base import UDFRunner as JaxUDFRunner

import libertem_tpu_torch as port
from libertem_tpu_torch.common.exceptions import UDFException
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet
from libertem_tpu_torch.udf.base import HostFeed, UDFRunner

torch.set_num_threads(1)

RTOL = 1e-5
JUDF = libertem_tpu.udf.base.UDF
PUDF = port.udf.UDF


def _counts(shape=(6, 5, 16, 16), seed=0):
    return np.random.default_rng(seed).poisson(8.0, shape).astype(
        np.uint16)


def _floats(shape=(5, 6, 12, 12), seed=1):
    return np.random.default_rng(seed).normal(1.0, 3.0, shape).astype(
        np.float32)


def _jctx():
    return JaxContext(executor=InlineJobExecutor())


def _run_both(data, ours_udfs, theirs_udfs, num_partitions=2, **kw):
    ctx = port.Context(device="cpu")
    ours = ctx.run_udf(ctx.load("memory", data=data, sig_dims=2,
                                num_partitions=num_partitions),
                       ours_udfs, **kw)
    theirs = _jctx().run_udf(
        JaxMemoryDataSet(data=data, sig_dims=2,
                         num_partitions=num_partitions),
        theirs_udfs, **kw,
    )
    return ours, theirs


def _compare(ours, theirs, rtol=RTOL, exact=()):
    if isinstance(theirs, dict):
        ours, theirs = [ours], [theirs]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for name in b:
            x = np.asarray(a[name].data)
            y = np.asarray(b[name].data)
            assert x.shape == y.shape, name
            if name in exact:
                assert x.dtype == y.dtype, name
                assert np.array_equal(x, y, equal_nan=True), name
                continue
            scale = max(float(np.nanmax(np.abs(y), initial=0.0)), 1.0)
            np.testing.assert_allclose(x, y, rtol=rtol,
                                       atol=rtol * scale, err_msg=name)


# -- lifecycle hooks ----------------------------------------------------------

def _doubling(base):
    class DoublingUDF(base):
        """Adds each frame's sum, then postprocess doubles the
        partition's rows."""

        def get_result_buffers(self):
            return {"s": self.buffer(kind="nav", dtype="float32")}

        def process_tile(self, tile):
            self.results.s += tile.sum((1, 2))

        def postprocess(self):
            self.results.s[:] *= 2

    return DoublingUDF()


def test_postprocess_doubles_like_jax():
    """All-ones 8x8 frames, 4x4 nav, 4 partitions: 64 per frame,
    doubled by postprocess to 128 in both packages."""
    data = np.ones((4, 4, 8, 8), dtype=np.float32)
    ours, theirs = _run_both(data, _doubling(PUDF), _doubling(JUDF),
                             num_partitions=4)
    assert np.all(theirs["s"].data == 128)
    assert np.all(ours["s"].data == 128)


def _with_hooks(base, xp_sum, events):
    class HookUDF(base):
        """preprocess sets what process_tile uses (so the device engine
        is declared: a probe before preprocess would not find it);
        get_task_data and preprocess overridden, so cleanup runs per
        partition too."""

        def get_backends(self):
            return (getattr(self, "BACKEND_TORCH", "jax"),)

        def get_task_data(self):
            return {"n": len(self.meta.coordinates)}

        def get_result_buffers(self):
            return {
                "scaled": self.buffer(kind="sig", dtype="float32"),
                "rows": self.buffer(kind="nav", dtype="float32"),
            }

        def preprocess(self):
            events.append("pre")
            self._scale = 3.0

        def process_tile(self, tile):
            self.results.scaled += xp_sum(tile) * self._scale
            self.results.rows += self.task_data.n

        def postprocess(self):
            events.append("post")

        def merge(self, dest, src):
            dest.scaled = dest.scaled + src.scaled

        def cleanup(self):
            events.append("cleanup")

    return HookUDF()


def test_preprocess_and_cleanup_cadence_like_jax():
    data = _floats()
    ours_ev, theirs_ev = [], []
    ours, theirs = _run_both(
        data, _with_hooks(PUDF, lambda t: t.sum(dim=0), ours_ev),
        _with_hooks(JUDF, lambda t: t.sum(axis=0), theirs_ev),
        num_partitions=3,
    )
    _compare(ours, theirs)
    np.testing.assert_allclose(ours["scaled"].data,
                               3 * data.sum(axis=(0, 1)), rtol=1e-5)
    # task data per partition: each frame saw its partition's count
    assert sorted(set(ours["rows"].data.reshape(-1))) == [10.0]
    # cleanup once per partition, then once at the end
    assert ours_ev == theirs_ev
    assert ours_ev.count("cleanup") == 4
    assert ours_ev[-1] == "cleanup"
    assert ours_ev.count("pre") == ours_ev.count("post") == 3


def test_host_postprocess_views_and_cleanup():
    """On the host engine postprocess gets mutable numpy views."""
    def make(base):
        class HostDouble(base):
            def get_backends(self):
                return (self.BACKEND_NUMPY,)

            def get_result_buffers(self):
                return {"s": self.buffer(kind="nav", dtype="float64")}

            def process_frame(self, frame):
                self.results.s[:] = frame.sum()

            def postprocess(self):
                assert isinstance(self.results.s, np.ndarray)
                self.results.s[:] *= 2

        return HostDouble()

    data = _floats()
    ours, theirs = _run_both(data, make(PUDF), make(JUDF),
                             num_partitions=3)
    _compare(ours, theirs, exact=("s",))


def test_on_params_updated_on_new_sig_shape():
    calls = {PUDF: 0, JUDF: 0}

    def make(base, xp_sum):
        class Cached(base):
            def get_result_buffers(self):
                return {"s": self.buffer(kind="nav", dtype="float32")}

            def process_tile(self, tile):
                self.results.s += xp_sum(tile)

            def on_params_updated(self):
                calls[base] += 1

        return Cached()

    ours = make(PUDF, lambda t: t.sum(dim=(1, 2)))
    theirs = make(JUDF, lambda t: t.sum(axis=(1, 2)))
    for shape in ((3, 4, 8, 8), (3, 4, 8, 8), (3, 4, 6, 10)):
        data = _floats(shape)
        res, jres = _run_both(data, ours, theirs)
        _compare(res, jres)
    # the probe calls it once per run too; the sig change once more
    assert calls[PUDF] - 3 == calls[JUDF] - 3 == 1


# -- roi forms ------------------------------------------------------------------

class _Todense:
    def __init__(self, arr):
        self._arr = arr

    def todense(self):
        return self._arr


_NAV = (6, 5)
_ROI_BOOL = np.random.default_rng(7).random(_NAV) > 0.5

ROI_FORMS = {
    "bool nav": _ROI_BOOL,
    "bool flat": _ROI_BOOL.reshape(-1),
    "int ndarray": _ROI_BOOL.astype(np.int64),
    "scipy.sparse": sp.csr_matrix(_ROI_BOOL),
    "todense": _Todense(_ROI_BOOL),
    "coordinate": (2, 3),
    "pairs": [((0, 1), True), ((4, 2), True), ((5, 4), True)],
    "pairs inverse": [((0, 1), False), ((4, 2), False)],
    "coordinates": [(1, 1), (3, 0), (5, 4)],
    "empty": [],
}


@pytest.mark.parametrize("form", list(ROI_FORMS))
def test_roi_forms_like_jax(form):
    roi = ROI_FORMS[form]
    data = _counts(_NAV + (8, 8))
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=data, sig_dims=2)
    jctx = _jctx()
    jds = JaxMemoryDataSet(data=data, sig_dims=2)
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        ours = port.Context._normalize_roi(roi, ds)
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        theirs = jctx._normalize_roi(roi, jds)
    assert ours.dtype == np.bool_ and ours.shape == (30,)
    assert np.array_equal(ours, theirs)
    assert [str(w.message) for w in ours_w] == [
        str(w.message) for w in theirs_w
    ]
    if form == "int ndarray":
        assert "expected bool" in str(ours_w[0].message)
    if form == "empty":
        return
    res = ctx.run_udf(ds, port.SumUDF(), roi=roi)
    want = data.reshape(30, 8, 8)[ours].sum(axis=0, dtype=np.float64)
    assert np.array_equal(res["intensity"].data, want)


def test_roi_mixed_truth_values_raise():
    ds = port.Context(device="cpu").load("memory", data=_counts(),
                                         sig_dims=2)
    with pytest.raises(ValueError, match="truth value"):
        port.Context._normalize_roi([((0, 0), True), ((1, 1), False)], ds)


# -- backends and the host engine ------------------------------------------

def _numpy_sum(base):
    class NumpySumUDF(base):
        """In-place numpy mutation on the host engine."""

        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"intensity": self.buffer(kind="sig", dtype="float32")}

        def process_tile(self, tile):
            assert isinstance(tile, np.ndarray)
            assert self.xp is np
            self.results.intensity[:] += tile.sum(axis=0)

        def merge(self, dest, src):
            dest.intensity[:] += src.intensity

    return NumpySumUDF()


def _numpy_median(base):
    class NumpyMedianUDF(base):
        """Per-frame numpy with data-dependent control flow."""

        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {
                "median": self.buffer(kind="nav", dtype="float32"),
                "n_above": self.buffer(kind="nav", dtype="float32"),
            }

        def process_frame(self, frame):
            med = float(np.median(frame))
            self.results.median = med
            if med > 0:
                self.results.n_above = float((frame > med).sum())
            else:
                self.results.n_above = -1.0

    return NumpyMedianUDF()


def _numpy_partition(base):
    class NumpyPartitionUDF(base):
        def get_backends(self):
            return ("scipy.sparse.csr_matrix", self.BACKEND_NUMPY)

        def get_result_buffers(self):
            return {"nnz": self.buffer(kind="nav", dtype="int64"),
                    "frames": self.buffer(kind="single", dtype="int64")}

        def process_partition(self, partition):
            # scipy.sparse spelling first: a 2D csr block
            assert sp.issparse(partition)
            self.results.nnz[:] = np.diff(partition.indptr)
            self.results.frames[:] += partition.shape[0]

        def merge(self, dest, src):
            dest.frames[:] += src.frames

    return NumpyPartitionUDF()


@pytest.mark.parametrize("which", ["tile", "frame", "partition"])
def test_host_engine_like_jax(which):
    make = {"tile": _numpy_sum, "frame": _numpy_median,
            "partition": _numpy_partition}[which]
    data = _floats()
    if which == "partition":
        data = np.where(data > 2.0, data, 0).astype(np.float32)
    ours, theirs = _run_both(data, make(PUDF), make(JUDF),
                             num_partitions=3)
    names = tuple(theirs)
    _compare(ours, theirs, exact=names if which != "tile" else ())
    if which == "tile":
        np.testing.assert_allclose(ours["intensity"].data,
                                   data.sum(axis=(0, 1)), rtol=1e-5)


def test_host_tile_udfs_on_a_sig_split_scheme():
    """Beside a device UDF that asks for small tiles, host tile UDFs
    iterate the scheme's sig slices (sig buffers as contiguous copies
    of each slice, written back)."""
    from test_torch_generic import TiledSumUDF
    from test_udf_methods import TiledSumUDF as JaxTiledSumUDF

    data = _floats((5, 6, 16, 16))
    prep = UDFRunner([TiledSumUDF(), _numpy_sum(PUDF)])._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
    assert len(prep["scheme"]) == 2
    ours, theirs = _run_both(data, [TiledSumUDF(), _numpy_sum(PUDF)],
                             [JaxTiledSumUDF(), _numpy_sum(JUDF)])
    _compare(ours, theirs)
    np.testing.assert_allclose(ours[1]["intensity"].data,
                               data.sum(axis=(0, 1)), rtol=1e-5)


def test_mixed_pass_keeps_fusion():
    """A host UDF beside device UDFs: the device UDFs stay fused, the
    host UDF reads the same blocks."""
    data = _floats()
    udfs = [_numpy_sum(PUDF), port.SumUDF(), port.StdDevUDF()]
    prep = UDFRunner(udfs)._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
    assert [e.host for e in prep["plan"]] == [True, False, False]
    assert [s["ui"] for s in prep["fused"].specs] == [1, 2]
    jprep = JaxUDFRunner([_numpy_sum(JUDF), libertem_tpu.udf.SumUDF(),
                          libertem_tpu.udf.StdDevUDF()])._prepare(
        JaxMemoryDataSet(data=data, sig_dims=2), None, None, None)
    assert [s["ui"] for s in jprep["fused"]["specs"]] == [1, 2]
    ours, theirs = _run_both(
        data, [_numpy_sum(PUDF), _numpy_median(PUDF), port.SumUDF(),
               port.StdDevUDF()],
        [_numpy_sum(JUDF), _numpy_median(JUDF), libertem_tpu.udf.SumUDF(),
         libertem_tpu.udf.StdDevUDF()],
        num_partitions=3,
    )
    _compare(ours[1:2], theirs[1:2], exact=("median", "n_above"))
    _compare(ours, theirs, rtol=1e-4)


def _maxima(base, merge_nav):
    class FrameAndPixelMaxUDF(base):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"frame_max": self.buffer(kind="nav", dtype="float32"),
                    "pixel_max": self.buffer(kind="sig", dtype="float32")}

        def process_tile(self, tile):
            self.results.frame_max[:] = tile.max(axis=(1, 2))
            np.maximum(self.results.pixel_max, tile.max(axis=0),
                       out=self.results.pixel_max)

        def merge(self, dest, src):
            if merge_nav:
                dest.frame_max[:] = src.frame_max
            np.maximum(dest.pixel_max, src.pixel_max, out=dest.pixel_max)

    return FrameAndPixelMaxUDF()


@pytest.mark.parametrize("merge_nav", [True, False])
def test_custom_host_merge_gets_nav_rows_like_jax(merge_nav):
    """A custom merge on the host engine also gets the nav rows (dest:
    as before the partition, src: its results) and writes them: one
    that leaves them out leaves zeros, in both packages."""
    data = _counts()
    ours, theirs = _run_both(data, _maxima(PUDF, merge_nav),
                             _maxima(JUDF, merge_nav), num_partitions=3)
    _compare(ours, theirs, exact=("frame_max", "pixel_max"))
    want = data.max(axis=(2, 3)) if merge_nav else 0
    assert np.all(ours["frame_max"].data == want)
    assert np.array_equal(ours["pixel_max"].data, data.max(axis=(0, 1)))


def test_host_engine_with_roi_and_corrections():
    data = _counts()
    roi = np.random.default_rng(3).random(data.shape[:2]) > 0.4
    rng = np.random.default_rng(4)
    ex = np.zeros((16, 16), dtype=bool)
    ex.flat[rng.choice(256, 5, replace=False)] = True
    kw = dict(dark=rng.normal(1.0, 0.2, (16, 16)).astype(np.float32),
              gain=(1 + 0.1 * rng.random((16, 16))).astype(np.float32),
              excluded_pixels=ex)
    ctx = port.Context(device="cpu")
    ours = ctx.run_udf(
        ctx.load("memory", data=data, sig_dims=2, num_partitions=3),
        [_numpy_median(PUDF), port.SumUDF()], roi=roi,
        corrections=port.CorrectionSet(**kw),
    )
    from libertem_tpu.io.corrections import CorrectionSet as JaxCorr
    theirs = _jctx().run_udf(
        JaxMemoryDataSet(data=data, sig_dims=2, num_partitions=3),
        [_numpy_median(JUDF), libertem_tpu.udf.SumUDF()], roi=roi,
        corrections=JaxCorr(**kw),
    )
    _compare(ours[:1], theirs[:1], exact=("median", "n_above"))
    _compare(ours, theirs)
    assert np.all(np.isnan(ours[0]["median"].data[~roi]))


def test_backend_restriction_like_jax():
    def dual(base, xp_name):
        class DualBackendSumUDF(base):
            def get_backends(self):
                return (getattr(self, xp_name), self.BACKEND_NUMPY)

            def get_result_buffers(self):
                return {"intensity": self.buffer(kind="sig",
                                                 dtype="float32")}

            def process_tile(self, tile):
                self.results.intensity += tile.sum(0)

            def merge(self, dest, src):
                dest.intensity = dest.intensity + src.intensity

        return DualBackendSumUDF()

    data = _floats()
    for backends in (None, ("numpy",)):
        udf = dual(PUDF, "BACKEND_TORCH")
        prep = UDFRunner([udf], backends=backends)._prepare(
            MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
        assert prep["plan"][0].host is (backends is not None)
        ours, theirs = _run_both(data, dual(PUDF, "BACKEND_TORCH"),
                                 dual(JUDF, "BACKEND_JAX"),
                                 backends=backends)
        _compare(ours, theirs)
    ctx = port.Context(device="cpu")
    with pytest.raises(UDFException, match="restriction"):
        ctx.run_udf(ctx.load("memory", data=data, sig_dims=2),
                    _numpy_sum(PUDF), backends=("torch",))


def test_undeclared_numpy_udfs_go_to_host_with_warning():
    """No get_backends: the probe on meta tensors finds what the device
    engine cannot run -- np.asarray on a tile (which a CPU tensor would
    take, a CUDA tensor not), a numpy merge -- and sends those UDFs to
    the host engine with the JAX package's warning."""
    def as_numpy(base):
        class AsNumpyUDF(base):
            def get_result_buffers(self):
                return {"m": self.buffer(kind="nav", dtype="float32")}

            def process_tile(self, tile):
                self.results.m[:] = np.asarray(tile).max(axis=(1, 2))

        return AsNumpyUDF()

    def numpy_merge(base):
        class NumpyMergeUDF(base):
            def get_result_buffers(self):
                return {"mx": self.buffer(kind="sig", dtype="float32")}

            def process_tile(self, tile):
                xp = self.xp
                self.results.mx = xp.maximum(self.results.mx,
                                             xp.amax(tile, 0))

            def merge(self, dest, src):
                np.maximum(dest.mx, src.mx, out=dest.mx)

        return NumpyMergeUDF()

    data = _floats()
    ours_udfs = [as_numpy(PUDF), numpy_merge(PUDF), port.SumUDF()]
    with pytest.warns(UserWarning, match="HOST engine") as rec:
        prep = UDFRunner(ours_udfs)._prepare(
            MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
    assert [e.host for e in prep["plan"]] == [True, True, False]
    assert {str(w.message).split(" ")[0] for w in rec} == {
        "AsNumpyUDF.process_tile", "NumpyMergeUDF.merge"}
    with pytest.warns(UserWarning, match="HOST engine"):
        ours, theirs = _run_both(
            data, [as_numpy(PUDF), numpy_merge(PUDF),
                   port.SumUDF()],
            [as_numpy(JUDF), numpy_merge(JUDF),
             libertem_tpu.udf.SumUDF()],
        )
    _compare(ours, theirs, exact=("m", "mx"))


def _library_udfs():
    m = port.masks
    return [
        port.ApplyMasksUDF(mask_factories=[
            lambda: m.circular(8, 8, 16, 16, 4)]),
        port.ApplyMasksUDF(mask_factories=lambda: m.sparse_circular_multi_stack(
            np.arange(2), [4, 12], [4, 4], 16, 16, 2), mask_count=2),
        port.CoMUDF.with_params(cy=8, cx=8, r=6), port.SumUDF(),
        port.SumSigUDF(), port.StdDevUDF(), port.LogsumUDF(),
        port.FEMUDF(center=(8, 8), rad_in=2, rad_out=6),
        port.CrystallinityUDF(rad_in=1, rad_out=5, real_center=(8, 8),
                              real_rad=3),
        port.PickUDF(), port.NoOpUDF(),
    ]


def test_library_udfs_stay_on_device():
    """The probe passes every library UDF: none goes to the host
    engine, and no warning is given."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        prep = UDFRunner(_library_udfs())._prepare(
            MemoryDataSet(data=_counts(), sig_dims=2), torch.device("cpu"))
    assert not any(e.host for e in prep["plan"])


def test_explicit_64bit_runs_on_host_like_jax():
    """Explicit 64-bit requests run on the host engine, in float64 on
    both sides; implicit float64 factory output stays fused."""
    data = _floats((2, 3, 16, 16))

    def factory():
        return np.random.default_rng(5).random((16, 16))

    for kw in (dict(mask_dtype=np.float64), dict(dtype=np.float64)):
        udf = port.ApplyMasksUDF(mask_factories=[factory], **kw)
        assert udf.get_backends() == ("numpy",)
        ours, theirs = _run_both(
            data, port.ApplyMasksUDF(mask_factories=[factory], **kw),
            libertem_tpu.udf.ApplyMasksUDF(mask_factories=[factory], **kw),
        )
        assert ours["intensity"].data.dtype == np.float64
        _compare(ours, theirs, rtol=1e-12)
    prep = UDFRunner([port.ApplyMasksUDF(mask_factories=[factory])])._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
    assert prep["fused"] is not None and not prep["plan"][0].host


def test_all_host_run_keeps_64bit_input():
    """Every UDF on the host engine: the input stays float64."""
    data = _floats((3, 4, 8, 8)).astype(np.float64) * np.pi
    ours, theirs = _run_both(
        data, [port.ApplyMasksUDF(mask_factories=[lambda: np.ones((8, 8))]),
               _numpy_median(PUDF)],
        [libertem_tpu.udf.ApplyMasksUDF(
            mask_factories=[lambda: np.ones((8, 8))]),
         _numpy_median(JUDF)],
    )
    assert ours[0]["intensity"].data.dtype == np.float64
    _compare(ours, theirs, rtol=1e-12, exact=("median", "n_above"))
    np.testing.assert_allclose(ours[0]["intensity"].data[..., 0],
                               data.sum(axis=(2, 3)), rtol=1e-12)


def test_host_engine_with_every_slot_in_flight():
    """Blocks of 8 frames, a host UDF slower than the reader: the
    reader fills every one of the feed's slots ahead of the host
    engine (it waits for a free slot), and still no slot is refilled
    while the host engine reads it."""
    import time as time_

    class SlowCopyUDF(PUDF):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"frames": self.buffer(kind="nav", extra_shape=(8, 8),
                                          dtype="uint16")}

        def get_tiling_preferences(self):
            return {"depth": 8}

        def process_tile(self, tile):
            time_.sleep(0.01)
            self.results.frames[:] = tile
            time_.sleep(0.01)

    data = _counts((12, 8, 8, 8), seed=9)
    ctx = port.Context(device="cpu")
    res = ctx.run_udf(ctx.load("memory", data=data, sig_dims=2,
                               num_partitions=2),
                      [SlowCopyUDF(), port.SumUDF()])
    assert ctx.feed_stats["blocks"] == 12 > HostFeed.SLOTS
    assert ctx.feed_stats["slot_wait_s"] > 0
    assert ctx.feed_stats["host_s"] >= 12 * 0.02
    assert np.array_equal(res[0]["frames"].data, data)
    assert np.array_equal(res[1]["intensity"].data,
                          data.sum(axis=(0, 1), dtype=np.float64))
