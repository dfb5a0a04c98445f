"""The public API that user UDFs touch, in the port against the JAX
package on the CPU: ``Shape``, ``Slice``, ``UDFMeta``, ``UDFData`` and
``UDFParams``, the result ``BufferWrapper``, and the names and the
``Context`` lifecycle of the JAX package's API.

Each test makes the same calls, or runs the same small user UDF, in
both packages on ``load("memory", data=...)`` (nav 4x4, sig 8x8,
seeded Poisson counts) and compares what comes out: shapes, slices,
masks and frame counts equal; float32 results within 1e-5 relative
(other summation orders), integer sums exact.
"""
import warnings

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.common.exceptions as jexceptions
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
import libertem_tpu.udf.base as jbase
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.common.shape import Shape as JShape
from libertem_tpu.common.slice import Slice as JSlice
from libertem_tpu.common.slice import SliceUsageError as JSliceUsageError
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.dataset.base import DataSet as JDataSet
from libertem_tpu.udf.stddev import run_stddev as jrun_stddev

import libertem_tpu_torch as port
import libertem_tpu_torch.common.exceptions as pexceptions
import libertem_tpu_torch.udf.base as pbase
from libertem_tpu_torch.common.shape import Shape
from libertem_tpu_torch.common.slice import Slice
from libertem_tpu_torch.io.dataset.base import DataSet

torch.set_num_threads(1)

RTOL = 1e-5
NAV, SIG = (4, 4), (8, 8)


def _data():
    return np.random.default_rng(11).poisson(5.0, NAV + SIG).astype(
        np.uint16)


def _both(data=None):
    """(port context, port dataset, JAX context, JAX dataset)."""
    data = _data() if data is None else data
    ctx = port.Context(device="cpu")
    jctx = JaxContext(executor=InlineJobExecutor())
    return (ctx, ctx.load("memory", data=data, sig_dims=2), jctx,
            jctx.load("memory", data=data, sig_dims=2))


def _roi():
    roi = np.zeros(NAV, bool)
    roi[1:3] = True
    roi[0, 3] = True
    return roi


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=RTOL, atol=RTOL, equal_nan=True)


# -- 1. Shape ------------------------------------------------------------------


def test_shape_api_like_jax():
    from libertem_tpu_torch.common.shape import NavOnlyShape, SigOnlyShape
    for shape, sig_dims in (((4, 5, 6, 7), 2), ((3, 8, 9), 2),
                            ((2, 3, 4, 5, 6), 3)):
        s, j = Shape(shape, sig_dims), JShape(shape, sig_dims)
        assert (s.nav_dims, s.sig_dims) == (j.nav_dims, j.sig_dims)
        assert tuple(s.flatten_nav()) == tuple(j.flatten_nav())
        assert s.flatten_nav().sig_dims == j.flatten_nav().sig_dims
        assert tuple(s.flatten_sig()) == tuple(j.flatten_sig())
        assert s.flatten_sig().sig_dims == j.flatten_sig().sig_dims
        assert len(s) == len(j) and len(s.sig) == len(j.sig)
        assert s[0] == j[0] and s[-1] == j[-1] and s[1:] == j[1:]
        for other in ((2,), (2, 3)):
            a, b = s + other, j + other
            assert tuple(a) == tuple(b) and a.sig_dims == b.sig_dims
            a, b = other + s, other + j
            assert tuple(a) == tuple(b) and a.sig_dims == b.sig_dims
    assert SigOnlyShape((8, 9)).sig_dims == 2
    assert NavOnlyShape((4, 5)).nav_dims == 2
    assert SigOnlyShape((8, 9)) == Shape((4, 8, 9), 2).sig


class ShapeReader:
    """The dataset shape as a UDF reads it, in one result: sig dims,
    nav dims, len of sig, the flat nav size, each frame's sum."""

    @staticmethod
    def make(lib):
        class ShapeUDF(lib.udf.UDF):
            def get_result_buffers(self):
                return {
                    "dims": self.buffer("single", (4,), "int64"),
                    "sums": self.buffer("nav", dtype="float32"),
                }

            def get_backends(self):
                return (self.BACKEND_NUMPY,)

            def process_frame(self, frame):
                shape = self.meta.dataset_shape
                self.results.dims[:] = (shape.sig_dims, shape.nav_dims,
                                        len(shape.sig),
                                        shape.flatten_nav()[0])
                self.results.sums[:] = frame.sum()

            def merge(self, dest, src):
                dest.dims[:] = src.dims

        return ShapeUDF()


def test_shape_in_a_user_udf():
    ctx, ds, jctx, jds = _both()
    res = ctx.run_udf(ds, ShapeReader.make(port))
    jres = jctx.run_udf(jds, ShapeReader.make(libertem_tpu))
    assert list(res["dims"].data) == list(jres["dims"].data) == [2, 2, 2, 16]
    _close(res["sums"].data, jres["sums"].data)


# -- 2. Slice ------------------------------------------------------------------


def _slice_pair(origin, shape, sig_dims):
    return (Slice(origin, Shape(shape, sig_dims)),
            JSlice(origin, JShape(shape, sig_dims)))


def _same(a, b):
    assert a.origin == b.origin and tuple(a.shape) == tuple(b.shape)
    assert a.shape.sig_dims == b.shape.sig_dims


def test_slice_api_like_jax():
    s, j = _slice_pair((2, 3, 0, 0), (2, 4, 8, 8), 2)
    _same(s.nav, j.nav)
    _same(s.sig, j.sig)
    _same(s.discard_nav(), j.discard_nav())
    o, jo = _slice_pair((3, 1, 2, 2), (4, 4, 4, 4), 2)
    _same(s.intersection_with(o), j.intersection_with(jo))
    far, jfar = _slice_pair((9, 9, 0, 0), (1, 1, 8, 8), 2)
    assert s.intersection_with(far).is_null()
    assert j.intersection_with(jfar).is_null()
    _same(s.shift(o), j.shift(jo))
    _same(s.shift_by((1, 1, 0, 0)), j.shift_by((1, 1, 0, 0)))
    _same(s.clip_to(Shape((3, 5, 8, 8), 2)), j.clip_to(JShape((3, 5, 8, 8), 2)))
    _same(s.flatten_nav(Shape((6, 7, 8, 8), 2)),
          j.flatten_nav(JShape((6, 7, 8, 8), 2)))
    _same(s.flatten_nav((6, 7, 8, 8)), j.flatten_nav((6, 7, 8, 8)))
    flat, jflat = _slice_pair((4, 0, 0), (6, 8, 8), 2)
    roi = np.random.default_rng(2).random(16) > 0.5
    _same(flat.adjust_for_roi(roi), jflat.adjust_for_roi(roi))
    assert flat.adjust_for_roi(None) is flat
    arr = np.arange(5 * 7 * 8 * 8).reshape(5, 7, 8, 8)
    for kw in ({}, {"sig_only": True}, {"nav_only": True}):
        assert s.get(**kw) == j.get(**kw)
        assert np.array_equal(s.get(arr, **kw), j.get(arr, **kw))
    assert [x.origin for x in flat.subslices((3, 4, 4))] == \
        [x.origin for x in jflat.subslices((3, 4, 4))]


def test_slice_misuse_raises_slice_usage_error():
    """Misuse raises SliceUsageError (a ValueError) where the JAX
    package does."""
    from libertem_tpu_torch.common.slice import SliceUsageError
    assert issubclass(SliceUsageError, ValueError)
    calls = [
        lambda S, Sh: S((0, 1), (2, 2)),
        lambda S, Sh: S((0, 1, 2), Sh((2, 2), 1)),
        lambda S, Sh: S((0, 0), Sh((2, 2), 1)).shift(
            S((0, 0, 0), Sh((1, 1, 1), 1))),
        lambda S, Sh: S((0, 0), Sh((2, 2), 1)).shift_by((1, 1, 1)),
        lambda S, Sh: S((0, 0), Sh((2, 2), 1)).intersection_with(
            S((0, 0), Sh((2, 2), 2))),
        lambda S, Sh: S((0, 0, 0), Sh((2, 2, 2), 1)).adjust_for_roi(
            np.ones(4, bool)),
        lambda S, Sh: list(S((0, 0), Sh((2, 2), 1)).subslices((1,))),
    ]
    for call in calls:
        with pytest.raises(SliceUsageError) as ours:
            call(Slice, Shape)
        with pytest.raises(JSliceUsageError) as theirs:
            call(JSlice, JShape)
        assert str(ours.value) == str(theirs.value)


class WeightedTiles:
    """A tile UDF that weights each tile with its part of a frame-shaped
    weight map, cut with ``meta.sig_slice.get(w, sig_only=True)``, and
    sums it over the frames and pixels."""

    @staticmethod
    def make(lib, w):
        class Weighted(lib.udf.UDF):
            def get_result_buffers(self):
                return {"total": self.buffer("nav", dtype="float32")}

            def get_tiling_preferences(self):
                # tiles of two frame rows, so the sig slices differ
                return {"depth": 4, "total_size": 2 * SIG[1] * 4}

            def process_tile(self, tile):
                cut = self.forbuf(
                    self.meta.sig_slice.get(self.params.w, sig_only=True),
                    tile)
                self.results.total = self.results.total + (
                    tile * cut).sum(axis=(1, 2))

        return Weighted(w=w)


def test_sig_slice_get_in_a_user_udf():
    ctx, ds, jctx, jds = _both()
    w = np.linspace(0.5, 2.0, SIG[0] * SIG[1]).reshape(SIG).astype(
        np.float32)
    res = ctx.run_udf(ds, WeightedTiles.make(port, w))
    jres = jctx.run_udf(jds, WeightedTiles.make(libertem_tpu, w))
    want = (_data().astype(np.float64) * w).sum(axis=(2, 3))
    _close(res["total"].data, want)
    _close(res["total"].data, jres["total"].data)


# -- 3. UDFMeta ----------------------------------------------------------------


class MetaRecorder:
    """A numpy UDF that records what ``self.meta`` shows: in
    get_task_data its slice, in process_partition its slice, partition
    slice and shape, and whether the run has corrections, and its
    device class."""

    @staticmethod
    def make(lib, seen):
        class Recorder(lib.udf.UDF):
            def get_result_buffers(self):
                return {"n": self.buffer("nav", dtype="float32")}

            def get_backends(self):
                return (self.BACKEND_NUMPY,)

            def get_task_data(self):
                m = self.meta.slice
                seen.append(("task", m.origin, tuple(m.shape)))
                return {}

            def process_partition(self, partition):
                m = self.meta
                seen.append(("part", m.slice.origin, tuple(m.slice.shape),
                             m.partition_slice.origin,
                             tuple(m.partition_shape)))
                seen.append(("run", m.corrections.have_corrections(),
                             m.device_class))
                self.results.n[:] = partition.sum(axis=(1, 2))

        return Recorder()


def test_meta_in_a_user_udf():
    ctx, ds, jctx, jds = _both()
    for roi in (None, _roi()):
        seen, jseen = [], []
        res = ctx.run_udf(ds, MetaRecorder.make(port, seen), roi=roi)
        jres = jctx.run_udf(jds, MetaRecorder.make(libertem_tpu, jseen),
                            roi=roi)
        assert seen == jseen
        n = 16 if roi is None else int(roi.sum())
        assert seen[0] == ("task", (0, 0, 0), (n,) + SIG)
        _close(res["n"].data, jres["n"].data)


def test_meta_fields_and_roi_setter():
    _, ds, _, _ = _both()
    roi = _roi()
    prep = pbase.UDFRunner([port.SumUDF()])._prepare(
        ds, torch.device("cpu"), roi=roi,
        corrections=port.CorrectionSet(dark=np.ones(SIG, np.float32)))
    meta = prep["meta"]
    assert meta.device_class == "cpu"
    assert meta.corrections.have_corrections()
    assert meta.threads_per_worker == 1
    jmeta = jbase.UDFMeta(JShape(NAV + SIG, 2), np.uint16, np.float32)
    for m in (meta, jmeta):
        m.roi = roi.reshape(-1)
        assert m.roi.shape == NAV and np.array_equal(m.roi, roi)
        m.roi = None
        assert m.roi is None
        # no concrete slice outside the host engine and get_task_data
        with pytest.raises(AttributeError, match="meta.slice"):
            m.slice
        with pytest.raises(AttributeError, match="partition_slice"):
            m.partition_shape


class SliceOnDevice:
    """A UDF with default backends whose process_tile reads meta.slice:
    both packages cannot run it on the device engine (no concrete slice
    there), warn, and run it on the host engine."""

    @staticmethod
    def make(lib):
        class FromSlice(lib.udf.UDF):
            def get_result_buffers(self):
                return {"first": self.buffer("nav", dtype="float32")}

            def process_tile(self, tile):
                first = self.meta.slice.origin[0]
                self.results.first[:] = first + np.arange(tile.shape[0])

        return FromSlice()


def test_meta_slice_sends_a_udf_to_the_host_engine():
    ctx, ds, jctx, jds = _both()
    with pytest.warns(UserWarning, match="HOST engine"):
        res = ctx.run_udf(ds, SliceOnDevice.make(port))
    assert ctx.run_info["engines"] == ["host"]
    with pytest.warns(UserWarning):
        jres = jctx.run_udf(jds, SliceOnDevice.make(libertem_tpu))
    assert np.array_equal(res["first"].data, jres["first"].data)
    assert np.array_equal(res["first"].data.reshape(-1), np.arange(16))


# -- 4. UDFData and UDFParams -------------------------------------------------


class DictStyle:
    """A UDF that reads its buffers and arguments dict-style: a sig
    accumulator and a nav buffer through ``results["..."]``, ``in``,
    ``get``, ``keys`` and ``items``, ``params.items()``."""

    @staticmethod
    def make(lib):
        class Dicty(lib.udf.UDF):
            def get_result_buffers(self):
                return {
                    "acc": self.buffer("sig", dtype="float32"),
                    "per_frame": self.buffer("nav", dtype="float32"),
                }

            def process_tile(self, tile):
                scale = dict(self.params.items())["scale"]
                assert "acc" in self.results and "nope" not in self.results
                assert self.results.get("nope") is None
                assert sorted(self.results.keys()) == ["acc", "per_frame"]
                assert dict(self.results.items())["acc"] is not None
                assert set(self.results.as_dict()) == {"acc", "per_frame"}
                self.results["acc"] = self.results["acc"] + scale * tile.sum(
                    axis=0)
                self.results["per_frame"] = tile.sum(axis=(1, 2))

            def merge(self, dest, src):
                dest.acc = dest.acc + src.acc

        return Dicty(scale=2.0)


def test_dict_style_access_in_a_user_udf():
    ctx, ds, jctx, jds = _both()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        res = ctx.run_udf(ds, DictStyle.make(port))
        jres = jctx.run_udf(jds, DictStyle.make(libertem_tpu))
    assert ctx.run_info["engines"] == ["device"]
    for k in ("acc", "per_frame"):
        _close(res[k].data, jres[k].data)
    _close(res["acc"].data, 2.0 * _data().sum(axis=(0, 1)))


def test_udfdata_and_params_methods():
    for lib in (pbase, jbase):
        d = lib.UDFData({"x": np.arange(3.0), "y": None})
        with pytest.warns(FutureWarning, match="dict-style"):
            v = d["x"]
        assert np.array_equal(v.raw_data, np.arange(3.0))
        assert np.array_equal(v.data, np.arange(3.0))
        assert "x" in d and "z" not in d and d.get("z", 5) == 5
        assert list(d.keys()) == ["x", "y"]
        assert d.as_dict()["y"] is None and len(list(d.items())) == 2
        d["z"] = 1
        assert "z" in d._touched
        p = lib.UDFParams({"a": 1, "b": 2})
        assert dict(p.items()) == {"a": 1, "b": 2}
        assert p.get("c", 3) == 3
    p = pbase.UDFParams({"a": 1}, {"aux": np.zeros(2)})
    assert p["a"] == 1 and "a" in p and list(p.keys()) == ["a"]
    assert p.as_dict() == {"a": 1} and p["aux"].shape == (2,)


# -- 5. the result BufferWrapper ---------------------------------------------


def test_result_buffer_accessors_like_jax():
    ctx, ds, jctx, jds = _both()
    roi = _roi()
    for udfs in ([port.SumUDF(), port.SumSigUDF()],):
        res = ctx.run_udf(ds, udfs, roi=roi)
        jres = jctx.run_udf(jds, [libertem_tpu.udf.SumUDF(),
                                  libertem_tpu.udf.SumSigUDF()], roi=roi)
        for (b, jb) in ((res[0]["intensity"], jres[0]["intensity"]),
                        (res[1]["intensity"], jres[1]["intensity"])):
            m, jm = b.raw_masked_data, jb.raw_masked_data
            assert np.array_equal(np.ma.getmaskarray(m),
                                  np.ma.getmaskarray(jm))
            _close(m.data, jm.data)
            assert np.array_equal(b._valid_mask, jb._valid_mask)
            assert b.valid_slice_bounding == jb.valid_slice_bounding
            for axis in range(b.data.ndim):
                assert b.get_valid_slice_inner(axis) == \
                    jb.get_valid_slice_inner(axis)
            assert b.size == jb.size and b.where == jb.where
            assert np.array_equal(b.roi, jb.roi)
            vm = np.ones(int(roi.sum()), bool)
            vm[2] = False
            assert np.array_equal(
                b.make_default_mask(vm, ds.shape, roi.reshape(-1)),
                jb.make_default_mask(vm, jds.shape, roi.reshape(-1)))
    b = port.SumUDF.buffer("nav", (2,), "float32", where="device")
    jb = libertem_tpu.udf.SumUDF.buffer("nav", (2,), "float32",
                                        where="device")
    assert b.where == jb.where == "device"
    for buf in (b, jb):
        buf.replace_dtype(np.int16)
        assert buf.dtype == np.int16
        buf.set_shape_ds(ds.shape)
    assert b.size == jb.size == 32


# -- 6. names and lifecycle ---------------------------------------------------


def test_names_like_jax():
    for name in ("UDF", "BufferWrapper", "AuxBufferWrapper", "Shape",
                 "Slice", "ResultGenerator", "AnalysisResult",
                 "AnalysisResultSet", "__version__"):
        assert name in port.__all__ and hasattr(port, name)
        assert name in libertem_tpu.__all__
    assert port.__version__ == libertem_tpu.__version__
    assert port.BufferWrapper is pbase.BufferWrapper
    assert "guess_corrections" in port.udf.__all__
    for mixin in ("UDFFrameMixin", "UDFTileMixin", "UDFPartitionMixin",
                  "UDFPreprocessMixin", "UDFPostprocessMixin",
                  "UDFMergeAllMixin"):
        assert hasattr(pbase, mixin) and hasattr(jbase, mixin)
    assert issubclass(pexceptions.ExecutorSpecException, Exception)
    assert jexceptions.ExecutorSpecException.__name__ == \
        pexceptions.ExecutorSpecException.__name__
    assert DataSet.get_default_io_backend() in \
        DataSet.get_supported_io_backends()
    assert JDataSet.get_default_io_backend() in ("mmap", "buffered")


def _mixin_udf(lib):
    base = lib.udf.base

    class Mixed(base.UDFFrameMixin, base.UDFMergeAllMixin, lib.udf.UDF):
        def get_result_buffers(self):
            return {"s": self.buffer("sig", dtype="float32")}

        def process_frame(self, frame):
            self.results.s = self.results.s + frame * self.params.k

        def merge(self, dest, src):
            dest.s = dest.s + src.s

    return Mixed(k=3.0)


def test_mixins_copy_and_merge_all():
    ctx, ds, jctx, jds = _both()
    udf, judf = _mixin_udf(port), _mixin_udf(libertem_tpu)
    res = ctx.run_udf(ds, udf.copy())
    jres = jctx.run_udf(jds, judf.copy())
    _close(res["s"].data, jres["s"].data)
    assert udf.copy()._kwargs == {"k": 3.0}
    parts = [{"s": np.full(SIG, float(i), np.float32)} for i in range(3)]
    got = udf.merge_all([pbase.UDFData(p) for p in parts])
    want = judf.merge_all([jbase.UDFData(p) for p in parts])
    assert np.array_equal(got["s"], want["s"])
    assert np.array_equal(got["s"], np.full(SIG, 3.0))
    assert udf.merge_all([]) == {} == judf.merge_all([])


def test_run_stddev_like_jax():
    from libertem_tpu_torch.udf.stddev import run_stddev
    ctx, ds, jctx, jds = _both()
    got = run_stddev(ctx, ds, roi=_roi())
    want = jrun_stddev(jctx, jds, roi=_roi())
    assert set(got) == set(want)
    for k in got:
        _close(got[k], want[k])


def test_context_lifecycle():
    data = _data()
    with port.Context(device="cpu") as ctx:
        res = ctx.run_udf(ctx.load("memory", data=data, sig_dims=2),
                          port.SumUDF())
    with JaxContext(executor=InlineJobExecutor()) as jctx:
        jres = jctx.run_udf(jctx.load("memory", data=data, sig_dims=2),
                            libertem_tpu.udf.SumUDF())
    assert np.array_equal(res["intensity"].data, data.sum(axis=(0, 1)))
    _close(res["intensity"].data, jres["intensity"].data)
    ctx.close()
