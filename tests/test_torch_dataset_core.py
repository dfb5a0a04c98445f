"""The port's dataset core against the JAX package on the CPU: the sync
offset, the tile stream, the io backends, byte order, the raw and
memory datasets' arguments, the standalone corrections and the
partition helpers.

The same numpy-seeded data (nav up to 5x4, small sigs) goes through
``libertem_tpu_torch`` (``Context(device="cpu")``) and
``libertem_tpu``.  Tolerances: reads, tiles, corrections' plans and
helpers are bit-equal; UDF results (float32 sums in other orders)
within 1e-5 relative, with an absolute floor of 1e-5 of the buffer's
largest magnitude; the sync-offset golden as
``tests/test_parity_reference.py`` holds it (rtol 1e-4, atol 1e-2).
"""
import os
import warnings

import numpy as np
import pytest
import torch

import golden_common as gc
import libertem_tpu
import libertem_tpu.io.dataset.base as jbase
import libertem_tpu.io.tiling as jtiling
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.common.shape import Shape as JaxShape
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io import corrections as jcorr
from libertem_tpu.io.utils import get_partition_shape as j_partition_shape
from libertem_tpu.native import byteswap as j_byteswap
from libertem_tpu.udf import SumSigUDF as JSumSig, SumUDF as JSum

import libertem_tpu_torch as port
import libertem_tpu_torch.io.dataset.base as pbase
from libertem_tpu_torch.common.shape import Shape
from libertem_tpu_torch.io import corrections as pcorr
from libertem_tpu_torch.io.tiling import TilingScheme
from libertem_tpu_torch.io.utils import get_partition_shape
from libertem_tpu_torch.udf.base import UDFRunner

torch.set_num_threads(1)

RTOL = 1e-5
NAV, SIG = (5, 4), (8, 6)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _ctx():
    return port.Context(device="cpu")


def _jctx():
    return JaxContext(executor=InlineJobExecutor())


def _data(dtype=np.uint16, nav=NAV, sig=SIG, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1000, nav + sig).astype(dtype)


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    both_nan = np.isnan(got) & np.isnan(want)
    scale = max(float(np.nanmax(np.abs(want), initial=0.0)), 1.0)
    err = np.where(both_nan, 0.0, np.abs(got - want))
    assert np.all(err <= RTOL * np.abs(np.nan_to_num(want)) + RTOL * scale)


def _udfs(lib):
    h, w = SIG
    mask = lib.masks.circular(w / 2, h / 2, w, h, 3)
    return [lib.udf.SumUDF(), lib.udf.SumSigUDF(), lib.udf.StdDevUDF(),
            lib.udf.ApplyMasksUDF(mask_factories=[lambda: mask])]


def _compare(ours, theirs):
    for o, t in zip(ours, theirs):
        assert set(o) == set(t)
        for k in o:
            _close(o[k].data, t[k].data)


def _write(tmp_path, arr, name="d.raw"):
    path = str(tmp_path / name)
    arr.tofile(path)
    return path


def _load_both(kind, tmp_path, data, **kw):
    """The port's and the JAX package's dataset of ``data``: a raw file
    of its flat frames, or memory."""
    if kind == "raw":
        path = _write(tmp_path, data)
        args = dict(path=path, dtype=data.dtype, sig_shape=SIG, **kw)
        args.setdefault("nav_shape", NAV)
        return (_ctx().load("raw", **args), _jctx().load("raw", **args))
    args = dict(data=data, sig_dims=2, num_partitions=3, **kw)
    return (_ctx().load("memory", **args), _jctx().load("memory", **args))


# -- the sync offset ------------------------------------------------------

OFFSETS = [3, -3, 17, -17]


@pytest.mark.parametrize("kind", ["raw", "memory"])
@pytest.mark.parametrize("so", OFFSETS)
@pytest.mark.parametrize("with_roi", [False, True])
def test_sync_offset_runs(kind, so, with_roi, tmp_path):
    """Frames shifted by the offset, zeros where it runs past the data,
    through Sum, SumSig, StdDev and ApplyMasks (fused), with and without
    a roi."""
    data = _data()
    ds, jds = _load_both(kind, tmp_path, data, sync_offset=so)
    roi = None
    if with_roi:
        roi = np.random.default_rng(1).random(NAV) < 0.5
    ctx = _ctx()
    ours = ctx.run_udf(ds, _udfs(port), roi=roi)
    assert ctx.run_info["fused"]
    theirs = _jctx().run_udf(jds, _udfs(libertem_tpu),
                             roi=roi)
    _compare(ours, theirs)
    # the oracle: frame i is data frame i + so, zero outside the data
    flat = data.reshape(-1, *SIG).astype(np.float64)
    want = np.zeros_like(flat)
    n = len(flat)
    idx = np.arange(n) + so
    ok = (idx >= 0) & (idx < n)
    want[ok] = flat[idx[ok]]
    sel = np.ones(n, bool) if roi is None else roi.reshape(-1)
    _close(ours[0]["intensity"].data, want[sel].sum(0))


@pytest.mark.parametrize("kind", ["raw", "memory"])
def test_nav_beyond_the_file(kind, tmp_path):
    """A nav of more frames than the data holds, under an offset: the
    missing frames read as zeros, as in the JAX package."""
    data = _data(nav=(16,))
    if kind == "raw":
        path = _write(tmp_path, data)
        args = dict(path=path, dtype=data.dtype, sig_shape=SIG,
                    nav_shape=NAV, sync_offset=-2)
        ds, jds = _ctx().load("raw", **args), _jctx().load("raw", **args)
    else:
        args = dict(data=data, sig_dims=2, nav_shape=NAV, sync_offset=-2,
                    num_partitions=2)
        ds = _ctx().load("memory", **args)
        jds = _jctx().load("memory", **args)
    ours = _ctx().run_udf(ds, _udfs(port))
    theirs = _jctx().run_udf(jds, _udfs(libertem_tpu))
    _compare(ours, theirs)


@pytest.mark.parametrize("so", [20, -20, 25])
def test_sync_offset_out_of_range(so):
    """An offset at or past the frame count raises, on both sides."""
    data = _data()
    with pytest.raises(pbase.DataSetException) as ours:
        _ctx().load("memory", data=data, sig_dims=2, sync_offset=so)
    with pytest.raises(jbase.DataSetException) as theirs:
        _jctx().load("memory", data=data, sig_dims=2, sync_offset=so)
    assert str(ours.value) == str(theirs.value)


def test_sync_offset_golden(tmp_path):
    """``tests/goldens/sync_offset.npz`` as
    ``tests/test_parity_reference.py`` holds it."""
    g = np.load(os.path.join(GOLDEN_DIR, "sync_offset.npz"))
    path = str(tmp_path / "sync.raw")
    gc.golden_data().astype(np.float32).tofile(path)
    for name, off in (("pos", 3), ("neg", -3)):
        ds = _ctx().load("raw", path=path, dtype="float32",
                         nav_shape=gc.NAV, sig_shape=gc.SIG,
                         sync_offset=off)
        res = _ctx().run_udf(ds, [port.SumUDF(), port.SumSigUDF()])
        assert np.allclose(res[0]["intensity"].data, g[f"sum_{name}"],
                           rtol=1e-4, atol=1e-2), name
        got = np.nan_to_num(res[1]["intensity"].data)
        want = np.nan_to_num(g[f"sumsig_{name}"])
        assert np.allclose(got, want, rtol=1e-4, atol=1e-2), name


@pytest.mark.parametrize("so,n_frames", [
    (so, n) for n in (20, 14, 26) for so in (0, 3, -3, 13, -13, 19, -19)
    if -n < so < n
])
def test_sync_offset_info(so, n_frames, tmp_path):
    """Skipped, ignored and inserted frame counts, and the diagnostics
    rows, equal to the JAX package's, for files shorter and longer
    than nav."""
    data = _data(nav=(n_frames,))
    path = _write(tmp_path, data)
    args = dict(path=path, dtype="uint16", nav_shape=NAV, sig_shape=SIG,
                sync_offset=so)
    ds, jds = _ctx().load("raw", **args), _jctx().load("raw", **args)
    assert ds.get_sync_offset_info() == jds.get_sync_offset_info()
    assert ds.diagnostics == jds.diagnostics


# -- tiles ------------------------------------------------------------------


def _schemes(ds, jds, tileshape):
    ours = TilingScheme.make_for_shape(
        Shape(tileshape, sig_dims=2), ds.shape)
    theirs = jtiling.TilingScheme.make_for_shape(
        JaxShape(tileshape, sig_dims=2), jds.shape)
    return ours, theirs


@pytest.mark.parametrize("kind", ["raw", "memory"])
@pytest.mark.parametrize("so", [0, 3, -3, 7])
@pytest.mark.parametrize("tileshape", [(3, 8, 6), (4, 4, 3)])
@pytest.mark.parametrize("with_roi", [False, True])
def test_get_tiles_stream(kind, so, tileshape, with_roi, tmp_path):
    """Every partition's tile stream: the same origins, shapes, scheme
    indices and data as the JAX package's (blank frames of the offset
    left out without a roi; roi-compressed origins with one)."""
    data = _data()
    ds, jds = _load_both(kind, tmp_path, data, sync_offset=so)
    scheme, jscheme = _schemes(ds, jds, tileshape)
    roi = None
    if with_roi:
        roi = np.random.default_rng(2).random(NAV) < 0.6
    n = 0
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        assert p.get_ident() == jp.get_ident()
        assert tuple(p.slice.origin) == tuple(jp.slice.origin)
        assert tuple(p.shape) == tuple(jp.shape)
        assert p._get_read_ranges(scheme, roi) == \
            jp._get_read_ranges(jscheme, roi)
        ours = list(p.get_tiles(scheme, roi=roi, dest_dtype=np.float32))
        theirs = list(jp.get_tiles(jscheme, roi=roi,
                                   dest_dtype=np.float32))
        assert len(ours) == len(theirs)
        for t, jt in zip(ours, theirs):
            assert tuple(t.tile_slice.origin) == tuple(jt.tile_slice.origin)
            assert t.shape == jt.shape and t.scheme_idx == jt.scheme_idx
            assert t.dtype == jt.dtype == np.float32
            assert np.array_equal(t.data, jt.data)
            assert np.array_equal(t.flat_data, jt.flat_data)
            n += 1
    assert n > 0


@pytest.mark.parametrize("so", [0, -3, 4])
@pytest.mark.parametrize("with_roi", [False, True])
def test_get_macrotile(so, with_roi, tmp_path):
    data = _data()
    ds, jds = _load_both("raw", tmp_path, data, sync_offset=so)
    roi = np.random.default_rng(3).random(NAV) < 0.5 if with_roi else None
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        t = p.get_macrotile(roi=roi)
        jt = jp.get_macrotile(roi=roi)
        assert tuple(t.tile_slice.origin) == tuple(jt.tile_slice.origin)
        assert t.shape == jt.shape
        assert np.array_equal(t.data, jt.data)


def test_make_slices_and_slices():
    shape = Shape(NAV + SIG, sig_dims=2)
    jshape = JaxShape(NAV + SIG, sig_dims=2)
    for n, so in ((3, 0), (4, 2), (30, -1)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ours = list(pbase.Partition.make_slices(shape, n, so))
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            theirs = list(jbase.Partition.make_slices(jshape, n, so))
        assert [str(x.message) for x in w] == [str(x.message) for x in jw]
        assert [(tuple(s.origin), tuple(s.shape), a, b)
                for s, a, b in ours] == [
            (tuple(s.origin), tuple(s.shape), a, b) for s, a, b in theirs]
    data = _data()
    ds = _ctx().load("memory", data=data, sig_dims=2, num_partitions=3)
    jds = _jctx().load("memory", data=data, sig_dims=2, num_partitions=3)
    assert [(tuple(s.origin), tuple(s.shape)) for s in ds.get_slices()] == [
        (tuple(s.origin), tuple(s.shape)) for s in jds.get_slices()]


def test_roi_helper():
    data = _data()
    ds = _ctx().load("memory", data=data, sig_dims=2)
    jds = _jctx().load("memory", data=data, sig_dims=2)
    for k in (np.s_[1:3], np.s_[:, 2], (4, 3), np.s_[::2, 1:]):
        assert np.array_equal(ds.roi[k], jds.roi[k])
    res = _ctx().run_udf(ds, port.SumUDF(), roi=ds.roi[1:3])
    _close(res["intensity"].data, data[1:3].sum((0, 1)))


# -- io backends and byte order ---------------------------------------------


def _backend(lib_base, name):
    return None if name is None else lib_base.IOBackend.from_json(
        {"id": name})


@pytest.mark.parametrize("backend", [None, "buffered", "mmap", "direct"])
@pytest.mark.parametrize("sig", [(8, 6), (33,), (64, 64)])
def test_io_backends_bit_equal(backend, sig, tmp_path):
    """Every backend reads the same bytes as the JAX package's reader
    (1-D sigs of 33 pixels give unaligned runs, which O_DIRECT reads
    through its bounce buffer)."""
    data = _data(nav=NAV, sig=sig)
    path = _write(tmp_path, data)
    args = dict(path=path, dtype="uint16", nav_shape=NAV, sig_shape=sig,
                sync_offset=-1)
    ds = _ctx().load("raw", io_backend=_backend(pbase, backend), **args)
    jds = _jctx().load("raw", io_backend=_backend(jbase, backend), **args)
    roi = np.random.default_rng(4).random(NAV) < 0.5
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        assert p._reader.strategy == (backend or "buffered")
        ids = p.local_frame_ids(roi)
        assert np.array_equal(p._read_selected_with_offset(ids),
                              jp._read_selected_with_offset(ids))
        assert np.array_equal(
            p.read_dataset_frames(p.start_frame,
                                  p.start_frame + p.num_frames),
            jp.read_dataset_frames(jp.start_frame,
                                   jp.start_frame + jp.num_frames))
        if backend == "direct":
            assert p._reader.direct_opened in (True, False)
    res = _ctx().run_udf(ds, port.SumUDF(), roi=roi)
    jres = _jctx().run_udf(jds, JSum(), roi=roi)
    _close(res["intensity"].data, jres["intensity"].data)


@pytest.mark.parametrize("start,nbytes", [(0, 4096), (1, 100), (4095, 2),
                                         (3000, 9000), (0, 12000)])
@pytest.mark.parametrize("backend", ["buffered", "mmap", "direct"])
def test_range_reader(start, nbytes, backend, tmp_path):
    """Byte ranges of any alignment, up to the end of the file, and the
    short read past it."""
    blob = np.random.default_rng(5).integers(0, 256, 12000).astype(np.uint8)
    path = _write(tmp_path, blob)
    reader = pbase.RangeReader(path, _backend(pbase, backend))
    assert np.array_equal(reader.read(start, nbytes),
                          blob[start:start + nbytes])
    with pytest.raises(IOError):
        reader.read(11000, 2000)
    reader.close()


def test_direct_reader_aligned_into_destination(tmp_path):
    """An aligned range with an aligned destination: straight into it;
    O_DIRECT's open result is recorded either way."""
    blob = np.random.default_rng(6).integers(0, 256, 3 * 4096).astype(
        np.uint8)
    path = _write(tmp_path, blob)
    reader = pbase.RangeReader(path, pbase.DirectBackend())
    assert reader.direct_opened is None
    buf = np.empty(2 * 4096 + 4096, np.uint8)
    shift = (-buf.ctypes.data) % 4096
    dest = buf[shift:shift + 2 * 4096]
    reader.read_into(4096, dest)
    assert np.array_equal(dest, blob[4096:3 * 4096])
    assert reader.direct_opened in (True, False)
    reader.close()


def test_unknown_backend_raises(tmp_path):
    path = _write(tmp_path, _data())

    class Fake(pbase.IOBackend):
        pass

    class JFake(jbase.IOBackend):
        pass

    args = dict(path=path, dtype="uint16", nav_shape=NAV, sig_shape=SIG)
    ds = _ctx().load("raw", io_backend=Fake(), **args)
    jds = _jctx().load("raw", io_backend=JFake(), **args)
    with pytest.raises(RuntimeError) as ours:
        list(ds.get_partitions())
    with pytest.raises(RuntimeError) as theirs:
        list(jds.get_partitions())
    assert str(ours.value).replace("Fake", "") == \
        str(theirs.value).replace("JFake", "")
    assert pbase.IOBackend.get_supported() == \
        jbase.IOBackend.get_supported()
    assert ds.get_supported_io_backends() == \
        jds.get_supported_io_backends()


@pytest.mark.parametrize("dtype", [">u2", ">f4", ">i4", "<u2", ">u1"])
@pytest.mark.parametrize("kind", ["raw", "memory"])
def test_byte_order(dtype, kind, tmp_path):
    """Data of either byte order reads as the JAX package reads it, in
    native order, through the fused and the generic path."""
    data = np.random.default_rng(7).integers(-500, 1000, NAV + SIG)
    if np.dtype(dtype).kind == "u":
        data = np.abs(data) % 200
    data = data.astype(dtype)
    ds, jds = _load_both(kind, tmp_path, data)
    assert ds.meta.native_dtype == np.dtype(dtype).newbyteorder("=")
    ours = _ctx().run_udf(ds, _udfs(port))
    theirs = _jctx().run_udf(jds, _udfs(libertem_tpu))
    _compare(ours, theirs)
    pick = _ctx().run_udf(ds, port.PickUDF(), roi=ds.roi[2, 1])
    want = data[2, 1].astype(np.dtype(dtype).newbyteorder("="))
    assert pick["intensity"].data.dtype.isnative
    assert np.array_equal(pick["intensity"].data[0], want)
    for p in ds.get_partitions():
        got = p.read_dataset_frames(p.start_frame, p.start_frame + 1)
        assert got.dtype.isnative
        assert np.array_equal(got[0], data.reshape(-1, *SIG)[
            p.start_frame])


@pytest.mark.parametrize("dtype", [">u2", ">f4", ">i4", "<f8", "u1"])
def test_byteswap(dtype):
    """The read boundary's swap: the bytes of data of ``dtype``, read
    into an array of the native dtype, swapped in place, equal the JAX
    package's ``byteswap``."""
    arr = np.arange(-7, 17).reshape(4, 6).astype(dtype)
    native = arr.dtype.newbyteorder("=")
    out = np.frombuffer(arr.tobytes(), dtype=native).reshape(4, 6).copy()
    pbase.byteswap(out, arr.dtype)
    theirs = j_byteswap(arr)
    assert out.dtype == theirs.dtype and out.dtype.isnative
    assert np.array_equal(out, theirs) and np.array_equal(out, arr)


# -- the raw dataset's arguments -----------------------------------------


@pytest.mark.parametrize("extra", [0, 5, 95])
def test_raw_nav_inferred(extra, tmp_path):
    """Without nav_shape the nav is 1-D, the file's whole frames;
    trailing bytes are cut off."""
    data = _data()
    path = str(tmp_path / "d.raw")
    with open(path, "wb") as f:
        f.write(data.tobytes() + b"\x07" * extra)
    ds = _ctx().load("raw", path=path, dtype="uint16", sig_shape=SIG)
    jds = _jctx().load("raw", path=path, dtype="uint16", sig_shape=SIG)
    assert tuple(ds.shape) == tuple(jds.shape) == (20,) + SIG
    assert ds.meta.image_count == jds.meta.image_count == 20
    res = _ctx().run_udf(ds, [port.SumUDF(), port.SumSigUDF()])
    jres = _jctx().run_udf(jds, [JSum(), JSumSig()])
    _compare(res, jres)
    assert np.array_equal(res[1]["intensity"].data,
                          data.reshape(20, -1).sum(1).astype(np.float32))


def test_raw_sig_too_large(tmp_path):
    path = _write(tmp_path, _data())
    args = dict(path=path, dtype="uint16", sig_shape=(100, 100))
    with pytest.raises(pbase.DataSetException) as ours:
        _ctx().load("raw", **args)
    with pytest.raises(jbase.DataSetException) as theirs:
        _jctx().load("raw", **args)
    assert str(ours.value) == str(theirs.value) == \
        "sig_shape must be less than size: 960"


def test_raw_missing_sig_shape(tmp_path):
    path = _write(tmp_path, _data())
    with pytest.raises(TypeError) as ours:
        _ctx().load("raw", path=path, dtype="uint16", nav_shape=NAV)
    with pytest.raises(TypeError) as theirs:
        _jctx().load("raw", path=path, dtype="uint16", nav_shape=NAV)
    assert str(ours.value) == str(theirs.value)


ALIASES = [
    dict(scan_size=NAV, sig_shape=SIG),
    dict(nav_shape=NAV, detector_size=SIG),
    dict(nav_shape=NAV, sig_shape=SIG, tileshape=(1, 8, 6)),
    dict(nav_shape=NAV, sig_shape=SIG, enable_direct=True),
    dict(nav_shape=NAV, detector_size_raw=SIG, crop_detector_to=SIG),
    dict(nav_shape=NAV, crop_detector_to=SIG),
]


@pytest.mark.parametrize("kw", ALIASES)
def test_raw_aliases_warn(kw, tmp_path):
    """The deprecated spellings: the same FutureWarnings, the same
    dataset and results."""
    data = _data()
    path = _write(tmp_path, data)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ds = _ctx().load("raw", path=path, dtype="uint16", **kw)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jds = _jctx().load("raw", path=path, dtype="uint16", **kw)
    msgs = [(x.category, str(x.message)) for x in w]
    assert msgs == [(x.category, str(x.message)) for x in jw
                    if x.category is FutureWarning]
    assert all(c is FutureWarning for c, _ in msgs) and msgs
    assert tuple(ds.shape) == tuple(jds.shape)
    if kw.get("enable_direct"):
        assert next(ds.get_partitions())._reader.strategy == "direct"
    res = _ctx().run_udf(ds, port.SumUDF())
    _close(res["intensity"].data, data.sum((0, 1)))


ALIAS_ERRORS = [
    dict(nav_shape=NAV, sig_shape=SIG, enable_direct=True,
         io_backend="direct"),
    dict(nav_shape=NAV, detector_size=SIG, crop_detector_to=SIG),
    dict(nav_shape=NAV, detector_size_raw=(8, 8), crop_detector_to=SIG),
]


@pytest.mark.parametrize("kw", ALIAS_ERRORS)
def test_raw_alias_errors(kw, tmp_path):
    path = _write(tmp_path, _data())
    ours_kw, theirs_kw = dict(kw), dict(kw)
    if "io_backend" in kw:
        ours_kw["io_backend"] = pbase.DirectBackend()
        theirs_kw["io_backend"] = jbase.DirectBackend()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError) as ours:
            _ctx().load("raw", path=path, dtype="uint16", **ours_kw)
        with pytest.raises(ValueError) as theirs:
            _jctx().load("raw", path=path, dtype="uint16", **theirs_kw)
    assert str(ours.value) == str(theirs.value)


def test_raw_metadata(tmp_path):
    path = _write(tmp_path, _data())
    args = dict(path=path, dtype=">u2", nav_shape=NAV, sig_shape=SIG,
                sync_offset=2)
    ds, jds = _ctx().load("raw", **args), _jctx().load("raw", **args)
    assert ds.get_diagnostics() == jds.get_diagnostics()
    assert ds.get_cache_key() == jds.get_cache_key()
    assert ds.check_valid() and jds.check_valid()
    assert ds.get_supported_extensions() == jds.get_supported_extensions()
    assert ds.supports_correction() == jds.supports_correction()
    assert ds.get_max_io_size() == jds.get_max_io_size()
    assert not ds.get_correction_data().have_corrections()
    assert ds.dtype == ds.raw_dtype == jds.dtype == np.dtype(">u2")


# -- the memory dataset's arguments --------------------------------------


@pytest.mark.parametrize("tileshape", [(3, 8, 6), (2, 4, 6), (4, 8, 3)])
def test_memory_forced_tileshape(tileshape):
    """A forced tileshape tiles every run as given (the sig split
    included), as in the JAX package, and a frame UDF refuses a split."""
    data = _data().astype(np.float32)
    ds = _ctx().load("memory", data=data, sig_dims=2, tileshape=tileshape,
                     num_partitions=2)
    jds = _jctx().load("memory", data=data, sig_dims=2,
                       tileshape=tileshape, num_partitions=2)
    assert tuple(ds.tileshape) == tuple(jds.tileshape) == tileshape
    prep = UDFRunner([port.LogsumUDF(), port.SumUDF()])._prepare(
        ds, torch.device("cpu"))
    assert tuple(prep["scheme"].shape) == tileshape
    ours = _ctx().run_udf(ds, [port.LogsumUDF(), port.SumUDF()])
    theirs = _jctx().run_udf(jds, [libertem_tpu.udf.LogsumUDF(), JSum()])
    _compare(ours, theirs)

    class Frame(port.udf.UDF):
        def get_result_buffers(self):
            return {"s": self.buffer(kind="nav")}

        def process_frame(self, frame):
            self.results.s = frame.sum()

    if tuple(tileshape[1:]) != SIG:
        with pytest.raises(port.UDFException):
            _ctx().run_udf(ds, Frame())


def test_memory_datashape_and_delay():
    ds = _ctx().load("memory", datashape=NAV + SIG, tiledelay=0.001)
    jds = _jctx().load("memory", datashape=NAV + SIG, tiledelay=0.001)
    assert tuple(ds.shape) == tuple(jds.shape)
    assert ds.dtype == jds.dtype == np.float32
    assert ds.get_supported_io_backends() == \
        jds.get_supported_io_backends() == []
    res = _ctx().run_udf(ds, port.SumUDF())
    assert np.array_equal(res["intensity"].data, np.zeros(SIG, np.float32))
    with pytest.raises(pbase.DataSetException):
        _ctx().load("memory", sig_dims=2)


# -- corrections ---------------------------------------------------------------


def _excluded(sig, n, seed):
    return np.random.default_rng(seed).choice(
        int(np.prod(sig)), n, replace=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("inplace", [False, True])
def test_correct(seed, inplace):
    """The standalone correction: bit-equal to the JAX package's, with
    repair descriptors reused and the errors it raises."""
    rng = np.random.default_rng(seed)
    sig = (16, 12)
    data = rng.normal(100, 10, (3, 2) + sig).astype(np.float32)
    dark = rng.normal(5, 1, sig).astype(np.float32)
    gain = rng.uniform(0.9, 1.1, sig).astype(np.float32)
    flat = _excluded(sig, 6, seed)
    excluded = np.array(np.unravel_index(flat, sig))
    ours = pcorr.correct(data.copy(), dark, gain, excluded,
                         inplace=inplace, allow_empty=True)
    theirs = jcorr.correct(data.copy(), dark, gain, excluded,
                           inplace=inplace, allow_empty=True)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    desc = pcorr.RepairDescriptor(sig, excluded, allow_empty=True)
    jdesc = jcorr.RepairDescriptor(sig, excluded, allow_empty=True)
    for attr in ("exclude_flat", "repair_flat", "repair_counts"):
        assert np.array_equal(getattr(desc, attr), getattr(jdesc, attr))
    again = pcorr.correct(data.astype(np.uint16), dark, gain,
                          repair_descriptor=desc, allow_empty=True)
    assert np.array_equal(again, jcorr.correct(
        data.astype(np.uint16), dark, gain, repair_descriptor=jdesc,
        allow_empty=True))
    with pytest.raises(ValueError):
        pcorr.correct(data, dark, gain, excluded, repair_descriptor=desc,
                      allow_empty=True)
    with pytest.raises(TypeError):
        pcorr.correct(data.astype(np.uint16), dark, inplace=True)
    with pytest.raises(pcorr.CorrectError):
        pcorr.correct(np.asfortranarray(data.reshape(6, *sig)), dark,
                      inplace=True)
    with pytest.raises(ValueError):
        pcorr.correct(data)


def test_correct_empty_environment():
    """A pixel whose whole radius-1 ring is excluded: RepairValueError
    unless allow_empty, then left unrepaired, as in the JAX package."""
    sig = (6, 6)
    excluded = np.array([[0, 0, 1, 1], [0, 1, 0, 1]])
    data = np.arange(2 * 36, dtype=np.float32).reshape(2, *sig)
    with pytest.raises(pcorr.RepairValueError) as ours:
        pcorr.correct(data, sig_shape=sig, excluded_pixels=excluded)
    with pytest.raises(jcorr.RepairValueError) as theirs:
        jcorr.correct(data, sig_shape=sig, excluded_pixels=excluded)
    assert str(ours.value) == str(theirs.value)
    got = pcorr.correct(data, sig_shape=sig, excluded_pixels=excluded,
                        allow_empty=True)
    assert np.array_equal(got, jcorr.correct(
        data, sig_shape=sig, excluded_pixels=excluded, allow_empty=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_correct_dot_masks(seed):
    """Masks with the gain and the repair folded in: bit-equal to the
    JAX package's, and the corrected data's projections from the
    dark-subtracted raw data."""
    rng = np.random.default_rng(seed)
    sig = (16, 12)
    masks = rng.normal(size=(3,) + sig).astype(np.float32)
    dark = rng.normal(5, 1, sig).astype(np.float32)
    gain = rng.uniform(0.9, 1.1, sig).astype(np.float32)
    flat = _excluded(sig, 5, seed + 10)
    excluded = np.array(np.unravel_index(flat, sig))
    ours = pcorr.correct_dot_masks(masks, gain, excluded, allow_empty=True)
    theirs = jcorr.correct_dot_masks(masks, gain, excluded,
                                     allow_empty=True)
    assert np.array_equal(ours, theirs)
    data = rng.normal(100, 10, (4,) + sig)
    want = pcorr.correct(data, dark, gain, excluded, allow_empty=True
                         ).reshape(4, -1) @ masks.reshape(3, -1).T
    got = (data - dark).reshape(4, -1) @ ours.reshape(3, -1).T
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert np.array_equal(pcorr.correct_dot_masks(masks, gain),
                          jcorr.correct_dot_masks(masks, gain))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("tile,base", [((4, 12), (1, 1)), ((5, 5), (1, 4)),
                                       ((16, 3), (2, 1)), ((7, 1), (7, 1))])
def test_correction_set_adjust_tileshape(seed, tile, base):
    sig = (16, 12)
    flat = _excluded(sig, 4 + seed, seed)
    excluded = np.zeros(sig, bool)
    excluded.flat[flat] = True
    ours = pcorr.CorrectionSet(excluded_pixels=excluded, allow_empty=True)
    theirs = jcorr.CorrectionSet(excluded_pixels=excluded, allow_empty=True)
    assert ours.adjust_tileshape(tile, sig, base) == \
        theirs.adjust_tileshape(tile, sig, base)
    for excl, ext, b, t in (([3, 4, 7], 16, 2, 5), ([], 12, 3, 7),
                            ([1, 2, 3, 4, 5, 6], 8, 1, 3)):
        assert pcorr._conflict_free_multiple(np.array(excl), ext, b, t) == \
            jcorr._conflict_free_multiple(np.array(excl), ext, b, t)


# -- partition sizing -------------------------------------------------------


@pytest.mark.parametrize("shape,target,min_num,cores", [
    ((16, 16, 64, 64), 4096, 1, 1),
    ((16, 16, 64, 64), 4096 * 64, 4, 2),
    ((3, 7, 11, 8, 8), 1000, 2, 3),
    ((100, 32, 32), 50000, 1, 8),
    ((5, 4, 8, 6), 10 ** 9, 1, 4),
])
def test_get_partition_shape(shape, target, min_num, cores):
    ours = get_partition_shape(Shape(shape, sig_dims=2), target, min_num,
                               cores)
    theirs = j_partition_shape(JaxShape(shape, sig_dims=2), target,
                               min_num, cores)
    assert ours == theirs
