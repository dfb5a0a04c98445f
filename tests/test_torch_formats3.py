"""The port's last dataset formats against the JAX package on the CPU:
raw CSR (sparse frames, densified by the host feed), a live
acquisition (``LiveDataSet``, a producer thread pushing frames while
the run reads them), any array-like (``load("dask", ...)``) and HDF5,
with the tiling's cap by ``DataSet.get_max_io_size`` and NPY's file
table.

Data: seeded numpy counts, nav 6x8 (1-D 48 or 12x4 where said), sig
16x16.  Every format runs the main path's five UDFs (ApplyMasks with a
disk and a ring, Sum, SumSig, StdDev, CoM on a 2-D nav) through both
packages (``tests/test_torch_formats.py``'s ``check_format``: equal
frames, dtype and diagnostics; UDF results within 1e-5 relative, with
an absolute floor of 1e-5 of the buffer's largest magnitude, fused in
the port).  Frames, tiles and picked frames exact.  The same paths on
the card are in ``tests/test_torch_kernels_cuda.py``.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.io.dataset.hdf5 import H5DataSet as JH5DataSet
from libertem_tpu.io.dataset.live import FrameRing as JFrameRing
from libertem_tpu.io.dataset.live import LiveDataSet as JLiveDataSet
from libertem_tpu.io.dataset.raw_csr import CSRTriple as JCSRTriple
from libertem_tpu.io.dataset.raw_csr import (
    read_tiles_straight as jread_tiles_straight,
)
from libertem_tpu.io.dataset.raw_csr import (
    read_tiles_with_roi as jread_tiles_with_roi,
)
from libertem_tpu.io.tiling import Negotiator as JNegotiator
from libertem_tpu.udf.base import UDFRunner as JUDFRunner
from test_torch_formats import (
    _close,
    _compare_results,
    _ctx,
    _jctx,
    _udfs,
    check_detect,
    check_format,
)

import libertem_tpu_torch as port
from libertem_tpu_torch.io.dataset import NOT_PORTED
from libertem_tpu_torch.io.dataset.base import DataSetException, densify_into
from libertem_tpu_torch.io.dataset.live import FrameRing, LiveDataSet
from libertem_tpu_torch.io.dataset.raw_csr import (
    CSRTriple,
    read_tiles_straight,
    read_tiles_with_roi,
)
from libertem_tpu_torch.io.tiling import Negotiator
from libertem_tpu_torch.ops.moments import fused_moments
from libertem_tpu_torch.udf.base import UDFRunner

torch.set_num_threads(1)

NAV, SIG = (6, 8), (16, 16)
N = NAV[0] * NAV[1]
PX = SIG[0] * SIG[1]


def _counts(seed=0, nav=NAV, lam=3.0) -> np.ndarray:
    return np.random.default_rng(seed).poisson(lam, nav + SIG).astype(
        np.uint16)


# -- raw CSR -------------------------------------------------------------------


def _events(seed, n=N, per_frame=20, dup_every=7):
    """Single-electron events of ``n`` frames as CSR entries, frame by
    frame, with some pixels listed twice (non-canonical CSR): (indptr,
    indices, values), and the dense frames they sum to."""
    rng = np.random.default_rng(seed)
    indptr, indices, values = [0], [], []
    dense = np.zeros((n, PX), np.int64)
    for f in range(n):
        k = rng.poisson(per_frame)
        pix = rng.integers(0, PX, k)
        if k and f % dup_every == 0:
            pix = np.concatenate([pix, pix[:2]])
        val = rng.integers(1, 4, len(pix))
        indices.extend(pix.tolist())
        values.extend(val.tolist())
        indptr.append(len(indices))
        np.add.at(dense[f], pix, val)
    return (np.asarray(indptr), np.asarray(indices), np.asarray(values),
            dense)


def _write_csr(tmp_path, seed=1, nav=NAV, data_dtype="<u2",
               indices_dtype="<i4", indptr_dtype="<i8", n=None):
    """A raw CSR triple and its TOML; returns (toml path, dense
    frames)."""
    n = int(np.prod(nav)) if n is None else n
    indptr, indices, values, dense = _events(seed, n)
    d = str(tmp_path)
    np.asarray(indptr, indptr_dtype).tofile(os.path.join(d, "indptr.bin"))
    np.asarray(indices, indices_dtype).tofile(os.path.join(d, "ind.bin"))
    np.asarray(values, data_dtype).tofile(os.path.join(d, "val.bin"))
    path = os.path.join(d, "events.toml")
    with open(path, "w") as f:
        f.write(
            '[params]\nfiletype = "raw_csr"\n'
            f"nav_shape = {list(nav)}\nsig_shape = {list(SIG)}\n\n"
            '[raw_csr]\nindptr_file = "indptr.bin"\n'
            f'indptr_dtype = "{indptr_dtype}"\n'
            'indices_file = "ind.bin"\n'
            f'indices_dtype = "{indices_dtype}"\n'
            'data_file = "val.bin"\n'
            f'data_dtype = "{data_dtype}"\n'
        )
    return path, dense


def test_raw_csr_straight_and_duplicates(tmp_path):
    path, dense = _write_csr(tmp_path)
    ds, _ = check_format("raw_csr", path=path)
    frames = np.concatenate([
        p.read_dataset_frames(p.start_frame, p.start_frame + p.num_frames)
        for p in ds.get_partitions()])
    assert frames.dtype == np.uint16
    # duplicate entries sum, as np.add.at on the dense frames
    assert np.array_equal(frames.reshape(N, PX), dense)


@pytest.mark.parametrize("sync_offset", [5, -5])
def test_raw_csr_sync_offset(tmp_path, sync_offset):
    path, _ = _write_csr(tmp_path)
    check_format("raw_csr", path=path, sync_offset=sync_offset)


def test_raw_csr_roi(tmp_path):
    path, dense = _write_csr(tmp_path)
    roi = np.zeros(NAV, bool)
    roi[1:4, 2:7] = True
    roi[5, 0] = True
    check_format("raw_csr", path=path, roi=roi)
    pick = _ctx().run_udf(_ctx().load("raw_csr", path=path), port.PickUDF(),
                          roi=roi)
    assert np.array_equal(pick["intensity"].raw_data.reshape(-1, PX),
                          dense[roi.reshape(-1)])


def test_raw_csr_big_endian_and_narrow_indices(tmp_path):
    path, _ = _write_csr(tmp_path, data_dtype=">u2", indices_dtype="<u2",
                         indptr_dtype="<i4")
    ds, _ = check_format("raw_csr", path=path)
    assert ds.dtype == np.dtype(">u2")


def test_raw_csr_sparse_blocks(tmp_path):
    """Blocks carry the entries, zero-padded to a power of two; the
    host feed's staging budget is the largest block's."""
    path, dense = _write_csr(tmp_path)
    ds = _ctx().load("raw_csr", path=path)
    prep = UDFRunner([port.SumUDF()])._prepare(ds, torch.device("cpu"))
    scheme = prep["scheme"]
    for p in ds.get_partitions():
        blocks = list(p.gen_blocks(scheme))
        budgets = [len(b.sparse[0]) for b in blocks]
        assert all(b & (b - 1) == 0 and b >= 16 for b in budgets)
        assert p.sparse_nnz_budget(scheme) == max(budgets)
        for b in blocks:
            assert b.sparse[1].dtype == b.sparse[2].dtype == np.int32
            # the block's own entries, then the budget's zero padding
            assert 0 < b.nnz <= len(b.sparse[0])
            assert not any(a[b.nnz:].any() for a in b.sparse)
            assert b.sparse[0][:b.nnz].all()
            got = b.data.reshape(scheme.depth, PX)
            want = dense[b.global_offset:b.global_offset + b.valid]
            assert np.array_equal(got[:b.valid], want)
            assert not got[b.valid:].any()


def test_raw_csr_tiles(tmp_path):
    path, _ = _write_csr(tmp_path)
    ds = _ctx().load("raw_csr", path=path, sync_offset=3)
    jds = _jctx().load("raw_csr", path=path, sync_offset=3)
    roi = np.random.default_rng(4).random(N) > 0.4
    for r in (None, roi):
        scheme = UDFRunner([port.SumUDF()])._prepare(
            ds, torch.device("cpu"), roi=r)["scheme"]
        for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
            tiles = list(p.get_tiles(scheme, roi=r))
            jtiles = list(jp.get_tiles(scheme, roi=r))
            assert len(tiles) == len(jtiles) > 0
            for t, jt in zip(tiles, jtiles):
                assert t.tile_slice.origin == jt.tile_slice.origin
                assert tuple(t.tile_slice.shape) == tuple(jt.tile_slice.shape)
                assert np.array_equal(t.data, jt.data)
    # the scipy CSR tile streams over the triple
    indptr, indices, values, _ = _events(1)
    triple = CSRTriple(indptr, indices, values.astype(np.uint16))
    jtriple = JCSRTriple(indptr, indices, values.astype(np.uint16))
    jscheme = JNegotiator().get_scheme([libertem_tpu.udf.SumUDF()],
                                       jds.shape, np.float32,
                                       max_partition_frames=12)
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        for so in (0, 3, -3):
            got = list(read_tiles_straight(triple, p.slice, jscheme,
                                           sync_offset=so))
            want = list(jread_tiles_straight(jtriple, jp.slice, jscheme,
                                             sync_offset=so))
            got_r = list(read_tiles_with_roi(triple, p.slice, jscheme, roi,
                                             sync_offset=so))
            want_r = list(jread_tiles_with_roi(jtriple, jp.slice, jscheme,
                                               roi, sync_offset=so))
            for a, b in zip(got + got_r, want + want_r):
                assert a.tile_slice.origin == b.tile_slice.origin
                assert np.array_equal(a.data.toarray(), b.data.toarray())
            assert len(got) == len(want) and len(got_r) == len(want_r)


def test_raw_csr_detect(tmp_path):
    path, _ = _write_csr(tmp_path)
    ds = check_detect(path, "raw_csr")
    assert tuple(ds.shape) == NAV + SIG
    big = tmp_path / "big.toml"
    big.write_bytes(b"#" * (2 * 1024 * 1024))
    from libertem_tpu_torch.io.dataset.raw_csr import RawCSRDataSet
    assert RawCSRDataSet.detect_params(str(big)) is False


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32", "int64",
                                   "float32"])
def test_densify_into_like_np_add_at(dtype):
    """The feed's densify sums duplicates in the block's dtype (with
    the wrap of an unsigned type), as ``np.add.at``; padding entries
    add 0 at (0, 0), and rows past the block's entries are zeroed."""
    rng = np.random.default_rng(7)
    depth, pixels, nnz = 6, 32, 64
    info = np.iinfo(dtype) if np.dtype(dtype).kind in "iu" else None
    hi = info.max // 2 if info is not None else 1000
    vals = rng.integers(0, hi, nnz).astype(dtype)
    rows = rng.integers(0, depth - 1, nnz).astype(np.int32)
    cols = rng.integers(0, 4, nnz).astype(np.int32)  # many duplicates
    vals[-8:], rows[-8:], cols[-8:] = 0, 0, 0
    want = np.zeros((depth, pixels), dtype)
    np.add.at(want, (rows, cols), vals)
    dense = torch.full((depth, pixels), 7).to(getattr(torch, dtype))
    densify_into(dense, *(torch.from_numpy(a) for a in (vals, rows, cols)))
    assert np.array_equal(dense.numpy(), want)


# -- the tiling's io cap ------------------------------------------------------


@pytest.mark.parametrize("max_io_size", [None, 4096, 64 * 1024, 1 << 40])
def test_scheme_capped_by_max_io_size(max_io_size):
    shape = port.Shape((64, 32) + SIG, 2)
    for dtype in (np.uint16, np.float32):
        s = Negotiator().get_scheme([port.SumUDF()], shape, dtype,
                                    max_io_size=max_io_size)
        j = JNegotiator().get_scheme([libertem_tpu.udf.SumUDF()],
                                     libertem_tpu.Shape((64, 32) + SIG, 2),
                                     dtype, max_io_size=max_io_size)
        assert s.depth == j.depth
    # the runner passes the dataset's cap: HDF5 chunks, a live ring
    ds = LiveDataSet(nav_shape=NAV, sig_shape=SIG, dtype="uint16",
                     ring_capacity=16)
    jds = JLiveDataSet(nav_shape=NAV, sig_shape=SIG, dtype="uint16",
                       ring_capacity=16)
    depth = UDFRunner([port.SumUDF()])._prepare(
        ds, torch.device("cpu"))["scheme"].depth
    jdepth = JUDFRunner([libertem_tpu.udf.SumUDF()])._prepare(
        jds, None, None, None)["scheme"].depth
    assert depth == jdepth <= 8


# -- live ----------------------------------------------------------------------


def _producer(ds, flat, chunk=5, stop_after=None, pause=0.002,
              finish=True):
    def run():
        n = len(flat) if stop_after is None else stop_after
        for off in range(0, n, chunk):
            ds.push_frames(flat[off:min(off + chunk, n)])
            time.sleep(pause)
        if finish:
            ds.finish()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _live_pair(capacity=16, parts=3, dtype="uint16", nav=NAV):
    kw = dict(nav_shape=nav, sig_shape=SIG, dtype=dtype,
              ring_capacity=capacity, num_partitions=parts)
    return LiveDataSet(**kw).initialize(), JLiveDataSet(**kw).initialize()


def test_live_stream_like_jax():
    data = _counts(2)
    flat = data.reshape((N,) + SIG)
    ds, jds = _live_pair()
    t, jt = _producer(ds, flat), _producer(jds, flat)
    ctx = _ctx()
    res = ctx.run_udf(ds, _udfs(port, SIG, True))
    jres = _jctx().run_udf(jds, _udfs(libertem_tpu, SIG, True))
    t.join(10)
    jt.join(10)
    assert not t.is_alive() and not jt.is_alive()
    assert ctx.run_info["fused"]
    _compare_results(res, jres)
    _close(res[1]["intensity"].data, data.astype(np.float64).sum((0, 1)))


def test_live_early_finish_like_jax():
    data = _counts(3)
    flat = data.reshape((N,) + SIG)
    ds, jds = _live_pair(capacity=64, parts=2)
    for d in (ds, jds):
        d.push_frames(flat[:20])
        d.finish()
    res = _ctx().run_udf(ds, _udfs(port, SIG, True))
    jres = _jctx().run_udf(jds, _udfs(libertem_tpu, SIG, True))
    _compare_results(res, jres)
    sumsig = res[2]["intensity"]
    assert np.array_equal(sumsig.valid_mask.reshape(-1),
                          np.arange(N) < 20)
    assert np.array_equal(sumsig.valid_mask,
                          jres[2]["intensity"].valid_mask)
    assert not sumsig.data.reshape(-1)[20:].any()


def test_live_roi_gap_larger_than_ring():
    nav = (512,)
    flat = np.random.default_rng(5).poisson(2.0, nav + SIG).astype(
        np.uint16)
    roi = np.zeros(512, bool)
    roi[[0, 500]] = True
    ds, jds = _live_pair(capacity=32, parts=4, nav=nav)
    t = _producer(ds, flat, chunk=16, pause=0)
    jt = _producer(jds, flat, chunk=16, pause=0)
    res = _ctx().run_udf(ds, port.SumUDF(), roi=roi)
    jres = _jctx().run_udf(jds, libertem_tpu.udf.SumUDF(), roi=roi)
    t.join(30)
    jt.join(30)
    assert not t.is_alive(), "the producer deadlocked"
    want = flat[[0, 500]].astype(np.float64).sum(axis=0)
    _close(res["intensity"].data, want)
    _close(res["intensity"].data, jres["intensity"].data)


def test_live_ring_reads_like_jax():
    """Reads in order; a read behind freed frames raises RuntimeError,
    one larger than the ring ValueError; frames that never came read
    as zeros."""
    frames = _counts(6).reshape((N,) + SIG)[:12]
    ring = FrameRing(N, SIG, np.uint16, capacity=8)
    jring = JFrameRing(N, SIG, np.uint16, capacity=8)
    for r in (ring, jring):
        r.push_frames(frames[:6])
    assert np.array_equal(ring.read(0, 4), jring.read(0, 4))
    for r in (ring, jring):
        r.push_frames(frames[6:12])
        r.finish()
    out = np.full((5,) + SIG, 9, np.uint16)
    ring.read(8, 13, out)
    assert np.array_equal(out, jring.read(8, 13))
    assert not out[4:].any()
    for r in (ring, jring):
        with pytest.raises(RuntimeError, match="regresses"):
            r.read(5, 6)
        with pytest.raises(ValueError, match="capacity"):
            r.read(13, 22)


def test_live_abandoned_iterator_returns_promptly():
    """An iterator abandoned after its first partial while the producer
    stalls: close() returns, and the reader thread, which waits inside
    the ring's read, ends, within 5 s (the feed's stop reaches a read
    that waits for data)."""
    data = _counts(7)
    flat = data.reshape((N,) + SIG)
    ds = LiveDataSet(nav_shape=NAV, sig_shape=SIG, dtype="uint16",
                     ring_capacity=32, num_partitions=3).initialize()
    ds.push_frames(flat[:24])  # the first partition and half the second
    before = set(threading.enumerate())
    gen = _ctx().run_udf_iter(ds, _udfs(port, SIG, True))
    first = next(gen)
    assert first.damage.data.reshape(-1)[:16].all()
    t0 = time.perf_counter()
    gen.close()
    deadline = time.perf_counter() + 5.0
    while time.perf_counter() < deadline:
        alive = [t for t in set(threading.enumerate()) - before
                 if t.name == "HostFeed-reader"]
        if not alive:
            break
        time.sleep(0.02)
    assert not alive
    assert time.perf_counter() - t0 < 5.0


# -- array-like ---------------------------------------------------------------


class Chunked:
    """An array-like with dask's ``.chunks`` and ``.compute()``: the
    first axis in the given chunks, the others whole."""

    def __init__(self, arr, first_chunks):
        self._arr = arr
        self.shape, self.dtype = arr.shape, arr.dtype
        rest = tuple((s,) for s in arr.shape[1:])
        self.chunks = (tuple(first_chunks),) + rest
        self.computed = 0

    def reshape(self, shape):
        """A flat-nav view: the first-axis chunks scale by the nav
        axes folded into it."""
        flat = self._arr.reshape(shape)
        per = flat.shape[0] // self.shape[0]
        return Chunked(flat, [c * per for c in self.chunks[0]])

    def __getitem__(self, key):
        return _Lazy(self._arr[key])


class _Lazy:
    def __init__(self, arr):
        self._arr = arr

    def compute(self):
        return self._arr


@pytest.mark.parametrize("chunks", [None, (2, 1, 3)])
def test_dask_array_like(chunks):
    data = _counts(8).astype(np.float32)
    arr = data if chunks is None else Chunked(data, chunks)
    ds, jds = check_format("dask", array=arr)
    n = (len(list(jds.get_partitions())) if chunks is None else len(chunks))
    assert len(list(ds.get_partitions())) == n
    if chunks is not None:
        assert [p.num_frames for p in ds.get_partitions()] == \
            [c * NAV[1] for c in chunks]
    ds2 = _ctx().load("dask", dask_array=data, sig_dims=2)
    assert tuple(ds2.shape) == NAV + SIG


# -- HDF5 -------------------------------------------------------------------------


def _h5(tmp_path, data, name="d.h5", chunks=None, compression=None):
    import h5py
    path = str(tmp_path / name)
    with h5py.File(path, "w") as f:
        f.create_dataset("entry/data", data=data, chunks=chunks,
                         compression=compression)
        f.create_dataset("entry/small", data=np.zeros((3, 4)))
    return path


@pytest.mark.parametrize("layout", ["1d-contiguous", "2d-chunked",
                                    "2d-gzip", "3d-contiguous"])
def test_hdf5_like_jax(tmp_path, layout):
    data = _counts(9)
    chunks = compression = None
    if layout == "1d-contiguous":
        data = data.reshape((N,) + SIG)
    elif layout == "3d-contiguous":
        data = data.reshape((2, 3, 8) + SIG)
    else:
        chunks = (1, 4) + SIG
        compression = "gzip" if layout == "2d-gzip" else None
    path = _h5(tmp_path, data, chunks=chunks, compression=compression)
    ds, jds = check_format("hdf5", path=path, ds_path="entry/data")
    assert ds.get_max_io_size() == jds.get_max_io_size()
    assert ds.get_base_shape(None) == jds.get_base_shape(None)
    for ts in ((16,) + SIG, (16, 4, 16), (4, 2, 2)):
        assert ds.adjust_tileshape(ts, None) == jds.adjust_tileshape(ts, None)
    scheme = UDFRunner(_udfs(port, SIG, False))._prepare(
        ds, torch.device("cpu"))["scheme"]
    jscheme = JUDFRunner(_udfs(libertem_tpu, SIG, False))._prepare(
        jds, None, None, None)["scheme"]
    assert scheme.depth == jscheme.depth


def test_hdf5_roi_and_selected_frames(tmp_path):
    data = _counts(10).astype(np.float32)
    path = _h5(tmp_path, data, chunks=(1, 2) + SIG)
    roi = np.zeros(NAV, bool)
    roi[0, 1:5] = roi[4, :] = True
    ds, jds = check_format("hdf5", path=path, ds_path="entry/data", roi=roi)
    ids = np.flatnonzero(roi)
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        sel = ids[(ids >= p.start_frame)
                  & (ids < p.start_frame + p.num_frames)]
        assert np.array_equal(p.read_selected_frames(sel),
                              jp.read_selected_frames(sel))
    pick = _ctx().run_udf(ds, port.PickUDF(), roi=roi)
    assert np.array_equal(pick["intensity"].raw_data,
                          data.reshape((N,) + SIG)[ids])


def test_hdf5_tile_row_cap(tmp_path):
    data = _counts(11, nav=(12, 4))
    path = _h5(tmp_path, data)
    ds = _ctx().load("hdf5", path=path, ds_path="entry/data")
    jds = _jctx().load("hdf5", path=path, ds_path="entry/data")
    scheme = Negotiator().get_scheme([port.SumUDF()], ds.shape, np.float32)
    assert scheme.depth > 4
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        tiles = list(p.get_tiles(scheme))
        jtiles = list(jp.get_tiles(scheme))
        assert len(tiles) == len(jtiles)
        for t, jt in zip(tiles, jtiles):
            assert t.shape[0] <= 4
            assert t.tile_slice.origin == jt.tile_slice.origin
            assert np.array_equal(t.data, jt.data)


def test_hdf5_detect_and_options(tmp_path, monkeypatch):
    data = _counts(12)
    path = _h5(tmp_path, data)
    ds = check_detect(path, "hdf5")
    assert tuple(ds.shape) == NAV + SIG
    kw = dict(path=path, ds_path="entry/data", nav_shape=(N,),
              target_size=PX * 2 * 12, min_num_partitions=2)
    ds = _ctx().load("hdf5", **kw)
    jds = _jctx().load("hdf5", **kw)
    assert ds.get_num_partitions() == jds.get_num_partitions() == 4
    assert tuple(ds.shape) == (N,) + SIG
    for bad in (dict(sig_shape=(8, 32)), dict(ds_path="entry/small")):
        with pytest.raises(DataSetException) as ours:
            _ctx().load("hdf5", path=path, **{"ds_path": "entry/data",
                                              **bad})
        with pytest.raises(Exception) as theirs:
            _jctx().load("hdf5", path=path, **{"ds_path": "entry/data",
                                               **bad})
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="I/O backends"):
        _ctx().load("hdf5", path=path, io_backend=object())
    # without h5py: a DataSetException that names it, no fallback
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(DataSetException, match="h5py"):
        _ctx().load("hdf5", path=path)
    assert JH5DataSet.__name__ == type(ds).__name__


# -- NPY's file table --------------------------------------------------------


def test_npy_fileset_like_jax(tmp_path):
    path = str(tmp_path / "a.npy")
    np.save(path, _counts(13))
    fs = _ctx().load("npy", path=path)._get_fileset()
    jfs = _jctx().load("npy", path=path)._get_fileset()
    assert len(fs) == len(jfs) == 1
    for a, b in zip(fs, jfs):
        for attr in ("path", "start_idx", "end_idx", "native_dtype",
                     "sig_shape", "file_header"):
            assert getattr(a, attr) == getattr(b, attr)
    from libertem_tpu_torch.io.dataset.memory import FileSet, MemoryFile
    mf = MemoryFile("mem", 0, 4, np.uint16, SIG, np.zeros((4,) + SIG))
    assert mf.num_frames == 4 and FileSet([mf])[0] is mf


# -- the slice as a whole --------------------------------------------------------


def test_every_format_ported_and_fused(tmp_path):
    """Every format of the JAX package loads in the port; each of this
    slice's runs the five main-path UDFs fused, with no kernel launch
    on the CPU."""
    assert NOT_PORTED == {}
    data = _counts(14)
    csr, _ = _write_csr(tmp_path)
    h5 = _h5(tmp_path, data)
    before = fused_moments.launches
    for kind, kw in (("raw_csr", dict(path=csr)),
                     ("hdf5", dict(path=h5, ds_path="entry/data")),
                     ("dask", dict(array=data))):
        ctx = _ctx()
        ctx.run_udf(ctx.load(kind, **kw), _udfs(port, SIG, True))
        assert ctx.run_info["fused"]
    assert fused_moments.launches == before
