"""Dataset export, the result formats and the transposed-data
converters of the port against the JAX package's, on the CPU
(counterparts of ``tests/test_api_parity.py``'s export checks of
test_context_kwarg_sweep and ``tests/test_formats2.py``'s
test_convert_transposed).

The same seeded numpy data goes through ``libertem_tpu_torch`` with
``device="cpu"`` and ``libertem_tpu`` with ``InlineJobExecutor()``:
files, bytes, array names and headers are equal; float results within
1e-5 relative.
"""
import io
import os

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor as JaxInline
from libertem_tpu.io import writers as jw
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet

import libertem_tpu_torch as port
from libertem_tpu_torch.io import writers as pw

torch.set_num_threads(1)

RTOL = 1e-5


def _data(nav=(4, 6), sig=(8, 8), dtype=np.uint16, seed=11):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(3.0, 1.0, nav + sig).astype(dtype)
    return rng.poisson(9.0, nav + sig).astype(dtype)


def _contexts():
    return port.Context(device="cpu"), JaxContext(executor=JaxInline())


def _npy_header(path):
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        return np.lib.format._read_array_header(f, version)


# -- export_dataset -----------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_export_dataset_like_jax(tmp_path, dtype):
    """The .npy file of the full shape (its header the full nav), bit
    for bit the frames, equal to the JAX package's file."""
    data = _data(dtype=dtype)
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    jds = JaxMemoryDataSet(data=data, sig_dims=2,
                           num_partitions=3).initialize()
    out, jout = str(tmp_path / "p.npy"), str(tmp_path / "j.npy")
    ctx.export_dataset(ds, path=out)
    jctx.export_dataset(jds, path=jout)
    assert _npy_header(out) == _npy_header(jout)
    assert _npy_header(out)[0] == data.shape
    got = np.load(out)
    assert got.dtype == data.dtype and np.array_equal(got, data)
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()


def test_export_dataset_refusals_like_jax(tmp_path):
    data = _data()
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2)
    jds = JaxMemoryDataSet(data=data, sig_dims=2).initialize()
    for c, d, name in ((ctx, ds, "p"), (jctx, jds, "j")):
        out = str(tmp_path / f"{name}.npy")
        c.export_dataset(d, path=out)
        with pytest.raises(FileExistsError, match="overwrite"):
            c.export_dataset(d, path=out)
        np.save(out, np.zeros(3))
        c.export_dataset(d, path=out, overwrite=True)
        assert np.array_equal(np.load(out), data)
        with pytest.raises(ValueError, match="npy"):
            c.export_dataset(d, path=str(tmp_path / f"{name}.tiff"))


def test_export_raw_file_and_reload(tmp_path):
    """A raw file exported and loaded again as npy gives the same
    results as the raw file, through the five main-path UDFs."""
    data = _data(nav=(6, 4), sig=(16, 16))
    raw = str(tmp_path / "scan.raw")
    data.tofile(raw)
    ctx = port.Context(device="cpu")
    ds = ctx.load("raw", path=raw, dtype="uint16", nav_shape=(6, 4),
                  sig_shape=(16, 16))
    out = str(tmp_path / "scan.npy")
    ctx.export_dataset(ds, path=out, progress=False)
    assert np.array_equal(np.load(out), data)
    again = ctx.load("npy", path=out)
    res = ctx.run_udf(again, [port.SumUDF(), port.StdDevUDF()])
    want = ctx.run_udf(ds, [port.SumUDF(), port.StdDevUDF()])
    for r, w in zip(res, want):
        for k in w:
            assert np.array_equal(r[k].data, w[k].data)
    assert ctx.run_info["engines"] == ["device", "device"]


def test_write_dataset_npy_runs_record_on_the_host(tmp_path):
    data = _data()
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=data, sig_dims=2)
    out = str(tmp_path / "w.npy")
    pw.write_dataset_npy(ctx, ds, out)
    assert ctx.run_info["engines"] == ["host"]
    assert np.array_equal(np.load(out), data)


# -- WriteHandle ---------------------------------------------------------


def _tiles(lib, tiles):
    """``(origin, array)`` pairs as objects with ``tile_slice`` and
    ``data`` (nav flat, sig 2-D)."""
    Shape = lib.common.shape.Shape  # noqa: N806
    Slice = lib.common.slice.Slice  # noqa: N806

    class Tile:
        def __init__(self, origin, arr):
            self.tile_slice = Slice(origin, Shape(arr.shape, sig_dims=2))
            self.data = arr

    return [Tile(o, a) for o, a in tiles]


@pytest.mark.parametrize("abort", [False, True])
def test_write_handle_like_jax(tmp_path, abort):
    """Tiles into a temporary file, renamed on a clean exit and
    unlinked on abort or an exception; equal files from both."""
    import libertem_tpu.common.shape  # noqa: F401
    import libertem_tpu.common.slice  # noqa: F401

    import libertem_tpu_torch.common.shape  # noqa: F401
    import libertem_tpu_torch.common.slice  # noqa: F401
    rng = np.random.default_rng(2)
    full = rng.random((6, 4, 5)).astype(np.float32)
    tiles = [((0, 0, 0), full[:3, :2]), ((0, 2, 0), full[:3, 2:]),
             ((3, 0, 0), full[3:])]
    written = {}
    for lib, mod, name in ((port, pw, "p"), (libertem_tpu, jw, "j")):
        Shape, Slice = lib.common.shape.Shape, lib.common.slice.Slice  # noqa
        part = Slice((0, 0, 0), Shape((6, 4, 5), sig_dims=2))
        path = str(tmp_path / f"{name}.raw")
        with mod.WriteHandle(path, str(tmp_path), part, np.float32) as wh:
            tmp_name = wh._tmp_file.name
            assert os.path.dirname(tmp_name) == str(tmp_path)
            seen = list(wh.write_tiles(_tiles(lib, tiles)))
            assert len(seen) == 3
            if abort:
                wh.abort()
        assert not os.path.exists(tmp_name)
        if abort:
            assert not os.path.exists(path)
            continue
        assert oct(os.stat(path).st_mode & 0o777) == oct(
            0o666 & ~_umask())
        written[name] = np.fromfile(path, np.float32).reshape(6, 4, 5)
        assert np.array_equal(written[name], full)
        # an exception inside the block leaves no file
        bad = str(tmp_path / f"{name}-bad.raw")
        with pytest.raises(RuntimeError):
            with mod.WriteHandle(bad, str(tmp_path), part, np.float32) as wh:
                wh.write_frames(0, full[:2])
                raise RuntimeError("stop")
        assert not os.path.exists(bad)
    if not abort:
        assert np.array_equal(written["p"], written["j"])


def _umask():
    m = os.umask(0)
    os.umask(m)
    return m


# -- result formats --------------------------------------------------------


def _result_sets():
    """The same results in both packages: StdDevUDF's buffers, and
    CoM's AnalysisResultSet (whose field tuple is left out of
    downloads)."""
    data = _data(nav=(4, 5), sig=(12, 12))
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2)
    jds = JaxMemoryDataSet(data=data, sig_dims=2).initialize()
    res = ctx.run_udf(ds, port.StdDevUDF())
    jres = jctx.run_udf(jds, libertem_tpu.udf.StdDevUDF())
    com = ctx.run(ctx.create_com_analysis(ds, cx=6, cy=6, mask_radius=4))
    jcom = jctx.run(jctx.create_com_analysis(jds, cx=6, cy=6,
                                             mask_radius=4))
    return [(res, jres), (com, jcom)]


def test_format_registry_like_jax():
    assert pw.ResultFormat.get_available_formats() == \
        jw.ResultFormat.get_available_formats()
    assert set(pw.ResultFormat.registry) == {
        "NPZ", "NPZ_COMPRESSED", "HDF5", "RAW", "TIFF"}
    for id_ in pw.ResultFormat.registry:
        f = pw.ResultFormatRegistry.get_format_by_id(id_)
        jf = jw.ResultFormatRegistry.get_format_by_id(id_)
        assert f.__name__ == jf.__name__ and f.id_ == id_
        assert f.extension == jf.extension
        assert f(None).get_filename() == jf(None).get_filename()
        assert f(None).get_content_type() == "application/octet-stream"
    assert pw.ResultFormatRegistry.get_available_formats() == \
        pw.ResultFormat.get_available_formats()


def _serialize(mod, id_, rs):
    buf = io.BytesIO()
    mod.ResultFormat.get_format_by_id(id_)(rs).serialize_to_buffer(buf)
    return buf.getvalue()


@pytest.mark.parametrize("id_", ["NPZ", "NPZ_COMPRESSED"])
def test_npz_like_jax(id_):
    for rs, jrs in _result_sets():
        a = np.load(io.BytesIO(_serialize(pw, id_, rs)))
        b = np.load(io.BytesIO(_serialize(jw, id_, jrs)))
        assert sorted(a.files) == sorted(b.files)
        assert "field" not in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert np.allclose(a[k], b[k], rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(b[k]).max()),
                               equal_nan=True)


def test_raw_format_like_jax():
    """RAW: the arrays' bytes in the result set's order; the same
    length and, read back as the same dtypes, the same values."""
    for rs, jrs in _result_sets():
        raw, jraw = _serialize(pw, "RAW", rs), _serialize(jw, "RAW", jrs)
        assert len(raw) == len(jraw)
        names = [k for k, _ in pw.ResultFormat(rs)._iter_arrays()]
        assert names == [k for k, _ in jw.ResultFormat(jrs)._iter_arrays()]
        off = 0
        for (_, arr), (_, jarr) in zip(pw.ResultFormat(rs)._iter_arrays(),
                                       jw.ResultFormat(jrs)._iter_arrays()):
            n = arr.nbytes
            got = np.frombuffer(raw[off:off + n], arr.dtype)
            want = np.frombuffer(jraw[off:off + n], jarr.dtype)
            assert np.allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(1.0, np.nanmax(np.abs(want))),
                               equal_nan=True)
            off += n


def test_tiff_format_like_jax():
    from PIL import Image
    for rs, jrs in _result_sets():
        planes = []
        for blob in (_serialize(pw, "TIFF", rs),
                     _serialize(jw, "TIFF", jrs)):
            img = Image.open(io.BytesIO(blob))
            frames = []
            for i in range(img.n_frames):
                img.seek(i)
                frames.append(np.array(img))
            planes.append(frames)
        assert len(planes[0]) == len(planes[1]) > 0
        for a, b in zip(*planes):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.allclose(a, b, rtol=RTOL,
                               atol=RTOL * max(1.0, np.nanmax(np.abs(b))),
                               equal_nan=True)


def test_hdf5_format_like_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    for rs, jrs in _result_sets():
        files = []
        for mod, r, name in ((pw, rs, "p"), (jw, jrs, "j")):
            path = str(tmp_path / f"{name}.h5")
            with open(path, "wb") as f:
                mod.ResultFormat.get_format_by_id("HDF5")(r).serialize_to(f)
            files.append(h5py.File(path, "r"))
        a, b = files
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert np.allclose(a[k][()], b[k][()], rtol=RTOL,
                               atol=RTOL * max(1.0, np.nanmax(
                                   np.abs(b[k][()]))), equal_nan=True)
        for f in files:
            f.close()


def test_formats_import_their_libraries_lazily():
    import subprocess
    import sys
    code = ("import sys, libertem_tpu_torch.io.writers\n"
            "assert 'h5py' not in sys.modules and 'PIL' not in sys.modules\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=dict(os.environ, PYTHONPATH=repo), timeout=120)


# -- transposed data ---------------------------------------------------------


@pytest.mark.parametrize("chunk_px", [1024, 7])
def test_convert_transposed_to_npy_like_jax(tmp_path, chunk_px):
    from libertem_tpu.contrib.convert_transposed import (
        convert_transposed_to_npy as jconv,
    )

    from libertem_tpu_torch.contrib.convert_transposed import (
        convert_transposed_to_npy,
    )
    rng = np.random.default_rng(4)
    nav, sig = (3, 4), (5, 6)
    c_order = rng.random(nav + sig).astype(np.float32)
    transposed = np.moveaxis(c_order.reshape(12, 30), 0, 1)
    src = str(tmp_path / "transposed.bin")
    head = b"\x00" * 16
    with open(src, "wb") as f:
        f.write(head)
        f.write(np.ascontiguousarray(transposed).tobytes())
    out, jout = str(tmp_path / "p.npy"), str(tmp_path / "j.npy")
    assert convert_transposed_to_npy(
        src, out, nav_shape=nav, sig_shape=sig, dtype=np.float32,
        data_offset=16, chunk_px=chunk_px) == out
    jconv(src, jout, nav_shape=nav, sig_shape=sig, dtype=np.float32,
          data_offset=16, chunk_px=chunk_px)
    assert np.array_equal(np.load(out), c_order)
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()


def test_convert_transposed_udf_like_jax(tmp_path):
    """ConvertTransposedDatasetUDF over a raw (sig, nav) file loaded
    with nav and sig swapped: the nav-major .npy, equal to the JAX
    package's."""
    from libertem_tpu.contrib.convert_transposed import (
        ConvertTransposedDatasetUDF as JUDF,
    )

    from libertem_tpu_torch.contrib.convert_transposed import (
        ConvertTransposedDatasetUDF,
    )
    rng = np.random.default_rng(8)
    nav, sig = (4, 6), (5, 7)
    c_order = rng.poisson(5, nav + sig).astype(np.uint16)
    transposed = np.ascontiguousarray(
        np.moveaxis(c_order.reshape(24, 35), 0, 1))
    src = str(tmp_path / "t.raw")
    transposed.tofile(src)
    ctx, jctx = _contexts()
    ds = ctx.load("raw", path=src, dtype="uint16", nav_shape=sig,
                  sig_shape=nav)
    jds = jctx.load("raw", path=src, dtype="uint16", nav_shape=sig,
                    sig_shape=nav)
    out, jout = str(tmp_path / "p.npy"), str(tmp_path / "j.npy")
    ctx.run_udf(ds, ConvertTransposedDatasetUDF(out))
    jctx.run_udf(jds, JUDF(jout))
    got = np.load(out)
    assert got.shape == nav + sig and np.array_equal(got, c_order)
    assert np.array_equal(got, np.load(jout))
    assert ctx.run_info["engines"] == ["host"]


def test_convert_dm4_transposed_refusals_like_jax(tmp_path):
    """A Context and a CPU count exclude each other; a DM4 file in C
    order is not converted; both as in the JAX package."""
    from test_formats2 import _write_dm4

    from libertem_tpu.contrib.convert_transposed import (
        convert_dm4_transposed as jconv,
    )
    from libertem_tpu.io.dataset.base import (
        DataSetException as JDataSetException,
    )

    from libertem_tpu_torch.contrib.convert_transposed import (
        convert_dm4_transposed,
    )
    from libertem_tpu_torch.io.dataset.base import DataSetException
    path = str(tmp_path / "c.dm4")
    _write_dm4(path, _data(nav=(6,), sig=(8, 10)))
    ctx, jctx = _contexts()
    out = str(tmp_path / "o.npy")
    for conv, c in ((convert_dm4_transposed, ctx), (jconv, jctx)):
        with pytest.raises(ValueError, match="Either supply a Context"):
            conv(path, out, ctx=c, num_cpus=2)
    with pytest.raises(DataSetException, match="not transposed"):
        convert_dm4_transposed(path, out, ctx=ctx)
    with pytest.raises(JDataSetException, match="not transposed"):
        jconv(path, out, ctx=jctx)
    assert not os.path.exists(out)
