"""The port's detector formats against the JAX package on the CPU: the
format registry (``load("auto")``, ``detect``, the formats not yet
ported), MIB (r1/r6/r12/r24, U08/U16/U32, the 2x2 quad, several files)
and K2IS, the recorded goldens (``mib_decode.npz``, ``fmt_decode.npz``)
and the bad-header errors of ``tests/test_faults.py``.
``tests/test_torch_formats2.py`` holds the other formats.

The files are written with ``tests/format_encoders.py`` (numpy only)
from seeded numpy data, small (sig 16x16 unless the detector fixes it,
nav up to 3x4), and go through ``libertem_tpu_torch``
(``Context(device="cpu")``) and ``libertem_tpu``.  Tolerances: frames,
detection and diagnostics equal; UDF results (ApplyMasks + Sum + SumSig
+ StdDev, + CoM on a 2-D nav; float32 sums in other orders) within 1e-5
relative, with an absolute floor of 1e-5 of the buffer's largest
magnitude (CoM's buffers derived from the centres: of the centres');
goldens as the JAX
package's parity tests hold them.
"""
import os
import struct

import numpy as np
import pytest
import torch

import format_encoders as fe
import libertem_tpu
import libertem_tpu.io.dataset as jio
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from format_encoders import dir_hash, ramp, sha
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor

import libertem_tpu_torch as port
import libertem_tpu_torch.io.dataset as pio
from libertem_tpu_torch.io.dataset.base import DataSetException
from libertem_tpu_torch.ops.moments import fused_moments

torch.set_num_threads(1)

RTOL = 1e-5
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
# CoM's buffers derived from the centres of mass (differences com - c):
# their absolute floor follows the centres' magnitude (as chip_smoke.py's
# FROM_COM), not their own
SCALE_OF = {k: "raw_com" for k in (
    "raw_shifts", "field", "field_y", "field_x", "magnitude", "divergence",
    "curl")}


def _ctx():
    return port.Context(device="cpu")


def _jctx():
    return JaxContext(executor=InlineJobExecutor())


def _all_frames(ds) -> np.ndarray:
    return np.concatenate([
        p.read_dataset_frames(p.start_frame, p.start_frame + p.num_frames)
        for p in ds.get_partitions()
    ])


def _udfs(lib, sig, com):
    h, w = sig
    disk = lib.masks.circular(w / 2, h / 2, w, h, min(h, w) / 4)
    ring = lib.masks.ring(w / 2, h / 2, w, h, min(h, w) / 2,
                          min(h, w) / 4)
    udfs = [lib.udf.ApplyMasksUDF(mask_factories=[lambda: disk,
                                                  lambda: ring]),
            lib.udf.SumUDF(), lib.udf.SumSigUDF(), lib.udf.StdDevUDF()]
    if com:
        udfs.append(lib.udf.CoMUDF.with_params(cy=h / 2, cx=w / 2,
                                               r=min(h, w) / 3))
    return udfs


def _close(got, want, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    both_nan = np.isnan(got) & np.isnan(want)
    if scale is None:
        scale = float(np.nanmax(np.abs(want), initial=0.0))
    scale = max(scale, 1.0)
    err = np.where(both_nan, 0.0, np.abs(got - want))
    assert np.all(err <= RTOL * np.abs(np.nan_to_num(want)) + RTOL * scale)


def _compare_results(ours, theirs):
    for o, t in zip(ours, theirs):
        assert set(o) == set(t)
        for k in o:
            ref = t[SCALE_OF.get(k, k)].data
            scale = float(np.nanmax(np.abs(np.asarray(ref, np.float64)),
                                    initial=0.0))
            _close(o[k].data, t[k].data, scale)


def check_format(kind, roi=None, udfs=True, **kw):
    """Load ``kind`` with ``kw`` in both packages: equal shape, dtype,
    frames and diagnostics, and (with ``udfs``) the UDF results of one
    run, fused in the port.  Returns both datasets."""
    ds = _ctx().load(kind, **kw)
    jds = _jctx().load(kind, **kw)
    assert tuple(ds.shape) == tuple(jds.shape)
    assert ds.shape.sig.dims == jds.shape.sig.dims
    assert ds.dtype == jds.dtype
    assert ds.meta.image_count == jds.meta.image_count
    ours, theirs = _all_frames(ds), _all_frames(jds)
    assert ours.dtype == theirs.dtype
    assert np.array_equal(ours, theirs)
    assert ds.diagnostics == jds.diagnostics
    if udfs:
        sig = tuple(ds.shape.sig)
        com = len(tuple(ds.shape.nav)) == 2 and len(sig) == 2
        ctx = _ctx()
        before = fused_moments.launches
        res = ctx.run_udf(ds, _udfs(port, sig, com), roi=roi)
        assert ctx.run_info["fused"]
        assert fused_moments.launches == before  # the CPU launches none
        jres = _jctx().run_udf(jds, _udfs(libertem_tpu, sig, com), roi=roi)
        _compare_results(res, jres)
    return ds, jds


def check_detect(path, kind, **load_kw):
    """``detect`` finds what the JAX package's finds, and ``load("auto")``
    loads the file as that format."""
    found = pio.detect(path)
    assert found == jio.detect(path)
    assert found["type"] == kind
    ds = _ctx().load("auto", path=path, **load_kw)
    assert type(ds).__name__ == type(
        _jctx().load("auto", path=path, **load_kw)).__name__
    return ds


# -- the registry ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["hdf5", "raw_csr", "dask"])
def test_not_yet_ported_formats_raise(kind):
    """The formats ported last are no longer refused: each resolves to
    the class of the JAX package's name, and a missing file raises
    what the JAX package raises."""
    assert kind not in pio.NOT_PORTED and not pio.NOT_PORTED
    assert pio.get_dataset_cls(kind).__name__ == \
        jio.get_dataset_cls(kind).__name__
    if kind != "dask":
        with pytest.raises(Exception) as ours:
            _ctx().load(kind, path="x")
        with pytest.raises(Exception) as theirs:
            _jctx().load(kind, path="x")
        assert type(ours.value).__name__ == type(theirs.value).__name__


def test_unknown_format_raises():
    with pytest.raises(DataSetException, match="unknown filetype"):
        _ctx().load("nope", path="x")
    with pytest.raises(DataSetException, match="could not determine"):
        _ctx().load("auto", path=os.devnull)


def test_registry_like_jax():
    """Every format id of the JAX package is ported or named as not
    yet; the extensions and the search order match on the ported ones."""
    assert set(pio.filetypes) | set(pio.NOT_PORTED) == set(jio.filetypes)
    ported_ext = {
        e for ft in pio.filetypes
        for e in jio.get_dataset_cls(ft).get_supported_extensions()
    }
    assert pio.get_extensions() == ported_ext
    for path in ("a.mib", "a.hdr", "a.raw", "a.bin", "a.xml", "a.seq",
                 "a.dm4", "a.npy"):
        want = [ft for ft in jio.get_search_order(path)
                if ft in pio.filetypes]
        assert pio.get_search_order(path) == want


def test_register_and_unregister(tmp_path):
    from libertem_tpu_torch.io.dataset.raw import RawFileDataSet
    pio.register_dataset_cls("my_raw", RawFileDataSet)
    try:
        path = str(tmp_path / "d.raw")
        np.arange(4 * 64, dtype=np.uint16).tofile(path)
        ds = _ctx().load("my_raw", path=path, dtype="uint16",
                         nav_shape=(4,), sig_shape=(8, 8))
        assert isinstance(ds, RawFileDataSet)
        assert ds.get_num_partitions() == 4  # MIN_PARTITIONS
    finally:
        pio.unregister_dataset_cls("my_raw")
    assert "my_raw" not in pio.filetypes


# -- MIB -----------------------------------------------------------------------

MIB_KINDS = {
    # name: (dtype field, bit depth, encoder, value limit)
    "r1": ("R64", 1, fe.encode_mib_r1, 2),
    "r6": ("R64", 6, fe.encode_mib_r6, 64),
    "r12": ("R64", 12, fe.encode_mib_r12, 4096),
    "r24": ("R64", 24, fe.encode_mib_r24, 1 << 24),
    "u8": ("U08", 8, lambda f: f.astype(np.uint8), 256),
    "u16": ("U16", 12, lambda f: f.astype(">u2").view(np.uint8), 65536),
    "u32": ("U32", 24, lambda f: f.astype(">u4").view(np.uint8), 1 << 30),
}


def write_mib(path, name, n=12, sig=(16, 16), seed=0):
    dtype_str, bd, enc, lim = MIB_KINDS[name]
    frames = np.random.default_rng(seed).integers(
        0, lim, (n,) + sig).astype(np.uint32)
    width = 2 * sig[1] if name == "r24" else sig[1]
    fe.write_mib(path, frames, dtype_str, bd,
                 lambda fr: enc(fr.reshape(fr.shape[0], -1)),
                 width=width, height=sig[0])
    return frames


@pytest.mark.parametrize("name", list(MIB_KINDS))
def test_mib_like_jax(name, tmp_path):
    path = str(tmp_path / "scan.mib")
    frames = write_mib(path, name)
    ds, _ = check_format("mib", path=path, nav_shape=(3, 4))
    assert np.array_equal(_all_frames(ds), frames.astype(ds.dtype))
    check_detect(path, "mib")


@pytest.mark.parametrize("so", [5, -5])
@pytest.mark.parametrize("name", ["r1", "r12", "u16"])
def test_mib_sync_offset_and_roi(name, so, tmp_path):
    path = str(tmp_path / "scan.mib")
    write_mib(path, name)
    roi = np.random.default_rng(2).random((3, 4)) < 0.5
    check_format("mib", path=path, nav_shape=(3, 4), sync_offset=so)
    check_format("mib", path=path, nav_shape=(3, 4), sync_offset=so,
                 roi=roi)


def _write_quad(path, frames, dtype_str, bd, enc, h):
    """RAW 2x2 quad: stored rows [Q4|Q3|Q2|Q1] at 4x chip width, the
    bottom quadrants rotated 180 degrees."""
    hb = 384
    with open(path, "wb") as f:
        for i, fr in enumerate(frames):
            stored = np.empty((h, 4 * h), dtype=fr.dtype)
            stored[:, 3 * h:] = fr[:h, :h]
            stored[:, 2 * h:3 * h] = fr[:h, h:]
            stored[:, h:2 * h] = fr[h:, :h][::-1, ::-1]
            stored[:, :h] = fr[h:, h:][::-1, ::-1]
            head = (f"MQ1,{i + 1},{hb},4,{4 * h},{h},{dtype_str},2x2,2x2,"
                    f"{bd}").encode("ascii")
            f.write(head.ljust(hb, b"\x00"))
            f.write(enc(stored.reshape(1, -1)).tobytes())


@pytest.mark.parametrize("name", ["r1", "r6", "r12"])
def test_mib_quad_like_jax(name, tmp_path):
    dtype_str, bd, enc, lim = MIB_KINDS[name]
    h = 8
    frames = np.random.default_rng(3).integers(
        0, lim, (12, 2 * h, 2 * h)).astype(np.uint32)
    path = str(tmp_path / "quad.mib")
    _write_quad(path, frames, dtype_str, bd, enc, h)
    ds, _ = check_format("mib", path=path, nav_shape=(3, 4))
    assert tuple(ds.shape.sig) == (16, 16)
    assert np.array_equal(_all_frames(ds), frames.astype(ds.dtype))
    roi = np.zeros((3, 4), bool)
    roi[1, 1:3] = True
    check_format("mib", path=path, nav_shape=(3, 4), roi=roi,
                 sync_offset=-2)


def test_mib_several_files_and_sidecar(tmp_path):
    """Three files of one acquisition (the order from the headers'
    sequence numbers), the nav from the .hdr sidecar, a sig_shape that
    re-views the frames."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 4096, (12, 16, 16)).astype(np.uint32)
    hb = 384
    for k, name in enumerate(("acq_10.mib", "acq_2.mib", "acq_3.mib")):
        order = {0: 2, 1: 0, 2: 1}[k]
        with open(tmp_path / name, "wb") as f:
            for i in range(4):
                idx = order * 4 + i
                head = (f"MQ1,{idx + 1},{hb},1,16,16,R64,1x1,2x2,12"
                        ).encode("ascii")
                f.write(head.ljust(hb, b"\x00"))
                f.write(fe.encode_mib_r12(
                    frames[idx].reshape(1, -1)).tobytes())
    (tmp_path / "acq.hdr").write_text("ScanX: 4\nScanY: 3\n")
    hdr = str(tmp_path / "acq.hdr")
    ds, _ = check_format("mib", path=hdr)
    assert tuple(ds.shape) == (3, 4, 16, 16)
    assert np.array_equal(_all_frames(ds), frames)
    check_format("mib", path=str(tmp_path / "acq_2.mib"),
                 sig_shape=(8, 32), nav_shape=(12,), sync_offset=3)
    check_detect(hdr, "mib")


def test_mib_header_parsing_like_jax(tmp_path):
    from libertem_tpu.io.dataset import mib as jmib
    from libertem_tpu_torch.io.dataset import mib as pmib
    path = str(tmp_path / "a_001.mib")
    write_mib(path, "r24", n=2)
    assert pmib.parse_mib_header(path) == jmib.parse_mib_header(path)
    side = tmp_path / "a.hdr"
    side.write_text("Frames in Acquisition (Number): 12\n"
                    "Frames per Trigger (Number): 4\n")
    assert (pmib.parse_hdr_sidecar(str(side))
            == jmib.parse_hdr_sidecar(str(side)))
    assert (sorted(pmib.get_filenames(path))
            == sorted(jmib.get_filenames(path)))
    with pytest.raises(DataSetException):
        pmib.get_filenames(str(tmp_path / "a.txt"))


def test_mib_encoders_and_tile_decoders_like_jax():
    from libertem_tpu.io.dataset import mib as jmib
    from libertem_tpu_torch.io.dataset import mib as pmib
    rng = np.random.default_rng(6)
    for enc, n_bytes, lim in (("encode_u1", 256, 256),
                              ("encode_u2", 512, 65536),
                              ("encode_r1", 32, 2), ("encode_r6", 256, 64),
                              ("encode_r12", 512, 4096)):
        inp = rng.integers(0, lim, (3, 256)).astype(np.uint16)
        if enc in ("encode_u1", "encode_r6"):
            inp = inp.astype(np.uint8)
        a = np.zeros((3, n_bytes), np.uint8)
        b = np.zeros((3, n_bytes), np.uint8)
        getattr(pmib, enc)(inp, a)
        getattr(jmib, enc)(inp, b)
        assert np.array_equal(a, b), enc
    for dec, nbytes, dtype in (("decode_r1_swap", 32, np.uint8),
                               ("decode_r6_swap", 256, np.uint8),
                               ("decode_r12_swap", 512, np.uint16)):
        inp = rng.integers(0, 256, nbytes, dtype=np.uint8)
        a = np.zeros((2, 256), dtype)
        b = np.zeros((2, 256), dtype)
        getattr(pmib, dec)(inp, a, 1, dtype, None, None, None, None)
        getattr(jmib, dec)(inp, b, 1, dtype, None, None, None, None)
        assert np.array_equal(a, b), dec
    stream = rng.integers(0, 99, (2, 4, 16)).astype(np.uint16)
    assert np.array_equal(pmib.assemble_quad(stream),
                          jmib.assemble_quad(stream))


def test_mib_golden(tmp_path):
    """The JAX package's recorded MIB decodes (``mib_decode.npz``): the
    same bytes, the same pixels (r24 through SumUDF, as recorded)."""
    g = np.load(os.path.join(GOLDEN_DIR, "mib_decode.npz"))
    hb = 384
    encoders = {
        "r6": ("R64", 6, fe.encode_mib_r6),
        "r12": ("R64", 12, fe.encode_mib_r12),
        "r24": ("R64", 24, fe.encode_mib_r24),
        "u16": ("U16", 12, lambda fr: fr.astype(">u2").view(np.uint8)),
    }
    ctx = _ctx()
    for name, (dtype_str, bd, enc) in encoders.items():
        frames = g[f"{name}_frames"]
        n_f, hsz, real_w = frames.shape
        wsz = real_w * 2 if bd == 24 else real_w
        (tmp_path / name).mkdir()
        path = str(tmp_path / name / "acq1.mib")
        with open(path, "wb") as f:
            for i, fr in enumerate(frames):
                head = (f"MQ1,{i + 1},{hb},1,{wsz},{hsz},{dtype_str},"
                        f"1x1,2x2,{bd},").encode("ascii")
                f.write(head.ljust(hb, b"\x00"))
                f.write(enc(fr.reshape(1, -1)).tobytes())
        ds = ctx.load("mib", path=path, nav_shape=(n_f,))
        if bd == 24:
            got = ctx.run_udf(ds, port.SumUDF())["intensity"].data
            assert np.allclose(np.asarray(got, np.float64),
                               g[f"{name}_decoded"], rtol=1e-7), name
        else:
            got = ctx.run_udf(ds, port.PickUDF(),
                              roi=np.ones(n_f, bool))["intensity"].data
            assert np.array_equal(got, g[f"{name}_decoded"].astype(
                got.dtype)), name


def test_mib_faults(tmp_path):
    """The bad-header errors and the truncated file of
    ``tests/test_faults.py``."""
    bad = str(tmp_path / "bad.mib")
    with open(bad, "wb") as f:
        f.write(b"NOTMIB,1,384,1,16,16,U16,1x1,2x2,12" + b"\x00" * 800)
    with pytest.raises(DataSetException):
        _ctx().load("mib", path=bad)
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 4096, (10, 16, 16)).astype(np.uint16)
    path = str(tmp_path / "trunc.mib")
    hb = 384
    with open(path, "wb") as f:
        for i, fr in enumerate(frames):
            f.write(f"MQ1,{i+1},{hb},1,16,16,U16,1x1,2x2,12"
                    .encode().ljust(hb, b"\x00"))
            f.write(fr.astype(">u2").tobytes())
    with open(path, "rb+") as f:
        f.truncate(10 * (hb + 512) - 100)
    ds = _ctx().load("mib", path=path, nav_shape=(9,))
    assert ds.meta.image_count == 9
    roi = np.zeros(9, dtype=bool)
    roi[[0, 8]] = True
    res = _ctx().run_udf(ds, port.PickUDF(), roi=roi)
    assert np.array_equal(res["intensity"].data, frames[[0, 8]])


# -- K2IS -----------------------------------------------------------------------


def _k2is_frames(n, seed):
    return np.random.default_rng(seed).integers(
        0, 4096, (n, 1860, 2048)).astype(np.uint16)


@pytest.mark.parametrize("descending_x", [True, False])
def test_k2is_like_jax(descending_x, tmp_path):
    frames = _k2is_frames(4, 1)
    p0 = fe.write_k2is_sectors(str(tmp_path), frames,
                               descending_x=descending_x)
    ds, _ = check_format("k2is", path=p0, nav_shape=(2, 2))
    assert np.array_equal(_all_frames(ds), frames)
    check_detect(p0, "k2is", nav_shape=(2, 2))


def test_k2is_sync_offset_roi_and_sig_shape(tmp_path):
    frames = _k2is_frames(4, 2)
    p0 = fe.write_k2is_sectors(str(tmp_path), frames)
    roi = np.array([True, False, True, True])
    for so in (1, -1):
        check_format("k2is", path=p0, nav_shape=(4,), sync_offset=so,
                     roi=roi)
    check_format("k2is", path=p0, nav_shape=(4,), sig_shape=(3720, 1024),
                 udfs=False)
    with pytest.raises(DataSetException, match="detector size"):
        _ctx().load("k2is", path=p0, sig_shape=(10, 10))


def test_k2is_blocks_apart_on_disk(tmp_path):
    """A read whose blocks lie far apart in the sector files (frames 0
    and 3 of four, as one read) is read block by block: the same
    frames."""
    frames = _k2is_frames(4, 3)
    p0 = fe.write_k2is_sectors(str(tmp_path), frames)
    part = next(_ctx().load("k2is", path=p0, nav_shape=(4,),
                            num_partitions=1).get_partitions())
    rows = np.array([0, 3])
    part._offsets = part._offsets[rows].copy()
    part._xs = part._xs[rows].copy()
    part._ys = part._ys[rows].copy()
    offs = part._offsets[:, 0].reshape(-1)
    span = int(offs.max()) + fe.K2_BLOCK_SIZE - int(offs.min())
    assert span > (len(offs) + 2 * len(rows)) * fe.K2_BLOCK_SIZE
    got = np.empty((2, 1860, 2048), np.uint16)
    part._read_raw_frames(0, 2, got)
    assert np.array_equal(got, frames[rows])


def test_k2is_golden(tmp_path):
    g = np.load(os.path.join(GOLDEN_DIR, "fmt_decode.npz"))
    frames = ramp(2, 1860, 2048, 4096, seed=1).astype(np.uint16)
    p0 = fe.write_k2is_sectors(str(tmp_path), frames)
    assert dir_hash(str(tmp_path)) == str(g["k2is_files_sha"])
    ctx = _ctx()
    ds = ctx.load("k2is", path=p0, nav_shape=(2,))
    dec = ctx.run_udf(ds, port.PickUDF(),
                      roi=np.ones(2, bool))["intensity"].data
    dec = np.asarray(dec).astype(np.uint16)
    assert np.array_equal(dec[:, :32, :48], g["k2is_decoded_corner"])
    assert sha(dec) == str(g["k2is_decoded_sha"])


def _k2is_sectors_raw(tmp_path, frames):
    """Sector files written block by block as ``tests/test_faults.py``
    writes them."""
    h, w = fe.K2_SECTOR_SIZE
    bh, bw = fe.K2_BLOCK_SHAPE
    pad = fe.K2_DATA_SIZE - (bh * bw * 3 // 2)
    for s in range(fe.K2_NUM_SECTORS):
        with open(tmp_path / f"testfile{s}.bin", "wb") as f:
            for fi in range(len(frames)):
                for ys in (0, bh):
                    for xi in range(w // bw):
                        xs = xi * bw
                        block = frames[fi, ys:ys + bh,
                                       s * w + xs:s * w + xs + bw]
                        f.write(fe.k2is_block_header(100 + fi, xs, ys))
                        f.write(fe.pack_uint12_le(block))
                        f.write(b"\x00" * pad)


@pytest.mark.parametrize("fault", ["corrupt_header", "truncated"])
def test_k2is_faults(fault, tmp_path):
    """A corrupt block header or a truncated last block drops the frame
    it belongs to; the rest reads intact, as in the JAX package."""
    frames = _k2is_frames(2, 13)
    _k2is_sectors_raw(tmp_path, frames)
    if fault == "corrupt_header":
        with open(tmp_path / "testfile3.bin", "rb+") as f:
            f.seek(fe.K2_BLOCK_SIZE)
            f.write(b"\xde\xad\xbe\xef")
        kept = frames[1]
    else:
        bad = tmp_path / "testfile7.bin"
        size = bad.stat().st_size
        with open(bad, "rb+") as f:
            f.truncate(size - fe.K2_BLOCK_SIZE // 2)
        kept = frames[0]
    p0 = str(tmp_path / "testfile0.bin")
    ds, _ = check_format("k2is", path=p0, nav_shape=(1, 2), udfs=False)
    assert ds.meta.image_count == 1
    res = _ctx().run_udf(ds, port.SumSigUDF())
    got = np.asarray(res["intensity"].data).reshape(-1)
    assert np.isclose(got[0], kept.astype(np.float64).sum(), rtol=1e-4)
    assert got[1] == 0.0


def test_k2is_wrong_sector_count(tmp_path):
    frames = _k2is_frames(1, 4)
    p0 = fe.write_k2is_sectors(str(tmp_path), frames)
    os.remove(tmp_path / "testfile7.bin")
    with pytest.raises(DataSetException, match="sector files"):
        _ctx().load("k2is", path=p0)
    assert pio.detect(p0) == jio.detect(p0)


def test_k2is_nav_from_gtg(tmp_path):
    """The scan shape from the .gtg (a DM container of 'SI Dimensions'
    tags), with the frame before the first shutter-active one."""
    frames = _k2is_frames(5, 6)
    p0 = fe.write_k2is_sectors(str(tmp_path), frames)
    # the first frame without the shutter flag
    for s in range(fe.K2_NUM_SECTORS):
        with open(tmp_path / f"testfile{s}.bin", "rb+") as f:
            for b in range(32):
                f.seek(b * fe.K2_BLOCK_SIZE + 9)
                f.write(b"\x00")

    def tag(name, value):
        payload = (b"%%%%" + struct.pack(">i", 1) + struct.pack(">i", 3)
                   + struct.pack("<i", value))
        return (bytes([0x15]) + struct.pack(">h", len(name))
                + name.encode() + payload)

    def group(name, children):
        return (bytes([0x14]) + struct.pack(">h", len(name)) + name.encode()
                + bytes([1, 0]) + struct.pack(">i", len(children))
                + b"".join(children))

    root = bytes([1, 0]) + struct.pack(">i", 1) + group(
        "SI Dimensions", [tag("Size X", 2), tag("Size Y", 2)])
    with open(tmp_path / "testfile.gtg", "wb") as f:
        f.write(struct.pack(">iii", 3, len(root), 1) + root)
    gtg = str(tmp_path / "testfile.gtg")
    ds, jds = check_format("k2is", path=gtg, udfs=False)
    assert tuple(ds.shape.nav) == (2, 2)
    check_detect(gtg, "k2is")
