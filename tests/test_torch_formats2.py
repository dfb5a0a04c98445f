"""The port's other detector formats against the JAX package on the CPU:
FRMS6 (raw and dark-corrected), SEQ (with and without its sidecars),
TVIPS, BLO, EMPAD, NPY, MRC, SER and DM3/DM4, with the recorded goldens
of ``fmt_decode.npz`` and the bad-header errors of
``tests/test_faults.py``.  Helpers and tolerances are those of
``tests/test_torch_formats.py``; SER and DM files are written with
``tests/test_formats2.py``'s writers, MRC and NPY with numpy and
struct.
"""
import os
import struct

import numpy as np
import pytest
import torch

import format_encoders as fe
import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from format_encoders import dir_hash, ramp, sha
from test_formats2 import _write_dm3, _write_dm4, _write_ser
from test_torch_formats import (
    GOLDEN_DIR,
    _all_frames,
    _ctx,
    _jctx,
    check_detect,
    check_format,
)

import libertem_tpu_torch as port
from libertem_tpu_torch.io.dataset.base import DataSetException

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(GOLDEN_DIR, "fmt_decode.npz"))


def _u16(shape, seed, lim=4096):
    return np.random.default_rng(seed).integers(0, lim, shape).astype(
        np.uint16)


def _pick_all(ds, n):
    ctx = _ctx()
    return np.asarray(ctx.run_udf(ds, port.PickUDF(),
                                  roi=np.ones(n, bool))["intensity"].data)


# -- FRMS6 ---------------------------------------------------------------------


def _write_frms6_acq(tmp_path, dark, sig):
    fe.write_frms6(str(tmp_path / "acq_000.frms6"), dark)
    fe.write_frms6(str(tmp_path / "acq_001.frms6"), sig)
    with open(tmp_path / "acq.hdr", "w") as f:
        f.write(
            "[measurementInfo]\n"
            "darkframes = 2\n"
            "signalframes = 12\n"
            "gain = 1\n"
            "dwelltimemicroseconds = 10\n"
            "stemimagesize = 4x3\n"
            'readoutmode = "bin: 1, windowing: 1 x 1"\n'
        )
    return str(tmp_path / "acq_001.frms6")


def test_frms6_golden(tmp_path, gold):
    dark = ramp(2, 6, 16, 50, seed=2).astype(np.uint16)
    sig = (ramp(12, 6, 16, 900, seed=3) + 100).astype(np.uint16)
    path = _write_frms6_acq(tmp_path, dark, sig)
    assert dir_hash(str(tmp_path)) == str(gold["frms6_files_sha"])
    ds = _ctx().load("frms6", path=path, enable_offset_correction=False)
    assert np.array_equal(_pick_all(ds, 12).astype(np.uint16),
                          gold["frms6_raw_decoded"])
    # the dataset's dark frame applies without being passed
    ds_c = _ctx().load("frms6", path=path, enable_offset_correction=True)
    assert np.allclose(_pick_all(ds_c, 12),
                       gold["frms6_corrected_decoded"].astype(np.float64),
                       atol=1e-3)


@pytest.mark.parametrize("so", [0, 3, -3])
def test_frms6_like_jax(so, tmp_path):
    """Frames, UDFs raw and with the dark frame and a gain map of the
    dataset's own correction data, against the JAX package's."""
    dark = _u16((3, 8, 32), 1, 50)
    sig = _u16((12, 8, 32), 2) + 100
    path = _write_frms6_acq(tmp_path, dark, sig)
    gain = (1 + np.random.default_rng(3).random((16, 16))).astype(
        np.float32)
    np.save(tmp_path / "gain.npy", gain)
    kw = dict(path=path, nav_shape=(3, 4), sync_offset=so,
              gain_map_path=str(tmp_path / "gain.npy"))
    ds, jds = check_format("frms6", **kw)
    ours, theirs = ds.get_correction_data(), jds.get_correction_data()
    assert np.array_equal(ours.dark, theirs.dark)
    assert np.array_equal(ours.gain, theirs.gain)
    roi = np.random.default_rng(4).random((3, 4)) < 0.6
    res = _ctx().run_udf(ds, port.SumUDF(), roi=roi, corrections=ours)
    jres = _jctx().run_udf(jds, libertem_tpu.udf.SumUDF(),
                           roi=roi, corrections=theirs)
    assert np.allclose(res["intensity"].data, jres["intensity"].data,
                       rtol=1e-5, atol=1e-5 * float(
                           np.abs(jres["intensity"].data).max()))
    check_detect(path, "frms6")


def test_frms6_helpers_like_jax():
    from libertem_tpu.io.dataset import frms6 as jf
    from libertem_tpu_torch.io.dataset import frms6 as pf
    folded = _u16((3, 4, 12), 5)
    assert np.array_equal(pf.unfold(folded), jf.unfold(folded))
    for y in range(8):
        assert pf._map_y(y, 6, 1, 8) == jf._map_y(y, 6, 1, 8)
    rows = _u16((4, 12), 6).view(np.uint8).reshape(4, -1)
    a = np.zeros((1, 8, 6), np.uint16)
    b = np.zeros((1, 8, 6), np.uint16)
    dec_a = pf.FRMS6Decoder(1).get_decode(np.dtype("<u2"), None)
    dec_b = jf.FRMS6Decoder(1).get_decode(np.dtype("<u2"), None)
    for i in range(4):
        for dec, out in ((dec_a, a), (dec_b, b)):
            dec(rows[i][:12], out.reshape(1, -1), i, np.dtype("<u2"),
                None, (0, 4, 0), (1, 4, 6), (8, 6))
    assert np.array_equal(a, b)


# -- SEQ -----------------------------------------------------------------------


def test_seq_golden(tmp_path, gold):
    frames = ramp(9, 12, 16, 4096, seed=4).astype(np.uint16)
    fe.write_seq(str(tmp_path / "t.seq"), frames)
    assert dir_hash(str(tmp_path)) == str(gold["seq_files_sha"])
    ds = _ctx().load("seq", path=str(tmp_path / "t.seq"), nav_shape=(3, 3))
    assert np.array_equal(_pick_all(ds, 9).astype(np.uint16),
                          gold["seq_decoded"])


@pytest.mark.parametrize("so", [0, 4, -4])
def test_seq_like_jax(so, tmp_path):
    frames = _u16((12, 16, 16), 7)
    path = str(tmp_path / "scan.seq")
    fe.write_seq(path, frames)
    ds, _ = check_format("seq", path=path, nav_shape=(3, 4), sync_offset=so)
    if so == 0:
        assert np.array_equal(_all_frames(ds), frames)
    check_detect(path, "seq")


def test_seq_sidecars_like_jax(tmp_path):
    """The XML bad-pixel map with its binary metadata, and dark and gain
    sidecars (.npy and .mrc), into the CorrectionSet as the JAX
    package's; a corrected run against the JAX package's."""
    w, h, n = 16, 12, 12
    frames = _u16((n, h, w), 8)
    path = str(tmp_path / "scan.seq")
    fe.write_seq(path, frames)
    xml = (
        '<?xml version="1.0"?><Configuration><BadPixels>'
        f'<BadPixelMap Rows="{h}" Columns="{w}">'
        '<Defect Row="3"/><Defect Columns="5-6"/>'
        '<Defect Row="1" Column="2"/>'
        "</BadPixelMap>"
        f'<BadPixelMap Rows="{h // 2}" Columns="{w // 2}" Binning="2">'
        '<Defect Row="1"/></BadPixelMap>'
        "</BadPixels></Configuration>"
    )
    (tmp_path / "scan.seq.Config.Metadata.xml").write_text(xml)
    meta = bytearray(282) + struct.pack(
        "iiiiiiiiiii?", 0, 1, w, h, 0, 0, 1, 16, 100, 0, 0, False)
    (tmp_path / "scan.seq.metadata").write_bytes(bytes(meta))
    dark = np.random.default_rng(9).random((h, w)).astype(np.float32)
    np.save(tmp_path / "scan.seq.dark.npy", dark)
    head = bytearray(1024)
    head[0:16] = struct.pack("<4i", w, h, 1, 2)
    gain = (1 + np.random.default_rng(10).random((h, w))).astype("<f4")
    (tmp_path / "scan.seq.gain.mrc").write_bytes(bytes(head)
                                                 + gain.tobytes())
    ds, jds = check_format("seq", path=path, nav_shape=(3, 4))
    ours, theirs = ds.get_correction_data(), jds.get_correction_data()
    assert np.array_equal(ours.dark, theirs.dark)
    assert np.array_equal(ours.gain, theirs.gain)
    assert np.array_equal(ours.excluded_coords, theirs.excluded_coords)
    assert len(ours.excluded_coords) == w + 2 * h - 2 + 1
    res = _ctx().run_udf(ds, [port.SumUDF(), port.SumSigUDF()],
                         corrections=ours)
    jres = _jctx().run_udf(jds, [libertem_tpu.udf.SumUDF(),
                                 libertem_tpu.udf.SumSigUDF()],
                           corrections=theirs)
    for o, t in zip(res, jres):
        want = np.asarray(t["intensity"].data, np.float64)
        assert np.allclose(o["intensity"].data, want, rtol=1e-5,
                           atol=1e-5 * np.abs(want).max())


def test_seq_xml_helpers_like_jax():
    import xml.etree.ElementTree as ET
    from libertem_tpu.io.dataset import seq as js
    from libertem_tpu_torch.io.dataset import seq as ps
    root = ET.fromstring(
        '<r><BadPixelMap Rows="8" Columns="10"><Defect Rows="1-2"/>'
        '<Defect Column="4"/><Defect Row="5" Column="7"/></BadPixelMap>'
        '<BadPixelMap Rows="4" Columns="5" Binning="2"><Defect Row="0"/>'
        "</BadPixelMap></r>")
    for binning in (1, 2):
        md = {"HardwareBinning": binning, "UnbinnedFrameSizeY": 6,
              "UnbinnedFrameSizeX": 8, "OffsetY": 0, "OffsetX": 2}
        assert np.array_equal(ps.xml_processing(root, md),
                              np.asarray(js.xml_processing(root, md)))
    arr = np.arange(100).reshape(10, 10)
    assert np.array_equal(ps.array_cropping(arr, (10, 10), (5, 4), (2, 3)),
                          js.array_cropping(arr, (10, 10), (5, 4), (2, 3)))


def test_seq_faults(tmp_path):
    path = str(tmp_path / "bad.seq")
    with open(path, "wb") as f:
        f.write(b"\x00" * 9000)
    with pytest.raises(DataSetException):
        _ctx().load("seq", path=path)


# -- TVIPS, BLO, EMPAD ---------------------------------------------------------


def test_tvips_golden(tmp_path, gold):
    frames = ramp(8, 14, 16, 60000, seed=5).astype(np.uint16)
    fe.write_tvips(str(tmp_path / "ser_000.tvips"), frames)
    assert dir_hash(str(tmp_path)) == str(gold["tvips_files_sha"])
    ds = _ctx().load("tvips", path=str(tmp_path / "ser_000.tvips"),
                     nav_shape=(2, 4))
    assert np.array_equal(_pick_all(ds, 8).astype(np.uint16),
                          gold["tvips_decoded"])


@pytest.mark.parametrize("version,img_header", [(1, 12), (2, 32)])
def test_tvips_series_like_jax(version, img_header, tmp_path):
    """A series over two files (the second without the series header),
    version 1 and 2 frame headers, under a sync offset and a roi."""
    frames = _u16((12, 16, 16), 11, 60000)
    first = str(tmp_path / "ser_000.tvips")
    fe.write_tvips(first, frames[:7], img_header=img_header,
                   version=version)
    with open(tmp_path / "ser_001.tvips", "wb") as f:
        for fr in frames[7:]:
            f.write(b"\x00" * (12 if version == 1 else img_header))
            f.write(fr.astype("<u2").tobytes())
    ds, _ = check_format("tvips", path=first, nav_shape=(3, 4))
    assert np.array_equal(_all_frames(ds), frames)
    roi = np.random.default_rng(12).random((3, 4)) < 0.5
    check_format("tvips", path=first, nav_shape=(3, 4), sync_offset=-2,
                 roi=roi)
    check_detect(first, "tvips")


def test_blo_golden(tmp_path, gold):
    frames = ramp(12, 16, 16, 256, seed=6).astype(np.uint8)
    fe.write_blo(str(tmp_path / "t.blo"), frames, nav=(3, 4))
    assert dir_hash(str(tmp_path)) == str(gold["blo_files_sha"])
    ds = _ctx().load("blo", path=str(tmp_path / "t.blo"))
    assert np.array_equal(_pick_all(ds, 12).astype(np.uint8),
                          gold["blo_decoded"])


@pytest.mark.parametrize("so", [0, 5, -5])
def test_blo_like_jax(so, tmp_path):
    frames = np.random.default_rng(13).integers(
        0, 256, (12, 16, 16)).astype(np.uint8)
    path = str(tmp_path / "t.blo")
    fe.write_blo(path, frames, nav=(3, 4))
    ds, _ = check_format("blo", path=path, sync_offset=so)
    if so == 0:
        assert np.array_equal(_all_frames(ds), frames)
    check_detect(path, "blo")


def test_blo_faults(tmp_path):
    hdr = np.zeros(1, dtype=fe.blo_header_dtype())
    hdr["MAGIC"] = 999
    path = str(tmp_path / "bad.blo")
    with open(path, "wb") as f:
        f.write(hdr.tobytes().ljust(2048, b"\x00"))
    with pytest.raises(DataSetException):
        _ctx().load("blo", path=path)


def test_empad_golden(tmp_path, gold):
    frames = ramp(24, 128, 128, 100000, seed=7).astype(np.float32) / 7.0
    xml = fe.write_empad(str(tmp_path), frames, nav=(4, 6))
    assert dir_hash(str(tmp_path)) == str(gold["empad_files_sha"])
    ds = _ctx().load("empad", path=xml)
    dec = _pick_all(ds, 24).astype(np.float32)
    assert np.array_equal(dec[:, :16, :16], gold["empad_decoded_corner"])
    assert sha(dec) == str(gold["empad_decoded_sha"])


def test_empad_like_jax(tmp_path):
    frames = np.random.default_rng(14).normal(
        5, 2, (12, 128, 128)).astype(np.float32)
    xml = fe.write_empad(str(tmp_path), frames, nav=(3, 4))
    ds, _ = check_format("empad", path=xml)
    assert np.array_equal(_all_frames(ds), frames)
    check_format("empad", path=xml, sync_offset=-3,
                 roi=np.eye(3, 4, dtype=bool))
    check_format("empad", path=str(tmp_path / "scan.raw"),
                 nav_shape=(12,), udfs=False)
    check_detect(xml, "empad")


# -- NPY, MRC, SER, DM ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["<u2", ">u2", "<f4", ">i4"])
def test_npy_like_jax(dtype, tmp_path):
    data = np.random.default_rng(15).integers(
        0, 3000, (3, 4, 16, 16)).astype(dtype)
    path = str(tmp_path / "d.npy")
    np.save(path, data)
    ds, _ = check_format("npy", path=path, sync_offset=2)
    check_format("npy", path=path, sig_shape=(8, 32), nav_shape=(12,),
                 udfs=False)
    ds = check_detect(path, "npy")
    assert np.array_equal(_all_frames(ds), data.reshape(12, 16, 16))


def test_npy_faults(tmp_path):
    path = str(tmp_path / "f.npy")
    np.save(path, np.asfortranarray(np.zeros((3, 4, 5, 6), np.float32)))
    with pytest.raises(DataSetException, match="fortran"):
        _ctx().load("npy", path=path)
    with pytest.raises(DataSetException, match="disagree"):
        _ctx().load("npy", path="nowhere.npy", sig_dims=1,
                    sig_shape=(2, 2))


def _write_mrc(path, frames, mode, nsymbt=0, nz=None):
    n, h, w = frames.shape
    head = bytearray(1024)
    head[0:16] = struct.pack("<4i", w, h, n if nz is None else nz, mode)
    head[92:96] = struct.pack("<i", nsymbt)
    with open(path, "wb") as f:
        f.write(bytes(head) + b"\x07" * nsymbt + frames.tobytes())


@pytest.mark.parametrize("mode,dtype", [(1, "<i2"), (2, "<f4"),
                                        (6, "<u2")])
def test_mrc_like_jax(mode, dtype, tmp_path):
    frames = np.random.default_rng(16).integers(
        0, 2000, (12, 16, 16)).astype(dtype)
    path = str(tmp_path / "t.mrc")
    _write_mrc(path, frames, mode, nsymbt=64)
    ds, _ = check_format("mrc", path=path, nav_shape=(3, 4), sync_offset=1)
    check_detect(path, "mrc")
    # a header that claims more frames than the file holds
    short = str(tmp_path / "short.mrc")
    _write_mrc(short, frames[:10], mode, nz=12)
    ds, _ = check_format("mrc", path=short, nav_shape=(3, 4))
    assert ds.meta.image_count == 10


def test_mrc_faults(tmp_path):
    path = str(tmp_path / "bad.mrc")
    with open(path, "wb") as f:
        f.write(b"\x00" * 100)
    with pytest.raises(DataSetException):
        _ctx().load("mrc", path=path)


def test_ser_like_jax(tmp_path):
    frames = _u16((12, 16, 16), 17)
    path = str(tmp_path / "t.ser")
    _write_ser(path, frames)
    ds, _ = check_format("ser", path=path, nav_shape=(3, 4))
    assert np.array_equal(_all_frames(ds), frames)
    check_format("ser", path=path, nav_shape=(3, 4), sync_offset=-2,
                 roi=np.random.default_rng(18).random((3, 4)) < 0.5)
    check_detect(path, "ser")


def test_ser_elements_apart(tmp_path):
    """Elements at uneven offsets are read one by one: the same
    frames."""
    frames = _u16((4, 8, 8), 19)
    path = str(tmp_path / "t.ser")
    _write_ser(path, frames)
    ds = _ctx().load("ser", path=path, nav_shape=(4,))
    index = dict(ds._index)
    offsets = index["offsets"].copy()
    with open(path, "rb") as f:
        raw = f.read()
    elem = 50 + 8 * 8 * 2
    # element 2 moved to the end of the file, 16 bytes past the others
    moved = str(tmp_path / "moved.ser")
    with open(moved, "wb") as f:
        f.write(raw + b"\x00" * 16 + raw[offsets[2]:offsets[2] + elem])
    offsets[2] = len(raw) + 16
    index["offsets"] = offsets
    part = type(next(ds.get_partitions()))(moved, index, ds.meta, 0, 4)
    assert part._records is None
    got = np.empty((4, 8, 8), np.uint16)
    part._read_raw_frames(0, 4, got)
    assert np.array_equal(got, frames)


def test_ser_faults(tmp_path):
    path = str(tmp_path / "bad.ser")
    with open(path, "wb") as f:
        f.write(b"\xff" * 64)
    with pytest.raises(DataSetException):
        _ctx().load("ser", path=path)


@pytest.mark.parametrize("writer", ["dm4", "dm3"])
def test_dm_like_jax(writer, tmp_path):
    data = _u16((3, 4, 16, 16), 20)
    path = str(tmp_path / f"t.{writer}")
    if writer == "dm4":
        _write_dm4(path, data, thumbnail=_u16((8, 8), 21))
    else:
        _write_dm3(path, data.reshape(12, 16, 16))
    kw = dict(path=path, force_c_order=True)
    ds, _ = check_format("dm", **kw)
    assert np.array_equal(_all_frames(ds), data.reshape(12, 16, 16))
    check_format("dm", nav_shape=(12,), sync_offset=-3, **kw)
    check_detect(path, "dm", force_c_order=True)


def test_dm_stack_like_jax(tmp_path):
    data = _u16((6, 16, 16), 22)
    files = []
    for i in range(3):
        p = str(tmp_path / f"f{i}.dm4")
        _write_dm4(p, data[2 * i:2 * i + 2])
        files.append(p)
    ds, _ = check_format("dm", files=files, nav_shape=(2, 3))
    assert type(ds).__name__ == "StackedDMDataSet"
    assert np.array_equal(_all_frames(ds), data)


def test_dm_faults(tmp_path):
    path = str(tmp_path / "bad.dm4")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(DataSetException):
        _ctx().load("dm", path=path)
    data = _u16((2, 2, 8, 8), 23)
    good = str(tmp_path / "t.dm4")
    _write_dm4(good, data)
    with pytest.raises(DataSetException, match="sig-major"):
        _ctx().load("dm", path=good)
