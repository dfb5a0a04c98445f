"""The port's host decoders (``libertem_tpu_torch/ops/decode.py``, the
C++ of ``csrc/decode.cpp`` built with g++) against their plain numpy
versions and the JAX package's ``libertem_tpu.native``, bit for bit,
on seeded random bytes; the build (a failed compile raises with the
compiler's output; workers that build at once); and the decode-function
protocol (``io/dataset/decode.py``) and ``FileTree``
(``io/dataset/utils.py``) against the JAX package's.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import libertem_tpu.io.dataset.decode as jdec
import libertem_tpu.native as jnative
from libertem_tpu.io.dataset.utils import FileTree as JFileTree

import libertem_tpu_torch.io.dataset.decode as pdec
from libertem_tpu_torch.io.dataset.base import byteswap as slot_byteswap
from libertem_tpu_torch.io.dataset.utils import FileTree
from libertem_tpu_torch.ops import build, decode

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PIX = 64 * 48
# bytes of one frame's payload
PAYLOAD = {"r1": N_PIX // 8, "r6": N_PIX, "r12": 2 * N_PIX,
           "r24": 4 * N_PIX}


def _bytes(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", ["r1", "r6", "r12", "r24"])
@pytest.mark.parametrize("n", [1, 5])
def test_mib_decoders_bits(name, n):
    raw = _bytes((n, PAYLOAD[name]), seed=n)
    ours = getattr(decode, f"decode_{name}")(raw, N_PIX)
    plain = getattr(decode, f"decode_{name}_plain")(raw, N_PIX)
    theirs = getattr(jnative, f"decode_{name}")(raw, N_PIX)
    assert ours.dtype == theirs.dtype == plain.dtype
    assert ours.shape == theirs.shape == (n, N_PIX)
    assert np.array_equal(ours, plain)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("name", ["r1", "r6", "r12", "r24"])
def test_mib_decoders_from_records_into_out(name):
    """Payloads straight out of whole records (a 384-byte header before
    each), into a given destination: the same bits as the contiguous
    payloads."""
    n, head = 4, 384
    records = _bytes((n, head + PAYLOAD[name]), seed=7)
    rows = records[:, head:]
    want = getattr(decode, f"decode_{name}_plain")(
        np.ascontiguousarray(rows), N_PIX)
    out = np.full_like(want, 7)
    calls = decode.stats["calls"]
    got = getattr(decode, f"decode_{name}")(rows, N_PIX, out=out)
    assert got is out
    assert decode.stats["calls"] == calls + 1
    assert np.array_equal(out, want)


@pytest.mark.parametrize("name,group", [("r1", 64), ("r6", 8), ("r12", 4),
                                        ("r24", 4)])
def test_mib_decoders_group_errors(name, group):
    """A frame size that is not a whole number of pixel groups raises
    ValueError, as in the JAX package."""
    n_pix = group * 3 + group // 2
    raw = _bytes((2, 4 * n_pix))
    with pytest.raises(ValueError, match="multiple of"):
        getattr(jnative, f"decode_{name}")(raw, n_pix)
    with pytest.raises(ValueError, match="multiple of"):
        getattr(decode, f"decode_{name}")(raw, n_pix)
    with pytest.raises(ValueError, match="multiple of"):
        getattr(decode, f"decode_{name}_plain")(raw, n_pix)


@pytest.mark.parametrize("nbytes", [3, 3 * 930 * 8, 3 * 930 * 8 * 5 + 2])
def test_uint12_le_bits(nbytes):
    raw = _bytes(nbytes, seed=nbytes)
    ours = decode.decode_uint12_le(raw)
    assert np.array_equal(ours, decode.decode_uint12_le_plain(raw))
    assert np.array_equal(ours, jnative.decode_uint12_le(raw))


@pytest.mark.parametrize("dtype", [">u2", ">i2", ">u4", ">f4", ">i8", ">f8",
                                   ">c8", "<u2", "u1"])
@pytest.mark.parametrize("n", [1, 3])
def test_byteswap_bits(dtype, n):
    raw = _bytes((n, 6, 8 * np.dtype(dtype).itemsize), seed=n)
    arr = raw.view(dtype)
    ours = decode.byteswap(arr)
    theirs = jnative.byteswap(arr)
    plain = decode.byteswap_plain(arr)
    assert ours.dtype == theirs.dtype == plain.dtype
    assert ours.dtype.isnative
    assert ours.tobytes() == theirs.tobytes() == plain.tobytes()


@pytest.mark.parametrize("dtype", [">u2", ">u4", ">f8"])
def test_slot_byteswap_in_place(dtype):
    """The raw reader's swap: in place in the destination, bit equal to
    the JAX package's swap into a new array; native data untouched."""
    raw = _bytes((4, 16 * np.dtype(dtype).itemsize), seed=3)
    slot = raw.copy().view(np.dtype(dtype).newbyteorder("="))
    ptr = slot.ctypes.data
    slot_byteswap(slot[1:3], np.dtype(dtype))
    want = raw.view(dtype)
    assert slot.ctypes.data == ptr
    assert slot[1:3].tobytes() == jnative.byteswap(want[1:3]).tobytes()
    assert slot[0].tobytes() == raw[0].tobytes()
    native = slot.copy()
    slot_byteswap(slot, slot.dtype)
    assert slot.tobytes() == native.tobytes()


def test_k2is_place_blocks():
    """Blocks of 12-bit pairs placed straight into frames: the frames
    the per-block decode and a numpy placement give."""
    rng = np.random.default_rng(4)
    bh, bw, n_frames, h, w = 6, 4, 2, 12, 8
    need = bh * bw * 3 // 2
    blocks = [(f, y, x) for f in range(n_frames) for y in (0, 6)
              for x in (0, 4)]
    cover = rng.integers(0, 256, len(blocks) * (need + 5), dtype=np.uint8)
    offs = np.arange(len(blocks)) * (need + 5) + 2
    want = np.zeros((n_frames, h, w), np.uint16)
    for (f, y, x), off in zip(blocks, offs):
        vals = jnative.decode_uint12_le(cover[off:off + need])
        want[f, y:y + bh, x:x + bw] = vals.reshape(bh, bw)
    got = np.zeros_like(want)
    f, y, x = (np.array(v) for v in zip(*blocks))
    decode.k2is_place_blocks(cover, offs, f, y, x, (bh, bw), got)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        decode.k2is_place_blocks(cover, offs, f, y + 1, x, (bh, bw), got)


def test_library_is_the_ports_own_build():
    """A fresh process that imports the port and decodes maps the port's
    library from ``build/`` and neither the JAX package's
    ``_decode.so`` nor any of its modules."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from libertem_tpu_torch.ops import build, decode
        out = decode.decode_r12(np.zeros((1, 32), np.uint8), 16)
        maps = open("/proc/self/maps").read()
        lib = str(build.library_path("decode"))
        assert lib in maps, lib
        assert str(build.BUILD_DIR) in lib
        assert "_decode.so" not in maps
        bad = [k for k in sys.modules if k == "jax" or k.startswith(
            ("jax.", "libertem_tpu.")) or k == "libertem_tpu"]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ refuses raises RuntimeError with
    the compiler's message, and leaves no library behind."""
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        build.build(["broken"])
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_builds_at_once_in_several_processes(tmp_path):
    """Processes that build the same library at once each compile to a
    name of their own and move it into place: all of them load it."""
    code = textwrap.dedent(f"""
        import pathlib
        from libertem_tpu_torch.ops import build
        build.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        lib = build.load("decode")
        assert lib.decode_r6 is not None
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env) for _ in range(3)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    assert len(list(tmp_path.glob("libdecode-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


# -- the decode-function protocol and FileTree -----------------------------


@pytest.mark.parametrize("name,size,dtype", [
    ("default_decode", 2, "<u2"), ("decode_swap_2", 2, "<u2"),
    ("decode_swap_4", 4, "<u4"), ("decode_swap_8", 8, "<u8"),
    ("decode_swap_only_2", 2, "<u2"), ("decode_swap_only_4", 4, "<u4"),
    ("decode_swap_only_8", 8, "<u8"),
])
def test_decode_functions_like_jax(name, size, dtype):
    inp = _bytes(10 * size, seed=size)
    ours = np.zeros((2, 10), dtype)
    theirs = np.zeros((2, 10), dtype)
    args = (np.dtype(dtype), None, None, None, None)
    getattr(pdec, name)(inp, ours, 1, *args)
    getattr(jdec, name)(inp, theirs, 1, *args)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("native,read", [("<u2", "<u2"), ("<u2", ">u2"),
                                         (">i4", "<i4"), ("<u1", ">u1")])
def test_dtype_conversion_decoder_like_jax(native, read):
    ours, theirs = pdec.DtypeConversionDecoder(), jdec.DtypeConversionDecoder()
    assert (ours.get_native_dtype(native, read)
            == theirs.get_native_dtype(native, read))
    assert (ours.get_decode(native, read).__name__
            == theirs.get_decode(native, read).__name__)
    with pytest.raises(NotImplementedError):
        ours.get_decode(">f4", "<f4")


def test_file_tree_like_jax():
    class F:
        def __init__(self, a, b):
            self.start_idx, self.end_idx = a, b

    files = [F(0, 4), F(4, 9), F(9, 10)]
    ours, theirs = FileTree.make(files), JFileTree.make(files)
    for frame in range(10):
        assert ours.search_start(frame) == theirs.search_start(frame)
    with pytest.raises(KeyError):
        ours.search_start(10)
    assert str(ours) == str(theirs)
    with pytest.raises(ValueError):
        FileTree.make([F(3, 3)])
