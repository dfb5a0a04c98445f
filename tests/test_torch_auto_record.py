"""``Context.map`` (AutoUDF) and RecordUDF against the JAX package's,
on the CPU.

The same seeded u16 Poisson(8) scan (nav 6x7, sig 12x10, 3 partitions)
goes through both packages.  ``map`` with a function written for the
device (torch in the port, jnp in the JAX package), one written with
numpy, one returning Python objects, and an AutoUDF with ``monitor``:
the same values (rtol 1e-6 for float results) and the same dtypes
(frames are float32 in both; a 64-bit torch result is declared in 32
bits, as jnp computes it).
RecordUDF: the ``.npy`` files the two packages write are equal byte
for byte, with and without a roi, with ``_dtype``, and after a patched
filename.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.udf.auto import AutoUDF as JaxAutoUDF
from libertem_tpu.udf.record import RecordUDF as JaxRecordUDF

import libertem_tpu_torch as port
from libertem_tpu_torch.udf.auto import AutoUDF

torch.set_num_threads(1)

NAV, SIG = (6, 7), (12, 10)


def _data(dtype=np.uint16):
    return np.random.default_rng(0).poisson(8.0, NAV + SIG).astype(dtype)


@pytest.fixture(scope="module")
def ctxs():
    jctx = JaxContext(executor=InlineJobExecutor())
    pctx = port.Context(device="cpu")
    data = _data()
    return (jctx, jctx.load("memory", data=data, sig_dims=2,
                            num_partitions=3),
            pctx, pctx.load("memory", data=data, sig_dims=2,
                            num_partitions=3))


def _roi():
    roi = np.zeros(NAV, dtype=bool)
    roi[1:4, 2:6] = True
    roi[5, 0] = True
    return roi


# name -> (port f, JAX f, the port's engine)
FUNCTIONS = {
    "sum": (lambda f: f.sum(), lambda f: f.sum(), "device"),
    "column sums": (lambda f: f.sum(0), lambda f: f.sum(0), "device"),
    "identity": (lambda f: f, lambda f: f, "device"),
    "float stats": (
        lambda f: torch.stack([f.float().mean(), f.float().amax() / 2]),
        lambda f: jnp.stack([f.astype(jnp.float32).mean(),
                             f.astype(jnp.float32).max() / 2]),
        "device",
    ),
    "scaled": (lambda f: f * 1.5, lambda f: f * 1.5, "device"),
    # 64-bit results: int32 and float32 in the JAX package
    "count": (lambda f: (f > 8).sum(), lambda f: (f > 8).sum(), "device"),
    "double": (lambda f: f.double().sum(0),
               lambda f: f.astype(jnp.float64).sum(0), "device"),
    "numpy": (lambda f: np.asarray(f).astype(np.float64).std(axis=1),
              lambda f: np.asarray(f).astype(np.float64).std(axis=1),
              "host"),
    "numpy sum": (lambda f: np.asarray(f).sum(),
                  lambda f: np.asarray(f).sum(), "host"),
}


@pytest.mark.parametrize("with_roi", [False, True])
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_map_matches_jax(ctxs, name, with_roi):
    jctx, jds, pctx, pds = ctxs
    f_port, f_jax, engine = FUNCTIONS[name]
    roi = _roi() if with_roi else None
    ours = pctx.map(pds, f_port, roi=roi)
    theirs = jctx.map(jds, f_jax, roi=roi)
    assert pctx.run_info["engines"] == [engine]
    assert ours.data.dtype == theirs.data.dtype, name
    assert ours.data.shape == theirs.data.shape
    if ours.data.dtype.kind == "f":
        np.testing.assert_allclose(ours.data, theirs.data, rtol=1e-6)
    else:
        np.testing.assert_array_equal(ours.data, theirs.data)
    assert np.array_equal(ours.valid_mask, theirs.valid_mask)


def test_map_objects_match_jax(ctxs):
    """A function returning Python objects: an object-dtype nav
    buffer, on the host engine."""
    jctx, jds, pctx, pds = ctxs

    def f(frame):
        return {"max": int(np.max(frame)), "label": "frame"}

    ours = pctx.map(pds, f)
    theirs = jctx.map(jds, f)
    assert pctx.run_info["engines"] == ["host"]
    assert ours.data.dtype == theirs.data.dtype == object
    assert ours.data.shape == theirs.data.shape == NAV
    assert [d for d in ours.data.reshape(-1)] == [
        d for d in theirs.data.reshape(-1)]


@pytest.mark.parametrize("name", ["sum", "numpy"])
def test_auto_monitor_matches_jax(ctxs, name):
    """``monitor=True``: the result of a frame of the last partition,
    beside the nav results."""
    jctx, jds, pctx, pds = ctxs
    f_port, f_jax, engine = FUNCTIONS[name]
    ours = pctx.run_udf(pds, AutoUDF(f=f_port, monitor=True))
    theirs = jctx.run_udf(jds, JaxAutoUDF(f=f_jax, monitor=True))
    assert pctx.run_info["engines"] == [engine]
    assert set(ours) == set(theirs) == {"result", "monitor"}
    for key in ("result", "monitor"):
        assert ours[key].data.dtype == theirs[key].data.dtype
        np.testing.assert_allclose(ours[key].data.astype(np.float64),
                                   theirs[key].data.astype(np.float64),
                                   rtol=1e-6)


def test_auto_monitor_needs_arrays(ctxs):
    _, _, pctx, pds = ctxs
    with pytest.raises(ValueError, match="monitor"):
        pctx.run_udf(pds, AutoUDF(f=lambda f: {"a": 1}, monitor=True))


def test_auto_probe_on_meta_tensors(ctxs):
    """The probe runs ``f`` vmapped on meta tensors: no data, and a
    function that the device engine cannot run is seen there."""
    _, _, pctx, pds = ctxs
    calls = []

    def f(frame):
        calls.append(frame.device.type)
        return frame.float().sum(0)

    res = pctx.map(pds, f)
    assert calls[0] == "meta"
    assert res.data.shape == NAV + (SIG[1],)
    assert pctx.run_info["engines"] == ["device"]
    # an item() call cannot run on a meta tensor: the host engine
    res = pctx.map(pds, lambda frame: frame.max().item() * 2)
    assert pctx.run_info["engines"] == ["host"]
    np.testing.assert_array_equal(res.data, _data().max(axis=(2, 3)) * 2)


def _record(lib, ctx, ds, path, **kw):
    udf_cls = port.RecordUDF if lib is port else JaxRecordUDF
    dtype = kw.pop("_dtype", None)
    ctx.run_udf(ds, udf_cls(str(path), _dtype=dtype), **kw)
    return path.read_bytes()


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("with_roi", [False, True])
def test_record_matches_jax_byte_for_byte(ctxs, tmp_path, with_roi, dtype):
    jctx, jds, pctx, pds = ctxs
    roi = _roi() if with_roi else None
    ours = _record(port, pctx, pds, tmp_path / "port.npy", roi=roi,
                   _dtype=dtype)
    theirs = _record(libertem_tpu, jctx, jds, tmp_path / "jax.npy",
                     roi=roi, _dtype=dtype)
    assert pctx.run_info["engines"] == ["host"]
    assert ours == theirs
    back = np.load(tmp_path / "port.npy")
    want = _data() if roi is None else _data()[roi]
    np.testing.assert_array_equal(back, want.astype(dtype or np.uint16))
    assert back.dtype == np.dtype(dtype or np.uint16)


def test_record_beside_device_udfs(ctxs, tmp_path):
    """Recording in the same read pass as a fused device pass."""
    _, _, pctx, pds = ctxs
    res = pctx.run_udf(pds, [port.SumUDF(),
                             port.RecordUDF(str(tmp_path / "r.npy"))])
    assert pctx.run_info["engines"] == ["device", "host"]
    assert pctx.run_info["fused"]
    np.testing.assert_array_equal(np.load(tmp_path / "r.npy"), _data())
    np.testing.assert_array_equal(res[0]["intensity"].data,
                                  _data().sum(axis=(0, 1)))


def test_record_patched_filename_matches_jax(ctxs, tmp_path):
    """A filename patched after the first partition opens a new file:
    the first holds the first partition's frames, the second the rest,
    in both packages alike."""
    jctx, jds, pctx, pds = ctxs
    out = {}
    for name, ctx, ds, cls in (("port", pctx, pds, port.RecordUDF),
                               ("jax", jctx, jds, JaxRecordUDF)):
        first = tmp_path / f"{name}-a.npy"
        second = tmp_path / f"{name}-b.npy"
        gen = ctx.run_udf_iter(ds, [cls(str(first))])
        next(gen)
        gen.update_parameters_experimental([{"filename": str(second)}])
        for _ in gen:
            pass
        out[name] = (first.read_bytes(), second.read_bytes())
    assert out["port"] == out["jax"]
    a = np.load(tmp_path / "port-a.npy").reshape(-1, *SIG)
    b = np.load(tmp_path / "port-b.npy").reshape(-1, *SIG)
    flat = _data().reshape(-1, *SIG)
    n0 = 14  # the first of 3 partitions of 42 frames
    np.testing.assert_array_equal(a[:n0], flat[:n0])
    np.testing.assert_array_equal(b[n0:], flat[n0:])
    assert not b[:n0].any()
