"""Complex data through StdDevUDF, CoMUDF and LogsumUDF, and the port's
``UDFException``, against the JAX package on the CPU.

The same seeded complex64 data (nav 8x8, sig 16x16, 4 partitions)
goes through ``libertem_tpu_torch.Context(device="cpu")`` and
``libertem_tpu.api.Context``, once as a set the fused path would take
for real data (the fused kernel takes only real input, so
``run_info["fused"]`` is False) and once beside a UDF that splits the
frame into sig tiles.  Tolerances: StdDev within 1e-5 relative of a
complex128 numpy oracle, as the JAX package holds it; port against JAX
within 1e-5 relative, with an absolute floor of 1e-5 of the buffer's
largest magnitude (complex64 with other summation orders); the centre
of mass's derived fields take the centres' magnitude as that floor.
"""
import warnings

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.common.buffers  # noqa: F401  (binds .common.buffers)
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.common.exceptions import UDFException as JaxUDFException
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet

import libertem_tpu_torch as port
import libertem_tpu_torch.common.buffers  # noqa: F401
from libertem_tpu_torch.common.exceptions import UDFException
from libertem_tpu_torch.udf.base import UDFRunner

torch.set_num_threads(1)

RTOL = 1e-5
NAV, SIG = (8, 8), (16, 16)


def _complex_data(seed=21):
    rng = np.random.default_rng(seed)
    shape = NAV + SIG
    return (rng.normal(3.0, 2.0, shape)
            + 1j * rng.normal(-1.0, 1.5, shape)).astype(np.complex64)


def _tiny_tile_sum(lib):
    """A complex sig sum whose tiling preference splits the frame."""
    class TinySum(lib.udf.base.UDF):
        def get_result_buffers(self):
            return {"s": self.buffer(kind="sig", dtype="complex64")}

        def get_tiling_preferences(self):
            return {"total_size": 1024, "depth": 4}

        def process_tile(self, tile):
            self.results.s = self.results.s + tile.sum(0)

        def merge(self, dest, src):
            dest.s = dest.s + src.s

    return TinySum()


def _run_both(data, make_udfs, split):
    def udfs(lib):
        us = make_udfs(lib)
        return us + [_tiny_tile_sum(lib)] if split else us

    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=4)
    prep = UDFRunner(udfs(port))._prepare(ds, torch.device("cpu"))
    assert (len(prep["scheme"]) > 1) is split
    with warnings.catch_warnings():
        # a complex sum into a real buffer drops the imaginary part on
        # both sides
        warnings.simplefilter("ignore")
        ours = ctx.run_udf(ds, udfs(port))
        theirs = JaxContext(executor=InlineJobExecutor()).run_udf(
            JaxMemoryDataSet(data=data, sig_dims=2, num_partitions=4),
            udfs(libertem_tpu),
        )
    # the fused kernel takes only real input: no complex pass reaches it
    assert ctx.run_info["fused"] is False
    return ours, theirs


def _close(got, want, rtol=RTOL, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if scale is None:
        scale = float(np.nanmax(np.abs(want), initial=0.0))
    scale = max(scale, 1.0)
    ok = (np.abs(got - want) <= rtol * np.abs(want) + rtol * scale) | (
        np.isnan(got) & np.isnan(want))
    assert ok.all(), float(np.nanmax(np.abs(got - want)))


@pytest.mark.parametrize("split", [False, True])
def test_stddev_complex_like_jax(split):
    data = _complex_data()
    ours, theirs = _run_both(data, lambda lib: [lib.udf.StdDevUDF()], split)
    flat = data.reshape(-1, *SIG).astype(np.complex128)
    mean = flat.mean(axis=0)
    var = (np.abs(flat - mean) ** 2).mean(axis=0)
    want = {"sum": flat.sum(axis=0), "mean": mean, "var": var,
            "varsum": var * flat.shape[0], "std": np.sqrt(var)}
    for name, w in want.items():
        got = np.asarray(ours[0][name].data)
        assert got.dtype == np.asarray(theirs[0][name].data).dtype, name
        assert np.all(np.isfinite(got)), name
        np.testing.assert_allclose(got, w, rtol=RTOL, err_msg=name)
        _close(got, theirs[0][name].data)
    assert ours[0]["sum"].data.dtype == np.complex64
    assert ours[0]["var"].data.dtype == np.float32


@pytest.mark.parametrize("split", [False, True])
def test_com_complex_like_jax(split):
    data = _complex_data(seed=22)

    def udfs(lib):
        return [lib.udf.CoMUDF.with_params(cy=7.5, cx=8.0, r=6.0,
                                           scan_rotation=30.0)]

    ours, theirs = _run_both(data, udfs, split)
    # everything derived from the centres (differences com - c and
    # their neighbours' differences) takes the centres' magnitude as
    # its absolute floor
    centres = float(np.abs(theirs[0]["raw_com"].data).max())
    for name in ("raw_com", "raw_shifts", "field", "field_y", "field_x",
                 "magnitude", "divergence", "curl"):
        got = ours[0][name].data
        assert got.dtype == np.complex64, name
        _close(got, theirs[0][name].data, scale=centres)


@pytest.mark.parametrize("with_stats", [False, True])
def test_logsum_complex_like_jax(with_stats):
    data = _complex_data(seed=23)

    def udfs(lib):
        us = [lib.udf.LogsumUDF()]
        return us + [lib.udf.StdDevUDF()] if with_stats else us

    ours, theirs = _run_both(data, udfs, False)
    got = ours[0]["logsum"].data
    assert np.all(np.isfinite(got))
    _close(got, theirs[0]["logsum"].data)


def test_logsum_frame_min_is_lexicographic():
    """The complex minimum is the least (real, imaginary) pair, as
    ``jnp.min`` gives it."""
    from libertem_tpu_torch.udf.logsum import _frame_min

    import jax.numpy as jnp

    vals = np.array([[[1 + 5j, 1 + 2j], [3 - 9j, 0.5 + 100j]],
                     [[0.5 - 1j, 0.5 - 3j], [2 + 0j, 0.5 + 0j]]],
                    np.complex64)
    got = _frame_min(torch.from_numpy(vals), (1, 2)).numpy()
    want = np.asarray(jnp.min(jnp.asarray(vals), axis=(1, 2), keepdims=True))
    assert np.array_equal(got, want)
    real = np.abs(vals).astype(np.float32)
    assert np.array_equal(_frame_min(torch.from_numpy(real), (1, 2)).numpy(),
                          real.min(axis=(1, 2), keepdims=True))


# -- UDFException ---------------------------------------------------------

def _bad_udf(lib, what):
    """A UDF that each engine refuses with UDFException, for ``what``."""
    base = lib.udf.base.UDF
    backend = getattr(base, "BACKEND_TORCH", None) or base.BACKEND_JAX

    class Bad(base):
        def get_result_buffers(self):
            bufs = {"x": self.buffer(kind="nav", dtype="float32")}
            if what in ("private", "result_only"):
                bufs["p"] = self.buffer(
                    kind="nav", dtype="float32",
                    use="private" if what == "private" else "result_only")
            return bufs

        def process_tile(self, tile):
            self.results.x = self.results.x + 1

        def get_method(self):
            if what == "method":
                return "bogus"
            if what == "missing_process":
                return "frame"
            return super().get_method()

        def get_backends(self):
            if what == "no_engine":
                return ("quantum",)
            return (backend,)

        def get_results(self):
            if what == "private":
                return {"p": np.zeros(64, np.float32)}
            return {}

    kwargs = {}
    if what == "aux_no_data":
        kwargs["weights"] = lib.common.buffers.AuxBufferWrapper("nav")
    return Bad(**kwargs)


@pytest.mark.parametrize("what", [
    "method", "missing_process", "no_engine", "restriction", "aux_no_data",
    "private", "result_only",
])
def test_udf_exception_where_jax_raises_it(what):
    data = np.ones(NAV + SIG, np.float32)
    backends = ("numpy",) if what == "restriction" else None
    ctx = port.Context(device="cpu")
    with pytest.raises(UDFException):
        ctx.run_udf(ctx.load("memory", data=data, sig_dims=2),
                    _bad_udf(port, what), backends=backends)
    with pytest.raises(JaxUDFException):
        JaxContext(executor=InlineJobExecutor()).run_udf(
            JaxMemoryDataSet(data=data, sig_dims=2),
            _bad_udf(libertem_tpu, what), backends=backends)


def test_default_merge_raises_udf_exception():
    assert port.UDFException is UDFException
    assert port.udf.UDFException is UDFException
    with pytest.raises(UDFException, match="merge"):
        port.udf.UDF().merge(None, None)
    with pytest.raises(JaxUDFException, match="merge"):
        libertem_tpu.udf.base.UDF().merge(None, None)
