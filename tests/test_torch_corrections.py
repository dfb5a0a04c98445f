"""The port's detector corrections against the JAX package's, on the
CPU.

The correction plan (dark, gain, repair gather indices and weights) is
numpy on both sides and must be equal bit for bit.  Runs with
corrections compute in float32 with different summation orders: rtol
1e-5, with an absolute floor of 1e-5 of the buffer's largest magnitude
(CoM shifts and their derivatives: of the centres' magnitude).  The
``corrections.npz`` golden is held at the tolerances of
``tests/test_parity_reference.py``.
"""
import numpy as np
import pytest
import torch

import golden_common as gc
import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.corrections import CorrectionSet as JaxCorrectionSet
from libertem_tpu.io.corrections import RepairValueError as JaxRepairError
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet
from test_parity_reference import _golden
from test_torch_generic import _compare, _generic_udfs

import libertem_tpu_torch as port
from libertem_tpu_torch.convert import correction_plan_from_numpy
from libertem_tpu_torch.io.corrections import (
    CorrectionSet,
    RepairValueError,
)
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet
from libertem_tpu_torch.udf.base import UDFRunner

torch.set_num_threads(1)

NAV, SIG = (12, 10), (32, 32)


def _arrays(seed=45, n_excluded=9):
    rng = np.random.default_rng(seed)
    dark = rng.normal(2.0, 0.5, SIG).astype(np.float32)
    gain = (1.0 + 0.2 * rng.random(SIG)).astype(np.float32)
    excluded = np.zeros(SIG, dtype=bool)
    excluded.flat[rng.choice(SIG[0] * SIG[1], n_excluded,
                             replace=False)] = True
    # a 2x2 clump and an edge pixel: environments that grow past
    # radius 1 on neither, but skip excluded neighbours
    excluded[10:12, 20:22] = True
    excluded[0, 5] = True
    return dark, gain, excluded


def _both(**kw):
    return CorrectionSet(**kw), JaxCorrectionSet(**kw)


@pytest.mark.parametrize("form", ["mask", "coords_ndim_n", "coords_n_ndim"])
def test_plan_equal_to_jax(form):
    dark, gain, excluded = _arrays()
    if form == "mask":
        ex = excluded
    elif form == "coords_ndim_n":
        ex = np.argwhere(excluded).T
    else:
        ex = np.argwhere(excluded)
    ours, theirs = _both(dark=dark, gain=gain, excluded_pixels=ex)
    mine = ours.make_plan(SIG)
    carried = correction_plan_from_numpy(theirs.make_plan(SIG))
    assert set(mine) == set(carried)
    for key in carried:
        assert mine[key].dtype == carried[key].dtype, key
        assert np.array_equal(mine[key], carried[key]), key
    # a clump needs a grown environment: the plan has more than one
    # neighbour slot, padded with zero weights
    assert mine["nbr_idx"].shape[1] > 1
    assert np.allclose(mine["nbr_w"].sum(axis=1), 1.0)


def test_plan_without_corrections_is_none():
    ours, theirs = _both()
    assert ours.make_plan(SIG) is None
    assert correction_plan_from_numpy(theirs.make_plan(SIG)) is None
    assert not ours.have_corrections()


def test_repair_environment_check_as_jax():
    excluded = np.zeros(SIG, dtype=bool)
    excluded[0:2, 0:2] = True
    excluded[2, 0:3] = True
    excluded[0:3, 2] = True  # (1, 1) is walled in
    with pytest.raises(RepairValueError):
        CorrectionSet(excluded_pixels=excluded)
    with pytest.raises(JaxRepairError):
        JaxCorrectionSet(excluded_pixels=excluded)
    ours, theirs = _both(excluded_pixels=excluded, allow_empty=True)
    for key, value in ours.make_plan(SIG).items():
        other = theirs.make_plan(SIG)[key]
        assert (value is None and other is None) or np.array_equal(
            value, other
        ), key


def test_wrong_dark_shape_raises():
    with pytest.raises(ValueError, match="dark frame shape"):
        CorrectionSet(dark=np.zeros((4, 4), np.float32)).make_plan(SIG)


def test_apply_numpy_equal_to_jax():
    dark, gain, excluded = _arrays()
    frames = np.random.default_rng(1).poisson(8.0, (7,) + SIG).astype(
        np.uint16
    )
    ours, theirs = _both(dark=dark, gain=gain, excluded_pixels=excluded)
    assert np.array_equal(ours.apply_numpy(frames),
                          theirs.apply_numpy(frames))


def _data(seed=0):
    return np.random.default_rng(seed).poisson(
        8.0, NAV + SIG
    ).astype(np.uint16)


def _run(data, udfs_port, udfs_jax, num_partitions=3, roi=None,
         **corr):
    ctx = port.Context(device="cpu")
    ours = ctx.run_udf(
        ctx.load("memory", data=data, sig_dims=2,
                 num_partitions=num_partitions),
        udfs_port, roi=roi, corrections=CorrectionSet(**corr),
    )
    theirs = JaxContext(executor=InlineJobExecutor()).run_udf(
        JaxMemoryDataSet(data=data, sig_dims=2,
                         num_partitions=num_partitions),
        udfs_jax, roi=roi, corrections=JaxCorrectionSet(**corr),
    )
    return ours, theirs


@pytest.mark.parametrize("with_roi", [False, True])
def test_fused_path_with_corrections_matches_jax(with_roi):
    """ApplyMasks, CoM, Sum, SumSig, StdDev with dark, gain and
    excluded pixels: the fused path, fed corrected float32 blocks."""
    dark, gain, excluded = _arrays()
    data = _data()
    roi = (np.random.default_rng(3).random(NAV) > 0.3) if with_roi \
        else None
    corr = dict(dark=dark, gain=gain, excluded_pixels=excluded)
    prep = UDFRunner(_generic_udfs(port)[:5])._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"),
        roi, CorrectionSet(**corr),
    )
    assert prep["fused"] is not None
    assert prep["meta"].input_dtype == np.float32
    ours, theirs = _run(data, _generic_udfs(port)[:5],
                        _generic_udfs(libertem_tpu)[:5], roi=roi, **corr)
    _compare(ours, theirs)
    # and the plain float64 answer of the summed frames
    frames = CorrectionSet(**corr).apply_numpy(data.reshape(-1, *SIG))
    if roi is not None:
        frames = frames[roi.reshape(-1)]
    np.testing.assert_allclose(
        ours[2]["intensity"].data, frames.astype(np.float64).sum(axis=0),
        rtol=1e-5, atol=1e-5 * np.abs(frames).sum(axis=0).max(),
    )


def test_generic_path_with_corrections_matches_jax():
    dark, gain, excluded = _arrays(seed=7)
    ours, theirs = _run(
        _data(seed=1), _generic_udfs(port), _generic_udfs(libertem_tpu),
        roi=np.random.default_rng(4).random(NAV) > 0.5,
        dark=dark, gain=gain, excluded_pixels=excluded,
    )
    _compare(ours, theirs)


def test_padded_tail_with_nonzero_dark_stays_exact():
    """Blocks deeper than the partitions: every block has a padded
    tail, which becomes (0 - dark) * gain before the runner zeroes it
    again.  With integer counts and an integer dark, the corrected
    frames are integers and their sums exact in float32."""
    data = _data(seed=2)
    dark = np.full(SIG, 3.0, np.float32)
    dark[5, 7] = 11.0
    frames = data.reshape(-1, *SIG).astype(np.float64) - dark
    for udfs in ([port.SumUDF(), port.SumSigUDF(), port.StdDevUDF()],
                 [port.SumUDF(), port.SumSigUDF(), port.StdDevUDF(),
                  port.LogsumUDF()]):
        ctx = port.Context(device="cpu")
        res = ctx.run_udf(
            ctx.load("memory", data=data, sig_dims=2, num_partitions=7),
            udfs, corrections=CorrectionSet(dark=dark),
        )
        assert ctx.feed_stats["blocks"] == 7
        assert np.array_equal(res[0]["intensity"].data, frames.sum(axis=0))
        assert np.array_equal(res[1]["intensity"].data.reshape(-1),
                              frames.sum(axis=(1, 2)))
        assert res[2]["num_frames"].data[0] == frames.shape[0]
        np.testing.assert_allclose(res[2]["var"].data, frames.var(axis=0),
                                   rtol=1e-5)


def test_golden_corrections():
    g = _golden("corrections")
    dark, gain, excluded = gc.golden_corrections_arrays()
    ctx = port.Context(device="cpu")
    res = ctx.run_udf(
        ctx.load("memory", data=gc.golden_data_u16(), sig_dims=2,
                 num_partitions=4),
        [port.SumUDF(), port.StdDevUDF()],
        corrections=CorrectionSet(dark=dark, gain=gain,
                                  excluded_pixels=excluded),
    )
    assert np.allclose(res[0]["intensity"].data, g["sum_intensity"],
                       rtol=1e-4, atol=1e-2)
    assert np.allclose(res[1]["var"].data, g["var"], rtol=1e-3, atol=1e-3)
