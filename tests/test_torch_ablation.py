"""The stage ablation's plain versions (``ops/ablation.py``) against the
definitions of the JAX stage ablation.

``ablated`` is a closure inside ``main()`` of
``benchmarks/bench_kernel_ablation.py`` and cannot be imported, so each
stage is held against a numpy statement of what that stage computes,
with the script's lines cited; the full stage is held against
``_fused_moments_pallas`` in interpret mode, as
``tests/test_torch_moments.py`` runs it.  The JAX script works on
64-row steps (``TD``) of u16 blocks whose depth is a multiple of 64;
the port's stages also take a ragged depth (the first and last row of
its last, short chunk for load_min).  Tolerances: integer stages
exact; float32 sums with other summation orders within 1e-5 relative,
with an absolute floor of 1e-5 of the largest magnitude.  The CUDA
stages themselves are held against these plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 9).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libertem_tpu.ops.moments import _fused_moments_pallas
from libertem_tpu_torch.ops import ablation
from libertem_tpu_torch.ops.ablation import (
    STAGES,
    fused_moments_stage,
    fused_moments_stage_reference,
    stage_bound,
)
from libertem_tpu_torch.ops.moments import plan_grid

torch.set_num_threads(1)

RTOL = 1e-5


def _close(actual, expected):
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    scale = max(float(np.abs(expected).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(actual, expected, rtol=RTOL,
                               atol=RTOL * scale)


def _block(kind, depth, pixels, valid, seed):
    rng = np.random.default_rng(seed)
    if kind == "u16":
        x = rng.poisson(8.0, (depth, pixels)).astype(np.uint16)
    elif kind == "u8":
        x = rng.integers(0, 256, (depth, pixels)).astype(np.uint8)
    else:
        x = rng.normal(1000.0, 0.5, (depth, pixels)).astype(np.float32)
    x[valid:] = 0  # the zero-padding contract
    return x


def _stage(x, masks, valid, stage):
    return [t.numpy() for t in fused_moments_stage(
        torch.from_numpy(x), torch.from_numpy(masks), valid, stage)]


def _jax_definition(x, masks, valid, stage):
    """What the JAX stage computes, as numpy, with the JAX script's row
    step ``TD`` (bench_kernel_ablation.py:35) set to the grid plan's
    rows a CTA, on a depth that is a multiple of it: ``(y, colsum,
    colvar)``."""
    depth, pixels = x.shape
    TD = plan_grid(depth, pixels).rows
    steps = x.reshape(depth // TD, TD, pixels).astype(np.int64)
    y = np.zeros((depth, masks.shape[0]))
    colvar = np.zeros(pixels)
    if stage == "load_min":
        # :60-77: rows 0 and TD - 1 of every step enter colsum
        return y, (steps[:, 0] + steps[:, TD - 1]).sum(axis=0), colvar
    if stage == "load":
        # :78-103: an int32 widen, the step's colsum, then one convert
        return y, steps.sum(axis=(0, 1)), colvar
    xf = x.astype(np.float64)
    colsum = xf.sum(axis=0)  # :105-106, the f32 convert and colsum
    if stage == "cast":
        return y, colsum, colvar
    # :127-133: the MXU product with the mask stack (dot1: its bf16
    # term of x is x itself for counts below 256)
    y = xf @ masks.astype(np.float64).T
    if stage == "dot":
        return y, colsum, colvar
    # :136-192: the centred variance over rows < valid, Chan-combined
    # over steps: the two-pass variance of the valid rows
    xv = xf[:valid]
    mean = xv.sum(axis=0) / max(valid, 1)
    return y, colsum, ((xv - mean) ** 2).sum(axis=0)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kind,depth,pixels,n_masks,valid", [
    ("u16", 128, 1024, 6, 128),
    ("u16", 192, 512, 12, 150),
    ("u8", 64, 256, 3, 64),
])
def test_stage_matches_jax_definition(stage, kind, depth, pixels, n_masks,
                                      valid):
    x = _block(kind, depth, pixels, valid, seed=depth + n_masks)
    masks = np.random.default_rng(5).normal(
        size=(n_masks, pixels)).astype(np.float32)
    ours = _stage(x, masks, valid, stage)
    want = _jax_definition(x, masks, valid, stage)
    assert ours[0].shape == (depth, n_masks)
    for mine, w in zip(ours, want):
        assert mine.dtype == np.float32
        if stage in ("load_min", "load"):
            assert np.array_equal(mine, w)
        else:
            _close(mine, w)


@pytest.mark.parametrize("kind,depth,pixels,n_masks,valid", [
    ("u16", 128, 1024, 6, 128),
    ("u16", 128, 1024, 6, 77),
    ("u8", 64, 512, 12, 40),
    ("f32", 128, 256, 5, 100),
])
def test_full_stage_matches_pallas(kind, depth, pixels, n_masks, valid):
    x = _block(kind, depth, pixels, valid, seed=valid)
    masks = np.random.default_rng(6).normal(
        size=(n_masks, pixels)).astype(np.float32)
    pallas = _fused_moments_pallas(
        jnp.asarray(x), jnp.asarray(masks), jnp.int32(valid),
        interpret=True,
    )
    for stage in ("var", "full"):
        for mine, p in zip(_stage(x, masks, valid, stage), pallas):
            _close(mine, p)


def test_ragged_depth_stages():
    """A depth of 100 in the plan's 16-row chunks: six of 16 rows and a
    short one of 4."""
    x = _block("u16", 100, 300, 100, seed=9)
    masks = np.random.default_rng(2).random((4, 300)).astype(np.float32)
    x64 = x.astype(np.int64)
    assert plan_grid(100, 300).rows == 16
    _, colsum, _ = _stage(x, masks, 100, "load_min")
    ends = [r for r0 in range(0, 96, 16) for r in (r0, r0 + 15)] + [96, 99]
    assert np.array_equal(colsum, x64[ends].sum(axis=0))
    _, colsum, _ = _stage(x, masks, 100, "load")
    assert np.array_equal(colsum, x64.sum(axis=0))
    # a one-row last chunk enters once
    x65 = _block("u16", 65, 300, 65, seed=10)
    _, colsum, _ = _stage(x65, masks, 65, "load_min")
    ends = [r for r0 in range(0, 64, 16) for r in (r0, r0 + 15)] + [64]
    assert np.array_equal(colsum, x65.astype(np.int64)[ends].sum(axis=0))


def test_float_load_stage_is_the_cast():
    x = _block("f32", 128, 256, 128, seed=3)
    masks = np.ones((1, 256), np.float32)
    load = _stage(x, masks, 128, "load")
    cast = _stage(x, masks, 128, "cast")
    for a, b in zip(load, cast):
        assert np.array_equal(a, b)


def test_stage_reference_refuses_unknown_stage():
    x = torch.zeros((64, 8), dtype=torch.uint16)
    m = torch.ones((1, 8))
    with pytest.raises(ValueError, match="stage"):
        fused_moments_stage(x, m, 64, "dec")
    with pytest.raises(ValueError, match="stage"):
        fused_moments_stage_reference(x, m, 64, "dot2")


def test_stage_bounds_at_the_headline_shape():
    """Every stage reads x once: 33.5 MB over 3.35 TB/s is 0.0100 ms
    at u16, D = 1024, P = 16384; M = 40 is bound by its operations."""
    for stage in STAGES:
        ms, by = stage_bound(stage, 1024, 16384, 6, 2)
        assert by == "bytes"
        assert 0.0100 <= ms < 0.0104
    ms, by = stage_bound("full", 1024, 16384, 40, 2)
    assert by == "operations"
    assert ms == pytest.approx(1024 * 16384 * 85 / 67e12 * 1e3)
    assert stage_bound("load_min", 1024, 16384, 6, 2)[0] == pytest.approx(
        (1024 * 16384 * 2 + 16384 * 4) / 3.35e12 * 1e3)


def test_library_yardsticks_on_the_cpu():
    """Each stage's library call computes (part of) its outputs."""
    x = torch.from_numpy(_block("u16", 64, 128, 64, seed=4))
    m = torch.from_numpy(np.random.default_rng(1).random(
        (3, 128)).astype(np.float32))
    assert ablation.library_call("load_min") is None
    assert torch.equal(ablation.library_call("load")(x, m),
                       x.to(torch.int32).sum(0))
    _close(ablation.library_call("cast")(x, m), x.float().sum(0))
    _close(ablation.library_call("dot")(x, m), x.float() @ m.T)
    y, (var, mean) = ablation.library_call("full")(x, m)
    ref = fused_moments_stage_reference(x, m, 64, "full")
    _close(y, ref[0])
    _close(var * 64, ref[2])


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ablation.main()
