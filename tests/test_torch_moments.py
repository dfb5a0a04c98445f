"""The port's fused moments op against the JAX package's.

``fused_moments_reference`` (the plain PyTorch version the CPU runs)
is held against ``_fused_moments_pallas`` in interpret mode and
against ``_fused_moments_xla`` on the same numpy inputs.  Both sides
compute in float32 with different summation orders: rtol 1e-5, with
an absolute floor of 1e-5 of the largest magnitude for entries near
zero.  The CUDA kernel itself is held against the plain version in
``tests/test_torch_kernels_cuda.py`` (needs a card) and in
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libertem_tpu.ops.moments import (
    _fused_moments_pallas,
    _fused_moments_xla,
)
from libertem_tpu_torch.ops.moments import (
    fused_moments,
    fused_moments_reference,
)

torch.set_num_threads(1)

RTOL = 1e-5


def _close(actual, expected):
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    scale = max(float(np.abs(expected).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(
        actual, expected, rtol=RTOL, atol=RTOL * scale
    )


def _block(kind, depth, pixels, valid, seed):
    rng = np.random.default_rng(seed)
    if kind == "u16":
        x = rng.poisson(8.0, (depth, pixels)).astype(np.uint16)
    elif kind == "u8":
        x = rng.integers(0, 256, (depth, pixels)).astype(np.uint8)
    elif kind == "f32":
        # large mean, narrow spread: the case a raw second moment
        # gets wrong
        x = rng.normal(1000.0, 0.5, (depth, pixels)).astype(np.float32)
    elif kind == "f64":
        x = rng.normal(1000.0, 0.5, (depth, pixels))
    else:
        raise ValueError(kind)
    x[valid:] = 0  # the zero-padding contract
    return x


def _ours(x, masks, valid, compute_var=True):
    out = fused_moments_reference(
        torch.from_numpy(x), torch.from_numpy(masks), valid,
        compute_var=compute_var,
    )
    return [t.numpy() for t in out]


CASES = [
    # kind, depth, pixels, masks, valid
    ("u16", 64, 1024, 6, 64),
    ("u16", 64, 1024, 6, 41),
    ("u8", 32, 512, 3, 32),
    ("u8", 32, 512, 3, 7),
    ("f32", 48, 256, 5, 48),
    ("f32", 48, 256, 5, 30),
]


@pytest.mark.parametrize("kind,depth,pixels,n_masks,valid", CASES)
def test_reference_matches_pallas_and_xla(kind, depth, pixels, n_masks,
                                          valid):
    x = _block(kind, depth, pixels, valid, seed=depth + valid)
    masks = np.random.default_rng(7).normal(
        size=(n_masks, pixels)
    ).astype(np.float32)
    ours = _ours(x, masks, valid)
    pallas = _fused_moments_pallas(
        jnp.asarray(x), jnp.asarray(masks), jnp.int32(valid),
        interpret=True,
    )
    xla = _fused_moments_xla(
        jnp.asarray(x), jnp.asarray(masks), jnp.int32(valid)
    )
    for mine, p, q in zip(ours, pallas, xla):
        _close(mine, p)
        _close(mine, q)
    # and the variance against float64 over the valid rows
    xv = x[:valid].astype(np.float64)
    _close(ours[2], ((xv - xv.mean(axis=0)) ** 2).sum(axis=0))


@pytest.mark.parametrize("kind,depth,pixels,n_masks,valid", [
    # more than one mask group of the CUDA kernel (8 rows a launch)
    ("u16", 64, 1024, 9, 64),
    ("u16", 64, 1024, 17, 50),
    ("u16", 40, 512, 40, 33),
    # float64 input, computed in float32 like the JAX package's
    ("f64", 48, 256, 5, 48),
    ("f64", 48, 256, 12, 30),
])
def test_reference_matches_xla_wide(kind, depth, pixels, n_masks, valid):
    x = _block(kind, depth, pixels, valid, seed=depth + n_masks)
    masks = np.random.default_rng(8).normal(
        size=(n_masks, pixels)
    ).astype(np.float32)
    ours = _ours(x, masks, valid)
    xla = _fused_moments_xla(
        jnp.asarray(x), jnp.asarray(masks), jnp.int32(valid)
    )
    assert ours[0].shape == (depth, n_masks)
    for mine, q in zip(ours, xla):
        _close(mine, q)
    # the float64 input enters as its float32 rounding on both sides
    xv = x[:valid].astype(np.float32).astype(np.float64)
    _close(ours[1], xv.sum(axis=0))
    _close(ours[2], ((xv - xv.mean(axis=0)) ** 2).sum(axis=0))


def test_reference_multi_row_tile(monkeypatch):
    """A depth the Pallas kernel cuts into three row tiles (1 MB tile
    budget: 64 rows of 4096 f32 pixels), with the valid boundary
    inside the last tile: its Chan combine across tiles agrees with
    the single two-pass of the plain version."""
    monkeypatch.setenv("LIBERTEM_TPU_MOMENTS_TILE_MB", "1")
    depth, pixels, valid = 192, 4096, 150
    x = _block("u16", depth, pixels, valid, seed=3)
    masks = np.random.default_rng(4).random((4, pixels)).astype(
        np.float32
    )
    ours = _ours(x, masks, valid)
    pallas = _fused_moments_pallas(
        jnp.asarray(x), jnp.asarray(masks), jnp.int32(valid),
        interpret=True,
    )
    for mine, p in zip(ours, pallas):
        _close(mine, p)


@pytest.mark.parametrize("x", [
    np.full((40, 256), 1000.0, np.float32),
    np.full((40, 256), 200, np.uint8),
    np.full((40, 256), 256, np.uint16),
])
def test_reference_constant_data_exact_zero(x):
    """Constant integer data: the mean is exact, so the centred
    variance is exactly 0 (a raw second moment would not be)."""
    masks = np.ones((2, x.shape[1]), np.float32)
    _, _, colvar = _ours(x, masks, x.shape[0])
    assert np.all(colvar == 0.0)


@pytest.mark.parametrize("valid", [24, 0])
def test_reference_var_disabled_and_empty(valid):
    x = _block("u16", 24, 128, valid, seed=1)
    masks = np.ones((1, 128), np.float32)
    y, colsum, colvar = _ours(x, masks, valid, compute_var=False)
    assert np.all(colvar == 0.0)
    _y, _cs, cv = _fused_moments_xla(
        jnp.asarray(x), jnp.asarray(masks), jnp.int32(valid),
        compute_var=False,
    )
    _close(colsum, _cs)
    # valid == 0 with the variance on: zero, not NaN
    _, _, colvar = _ours(x, masks, valid, compute_var=True)
    assert np.all(np.isfinite(colvar))
    if valid == 0:
        assert np.all(colvar == 0.0)


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and counts
    no kernel launch."""
    x = _block("u16", 16, 64, 16, seed=2)
    masks = np.ones((3, 64), np.float32)
    before = fused_moments.launches
    out = fused_moments(torch.from_numpy(x), torch.from_numpy(masks), 16)
    ref = _ours(x, masks, 16)
    assert fused_moments.launches == before
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), b)


def test_entry_points_cover_every_dtype_once():
    """Each input dtype's code is dispatched in the library that
    ``_fused_moments_cuda`` loads for its item size, and in no other:
    the 1- and 2-byte types in ``csrc/fused_moments.cu``, the 4- and
    8-byte ones in ``csrc/fused_moments_wide.cu``."""
    import re
    from pathlib import Path

    from libertem_tpu_torch.ops import moments

    csrc = Path(moments.__file__).resolve().parent.parent / "csrc"
    cases = {name: {int(c) for c in re.findall(
        r"FM_CASE\((\d+),", (csrc / f"{name}.cu").read_text())}
        for name in moments.LIBRARIES}
    want = {name: set() for name in moments.LIBRARIES}
    for dtype, code in moments._DTYPE_CODES.items():
        itemsize = torch.empty(0, dtype=dtype).element_size()
        want[moments.LIBRARIES[itemsize > 2]].add(code)
    assert cases == want

