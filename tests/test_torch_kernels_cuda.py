"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs a CUDA card and nvcc; skipped without them.  Imports no
jax, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 of the largest
magnitude (float32 on both sides, different summation orders).
"""
import numpy as np
import pytest
import torch

from libertem_tpu_torch.ops.moments import (
    fused_moments,
    fused_moments_reference,
)

RTOL = 1e-5

CASES = [
    # kind, depth, pixels, masks, valid
    ("u16", 1024, 16384, 6, 1024),  # the main path's block
    ("u16", 1024, 16384, 6, 987),   # its tail
    ("u8", 64, 4096, 3, 64),
    ("i16", 64, 4096, 2, 50),
    ("f32", 96, 2048, 5, 96),       # large mean, narrow spread
    ("u16", 100, 1000, 7, 77),      # unaligned rows, ragged edge
    ("u32", 40, 640, 1, 40),
]


def _block(kind, depth, pixels, valid, rng):
    if kind == "f32":
        x = rng.normal(1000.0, 0.5, (depth, pixels)).astype(np.float32)
    else:
        dtype = {"u16": np.uint16, "u8": np.uint8, "i16": np.int16,
                 "u32": np.uint32}[kind]
        x = rng.poisson(8.0, (depth, pixels)).astype(dtype)
    x[valid:] = 0
    return x


def _close(got, want):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,depth,pixels,n_masks,valid", CASES)
def test_fused_moments_kernel(card, kind, depth, pixels, n_masks, valid):
    rng = np.random.default_rng(depth + pixels)
    x = torch.from_numpy(_block(kind, depth, pixels, valid, rng)).to(card)
    masks = torch.from_numpy(
        rng.normal(size=(n_masks, pixels)).astype(np.float32)
    ).to(card)
    before = fused_moments.launches
    got = fused_moments(x, masks, valid)
    assert fused_moments.launches == before + 1
    want = fused_moments_reference(x, masks, valid)
    for a, b in zip(got, want):
        _close(a, b)
    # identical bits on a second launch: no atomics
    again = fused_moments(x, masks, valid)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_moments_kernel_contracts(card):
    x = torch.full((96, 2048), 1000.123, dtype=torch.float32, device=card)
    masks = torch.ones((2, 2048), dtype=torch.float32, device=card)
    assert torch.all(fused_moments(x, masks, 96)[2] == 0)
    assert torch.all(fused_moments(x, masks, 96, compute_var=False)[2] == 0)
    zeros = torch.zeros((64, 2048), dtype=torch.uint16, device=card)
    assert torch.all(fused_moments(zeros, masks, 0)[2] == 0)
    with pytest.raises(ValueError):
        fused_moments(x, torch.ones((9, 2048), device=card), 96)
