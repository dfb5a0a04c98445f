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
    # more than one mask group of 8 rows
    ("u16", 1024, 16384, 9, 1024),
    ("u16", 1024, 16384, 12, 1000),
    ("u16", 256, 4096, 17, 200),
    ("u16", 100, 1000, 40, 77),
    # wide and half-width input
    ("f64", 128, 4096, 6, 128),
    ("i64", 128, 4096, 3, 100),
    ("u64", 64, 2048, 9, 64),
    ("f16", 256, 4096, 6, 256),
    ("bf16", 256, 4096, 12, 199),
    # a dark- and gain-corrected f32 block: large means, padded tail
    ("corrected", 1024, 16384, 12, 1000),
]

_TORCH_ONLY = {"f16": torch.float16, "bf16": torch.bfloat16}


def _block(kind, depth, pixels, valid, rng):
    if kind == "f32":
        x = rng.normal(1000.0, 0.5, (depth, pixels)).astype(np.float32)
    elif kind == "corrected":
        dark = rng.normal(100.0, 5.0, pixels).astype(np.float32)
        gain = (1.0 + 0.2 * rng.random(pixels)).astype(np.float32)
        raw = rng.poisson(1000.0, (depth, pixels)).astype(np.float32)
        x = (raw - dark) * gain
    elif kind in _TORCH_ONLY:
        # counts are exact in both half-width types
        x = rng.poisson(8.0, (depth, pixels)).astype(np.float32)
    else:
        dtype = {"u16": np.uint16, "u8": np.uint8, "i16": np.int16,
                 "u32": np.uint32, "f64": np.float64, "i64": np.int64,
                 "u64": np.uint64}[kind]
        x = rng.poisson(8.0, (depth, pixels)).astype(dtype)
    x[valid:] = 0
    x = torch.from_numpy(x)
    if kind in _TORCH_ONLY:
        x = x.to(_TORCH_ONLY[kind])
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
    x = _block(kind, depth, pixels, valid, rng).to(card)
    masks = torch.from_numpy(
        rng.normal(size=(n_masks, pixels)).astype(np.float32)
    ).to(card)
    before = fused_moments.launches
    got = fused_moments(x, masks, valid)
    # one launch per group of 8 mask rows
    assert fused_moments.launches == before + -(-n_masks // 8)
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
    # with more than 8 mask rows, later groups skip the moments: the
    # first group's colsum and colvar stand
    many = torch.ones((17, 2048), dtype=torch.float32, device=card)
    y, colsum, colvar = fused_moments(x, many, 96)
    assert torch.all(colvar == 0)
    assert torch.equal(colsum, fused_moments(x, masks, 96)[1])
    assert torch.equal(y[:, :8], y[:, 8:16])
    with pytest.raises(ValueError):
        fused_moments(x, torch.ones((0, 2048), device=card), 96)


# -- whole runs on the card against the same runs on the CPU ------------------
# The CPU runs the kernel's plain version and the same torch ops: float32
# on both sides, other summation orders, so rtol 1e-5 with the floor of
# the buffer's magnitude (centre-of-mass-derived fields: the centres').

def _compare_runs(ours, theirs):
    from_com = ("raw_shifts", "field", "field_y", "field_x", "magnitude",
                "divergence", "curl")
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for name in b:
            x = np.asarray(a[name].data, dtype=np.float64)
            y = np.asarray(b[name].data, dtype=np.float64)
            ref = b["raw_com"].data if name in from_com else b[name].data
            scale = max(float(np.nanmax(np.abs(
                np.asarray(ref, np.float64)), initial=0.0)), 1.0)
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=RTOL * scale,
                                       err_msg=name)


def _ring_udfs(lt, n_rings=10):
    h = w = 64
    rings = np.stack([lt.masks.ring(32, 32, w, h, r + 3, r)
                      for r in range(0, 3 * n_rings, 3)])
    return [
        lt.ApplyMasksUDF(mask_factories=lambda: rings, mask_count=n_rings),
        lt.CoMUDF.with_params(cy=32, cx=32, r=20),
        lt.SumUDF(), lt.SumSigUDF(), lt.StdDevUDF(),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "int64", "uint64", "float16",
                                   "uint16"])
def test_fused_run_any_dtype_on_card(card, dtype):
    """Datasets of wide and half-width dtypes go to the card at their
    own width and through the kernel (14 mask rows: two groups).  On
    float64 data ApplyMasksUDF asks for 64-bit sums, which the JAX
    package runs on its host engine: that run leaves it out (4 mask
    rows: one group)."""
    import libertem_tpu_torch as lt

    data = np.random.default_rng(3).poisson(
        8.0, (12, 10, 64, 64)).astype(dtype)
    wide = dtype == "float64"
    runs, launched = [], []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
        before = fused_moments.launches
        udfs = _ring_udfs(lt)
        runs.append(ctx.run_udf(ds, udfs[1:] if wide else udfs))
        launched.append(fused_moments.launches - before)
    _compare_runs(*runs)
    # 3 partitions of 40 frames, one block each; the CPU run takes the
    # plain version
    assert launched == [3 if wide else 6, 0]
    assert runs[0][-3]["intensity"].data.dtype == np.float32


@pytest.mark.cuda
def test_generic_run_with_roi_and_corrections_on_card(card):
    """The generic path on the card: tile UDFs (the five of the fused
    path among them, as matmuls and torch reductions), a vmapped
    nav-only process_frame, a frame loop with a sig buffer, with a roi
    and corrections, against the same run on the CPU."""
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.udf import UDF

    class FrameMaxUDF(UDF):
        def get_result_buffers(self):
            return {"m": self.buffer(kind="nav", dtype="float32")}

        def process_frame(self, frame):
            self.results.m = frame.max()

    class FrameTotalUDF(UDF):
        def get_result_buffers(self):
            return {"t": self.buffer(kind="sig", dtype="float32"),
                    "n": self.buffer(kind="nav", dtype="float32")}

        def process_frame(self, frame):
            self.results.t += frame
            self.results.n = frame.sum()

        def merge(self, dest, src):
            dest.t = dest.t + src.t

    rng = np.random.default_rng(4)
    data = rng.poisson(8.0, (12, 10, 64, 64)).astype(np.uint16)
    roi = rng.random((12, 10)) > 0.4
    excluded = np.zeros((64, 64), dtype=bool)
    excluded.flat[rng.choice(64 * 64, 12, replace=False)] = True
    corr = dict(dark=rng.normal(1.5, 0.3, (64, 64)).astype(np.float32),
                gain=(1 + 0.1 * rng.random((64, 64))).astype(np.float32),
                excluded_pixels=excluded)

    def udfs():
        return [lt.LogsumUDF(),
                lt.FEMUDF(center=(32, 32), rad_in=8, rad_out=20),
                lt.CrystallinityUDF(rad_in=2, rad_out=12,
                                    real_center=(32, 32), real_rad=6),
                lt.PickUDF(), FrameMaxUDF(), FrameTotalUDF()] + _ring_udfs(lt)

    runs = []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
        before = fused_moments.launches
        runs.append(ctx.run_udf(ds, udfs(), roi=roi,
                                corrections=lt.CorrectionSet(**corr)))
        assert fused_moments.launches == before
    _compare_runs(*runs)
    assert np.all(np.isnan(runs[0][4]["m"].data[~roi]))
