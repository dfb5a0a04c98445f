"""The fused-moments kernel's product arithmetic, on the CPU.

The CUDA kernel (``libertem_tpu_torch/csrc/fused_moments.cuh``) computes
``y = x @ masks.T`` on the tensor cores in the 3xTF32 form: each
operand split into hi (TF32, rounded to nearest, ties away from zero,
as ``cvt.rna.tf32.f32``) and lo (the rest, which the tensor cores read
truncated to TF32), and ``x_hi m_hi + x_hi m_lo + x_lo m_hi``
accumulated in float32.  ``product_3xtf32`` below is a plain numpy model
of that arithmetic in the kernel's tiling and order: per CTA pixel chunk
of the grid plan, its 128-pixel sub-tiles in order, per warp a 32-pixel
unit of each sub-tile, the four k-steps of a unit in order (step q takes pixels 8t + 2q and
8t + 2q + 1 of the unit's quarters t), each MMA adding its 8 products
(summed exactly, then rounded into the float32 accumulator), the three
passes in the kernel's order; then the four warps summed in order, then
the pixel chunks in the combine kernel's lanes and tree.

It is held against the JAX package's ``_fused_moments_xla`` and
``_fused_moments_pallas`` (interpret mode, as
``tests/test_torch_moments.py`` runs it) and a float64 product, on
u8 / u16 / i16 / f32 blocks with signed masks, among them dark- and
gain-corrected float32 blocks of large mean: rtol 1e-5 with an absolute
floor of 1e-5 of the largest magnitude, and the error relative to
``|x| @ |m|`` below 1e-5 (the JAX package's split-matmul contract,
``tests/test_moments.py::test_split_matmul_accuracy_sweep``).  TF32
alone misses that contract, which is why the kernel takes three
passes.  The kernel itself is held against these on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
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
    SUB_PX,
    Grid,
    fused_moments_reference,
    plan_grid,
    tf32_passes,
)

torch.set_num_threads(1)

RTOL = 1e-5
UNIT_PX = 32          # pixels of a warp's unit
WARPS = SUB_PX // UNIT_PX
COMBINE_LANES = 8     # LANES in the source


def tf32_round(a):
    """float32 to TF32, rounded to nearest with ties away from zero as
    ``cvt.rna.tf32.f32`` does (and the kernel's integer rounding): the
    low 13 mantissa bits cleared after adding half of their weight to
    the magnitude."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_truncate(a):
    """float32 to TF32 toward zero: what the tensor cores read of an
    f32 operand (its top 19 bits)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(a):
    """``(hi, lo)``: the kernel's 3xTF32 operands as the tensor cores
    read them, hi = tf32(a) rounded to nearest, lo = a - hi (exact in
    float32) truncated to TF32."""
    a = np.asarray(a, dtype=np.float32)
    hi = tf32_round(a)
    return hi, tf32_truncate(a - hi)


def _lane_tree(parts):
    """Sum ``parts`` (one per pixel chunk) as the combine kernel does:
    lane g of 8 takes chunks g, g + 8, ... in order, then the lanes
    pair up at distance 1, 2 and 4, the lower lane first (float32)."""
    lanes = []
    for g in range(COMBINE_LANES):
        acc = None
        for part in parts[g::COMBINE_LANES]:
            acc = part if acc is None else (acc + part).astype(np.float32)
        lanes.append(acc)
    off = 1
    while off < COMBINE_LANES:
        for g in range(0, COMBINE_LANES, 2 * off):
            lo, hi = lanes[g], lanes[g + off]
            lanes[g] = lo if hi is None else hi if lo is None else (
                lo + hi).astype(np.float32)
        off *= 2
    return lanes[0]


def _k_order():
    """The unit's pixels in the kernel's k order: step q, k = t (pixel
    8t + 2q) for t = 0..3, then k = t + 4 (pixel 8t + 2q + 1)."""
    return np.array([[8 * t + 2 * q + h for h in (0, 1) for t in range(4)]
                     for q in range(4)])


def product_3xtf32(x, masks, grid: Grid):
    """Plain numpy model of the kernel's y (float32), see the module
    docstring."""
    depth, pixels = x.shape
    n_masks = masks.shape[0]
    xf = np.asarray(x).astype(np.float32)
    n_tiles = -(-pixels // SUB_PX)
    padded = n_tiles * SUB_PX
    xh, xl = (np.pad(a, ((0, 0), (0, padded - pixels)))
              for a in tf32_split(xf))
    mh, ml = (np.pad(a, ((0, 0), (0, padded - pixels))).astype(np.float64)
              for a in tf32_split(masks))
    xh, xl = xh.astype(np.float64), xl.astype(np.float64)
    order = _k_order()
    parts = []
    for pc in range(grid.n_pc):
        warps = []
        for w in range(WARPS):
            acc = np.zeros((depth, n_masks), np.float32)
            # the CTA's sub-tiles: those of its pixel chunk, in order
            per_cta = grid.chunk // SUB_PX
            for sub in range(pc * per_cta,
                             min((pc + 1) * per_cta, n_tiles)):
                base = sub * SUB_PX + w * UNIT_PX
                for q in range(4):
                    px = base + order[q]
                    for a, b in ((xh, mh), (xh, ml), (xl, mh)):
                        # one MMA: 8 products summed, then the add into
                        # the float32 accumulator
                        acc = (acc + a[:, px] @ b[:, px].T).astype(
                            np.float32)
            warps.append(acc)
        part = warps[0]
        for acc in warps[1:]:
            part = (part + acc).astype(np.float32)
        parts.append(part)
    return _lane_tree(parts)


def _rel_err(y, x, masks):
    """|y - x m| relative to |x| |m|, float64 (the JAX package's
    split-matmul metric)."""
    xd = np.asarray(x).astype(np.float32).astype(np.float64)
    md = masks.astype(np.float64)
    return np.abs(np.asarray(y, np.float64) - xd @ md.T) / np.maximum(
        np.abs(xd) @ np.abs(md).T, 1e-30)


def _close(actual, expected):
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    scale = max(float(np.abs(expected).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(actual, expected, rtol=RTOL,
                               atol=RTOL * scale)


def _block(kind, depth, pixels, seed):
    rng = np.random.default_rng(seed)
    if kind == "corrected":
        dark = rng.normal(100.0, 5.0, pixels).astype(np.float32)
        gain = (1.0 + 0.2 * rng.random(pixels)).astype(np.float32)
        raw = rng.poisson(1000.0, (depth, pixels)).astype(np.float32)
        return (raw - dark) * gain
    if kind == "f32":
        return rng.normal(0, 100, (depth, pixels)).astype(np.float32)
    dtype = {"u8": np.uint8, "u16": np.uint16, "i16": np.int16}[kind]
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, (depth, pixels)).astype(dtype)


def test_tf32_rounding_and_split():
    """hi is round-to-nearest with ties away from zero at 10 mantissa
    bits; hi + lo is the value exactly before lo's truncation; TF32
    keeps every integer up to 2048 exactly."""
    assert tf32_round(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)
    assert tf32_round(np.float32(-(1 + 2 ** -11))) == np.float32(
        -(1 + 2 ** -10))
    assert tf32_round(np.float32(1 + 2 ** -12)) == np.float32(1.0)
    assert tf32_truncate(np.float32(1 + 2 ** -10 + 2 ** -12)) == np.float32(
        1 + 2 ** -10)
    ints = np.arange(-2048, 2049, dtype=np.float32)
    hi, lo = tf32_split(ints)
    assert np.array_equal(hi, ints) and not lo.any()
    v = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    hi, lo = tf32_split(v)
    exact = v.astype(np.float64) - hi.astype(np.float64)
    assert np.all(np.abs(exact) <= 2.0 ** -11 * np.abs(v))
    assert np.all(np.abs(exact - lo) <= 2.0 ** -10 * np.abs(exact))


def test_passes_follow_the_data():
    """Counts below 2^11 and 0/1 masks need one TF32 pass; signed
    masks a second; large counts or float data a third."""
    small = torch.from_numpy(np.random.default_rng(1).poisson(
        8.0, (16, 64)).astype(np.uint16))
    binary = torch.from_numpy((np.arange(2 * 64).reshape(2, 64) % 3 == 0)
                              .astype(np.float32))
    signed = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64)).astype(np.float32))
    wide = torch.full((16, 64), 40001, dtype=torch.int32)
    assert tf32_passes(small, binary) == 1
    assert tf32_passes(small, signed) == 2
    assert tf32_passes(wide, signed) == 3


CASES = [
    # kind, depth, pixels, masks
    ("u8", 64, 1000, 6),
    ("u16", 96, 2304, 6),
    ("u16", 48, 1280, 17),
    ("i16", 64, 777, 9),
    ("f32", 80, 1024, 5),
    ("corrected", 96, 2304, 12),
    ("corrected", 64, 1536, 40),
]


@pytest.mark.parametrize("kind,depth,pixels,n_masks", CASES)
def test_3xtf32_model_matches_xla_pallas_and_float64(kind, depth, pixels,
                                                     n_masks):
    x = _block(kind, depth, pixels, seed=depth + n_masks)
    # signed masks force cancellation in the accumulation
    masks = np.random.default_rng(pixels).normal(
        size=(n_masks, pixels)).astype(np.float32)
    grid = plan_grid(depth, pixels, n_masks=n_masks,
                     itemsize=x.dtype.itemsize)
    ours = product_3xtf32(x, masks, grid)
    assert _rel_err(ours, x, masks).max() < RTOL
    xla = _fused_moments_xla(jnp.asarray(x), jnp.asarray(masks),
                             jnp.int32(depth))[0]
    pallas = _fused_moments_pallas(jnp.asarray(x), jnp.asarray(masks),
                                   jnp.int32(depth), interpret=True)[0]
    _close(ours, xla)
    _close(ours, pallas)
    _close(ours, fused_moments_reference(
        torch.from_numpy(x), torch.from_numpy(masks), depth)[0])


@pytest.mark.parametrize("chunk", [128, 256, 1024])
def test_3xtf32_model_in_every_chunk_width(chunk):
    """The model at each chunk width the plan may choose, with a ragged
    last sub-tile, agrees with float64 within the contract."""
    x = _block("corrected", 32, 1000, seed=chunk)
    masks = np.random.default_rng(3).normal(size=(8, 1000)).astype(
        np.float32)
    grid = Grid(16, -(-1000 // chunk), 2, chunk)
    assert _rel_err(product_3xtf32(x, masks, grid), x, masks).max() < RTOL


def test_one_tf32_pass_misses_the_contract():
    """x_hi m_hi alone (plain TF32) on corrected float32 data and
    signed masks misses 1e-5: the kernel needs the lo passes."""
    x = _block("corrected", 64, 1024, seed=5)
    masks = np.random.default_rng(6).normal(size=(6, 1024)).astype(
        np.float32)
    xh = tf32_split(x)[0].astype(np.float64)
    mh = tf32_split(masks)[0].astype(np.float64)
    assert _rel_err(xh @ mh.T, x, masks).max() > RTOL
