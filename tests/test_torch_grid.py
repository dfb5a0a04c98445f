"""The fused-moments kernel's grid plan and its order of arithmetic,
on the CPU.

``plan_grid`` (``libertem_tpu_torch/ops/moments.py``) picks the CTA
tile the CUDA kernel's partials run a block with; the scratch is sized
from it.  ``fused_moments_tiled`` below is a plain PyTorch model of the
kernel's arithmetic in that tiling (shifted moments per row chunk,
partial projections per pixel chunk, both folded in the combine
kernel's order of lanes and tree, all float32): it is held against
the JAX package's ``_fused_moments_xla`` and
``_fused_moments_pallas`` in interpret
mode, as ``tests/test_torch_moments.py`` runs them, with rtol 1e-5 and
an absolute floor of 1e-5 of the largest magnitude (float32 on both
sides, other summation orders).  The stage ablation's ``load_min``
plain version reads the first and last row of each of the planner's
row chunks, checked exactly against the JAX stage's definition at that
step.  The kernel itself is held against these on the card
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
from libertem_tpu_torch.ops.ablation import fused_moments_stage
from libertem_tpu_torch.ops.moments import (
    CHUNK_PX,
    H100_SMS,
    MAX_ROWS,
    ROW_CHOICES,
    TARGET_CTAS_PER_SM,
    Grid,
    fused_moments_reference,
    grid_for,
    plan_grid,
)

torch.set_num_threads(1)

RTOL = 1e-5
# lanes of the combine kernel that fold one output (LANES in
# csrc/fused_moments.cu)
COMBINE_LANES = 8


def _chan(a, b):
    """(n, mean, m2) of two disjoint sets of rows, ``a`` before ``b``,
    as the combine kernel's ``chan``: an empty side leaves the other
    as it is."""
    na, ma, qa = a
    nb, mb, qb = b
    if nb == 0:
        return a
    if na == 0:
        return b
    nn = na + nb
    f32 = torch.float32
    delta = mb - ma
    return (nn, ma + delta * (torch.tensor(nb, dtype=f32) / nn),
            qa + qb + delta * delta * (torch.tensor(na * nb, dtype=f32) / nn))


def _lane_tree(parts, add):
    """Fold ``parts`` (one per chunk, in chunk order) as the combine
    kernel does: lane g of 8 takes chunks g, g + 8, ... in order, then
    the lanes pair up at distance 1, 2 and 4, the lower lane first."""
    lanes = []
    for g in range(COMBINE_LANES):
        acc = None
        for part in parts[g::COMBINE_LANES]:
            acc = part if acc is None else add(acc, part)
        lanes.append(acc)
    off = 1
    while off < COMBINE_LANES:
        for g in range(0, COMBINE_LANES, 2 * off):
            lo, hi = lanes[g], lanes[g + off]
            lanes[g] = lo if hi is None else hi if lo is None else add(lo, hi)
        off *= 2
    return lanes[0]


def fused_moments_tiled(x, masks_t, valid_count: int,
                        compute_var: bool = True, grid: Grid | None = None):
    """Plain PyTorch model of the kernel's order of arithmetic, in
    float32: per row chunk of ``grid`` the shifted moments about the
    chunk's first row; per pixel chunk the partial projections; both
    folded as the combine kernel folds them (chunk means relative to
    chunk 0's shift, Chan/Golub/LeVeque for the variance)."""
    grid = grid or grid_for(x)
    depth, pixels = x.shape
    valid = int(valid_count)
    xt = x.to(torch.float32)
    ys = [xt[:, lo:lo + CHUNK_PX] @ masks_t[:, lo:lo + CHUNK_PX].T
          for lo in range(0, pixels, CHUNK_PX)]
    y = _lane_tree(ys, torch.add)
    chunks = [xt[r0:r0 + grid.rows] for r0 in range(0, depth, grid.rows)]
    colsum = _lane_tree([c.sum(dim=0) for c in chunks], torch.add)
    n_var = min(grid.n_rc, -(-valid // grid.rows)) if compute_var else 0
    if n_var == 0:
        return y, colsum, torch.zeros_like(colsum)
    c0 = chunks[0][0]
    parts = []
    for j in range(n_var):
        nb = min(chunks[j].shape[0], valid - j * grid.rows)
        d = chunks[j][:nb] - chunks[j][0]
        s1 = d.sum(dim=0)
        m1 = s1 / max(nb, 1)
        q = torch.clamp(torch.sum(d * d, dim=0) - s1 * m1, min=0.0)
        parts.append((nb, (chunks[j][0] - c0) + m1, q))
    return y, colsum, _lane_tree(parts, _chan)[2]

SHAPES = [
    # depth, pixels
    (1024, 16384),  # the main path's block
    (1024, 5760),   # the compacted sparse stack
    (1000, 16384),
    (1, 8),
    (65, 3001),
    (4096, 65536),  # a 256 x 256 detector
    (32, 128),
]


def _close(actual, expected):
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    scale = max(float(np.abs(expected).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(actual, expected, rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("depth,pixels", SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 114, 8])
def test_plan_covers_every_row_and_pixel_once(depth, pixels, sms):
    grid = plan_grid(depth, pixels, sms)
    assert grid.rows % 4 == 0 and 0 < grid.rows <= MAX_ROWS
    # the chunks tile the block: the last one starts inside it
    assert (grid.n_pc - 1) * CHUNK_PX < pixels <= grid.n_pc * CHUNK_PX
    assert (grid.n_rc - 1) * grid.rows < depth <= grid.n_rc * grid.rows
    # a CTA's tile is (row chunk) x (pixel chunk), so the grid covers
    # every (row, pixel) once exactly when the row chunks cover every
    # row once and the pixel chunks every pixel once
    rows_covered = np.zeros(depth, np.int32)
    for rc in range(grid.n_rc):
        rows_covered[rc * grid.rows:(rc + 1) * grid.rows] += 1
    px_covered = np.zeros(pixels, np.int32)
    for pc in range(grid.n_pc):
        px_covered[pc * CHUNK_PX:(pc + 1) * CHUNK_PX] += 1
    assert np.all(rows_covered == 1) and np.all(px_covered == 1)


@pytest.mark.parametrize("depth,pixels", SHAPES)
@pytest.mark.parametrize("n_masks", [1, 6, 8, 17, 40])
def test_partials_fit_the_scratch(depth, pixels, n_masks):
    """y's partials of every mask group, (n_pc, depth, Mg) each, then
    four (n_rc, pixels) moment partials after a 64-float boundary."""
    grid = plan_grid(depth, pixels)
    groups = [min(8, n_masks - m0) for m0 in range(0, n_masks, 8)]
    ypart = sum(grid.n_pc * depth * mg for mg in groups)
    assert ypart == grid.n_pc * depth * n_masks
    floats = grid.scratch_floats(depth, pixels, n_masks)
    assert floats == -(-ypart // 64) * 64 + 4 * grid.n_rc * pixels
    assert grid.ctas == grid.n_pc * grid.n_rc


@pytest.mark.parametrize("pixels", [16384, 5760])
def test_plan_reaches_its_target_on_the_h100(pixels):
    """The main path's block and the compacted sparse stack's each give
    the grid at least TARGET_CTAS_PER_SM CTAs an SM, with the most rows
    a CTA that do."""
    grid = plan_grid(1024, pixels, H100_SMS)
    assert grid.ctas >= TARGET_CTAS_PER_SM * H100_SMS
    more = [r for r in ROW_CHOICES if r > grid.rows]
    for rows in more:
        assert grid.n_pc * -(-1024 // rows) < TARGET_CTAS_PER_SM * H100_SMS


def test_plan_of_a_small_block_takes_the_fewest_rows():
    assert plan_grid(32, 128).rows == ROW_CHOICES[-1]


def test_grid_for_cpu_tensor_is_the_h100_plan():
    x = torch.zeros((1024, 5760), dtype=torch.uint16)
    assert grid_for(x) == plan_grid(1024, 5760, H100_SMS)


def _corrected(depth, pixels, valid, seed):
    """Dark- and gain-corrected counts: large means, narrow spread."""
    rng = np.random.default_rng(seed)
    dark = rng.normal(100.0, 5.0, pixels).astype(np.float32)
    gain = (1.0 + 0.2 * rng.random(pixels)).astype(np.float32)
    x = (rng.poisson(1000.0, (depth, pixels)).astype(np.float32)
         - dark) * gain
    x[valid:] = 0
    return x


BLOCKS = [
    # name, depth, pixels, valid
    ("corrected", 192, 2304, 192),
    ("corrected", 192, 2304, 150),
    ("constant", 192, 2304, 192),
]


def _model(x, masks, valid, grid=None):
    return [t.numpy() for t in fused_moments_tiled(
        torch.from_numpy(x), torch.from_numpy(masks), valid, grid=grid)]


@pytest.mark.parametrize("name,depth,pixels,valid", BLOCKS)
@pytest.mark.parametrize("rows", [None, 16, 64])
def test_tiled_model_matches_xla_and_pallas(name, depth, pixels, valid,
                                            rows):
    x = (_corrected(depth, pixels, valid, seed=valid) if name == "corrected"
         else np.full((depth, pixels), 1000.123, np.float32))
    masks = np.random.default_rng(3).normal(
        size=(6, pixels)).astype(np.float32)
    grid = None if rows is None else Grid(
        rows, -(-pixels // CHUNK_PX), -(-depth // rows))
    ours = _model(x, masks, valid, grid)
    xla = _fused_moments_xla(jnp.asarray(x), jnp.asarray(masks),
                             jnp.int32(valid))
    pallas = _fused_moments_pallas(jnp.asarray(x), jnp.asarray(masks),
                                   jnp.int32(valid), interpret=True)
    for mine, q, p in zip(ours, xla, pallas):
        _close(mine, q)
        _close(mine, p)
    if name == "constant":
        # the shifted moments give exactly 0, not a rounding residue
        assert np.all(ours[2] == 0.0)


def test_tiled_model_variance_off_and_empty():
    x = _corrected(64, 1100, 64, seed=1)
    masks = np.ones((2, 1100), np.float32)
    y, colsum, colvar = fused_moments_tiled(
        torch.from_numpy(x), torch.from_numpy(masks), 64, compute_var=False)
    assert torch.all(colvar == 0)
    ref = fused_moments_reference(torch.from_numpy(x),
                                  torch.from_numpy(masks), 64)
    _close(y, ref[0])
    _close(colsum, ref[1])
    x[:] = 0
    assert torch.all(fused_moments_tiled(
        torch.from_numpy(x), torch.from_numpy(masks), 0)[2] == 0)


@pytest.mark.parametrize("depth,pixels,valid", [
    (1024, 5760, 1024), (256, 2048, 256), (100, 300, 100),
])
def test_load_min_at_the_planner_rows(depth, pixels, valid):
    """load_min: rows 0 and rows - 1 of every step of the planner's
    rows (bench_kernel_ablation.py:60-77 with TD = those rows), and the
    first and last row of a short last chunk."""
    rng = np.random.default_rng(depth)
    x = rng.poisson(8.0, (depth, pixels)).astype(np.uint16)
    masks = np.ones((1, pixels), np.float32)
    rows = plan_grid(depth, pixels).rows
    _, colsum, _ = fused_moments_stage(
        torch.from_numpy(x), torch.from_numpy(masks), valid, "load_min")
    wide = x.astype(np.int64)
    ends = sorted({r for r0 in range(0, depth, rows)
                   for r in (r0, min(r0 + rows, depth) - 1)})
    assert np.array_equal(colsum.numpy(), wide[ends].sum(axis=0))
    if depth % rows == 0:
        steps = wide.reshape(depth // rows, rows, pixels)
        want = (steps[:, 0] + steps[:, rows - 1]).sum(axis=0)
        assert np.array_equal(colsum.numpy(), want)
