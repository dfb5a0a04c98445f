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
    # depths of one row, one row past a chunk, and a ragged last chunk
    ("u16", 1, 4096, 6, 1),
    ("u16", 65, 4096, 6, 65),
    ("u16", 1000, 16384, 6, 999),
    # the compacted width (a ragged last pixel chunk) and a ragged P
    ("u16", 1024, 5760, 17, 1024),
    ("u16", 300, 4100, 6, 300),
    ("u16", 128, 3001, 3, 100),
    # no valid row
    ("u16", 256, 4096, 6, 0),
    # mask counts around the groups of 8
    ("u16", 512, 4096, 1, 512),
    ("u16", 512, 4096, 8, 400),
    ("u16", 512, 4096, 9, 512),
    ("u16", 1024, 16384, 17, 1024),
    ("u16", 1024, 16384, 40, 1000),
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


@pytest.mark.cuda
@pytest.mark.parametrize("n_masks", [6, 17])
def test_fused_moments_graph_replays_identical(card, n_masks):
    """Three calls and two replays of 32 captured calls give identical
    bits: no atomics, sums in a fixed order."""
    rng = np.random.default_rng(n_masks)
    x = _block("u16", 1024, 16384, 1000, rng).to(card)
    masks = torch.from_numpy(
        rng.normal(size=(n_masks, 16384)).astype(np.float32)).to(card)
    first = fused_moments(x, masks, 1000)
    outs = [fused_moments(x, masks, 1000) for _ in range(2)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs += [fused_moments(x, masks, 1000) for _ in range(32)]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(first, out):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_masks", [6, 12, 40])
def test_fused_moments_launches_per_call(card, n_masks):
    """One call captured in a CUDA graph holds ceil(M / 8) + 1 kernel
    nodes (a partials kernel per group of 8 mask rows, one combine)
    and no copy or memset node."""
    import ctypes

    x = torch.ones((1024, 16384), dtype=torch.uint16, device=card)
    masks = torch.ones((n_masks, 16384), dtype=torch.float32, device=card)
    fused_moments(x, masks, 1024)  # builds the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fused_moments(x, masks, 1024)
    libcuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert libcuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset
    assert kinds.count(0) == -(-n_masks // 8) + 1, kinds
    assert 1 not in kinds and 2 not in kinds, kinds


@pytest.mark.cuda
def test_grid_plan_matches_the_library(card):
    """The planner's scratch size is the library's, and the library
    refuses a tile it does not take."""
    from libertem_tpu_torch.ops.moments import (
        Grid, _fused_moments_cuda, _library, plan_grid)

    lib = _library()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for depth, pixels, n_masks in [(1024, 16384, 6), (1024, 5760, 17),
                                   (65, 3001, 40), (1, 8, 1)]:
        grid = plan_grid(depth, pixels, sms)
        assert lib.fused_moments_scratch_floats(
            depth, pixels, n_masks, grid.rows) == grid.scratch_floats(
            depth, pixels, n_masks)
    x = torch.zeros((64, 1024), dtype=torch.uint16, device=card)
    m = torch.ones((1, 1024), device=card)
    with pytest.raises(RuntimeError, match="geometry"):
        _fused_moments_cuda(x, m, 64, True, Grid(30, 1, 3))


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
    float64 data ApplyMasksUDF asks for 64-bit sums, which run on the
    host engine, not through the kernel: that run leaves it out (4 mask
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


# -- block-compacted operands (sparse mask stacks) ------------------------------

def _disk_stack(n_pix_side=128):
    import libertem_tpu_torch as lt
    c = [46, 58, 70, 82]
    s = n_pix_side
    disks = lt.masks.sparse_circular_multi_stack(
        np.arange(16), np.repeat(c, 4), np.tile(c, 4), s, s, 4)
    return np.concatenate([lt.masks.circular(64, 64, s, s, 16)[None],
                           np.asarray(disks)]).reshape(17, -1).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [1024, 999])
def test_fused_moments_on_compacted_operand(card, valid):
    """The (depth, S*128) u16 block that a compacted masks-only pass
    gives the kernel: the kernel against its plain version on it, and
    its projections against the full frame's (the dropped blocks are
    zero in every mask)."""
    from libertem_tpu_torch.ops.sparse_masks import (
        gather_blocks, plan_compaction)

    stack = _disk_stack()
    plan = plan_compaction(stack)
    assert plan["support"].size == 45
    rng = np.random.default_rng(valid)
    x = rng.poisson(8.0, (1024, 128 * 128)).astype(np.uint16)
    x[valid:] = 0
    x = torch.from_numpy(x).to(card)
    gathered = gather_blocks(x, torch.from_numpy(plan["support"]).to(card))
    assert gathered.shape == (1024, 45 * 128)
    assert gathered.dtype == torch.uint16
    masks_c = torch.from_numpy(
        np.ascontiguousarray(plan["operand_c"].T)).to(card)
    before = fused_moments.launches
    got = fused_moments(gathered, masks_c, valid, compute_var=False)
    assert fused_moments.launches == before + 3
    want = fused_moments_reference(gathered, masks_c, valid,
                                   compute_var=False)
    for a, b in zip(got, want):
        _close(a, b)
    full = fused_moments(x, torch.from_numpy(stack).to(card), valid)[0]
    _close(got[0], full)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pixels", [
    (torch.uint16, 16384), (torch.float32, 16384), (torch.uint16, 1000),
    (torch.complex64, 4096),
])
def test_gather_blocks_on_card(card, dtype, pixels):
    """The gather on the card moves the same bits as on the CPU."""
    from libertem_tpu_torch.ops.sparse_masks import gather_blocks

    rng = np.random.default_rng(pixels)
    x = torch.from_numpy(rng.poisson(8.0, (64, pixels)).astype(np.int32))
    x = x.to(dtype)
    nb = -(-pixels // 128)
    support = np.sort(rng.choice(nb, 4, replace=False))
    support[-1] = nb - 1
    got = gather_blocks(x.to(card), torch.from_numpy(support).to(card))
    assert torch.equal(got.cpu(), gather_blocks(x, support))


@pytest.mark.cuda
def test_slice5_runs_on_card(card):
    """A numpy UDF beside a sparse fused pass, and the generic path
    with aux shifts, complex masks and pre/postprocess hooks, with a
    roi: the card's runs against the CPU's."""
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.ops.sparse_masks import compaction_pays
    from libertem_tpu_torch.udf import UDF

    class NumpyMax(UDF):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"m": self.buffer(kind="nav", dtype="float32")}

        def process_tile(self, tile):
            self.results.m[:] = tile.max(axis=(1, 2))

    class Hooked(UDF):
        def get_backends(self):
            return (self.BACKEND_TORCH,)

        def get_result_buffers(self):
            return {"s": self.buffer(kind="nav", dtype="float32")}

        def preprocess(self):
            self._scale = 0.5

        def process_tile(self, tile):
            self.results.s += tile.sum(dim=(1, 2)) * self._scale

        def postprocess(self):
            self.results.s[:] *= 4

    rng = np.random.default_rng(5)
    data = rng.poisson(8.0, (12, 10, 128, 128)).astype(np.uint16)
    roi = rng.random((12, 10)) > 0.4
    shifts = rng.integers(-3, 4, (120, 2))
    stack = _disk_stack().reshape(17, 128, 128)
    r, phi = lt.masks.polar_map(64, 64, 128, 128)
    harm = ((r < 40)[None] * np.exp(1j * np.arange(4)[:, None, None] * phi)
            ).astype(np.complex64)
    # 13 of 128 blocks: compacted before the generic matmul on both
    spots = lt.masks.sparse_circular_multi_stack(
        np.arange(4), [61, 61, 67, 67], [61, 67, 61, 67], 128, 128, 3)

    def udfs():
        return [
            lt.ApplyMasksUDF(mask_factories=lambda: stack, mask_count=17),
            NumpyMax(),
        ], [
            lt.ApplyMasksUDF(
                mask_factories=[lambda: stack[0]],
                shifts=UDF.aux_data(shifts, kind="nav", extra_shape=(2,),
                                    dtype=np.int64)),
            lt.ApplyMasksUDF(mask_factories=lambda: harm, mask_count=4),
            Hooked(),
            lt.ApplyMasksUDF(mask_factories=lambda: spots, mask_count=4),
        ]

    runs = []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
        first, second = udfs()
        before = fused_moments.launches
        a = ctx.run_udf(ds, first)
        info = ctx.run_info
        assert info["engines"] == ["device", "host"] and info["fused"]
        # the plan is the same on both devices; whether a run uses it
        # follows the device
        assert info["compaction"]["support"].size == 45
        assert info["compacted_blocks"] == (
            45 if compaction_pays(info["compaction"], device,
                                  "fused_moments") else None)
        launched = fused_moments.launches - before
        b = ctx.run_udf(ds, second, roi=roi)
        assert not ctx.run_info["fused"]
        assert second[3]._compact_op is not None
        runs.append((a + b, launched))
    (cuda_res, cuda_launched), (cpu_res, cpu_launched) = runs
    # 3 partitions of 40 frames, one block each, 3 mask groups
    assert (cuda_launched, cpu_launched) == (9, 0)
    for a, b in zip(cuda_res, cpu_res):
        for name in b:
            x, y = np.asarray(a[name].data), np.asarray(b[name].data)
            assert x.dtype == y.dtype, name
            scale = max(float(np.nanmax(np.abs(y), initial=0.0)), 1.0)
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=RTOL * scale,
                                       err_msg=name)


# -- the stage ablation -------------------------------------------------------

STAGE_CASES = [
    # kind, depth, pixels, masks, valid
    ("u16", 1024, 16384, 6, 1024),  # the main path's block
    ("u16", 1024, 16384, 40, 1024),
    ("u16", 1024, 5760, 17, 1024),  # the compacted shape
    ("u16", 1024, 16384, 12, 987),  # a tail, two mask groups
    ("u16", 100, 1000, 7, 77),      # unaligned rows, ragged edge
    ("u16", 65, 4096, 3, 65),       # a one-row last chunk
    ("u8", 256, 4096, 12, 200),
    ("f32", 96, 2048, 5, 96),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,depth,pixels,n_masks,valid", STAGE_CASES)
def test_fused_moments_stages(card, kind, depth, pixels, n_masks, valid):
    from libertem_tpu_torch.ops.ablation import (
        STAGES,
        fused_moments_stage,
        fused_moments_stage_reference,
    )

    rng = np.random.default_rng(depth + n_masks)
    x = _block(kind, depth, pixels, valid, rng).to(card)
    masks = torch.from_numpy(
        rng.normal(size=(n_masks, pixels)).astype(np.float32)
    ).to(card)
    for stage in STAGES:
        before = fused_moments_stage.launches
        got = fused_moments_stage(x, masks, valid, stage)
        assert fused_moments_stage.launches == before + -(-n_masks // 8)
        want = fused_moments_stage_reference(x, masks, valid, stage)
        for a, b in zip(got, want):
            if stage in ("load_min", "load") and kind != "f32":
                assert torch.equal(a, b), stage
            else:
                _close(a, b)
        if stage != "full":
            # the partials alone, for timing: nothing to read back
            assert fused_moments_stage(x, masks, valid, stage,
                                       combine=False) is None
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,depth,pixels,n_masks,valid", STAGE_CASES)
def test_full_stage_is_fused_moments_bit_for_bit(card, kind, depth, pixels,
                                                n_masks, valid):
    from libertem_tpu_torch.ops.ablation import fused_moments_stage

    rng = np.random.default_rng(depth + pixels + n_masks)
    x = _block(kind, depth, pixels, valid, rng).to(card)
    masks = torch.from_numpy(
        rng.normal(size=(n_masks, pixels)).astype(np.float32)
    ).to(card)
    prod = fused_moments(x, masks, valid)
    for stage in ("var", "full"):
        for a, b in zip(fused_moments_stage(x, masks, valid, stage), prod):
            assert torch.equal(a, b), stage


@pytest.mark.cuda
def test_stage_refuses_other_dtypes(card):
    from libertem_tpu_torch.ops.ablation import fused_moments_stage

    x = torch.zeros((64, 1024), dtype=torch.int16, device=card)
    with pytest.raises(TypeError):
        fused_moments_stage(x, torch.ones((1, 1024), device=card), 64, "load")


@pytest.mark.cuda
def test_run_udf_iter_with_patch_on_card(card):
    """Partial results on the card: the fused kernel runs every block,
    the patch after the second partial rebuilds the fused plan, and
    every partial equals the CPU run's."""
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.common.progress import ProgressReporter

    data = np.random.default_rng(11).poisson(8.0, (16, 8, 32, 32)).astype(
        np.uint16)
    old = lt.masks.circular(16, 16, 32, 32, 6)
    new = lt.masks.ring(16, 16, 32, 32, 12, 4)

    class Frames(ProgressReporter):
        def end(self, state):
            self.frames = state.num_frames_complete

    runs = []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=4)
        udfs = [lt.ApplyMasksUDF(mask_factories=[lambda: old]),
                lt.CoMUDF.with_params(cy=16, cx=16, r=10), lt.SumUDF(),
                lt.SumSigUDF(), lt.StdDevUDF()]
        rep = Frames()
        before = fused_moments.launches
        gen = ctx.run_udf_iter(ds, udfs, progress=rep)
        partials = []
        for i, res in enumerate(gen):
            assert ctx.run_info["fused"]
            partials.append((res.damage.data.copy(),
                             [{k: np.asarray(v.data) for k, v in b.items()}
                              for b in res.buffers]))
            if i == 1:
                gen.update_parameters_experimental(
                    [{"mask_factories": [lambda: new]}, {}, {}, {}, {}])
        assert rep.frames == 128
        runs.append((partials, fused_moments.launches - before))
    (cuda_parts, cuda_launched), (cpu_parts, cpu_launched) = runs
    # 4 partitions of 32 frames, one block each, one mask group
    assert (cuda_launched, cpu_launched) == (4, 0)
    flat = data.reshape(128, -1).astype(np.float64)
    want = np.where(np.arange(128) < 64, flat @ old.reshape(-1),
                    flat @ new.reshape(-1))
    np.testing.assert_allclose(
        cuda_parts[-1][1][0]["intensity"].reshape(-1), want, rtol=RTOL,
        atol=RTOL * np.abs(want).max())
    for (da, ba), (db, bb) in zip(cuda_parts, cpu_parts):
        assert np.array_equal(da, db)
        for a, b in zip(ba, bb):
            for name in b:
                scale = max(float(np.nanmax(np.abs(b[name]), initial=0.0)),
                            16.0 if name in ("raw_shifts", "field",
                                             "divergence", "curl",
                                             "magnitude", "field_y",
                                             "field_x") else 1.0)
                np.testing.assert_allclose(a[name], b[name], rtol=RTOL,
                                           atol=RTOL * scale, err_msg=name)


# -- the analysis layer on the card --------------------------------------
# Each analysis id, Context.map and the CoM regression on the card
# against the same run on the CPU: rtol 1e-5 with an absolute floor of
# 1e-5 of the CPU result's largest magnitude (the phases of complex
# coefficients: as exact as the coefficients).

_AN_SIG = (32, 32)
_AN_PARAMS = {
    "MASKS": lambda lt: {"factories": [
        lambda: lt.masks.circular(16, 16, 32, 32, 6),
        lambda: lt.masks.ring(16, 16, 32, 32, 14, 8),
        lambda: lt.masks.gradient_x(32, 32),
    ]},
    "APPLY_DISK_MASK": lambda lt: {"cx": 16, "cy": 16, "r": 6},
    "APPLY_RING_MASK": lambda lt: {"cx": 16, "cy": 16, "ri": 8, "ro": 14},
    "APPLY_POINT_SELECTOR": lambda lt: {"cx": 9, "cy": 20},
    "SUM_FRAMES": lambda lt: {},
    "SUM_SIG": lambda lt: {},
    "SD_FRAMES": lambda lt: {},
    "PICK_FRAME": lambda lt: {"x": 3, "y": 11},
    "CENTER_OF_MASS": lambda lt: {"cx": 16, "cy": 16, "r": 12,
                                  "scan_rotation": 17.0},
    "RADIAL_FOURIER": lambda lt: {"cx": 16, "cy": 16, "ri": 0, "ro": 15,
                                  "n_bins": 2, "max_order": 8},
    "FEM": lambda lt: {"cx": 16, "cy": 16, "ri": 5, "ro": 14},
    "APPLY_FFT_MASK": lambda lt: {"rad_in": 3, "rad_out": 12,
                                  "real_rad": 4, "real_centery": 16,
                                  "real_centerx": 16},
    "PICK_FFT_FRAME": lambda lt: {"x": 5, "y": 2},
    "FFTSUM_FRAMES": lambda lt: {},
    "CLUST": lambda lt: {"n_clust": 3, "n_peaks": 6, "rad": 1},
}


def _an_data():
    return np.random.default_rng(12).poisson(
        8.0, (16, 12) + _AN_SIG).astype(np.uint16)


def _close_results(ours, theirs):
    assert ours.keys() == theirs.keys()
    for a, b in zip(ours, theirs):
        x, y = np.asarray(a.raw_data), np.asarray(b.raw_data)
        if b.key.startswith("phase_"):
            # an angle is as exact as its coefficient c: |c| times the
            # angle's error within 1e-5 of |c| and of the largest |c|
            c = np.abs(np.asarray(theirs[b.key.replace("phase_",
                                                       "complex_")].raw_data))
            err = c * np.abs(np.angle(np.exp(1j * (x - y))))
            assert np.all(err <= RTOL * (c + c.max())), b.key
            continue
        cplx = np.iscomplexobj(y)
        scale = max(float(np.nanmax(np.abs(y), initial=0.0)), 1.0)
        dt = np.complex128 if cplx else np.float64
        np.testing.assert_allclose(x.astype(dt), y.astype(dt), rtol=RTOL,
                                   atol=RTOL * scale, err_msg=b.key)


@pytest.mark.cuda
@pytest.mark.parametrize("id_", sorted(_AN_PARAMS))
def test_analysis_on_card(card, id_):
    """Every analysis id through Context.run on the card and on the
    CPU; the fused kernel launches on the card wherever the run is
    fused."""
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.analysis.base import Analysis

    runs = []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=_an_data(), sig_dims=2)
        analysis = Analysis.get_analysis_by_type(id_)(ds,
                                                      _AN_PARAMS[id_](lt))
        before = fused_moments.launches
        runs.append((ctx.run(analysis), ctx.run_info["fused"],
                     fused_moments.launches - before))
    (ours, fused, launched), (theirs, cpu_fused, cpu_launched) = runs
    assert fused == cpu_fused
    assert cpu_launched == 0
    assert (launched > 0) == fused
    _close_results(ours, theirs)


@pytest.mark.cuda
def test_clust_feature_passes_on_card(card):
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.analysis.clust import ClusterAnalysis

    feats = []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=_an_data(), sig_dims=2)
        before = fused_moments.launches
        feats.append(ClusterAnalysis(ds, _AN_PARAMS["CLUST"](lt))
                     .run_feature_passes(ctx)[1])
        assert ctx.run_info["fused"]
        assert (fused_moments.launches > before) == (device == "cuda")
    np.testing.assert_allclose(feats[0], feats[1], rtol=RTOL,
                               atol=RTOL * np.abs(feats[1]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_map_on_card(card, kind):
    import libertem_tpu_torch as lt

    f = ((lambda fr: fr.sum(0)) if kind == "torch"
         else (lambda fr: np.asarray(fr).std(axis=1)))
    roi = np.zeros((16, 12), dtype=bool)
    roi[2:9, 3:10] = True
    res = []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=_an_data(), sig_dims=2)
        res.append(ctx.map(ds, f, roi=roi))
        assert ctx.run_info["engines"] == [
            "device" if kind == "torch" else "host"]
    assert res[0].data.dtype == res[1].data.dtype
    want = np.asarray(res[1].data, np.float64)
    np.testing.assert_allclose(np.asarray(res[0].data, np.float64), want,
                               rtol=RTOL,
                               atol=RTOL * np.nanmax(np.abs(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
def test_com_regression_on_card(card, mode):
    import libertem_tpu_torch as lt

    roi = np.ones((16, 12), dtype=bool)
    roi[5:8, 2:4] = False
    res = []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=_an_data(), sig_dims=2)
        res.append(ctx.run_udf(ds, lt.CoMUDF.with_params(
            cy=16, cx=16, r=12, regression=mode), roi=roi))
    scale = np.nanmax(np.abs(res[1]["raw_com"].data))
    for name in ("field", "magnitude", "divergence", "curl"):
        np.testing.assert_allclose(res[0][name].data, res[1][name].data,
                                   rtol=RTOL, atol=RTOL * scale,
                                   err_msg=name)
    coef = res[1]["regression"].data
    np.testing.assert_allclose(res[0]["regression"].data, coef, rtol=1e-4,
                               atol=1e-4 * np.abs(coef).max())


# -- slice 9: the FFT UDFs and the dataset core on the card ---------------


def _lattice_scan(nav=(6, 8), sig=(64, 64)):
    """CBED frames on a (16, 0), (0, 16) lattice whose zero order
    wanders with the scan position, Poisson noise: u16."""
    from libertem_tpu_torch.utils.generate import cbed_frame

    rng = np.random.default_rng(11)
    frames = []
    for i in range(int(np.prod(nav))):
        zero = (sig[0] // 2 + (i % 5) - 2, sig[1] // 2 + (i // 5) % 5 - 2)
        f, _, _ = cbed_frame(*sig, zero=zero, a=(16, 0), b=(0, 16),
                             radius=3)
        frames.append(rng.poisson(20.0 * f[0] + 1.0))
    return np.stack(frames).astype(np.uint16).reshape(nav + sig)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["full", "sparse", "holo"])
def test_fft_udfs_on_card(card, which):
    """The FFT UDFs on the card (cuFFT) against the same code on the CPU,
    beside Sum and StdDev in one pass: centres equal where the CPU map's
    peak is unique by more than 1e-4 of its value, refined positions
    within 1e-3 px, peak values and waves within 1e-4 of their largest
    magnitude; the generic path (no fused launch), as the JAX plan."""
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.udf import blobfinder as blob
    from libertem_tpu_torch.udf import holography as holo
    from libertem_tpu_torch.utils import frame_peaks

    data = _lattice_scan()
    _, peaks = frame_peaks(64, 64, np.array((32, 32)), np.array((16, 0)),
                           np.array((0, 16)), 3, np.mgrid[-1:2, -1:2])

    def udfs():
        if which == "full":
            first = blob.FullFrameCorrelationUDF(blob.RadialGradient(3))
        elif which == "sparse":
            first = blob.SparseCorrelationUDF(
                blob.BackgroundSubtraction(3, 5), peaks=peaks.astype(int),
                steps=3)
        else:
            first = holo.HoloReconstructUDF(
                out_shape=(31, 32), sb_position=(16, 16), sb_size=6)
        return [first, lt.SumUDF(), lt.StdDevUDF()]

    runs, launched = [], []
    for device in ("cuda", "cpu"):
        ctx = lt.Context(device=device)
        ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
        before = fused_moments.launches
        runs.append(ctx.run_udf(ds, udfs()))
        launched.append(fused_moments.launches - before)
        assert ctx.run_info["engines"] == ["device"] * 3
        assert not ctx.run_info["fused"]
    assert launched == [0, 0]
    _compare_runs(runs[0][1:], runs[1][1:])
    got, want = runs[0][0], runs[1][0]
    if which == "holo":
        w = want["wave"].data
        assert np.abs(got["wave"].data - w).max() <= 1e-4 * np.abs(w).max()
        return
    pv = want["peak_values"].data
    assert np.abs(got["peak_values"].data - pv).max() <= \
        1e-4 * np.abs(pv).max()
    same = np.all(got["centers"].data == want["centers"].data, axis=-1)
    assert same.mean() > 0.9
    close = np.abs(got["refineds"].data - want["refineds"].data) <= 1e-3
    assert np.all(close[same])


@pytest.mark.cuda
@pytest.mark.parametrize("so", [5, -5, 0])
@pytest.mark.parametrize("dtype", ["<u2", ">u2", ">f4"])
def test_fused_path_sync_offset_byte_order_on_card(card, tmp_path, so,
                                                   dtype):
    """The fused kernel under a sync offset and on big-endian raw data,
    each io backend: the card's run against the same run on the CPU
    (the kernel's plain version), and the kernel launched once per block
    (and mask group)."""
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.io.dataset.base import IOBackend

    data = np.random.default_rng(12).poisson(
        8.0, (12, 10, 64, 64)).astype(dtype)
    path = str(tmp_path / "scan.raw")
    data.tofile(path)
    for backend in ("buffered", "mmap", "direct"):
        runs, launched = [], []
        for device in ("cuda", "cpu"):
            ctx = lt.Context(device=device)
            ds = ctx.load("raw", path=path, dtype=dtype, nav_shape=(12, 10),
                          sig_shape=(64, 64), sync_offset=so,
                          num_partitions=3,
                          io_backend=IOBackend.from_json({"id": backend}))
            before = fused_moments.launches
            runs.append(ctx.run_udf(ds, _ring_udfs(lt)))
            launched.append(fused_moments.launches - before)
            assert ctx.run_info["fused"]
        _compare_runs(*runs)
        assert launched == [6, 0]
        flat = data.reshape(120, -1).astype(np.float64)
        ids = np.arange(120) + so
        ok = (ids >= 0) & (ids < 120)
        want = flat[ids[ok]].sum(1)
        got = runs[0][3]["intensity"].data.reshape(-1)
        np.testing.assert_allclose(got[ok], want, rtol=RTOL)
        assert np.all(got[~ok] == 0)


def _write_events(dirpath, n, sig, seed):
    """Raw CSR of ``n`` frames of random single-electron hits, every
    7th frame's first pixel listed twice: the TOML path."""
    import os
    rng = np.random.default_rng(seed)
    px = sig[0] * sig[1]
    counts = rng.poisson(40, n)
    cols = rng.integers(0, px, counts.sum()).astype("<i4")
    vals = rng.integers(1, 5, counts.sum()).astype("<u2")
    indptr = np.concatenate(([0], np.cumsum(counts)))
    dup = np.flatnonzero((np.arange(n) % 7 == 0) & (counts > 0))
    cols = np.insert(cols, indptr[dup] + 1, cols[indptr[dup]])
    vals = np.insert(vals, indptr[dup] + 1, 3).astype("<u2")
    counts[dup] += 1
    indptr = np.concatenate(([0], np.cumsum(counts))).astype("<i8")
    for name, arr in (("indptr", indptr), ("indices", cols), ("data", vals)):
        arr.tofile(os.path.join(dirpath, f"{name}.bin"))
    path = os.path.join(dirpath, "events.toml")
    with open(path, "w") as f:
        f.write('[params]\nfiletype = "raw_csr"\n'
                f"nav_shape = [12, {n // 12}]\nsig_shape = {list(sig)}\n\n"
                '[raw_csr]\nindptr_file = "indptr.bin"\n'
                'indptr_dtype = "<i8"\nindices_file = "indices.bin"\n'
                'indices_dtype = "<i4"\ndata_file = "data.bin"\n'
                'data_dtype = "<u2"\n')
    return path


@pytest.mark.cuda
def test_densify_on_card(card):
    """The raw CSR densify on the card against its CPU version, exact
    for integer data (unsigned types wrap as on the CPU)."""
    from libertem_tpu_torch.io.dataset.base import densify_into

    rng = np.random.default_rng(8)
    for dtype, hi in ((torch.uint8, 200), (torch.uint16, 60000),
                      (torch.uint32, 1 << 31), (torch.int64, 1 << 40),
                      (torch.float32, 1000)):
        vals = torch.from_numpy(rng.integers(0, hi, 4096)).to(dtype)
        rows = torch.from_numpy(rng.integers(0, 64, 4096).astype(np.int32))
        cols = torch.from_numpy(rng.integers(0, 512, 4096).astype(np.int32))
        cpu = torch.empty((64, 1024), dtype=dtype)
        densify_into(cpu, vals, rows, cols)
        dev = torch.full((64, 1024), 3, device=card).to(dtype)
        densify_into(dev, vals.to(card), rows.to(card), cols.to(card))
        if dtype.is_floating_point:
            assert torch.allclose(dev.cpu(), cpu, rtol=1e-6)
        else:
            assert torch.equal(dev.cpu(), cpu)


@pytest.mark.cuda
def test_new_formats_on_card(card, tmp_path):
    """Raw CSR (densified on the card, its H2D bytes the entries'), a
    live ring fed by a thread, and an array-like: the card's fused run
    against the same run on the CPU, the kernel launched once a block."""
    import threading

    import libertem_tpu_torch as lt
    from libertem_tpu_torch.io.dataset.live import LiveDataSet

    sig = (64, 64)
    csr = _write_events(str(tmp_path), 120, sig, 4)
    data = np.random.default_rng(5).poisson(3.0, (12, 10) + sig).astype(
        np.uint16)

    def load(kind, ctx):
        if kind == "raw_csr":
            return ctx.load("raw_csr", path=csr, num_partitions=3)
        if kind == "dask":
            return ctx.load("dask", array=data)
        ds = LiveDataSet(nav_shape=(12, 10), sig_shape=sig, dtype="uint16",
                         ring_capacity=64, num_partitions=3)
        threading.Thread(target=lambda: (ds.push_frames(data),
                                         ds.finish()), daemon=True).start()
        return ds

    for kind in ("raw_csr", "live", "dask"):
        runs, launched, stats = [], [], []
        for device in (card, "cpu"):
            ctx = lt.Context(device=device)
            before = fused_moments.launches
            runs.append(ctx.run_udf(load(kind, ctx), _ring_udfs(lt)))
            launched.append(fused_moments.launches - before)
            stats.append(dict(ctx.feed_stats))
            assert ctx.run_info["fused"]
        _compare_runs(*runs)
        # 14 mask rows: two launches a block
        assert launched == [2 * stats[0]["blocks"], 0]
        if kind == "raw_csr":
            dense = 120 * 64 * 64 * 2
            assert 0 < stats[0]["h2d_bytes"] < dense / 4
