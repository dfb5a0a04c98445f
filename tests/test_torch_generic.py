"""The port's generic UDF path and rois against the JAX package's, on
the CPU.

The same numpy data goes through ``libertem_tpu_torch.Context(
device="cpu")`` and ``libertem_tpu.api.Context``; the user UDFs of
``tests/test_udf_methods.py`` are written once with jnp (imported from
there) and once with torch (here).  Both packages compute in float32
with different summation orders: rtol 1e-5, with an absolute floor of
1e-5 of the buffer's largest magnitude (CoM shifts, divergence and
curl are differences of centres, so their floor follows the centres'
magnitude).  The goldens of ``tests/goldens`` are held at the
tolerances of ``tests/test_parity_reference.py``; PickUDF is exact.
"""
import numpy as np
import pytest
import torch

import golden_common as gc
import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from conftest import _mk_random
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet
from test_parity_reference import _golden
from test_udf_methods import (
    FrameNavUDF as JaxFrameNavUDF,
    FrameStatsUDF as JaxFrameStatsUDF,
    PartitionSumUDF as JaxPartitionSumUDF,
    TiledNavUDF as JaxTiledNavUDF,
    TiledSumUDF as JaxTiledSumUDF,
)

import libertem_tpu_torch as port
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet
from libertem_tpu_torch.io.tiling import Negotiator
from libertem_tpu_torch.ops.moments import fused_moments
from libertem_tpu_torch.udf import UDF
from libertem_tpu_torch.udf.base import UDFRunner

torch.set_num_threads(1)

RTOL = 1e-5
# buffers whose absolute floor follows another buffer's magnitude
SCALE_OF = {
    "raw_shifts": "raw_com", "field": "raw_com", "field_y": "raw_com",
    "field_x": "raw_com", "magnitude": "raw_com",
    "divergence": "raw_com", "curl": "raw_com",
}


def _compare(ours, theirs):
    if isinstance(theirs, dict):
        ours, theirs = [ours], [theirs]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for name in b:
            x = np.asarray(a[name].data, dtype=np.float64)
            y = np.asarray(b[name].data, dtype=np.float64)
            ref = np.asarray(b[SCALE_OF.get(name, name)].data, np.float64)
            scale = max(float(np.nanmax(np.abs(ref), initial=0.0)), 1.0)
            assert x.shape == y.shape, name
            np.testing.assert_allclose(
                x, y, rtol=RTOL, atol=RTOL * scale, err_msg=name,
            )
            assert np.array_equal(
                np.asarray(a[name].valid_mask),
                np.asarray(b[name].valid_mask),
            ), name


def _run_both(data, ours_udfs, theirs_udfs, num_partitions=2, **kw):
    ctx = port.Context(device="cpu")
    ours = ctx.run_udf(
        ctx.load("memory", data=data, sig_dims=2,
                 num_partitions=num_partitions),
        ours_udfs, **kw,
    )
    theirs = JaxContext(executor=InlineJobExecutor()).run_udf(
        JaxMemoryDataSet(data=data, sig_dims=2,
                         num_partitions=num_partitions),
        theirs_udfs, **kw,
    )
    return ours, theirs


@pytest.fixture(scope="module")
def data():
    return _mk_random((5, 6, 16, 16), dtype="float32")


# -- the user UDFs of tests/test_udf_methods.py, in torch ----------------

class TiledSumUDF(UDF):
    """Sum with forced sig tiling: the K > 1 path."""

    def get_result_buffers(self):
        return {"intensity": self.buffer(kind="sig", dtype="float32")}

    def get_tiling_preferences(self):
        # 16x16 f32 frame = 1024 B; 512 splits sig in half
        return {"depth": 8, "total_size": 512}

    def process_tile(self, tile):
        self.results.intensity += tile.sum(dim=0)

    def merge(self, dest, src):
        dest.intensity = dest.intensity + src.intensity


class TiledNavUDF(UDF):
    """nav output accumulated across sig tiles."""

    def get_result_buffers(self):
        return {"intensity": self.buffer(kind="nav", dtype="float32")}

    def get_tiling_preferences(self):
        return {"depth": 8, "total_size": 512}

    def process_tile(self, tile):
        self.results.intensity += tile.sum(dim=tuple(range(1, tile.ndim)))


class FrameStatsUDF(UDF):
    """frame mode writing nav and sig buffers: the frame loop."""

    def get_result_buffers(self):
        return {
            "maxes": self.buffer(kind="nav", dtype="float32"),
            "total": self.buffer(kind="sig", dtype="float32"),
        }

    def process_frame(self, frame):
        self.results.maxes = frame.max()
        self.results.total += frame

    def merge(self, dest, src):
        dest.total = dest.total + src.total


class FrameNavUDF(UDF):
    """frame mode, nav only: the vmap path."""

    def get_result_buffers(self):
        return {"com_y": self.buffer(kind="nav", dtype="float32")}

    def process_frame(self, frame):
        ys = torch.arange(
            frame.shape[0], dtype=torch.float32, device=frame.device
        )[:, None]
        self.results.com_y = (frame * ys).sum() / frame.sum()


class PartitionSumUDF(UDF):
    def get_result_buffers(self):
        return {"intensity": self.buffer(kind="sig", dtype="float32")}

    def process_partition(self, partition):
        vmask = self.meta.tile_valid.reshape(
            (-1,) + (1,) * (partition.ndim - 1)
        )
        self.results.intensity += (partition * vmask).sum(dim=0)

    def merge(self, dest, src):
        dest.intensity = dest.intensity + src.intensity


def test_sig_tiled_scheme(data):
    ours, theirs = _run_both(data, TiledSumUDF(), JaxTiledSumUDF())
    _compare(ours, theirs)
    np.testing.assert_allclose(
        ours["intensity"].data, data.sum(axis=(0, 1)), rtol=1e-5,
    )


def test_sig_tiled_nav(data):
    ours, theirs = _run_both(data, TiledNavUDF(), JaxTiledNavUDF())
    _compare(ours, theirs)
    np.testing.assert_allclose(
        ours["intensity"].data, data.sum(axis=(2, 3)), rtol=1e-5,
    )


def test_frame_scan_path(data):
    ours, theirs = _run_both(data, FrameStatsUDF(), JaxFrameStatsUDF())
    _compare(ours, theirs)
    flat = data.reshape(-1, 16, 16)
    assert np.array_equal(
        ours["maxes"].data.reshape(-1), flat.max(axis=(1, 2))
    )
    np.testing.assert_allclose(
        ours["total"].data, flat.sum(axis=0), rtol=1e-5,
    )


def test_frame_vmap_path(data):
    ours, theirs = _run_both(data, FrameNavUDF(), JaxFrameNavUDF())
    _compare(ours, theirs)
    flat = data.reshape(-1, 16, 16).astype(np.float64)
    ys = np.arange(16)[:, None]
    expected = (flat * ys).sum(axis=(1, 2)) / flat.sum(axis=(1, 2))
    np.testing.assert_allclose(
        ours["com_y"].data.reshape(-1), expected, rtol=1e-3, atol=1e-3,
    )


def test_partition_method(data):
    ours, theirs = _run_both(data, PartitionSumUDF(), JaxPartitionSumUDF())
    _compare(ours, theirs)
    np.testing.assert_allclose(
        ours["intensity"].data, data.sum(axis=(0, 1)), rtol=1e-5,
    )


def _tiny_tile_udf(base, xp_sum):
    class TinyTileUDF(base):
        def get_result_buffers(self):
            return {"s": self.buffer(kind="sig", dtype="float32")}

        def get_tiling_preferences(self):
            return {"total_size": 128, "depth": 4}

        def process_tile(self, tile):
            self.results.s = self.results.s + xp_sum(tile)

        def merge(self, dest, src):
            dest.s = dest.s + src.s

    return TinyTileUDF()


def _frame_sum_udf(base, small_pref):
    class FrameSumUDF(base):
        def get_result_buffers(self):
            return {"fsum": self.buffer(kind="nav", dtype="float32")}

        def get_tiling_preferences(self):
            if small_pref:
                return {"total_size": 128, "depth": 4}
            return super().get_tiling_preferences()

        def process_frame(self, frame):
            self.results.fsum = frame.sum()

    return FrameSumUDF()


def _scheme_udfs(which, lib_udf, tiled, frame, partition):
    return [{
        "tiled": tiled, "logsum": lib_udf.LogsumUDF, "frame": frame,
        "partition": partition, "sum": lib_udf.SumUDF,
    }[w]() for w in which]


@pytest.mark.parametrize("which,frames,excluded", [
    (("tiled",), 40, False),            # sig split in half
    (("tiled", "logsum"), 40, False),   # whole_frames vetoes the split
    (("tiled", "frame"), 40, False),    # a frame UDF vetoes it
    (("frame",), 40, False),            # intent 'frame'
    (("partition", "sum"), 37, False),  # whole partitions
    (("tiled",), 40, True),             # repair environments veto it
    (("sum",), 3000, False),            # the byte budget sets the depth
])
def test_schemes_equal_to_jax(which, frames, excluded):
    """Negotiator.get_scheme: the same depth, intent and sig tiles as
    the JAX package's for the same UDF methods and preferences."""
    from libertem_tpu.common.shape import Shape as JaxShape
    from libertem_tpu.io.corrections import CorrectionSet as JaxCorr
    from libertem_tpu.io.tiling import Negotiator as JaxNegotiator
    from libertem_tpu_torch.common.shape import Shape

    shape = (5, 6, 16, 16)
    ex = np.zeros((16, 16), dtype=bool)
    ex[3, 7] = True
    ours = Negotiator().get_scheme(
        _scheme_udfs(which, port.udf, TiledSumUDF, FrameNavUDF,
                     PartitionSumUDF),
        Shape(shape, sig_dims=2), np.float32, frames,
        corrections=port.CorrectionSet(excluded_pixels=ex)
        if excluded else None,
    )
    theirs = JaxNegotiator().get_scheme(
        _scheme_udfs(which, libertem_tpu.udf, JaxTiledSumUDF,
                     JaxFrameNavUDF, JaxPartitionSumUDF),
        JaxShape(shape, sig_dims=2), np.float32,
        max_partition_frames=frames,
        corrections=JaxCorr(excluded_pixels=ex) if excluded else None,
    )
    assert (ours.depth, ours.intent, len(ours)) == (
        theirs.depth, theirs.intent, len(theirs)
    )
    assert [(s.origin, tuple(s.shape)) for s in ours.sig_slices] == [
        (s.origin, tuple(s.shape)) for s in theirs.sig_slices
    ]


def test_partition_intent_over_2gb_raises():
    from libertem_tpu.common.shape import Shape as JaxShape
    from libertem_tpu.io.tiling import Negotiator as JaxNegotiator
    from libertem_tpu_torch.common.shape import Shape

    shape = (200, 200, 128, 128)  # 64 KiB f32 frames
    with pytest.raises(ValueError, match="PARTITION"):
        Negotiator().get_scheme([PartitionSumUDF()],
                                Shape(shape, sig_dims=2), np.float32,
                                40000)
    with pytest.raises(ValueError, match="PARTITION"):
        JaxNegotiator().get_scheme(
            [JaxPartitionSumUDF()], JaxShape(shape, sig_dims=2),
            np.float32, max_partition_frames=40000,
        )


def test_frame_udf_never_sig_split():
    """FRAME-method UDFs get whole frames even when a co-running tile
    UDF, or their own size preference, would sig-split the scheme."""
    data = _mk_random((2, 2, 8, 8), dtype="float32")
    jbase = libertem_tpu.udf.base.UDF
    ours, theirs = _run_both(
        data,
        [_tiny_tile_udf(UDF, lambda t: t.sum(dim=0)),
         _frame_sum_udf(UDF, False)],
        [_tiny_tile_udf(jbase, lambda t: t.sum(axis=0)),
         _frame_sum_udf(jbase, False)],
        num_partitions=1,
    )
    _compare(ours, theirs)
    flat = data.reshape(-1, 8, 8)
    np.testing.assert_allclose(
        ours[1]["fsum"].data.reshape(-1), flat.sum(axis=(1, 2)),
        rtol=1e-5,
    )
    np.testing.assert_allclose(ours[0]["s"].data, flat.sum(axis=0),
                               rtol=1e-5)
    ours, theirs = _run_both(
        data, _frame_sum_udf(UDF, True), _frame_sum_udf(jbase, True),
        num_partitions=1,
    )
    _compare(ours, theirs)


# -- the ported UDFs on the generic path ---------------------------------

NAV, SIG = (12, 10), (32, 32)


def _counts(seed=0):
    return np.random.default_rng(seed).poisson(
        8.0, NAV + SIG
    ).astype(np.uint16)


def _roi(seed=5):
    return np.random.default_rng(seed).random(NAV) > 0.4


def _generic_udfs(lib):
    m = lib.masks
    h, w = SIG
    return [
        lib.udf.ApplyMasksUDF(mask_factories=[
            lambda: m.circular(w // 2, h // 2, w, h, 4),
            lambda: m.ring(w // 2, h // 2, w, h, 15, 10),
        ]),
        lib.udf.CoMUDF.with_params(cy=h // 2, cx=w // 2, r=8),
        lib.udf.SumUDF(),
        lib.udf.SumSigUDF(),
        lib.udf.StdDevUDF(),
        lib.udf.LogsumUDF(),
        lib.udf.FEMUDF(center=(16, 16), rad_in=4, rad_out=10),
        lib.udf.CrystallinityUDF(rad_in=2, rad_out=8,
                                 real_center=(16, 16), real_rad=4),
    ]


@pytest.mark.parametrize("with_roi", [False, True])
def test_generic_udfs_match_jax(with_roi):
    """The five UDFs of the fused path beside LogsumUDF, FEMUDF and
    CrystallinityUDF (which have no fused spec): the whole set runs on
    the generic path, and launches no fused op."""
    data = _counts()
    kw = {"roi": _roi()} if with_roi else {}
    prep = UDFRunner(_generic_udfs(port))._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu")
    )
    assert prep["fused"] is None
    ours, theirs = _run_both(
        data, _generic_udfs(port), _generic_udfs(libertem_tpu),
        num_partitions=3, **kw,
    )
    _compare(ours, theirs)
    if with_roi:
        outside = ~kw["roi"]
        assert np.all(np.isnan(ours[3]["intensity"].data[outside]))
        assert not np.any(ours[3]["intensity"].valid_mask[outside])


def test_sig_tiled_generic_udfs_match_jax():
    """Beside TiledSumUDF the scheme cuts each frame into 8 sig tiles of
    4 rows: ApplyMasks and CoM project each tile on its columns of the
    stack, StdDev counts the frames once, SumSig adds up the tiles."""
    data = _counts(seed=6)
    ours, theirs = _run_both(
        data, _generic_udfs(port)[:5] + [TiledSumUDF()],
        _generic_udfs(libertem_tpu)[:5] + [JaxTiledSumUDF()],
        num_partitions=3, roi=_roi(seed=7),
    )
    _compare(ours, theirs)


def test_fused_path_with_roi_matches_jax():
    data = _counts(seed=2)
    roi = _roi(seed=3)
    udfs = _generic_udfs(port)[:5]
    before = fused_moments.launches
    ours, theirs = _run_both(
        data, udfs, _generic_udfs(libertem_tpu)[:5], num_partitions=3,
        roi=roi,
    )
    assert fused_moments.launches == before  # the CPU runs the plain op
    _compare(ours, theirs)
    f = data.reshape(-1, *SIG)[roi.reshape(-1)].astype(np.float64)
    assert np.array_equal(ours[2]["intensity"].data, f.sum(axis=0))
    np.testing.assert_allclose(ours[4]["var"].data, f.var(axis=0),
                               rtol=1e-5)


def test_pick_udf_exact_in_native_dtype():
    data = _counts(seed=4)
    roi = np.zeros(NAV, dtype=bool)
    roi.flat[[0, 7, 8, 9, 50, 119]] = True
    ours, theirs = _run_both(
        data, port.PickUDF(), libertem_tpu.udf.PickUDF(),
        num_partitions=3, roi=roi,
    )
    got = ours["intensity"].data
    assert got.dtype == np.uint16
    assert np.array_equal(got, theirs["intensity"].data)
    assert np.array_equal(got, data[roi])


def test_noop_udf():
    data = _counts()
    ctx = port.Context(device="cpu")
    res = ctx.run_udf(ctx.load("memory", data=data, sig_dims=2),
                      [port.NoOpUDF(), port.SumUDF()])
    assert res[0] == {}
    assert np.array_equal(res[1]["intensity"].data,
                          data.sum(axis=(0, 1), dtype=np.float64))


def test_task_data_and_coordinates():
    """get_task_data runs once per run with the run's coordinates;
    process_tile sees the block's coordinates (zeros in padding)."""
    class CoordUDF(UDF):
        def get_task_data(self):
            return {"n": torch.tensor(len(self.meta.coordinates))}

        def get_result_buffers(self):
            return {
                "yx": self.buffer(kind="nav", extra_shape=(2,),
                                  dtype="int32"),
                "n": self.buffer(kind="nav", dtype="int32"),
            }

        def process_tile(self, tile):
            self.results.yx = self.meta.coordinates
            self.results.n += self.task_data.n

    data = _counts()
    roi = _roi()
    ctx = port.Context(device="cpu")
    res = ctx.run_udf(ctx.load("memory", data=data, sig_dims=2,
                               num_partitions=3), CoordUDF(), roi=roi)
    yy, xx = np.nonzero(roi)
    assert np.array_equal(res["yx"].raw_data, np.stack([yy, xx], -1))
    assert np.all(res["n"].raw_data == roi.sum())
    assert np.all(res["yx"].data[~roi] == 0)


def test_writes_to_padding_rows_are_dropped():
    """Partitions of 17 or 18 frames in blocks of 24: a UDF that adds 1
    to every row of its nav view also writes the padding rows, which
    must not reach the next partition's frames."""
    def counter(base, ones):
        class CountUDF(base):
            def get_result_buffers(self):
                return {"n": self.buffer(kind="nav", dtype="float32")}

            def process_tile(self, tile):
                self.results.n += ones(tile.shape[0])

        return CountUDF()

    ours, theirs = _run_both(
        _counts(), counter(UDF, torch.ones),
        counter(libertem_tpu.udf.base.UDF, np.ones), num_partitions=7,
    )
    _compare(ours, theirs)
    assert np.all(ours["n"].data == 1)


def test_vmap_incompatible_udf_raises():
    """A process_frame that vmap cannot take no longer raises: the
    probe sends it to the host engine with a warning, as the JAX
    package sends its untraceable UDFs, and both give the same."""
    def branchy(base):
        class BranchyUDF(base):
            def get_result_buffers(self):
                return {"x": self.buffer(kind="nav")}

            def process_frame(self, frame):
                # data-dependent Python control flow: vmap cannot take it
                self.results.x = frame.sum() if frame.sum() > 0 else 0

        return BranchyUDF()

    with pytest.warns(UserWarning, match="HOST engine"):
        ours, theirs = _run_both(_counts(), branchy(UDF),
                                 branchy(libertem_tpu.udf.base.UDF))
    _compare(ours, theirs)
    assert np.array_equal(ours["x"].data, _counts().sum(axis=(2, 3)))


def test_bad_roi_raises():
    """As tests/test_udf_methods.py::test_bad_roi_raises."""
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=_counts(), sig_dims=2)
    with pytest.raises(ValueError):
        ctx.run_udf(ds, port.SumUDF(), roi=np.ones(7, dtype=bool))


def test_blocks_equal_to_jax_with_roi():
    """Partition.gen_blocks with a roi: the same zero-padded blocks,
    offsets, valid counts and coordinates as the JAX package's."""
    from libertem_tpu.common.shape import Shape as JaxShape
    from libertem_tpu.io.tiling import Negotiator as JaxNegotiator

    data = _counts()
    roi = _roi().reshape(-1)
    ds = MemoryDataSet(data=data, sig_dims=2, num_partitions=3)
    jds = JaxMemoryDataSet(data=data, sig_dims=2, num_partitions=3)
    scheme = Negotiator().get_scheme([], ds.shape, np.float32, 16)
    jscheme = JaxNegotiator().get_scheme(
        [], JaxShape(NAV + SIG, sig_dims=2), np.float32,
        max_partition_frames=16,
    )
    assert scheme.depth == jscheme.depth == 16
    n = 0
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        assert p.frames_in_roi(roi) == jp.frames_in_roi(roi)
        assert p.roi_offset(roi) == jp.roi_offset(roi)
        assert np.array_equal(p.local_frame_ids(roi),
                              jp.local_frame_ids(roi))
        blocks = list(p.gen_blocks(scheme, roi))
        jblocks = list(jp.gen_blocks(jscheme, roi))
        assert len(blocks) == len(jblocks)
        for b, jb in zip(blocks, jblocks):
            assert np.array_equal(b.data, jb.data)
            assert np.array_equal(b.coords, jb.coords)
            assert (b.global_offset, b.valid) == (
                jb.global_offset, jb.valid
            )
            n += 1
    assert n == 6


# -- goldens -----------------------------------------------------------------

H, W = gc.SIG
MP = gc.MASK_PARAMS


@pytest.fixture(scope="module")
def golden_ds():
    return MemoryDataSet(data=gc.golden_data(), sig_dims=2,
                         num_partitions=4)


def test_golden_stats(golden_ds):
    g = _golden("stats")
    res = port.Context(device="cpu").run_udf(
        golden_ds, [port.StdDevUDF(), port.SumSigUDF(), port.LogsumUDF()]
    )
    assert np.allclose(res[0]["var"].data, g["var"], rtol=1e-3, atol=1e-4)
    assert np.allclose(res[0]["std"].data, g["std"], rtol=1e-3, atol=1e-4)
    assert np.allclose(res[0]["mean"].data, g["mean"],
                       rtol=1e-4, atol=1e-4)
    assert np.allclose(res[1]["intensity"].data, g["sumsig"],
                       rtol=1e-4, atol=1e-2)
    assert np.allclose(res[2]["logsum"].data, g["logsum"],
                       rtol=1e-4, atol=1e-3)


def test_golden_pick(golden_ds):
    g = _golden("pick")
    roi = np.zeros(int(np.prod(gc.NAV)), dtype=bool)
    roi[[3, 77, 200]] = True
    res = port.Context(device="cpu").run_udf(
        golden_ds, port.PickUDF(), roi=roi.reshape(gc.NAV)
    )
    got = np.asarray(res["intensity"].data).reshape(g["intensity"].shape)
    assert np.array_equal(got, g["intensity"])


def test_golden_fem_crystallinity(golden_ds):
    g = _golden("fem_crystal")
    fp = gc.FEM_PARAMS
    kp = gc.CRYSTAL_PARAMS
    res = port.Context(device="cpu").run_udf(golden_ds, [
        port.FEMUDF(center=fp["center"], rad_in=fp["rad_in"],
                    rad_out=fp["rad_out"]),
        port.CrystallinityUDF(
            rad_in=kp["rad_in"], rad_out=kp["rad_out"],
            real_center=kp["real_center"], real_rad=kp["real_rad"],
        ),
    ])
    assert np.allclose(res[0]["intensity"].data, g["fem"],
                       rtol=1e-3, atol=1e-3)
    assert np.allclose(res[1]["intensity"].data, g["crystal"],
                       rtol=1e-3, atol=1e-2)


def test_golden_mask_stack_roi(golden_ds):
    g = _golden("mask_stack_roi")
    roi = gc.golden_roi().reshape(gc.NAV)
    m = port.masks
    res = port.Context(device="cpu").run_udf(
        golden_ds,
        port.ApplyMasksUDF(mask_factories=[
            lambda: m.circular(MP["cx"], MP["cy"], W, H, MP["r_bf"]),
            lambda: m.ring(MP["cx"], MP["cy"], W, H, MP["ro_adf"],
                           MP["ri_adf"]),
            lambda: m.ring(MP["cx"], MP["cy"], W, H, MP["ro_haadf"],
                           MP["ri_haadf"]),
            lambda: m.gradient_x(W, H),
        ]),
        roi=roi,
    )
    got = res["intensity"].data
    assert got.shape == g["intensity"].shape
    assert np.all(np.isnan(got[~roi]))
    assert np.allclose(got[roi], g["intensity"][roi], rtol=1e-4, atol=1.0)
