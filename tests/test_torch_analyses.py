"""The port's analysis layer against the JAX package's, on the CPU.

The same seeded u16 Poisson(8) scan (nav 8x9, sig 20x22, 3 partitions)
goes through ``Context.run`` of both packages for each of the 15
analysis ids: the same result keys in the same order, and every
channel's raw data within rtol 1e-5 with an absolute floor of 1e-5 of
the reference channel's largest magnitude (complex channels 1e-4,
angles: the floor of pi).  Both sides compute in float32 with different
summation orders.
"""
import asyncio

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.analysis  # noqa: F401
from libertem_tpu.analysis.base import Analysis as JaxAnalysis
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.udf.base import UDFRunner as JaxUDFRunner

import libertem_tpu_torch as port
from libertem_tpu_torch.analysis.base import Analysis

torch.set_num_threads(1)

NAV, SIG = (8, 9), (20, 22)
RTOL = 1e-5
CRTOL = 1e-4
H, W = SIG

# id -> parameters, with factories made by the package's own masks
PARAMS = {
    "MASKS": lambda lib: {"factories": [
        lambda: lib.masks.circular(11, 10, W, H, 5),
        lambda: lib.masks.ring(11, 10, W, H, 9, 6),
        lambda: lib.masks.gradient_x(W, H),
    ]},
    "APPLY_DISK_MASK": lambda lib: {"cx": 11, "cy": 10, "r": 5},
    "APPLY_RING_MASK": lambda lib: {"cx": 11, "cy": 10, "ri": 4, "ro": 9},
    "APPLY_POINT_SELECTOR": lambda lib: {"cx": 7, "cy": 12},
    "SUM_FRAMES": lambda lib: {},
    "SUM_SIG": lambda lib: {},
    "SD_FRAMES": lambda lib: {},
    "PICK_FRAME": lambda lib: {"x": 4, "y": 6},
    "CENTER_OF_MASS": lambda lib: {"cx": 11, "cy": 10, "r": 8,
                                   "scan_rotation": 23.0, "flip_y": True},
    "RADIAL_FOURIER": lambda lib: {"cx": 11, "cy": 10, "ri": 0, "ro": 9,
                                   "n_bins": 2, "max_order": 8},
    "FEM": lambda lib: {"cx": 11, "cy": 10, "ri": 3, "ro": 8},
    "APPLY_FFT_MASK": lambda lib: {"rad_in": 2, "rad_out": 7,
                                   "real_rad": 3, "real_centery": 10,
                                   "real_centerx": 11},
    "PICK_FFT_FRAME": lambda lib: {"x": 2, "y": 5, "real_rad": 3,
                                   "real_centery": 10, "real_centerx": 11},
    "FFTSUM_FRAMES": lambda lib: {"real_rad": 3, "real_centery": 10,
                                  "real_centerx": 11},
    "CLUST": lambda lib: {"n_clust": 3, "n_peaks": 6, "rad": 1},
}
# what the JAX package's fused plan decides for each (checked below
# against the JAX runner itself)
FUSED = {"MASKS", "APPLY_DISK_MASK", "APPLY_RING_MASK",
         "APPLY_POINT_SELECTOR", "SUM_FRAMES", "SUM_SIG", "SD_FRAMES",
         "CENTER_OF_MASS", "FFTSUM_FRAMES", "CLUST"}


def _data(seed=0, nav=NAV):
    return np.random.default_rng(seed).poisson(
        8.0, nav + SIG).astype(np.uint16)


@pytest.fixture(scope="module")
def ctxs():
    jctx = JaxContext(executor=InlineJobExecutor())
    pctx = port.Context(device="cpu")
    data = _data()
    jds = jctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    pds = pctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    return jctx, jds, pctx, pds


def _close(label, got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, label
    cplx = np.iscomplexobj(want)
    assert np.iscomplexobj(got) == cplx, label
    rtol = CRTOL if cplx else RTOL
    scale = max(float(np.nanmax(np.abs(want), initial=0.0)), 1.0)
    if label.split("/")[-1].startswith(("phase_", "intensity_angle")):
        scale = np.pi
    np.testing.assert_allclose(
        got.astype(np.complex128 if cplx else np.float64),
        want.astype(np.complex128 if cplx else np.float64),
        rtol=rtol, atol=rtol * scale, err_msg=label,
    )


def compare_sets(label, ours, theirs):
    assert ours.keys() == theirs.keys(), label
    for a, b in zip(ours, theirs):
        _close(f"{label}/{b.key}", a.raw_data, b.raw_data)
        assert (a.title, a.desc, a.include_in_download) == (
            b.title, b.desc, b.include_in_download)


def _pair(ctxs, id_, params=None):
    jctx, jds, pctx, pds = ctxs
    make = PARAMS[id_] if params is None else params
    ja = JaxAnalysis.get_analysis_by_type(id_)(jds, make(libertem_tpu))
    pa = Analysis.get_analysis_by_type(id_)(pds, make(port))
    return ja, pa


@pytest.mark.parametrize("id_", sorted(PARAMS))
def test_analysis_matches_jax(ctxs, id_):
    jctx, _, pctx, _ = ctxs
    ja, pa = _pair(ctxs, id_)
    compare_sets(id_, pctx.run(pa), jctx.run(ja))


def test_registry_ids_equal_to_jax():
    assert set(Analysis.registry) == set(JaxAnalysis.registry)
    assert set(Analysis.registry) == set(PARAMS)
    # each registry holds its own package's classes only
    assert all(c.__module__.startswith("libertem_tpu_torch.")
               for c in Analysis.registry.values())
    assert all(c.__module__.startswith("libertem_tpu.")
               for c in JaxAnalysis.registry.values())


@pytest.mark.parametrize("id_", sorted(PARAMS))
def test_fused_plan_follows_jax(ctxs, id_):
    """The port's run takes the fused path exactly where the JAX
    package's plan does, so no analysis silently leaves the kernel."""
    _, jds, pctx, _ = ctxs
    ja, pa = _pair(ctxs, id_)
    roi = ja.get_roi()
    jprep = JaxUDFRunner([ja.get_udf()])._prepare(jds, roi, None, None)
    pctx.run(pa)
    assert pctx.run_info["fused"] == (jprep["fused"] is not None)
    assert pctx.run_info["fused"] == (id_ in FUSED)


def test_clust_feature_pass_is_fused(ctxs):
    """CLUST's feature pass: a sparse template stack, on the fused
    path in both packages, with the same features."""
    jctx, jds, pctx, _ = ctxs
    ja, pa = _pair(ctxs, "CLUST")
    std, feats = pa.run_feature_passes(pctx)
    assert pctx.run_info["fused"]
    jstd = np.asarray(jctx.run_udf(jds, libertem_tpu.udf.StdDevUDF())
                      ["std"].data)
    _close("std", std, jstd)
    jfeats = jctx.run_udf(jds, _jax_feature_udf(ja, std))
    _close("features", feats, jfeats["intensity"].data)
    assert feats.shape == NAV + (6,)
    # a cancel between the passes stops the pipeline
    assert pa.run_feature_passes(pctx, lambda: True) is None
    assert pa.run_clustering(pctx, lambda: True).keys() == []


def _jax_feature_udf(ja, std_map):
    """The JAX package's feature pass, as its run_clustering builds
    it."""
    from libertem_tpu.analysis.clust import peak_local_max
    from libertem_tpu.masks import sparse_template_multi_stack
    p = ja.parameters
    peaks = peak_local_max(std_map, min_distance=p["min_dist"],
                           num_peaks=p["n_peaks"])
    rad = int(p["rad"])
    template = np.ones((2 * rad + 1, 2 * rad + 1), np.float32)
    h, w = std_map.shape
    return libertem_tpu.udf.ApplyMasksUDF(
        mask_factories=lambda: sparse_template_multi_stack(
            mask_index=np.arange(len(peaks)),
            offsetY=peaks[:, 0] - rad, offsetX=peaks[:, 1] - rad,
            template=template, imageSizeY=h, imageSizeX=w,
        ),
        mask_count=len(peaks),
    )


def test_clust_with_sklearn(ctxs):
    pytest.importorskip("sklearn")
    jctx, _, pctx, _ = ctxs
    ja, pa = _pair(ctxs, "CLUST")
    ours = pa.run_clustering(pctx)
    theirs = ja.run_clustering(jctx)
    assert ours.keys() == theirs.keys() == ["intensity"]
    np.testing.assert_array_equal(ours.intensity.raw_data,
                                  theirs.intensity.raw_data)


@pytest.mark.parametrize("shape", ["rect", "disk"])
@pytest.mark.parametrize("id_", ["APPLY_POINT_SELECTOR", "FEM", "SUM_SIG",
                                 "APPLY_DISK_MASK", "RADIAL_FOURIER",
                                 "CENTER_OF_MASS"])
def test_gui_roi_matches_jax(ctxs, id_, shape):
    """The GUI roi parameter, honoured alike by both packages."""
    jctx, _, pctx, _ = ctxs
    roi = ({"shape": "rect", "x": 1, "y": 2, "width": 4, "height": 3}
           if shape == "rect" else
           {"shape": "disk", "cx": 4, "cy": 3, "r": 2.5})

    def params(lib):
        return {**PARAMS[id_](lib), "roi": roi}

    ja, pa = _pair(ctxs, id_, params)
    assert np.array_equal(pa.get_roi(), ja.get_roi())
    assert pa.get_roi().sum() in (12, 21)
    compare_sets(id_, pctx.run(pa), jctx.run(ja))


@pytest.mark.parametrize("nav,roi", [
    ((10,), {"shape": "rect", "x": 2, "y": 0, "width": 3, "height": 1}),
    ((10,), {"shape": "disk", "cx": 5, "cy": 0, "r": 1}),
    ((3, 4, 5), {"shape": "rect", "x": 1, "y": 1, "width": 2,
                 "height": 2}),
    ((3, 4, 5), {"shape": "disk", "cx": 2, "cy": 1, "r": 1.5}),
    ((4, 5), {"shape": "ellipse"}),
])
def test_get_roi_1d_and_3d_nav(nav, roi):
    from libertem_tpu.analysis.getroi import get_roi as jax_get_roi
    from libertem_tpu_torch.analysis.getroi import get_roi
    ours = get_roi({"roi": roi}, nav)
    theirs = jax_get_roi({"roi": roi}, nav)
    if theirs is None:
        assert ours is None
    else:
        assert ours.shape == nav
        assert np.array_equal(ours, theirs)


def test_null_parameters(ctxs):
    """The GUI's explicit nulls fall back to each analysis's defaults,
    as in the JAX package."""
    jctx, _, pctx, _ = ctxs
    nulls = {
        "CENTER_OF_MASS": {"cx": None, "cy": None, "scan_rotation": None,
                           "flip_y": None, "r": 3},
        "CLUST": dict.fromkeys(("n_clust", "n_peaks", "min_dist", "rad",
                                "cy", "cx", "ri", "ro")),
        "RADIAL_FOURIER": dict.fromkeys(("cx", "cy", "ri", "ro", "n_bins",
                                         "max_order")),
        "APPLY_RING_MASK": dict.fromkeys(("cx", "cy", "ri", "ro")),
    }
    for id_, params in nulls.items():
        ja, pa = _pair(ctxs, id_, lambda lib, p=params: dict(p))
        assert pa.parameters == ja.parameters, id_
    com = _pair(ctxs, "CENTER_OF_MASS",
                lambda lib: dict(nulls["CENTER_OF_MASS"]))
    compare_sets("CoM nulls", pctx.run(com[1]), jctx.run(com[0]))


def test_com_need_rerun(ctxs):
    """flip_y and scan_rotation need no new pass; anything else does,
    as in the JAX package."""
    ja, pa = _pair(ctxs, "CENTER_OF_MASS")
    old = dict(pa.parameters)
    for new, rerun in [
        ({**old, "flip_y": not old["flip_y"]}, False),
        ({**old, "scan_rotation": 90.0}, False),
        ({**old, "cx": old["cx"] + 1}, True),
        ({**old, "r": 2}, True),
    ]:
        assert pa.need_rerun(old, new) is rerun
        assert ja.need_rerun(old, new) is rerun
    sd = Analysis.get_analysis_by_type("SD_FRAMES")(ctxs[3], {})
    assert sd.need_rerun({}, {"x": 1})


def test_com_short_cut_equals_rerun(ctxs):
    """Post-processing the same UDF results with another flip and
    rotation gives what a new run gives."""
    _, _, pctx, pds = ctxs
    a = pctx.create_com_analysis(pds, cx=11, cy=10, mask_radius=8)
    first = pctx.run(a)
    b = pctx.create_com_analysis(pds, cx=11, cy=10, mask_radius=8,
                                 flip_y=True, scan_rotation=-40.0)
    assert not a.need_rerun(a.parameters, b.parameters)
    udf_results = first.raw_results
    shortcut = b.get_udf_results(udf_results, None, udf_results.damage)
    compare_sets("shortcut", shortcut, pctx.run(b))


@pytest.mark.parametrize("id_", ["SUM_FRAMES", "CENTER_OF_MASS"])
def test_complex_dataset_channels(id_):
    """Complex data: Sum's six complex channels, CoM's split channels,
    as in the JAX package."""
    rng = np.random.default_rng(1)
    cdata = (rng.random((4, 4, 8, 8)) + 0.5
             + 1j * rng.random((4, 4, 8, 8))).astype(np.complex64)
    jctx = JaxContext(executor=InlineJobExecutor())
    pctx = port.Context(device="cpu")
    jds = jctx.load("memory", data=cdata, sig_dims=2, num_partitions=2)
    pds = pctx.load("memory", data=cdata, sig_dims=2, num_partitions=2)
    params = {"cx": 3.5, "cy": 3.5} if id_ == "CENTER_OF_MASS" else {}
    ours = pctx.run(Analysis.get_analysis_by_type(id_)(pds, params))
    theirs = jctx.run(JaxAnalysis.get_analysis_by_type(id_)(jds, params))
    assert len(ours.keys()) == (6 if id_ == "SUM_FRAMES" else 4)
    compare_sets(id_, ours, theirs)


@pytest.mark.parametrize("id_,key", [
    ("SUM_FRAMES", "intensity"),
    ("CENTER_OF_MASS", "field"),
    ("RADIAL_FOURIER", "complex_1_2"),
    ("APPLY_DISK_MASK", "intensity_log"),
])
def test_visualized_matches_jax(ctxs, id_, key):
    pytest.importorskip("matplotlib")
    jctx, _, pctx, _ = ctxs
    ja, pa = _pair(ctxs, id_)
    ours = pctx.run(pa)[key].visualized
    theirs = jctx.run(ja)[key].visualized
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-6)


def test_visualize_functions_equal_to_jax():
    """The rendering helpers on the same float64 inputs: equal within
    1e-6."""
    pytest.importorskip("matplotlib")
    from libertem_tpu.viz import base as jviz
    from libertem_tpu_torch.viz import base as pviz
    rng = np.random.default_rng(5)
    real = rng.normal(10.0, 3.0, (12, 13))
    real[0, 0] = 1e6  # an outlier to snip
    cplx = rng.normal(size=(12, 13)) + 1j * rng.normal(size=(12, 13))
    damage = rng.random((12, 13)) > 0.3
    for args in [(real,), (cplx,)]:
        for kw in [{}, {"logarithmic": True}, {"damage": damage}]:
            np.testing.assert_allclose(
                pviz.visualize_simple(*args, **kw),
                jviz.visualize_simple(*args, **kw), atol=1e-6)
    np.testing.assert_allclose(
        pviz.rgb_from_2dvector(cplx.imag, cplx.real, vmax=2.0),
        jviz.rgb_from_2dvector(cplx.imag, cplx.real, vmax=2.0), atol=1e-6)
    assert pviz._get_stat_limits(real) == jviz._get_stat_limits(real)
    assert pviz._stat_limits(cplx, damage) == jviz._stat_limits(cplx,
                                                                damage)


def _guess(module, rel_guess, old_params, monkeypatch):
    """The guess RPC through a fake RPC context, with a fixed relative
    guess."""
    class Field:
        raw_data = np.zeros((4, 4))

    class Info:
        details = {"analysisType": "CENTER_OF_MASS",
                   "parameters": old_params}
        results = {"y": Field(), "x": Field()}

    class Ctx:
        def get_compound_analysis(self):
            return {"details": {"analyses": ["a-1"],
                                "mainType": "CENTER_OF_MASS"}}

        def get_analysis_details(self, analysis_id):
            return {"analysis": analysis_id,
                    "details": {"analysisType": "CENTER_OF_MASS",
                                "parameters": old_params}}

        def have_analysis_results(self, analysis_id):
            return True

        def get_analysis_results(self, analysis_id):
            return Info()

        async def run_sync(self, fn, *args, **kwargs):
            return fn(*args, **kwargs)

    monkeypatch.setattr(module, "guess_corrections",
                        lambda y, x: dict(rel_guess))
    return asyncio.run(module.GuessParametersProc()(Ctx()))


@pytest.mark.parametrize("flip,old_flip,want_rot", [
    (False, False, 75.0),   # 30 + 45
    (True, False, -15.0),   # 30 - 45: a flip conjugates the rotation
    (True, True, -15.0),
    (False, True, 75.0),
])
def test_guess_parameters_proc(monkeypatch, flip, old_flip, want_rot):
    import libertem_tpu.analysis.com as jcom
    import libertem_tpu_torch.analysis.com as pcom
    rel = {"scan_rotation": 30.0, "flip_y": flip, "cy": 0.5, "cx": -1.0}
    old = {"cx": 4, "cy": 4, "r": 3, "scan_rotation": 45.0,
           "flip_y": old_flip}
    ours = _guess(pcom, rel, old, monkeypatch)
    theirs = _guess(jcom, rel, old, monkeypatch)
    assert ours["status"] == "ok"
    assert ours["guess"]["scan_rotation"] == pytest.approx(want_rot)
    assert ours["guess"]["flip_y"] is (flip != old_flip)
    assert ours["guess"] == pytest.approx(theirs["guess"])
    assert set(pcom.COMAnalysis.get_rpc_definitions()) == {
        "guess_parameters"}


def test_com_factory_validations(ctxs):
    _, _, pctx, pds = ctxs
    flat = pctx.load("memory", data=_data(nav=(72,)), sig_dims=2)
    with pytest.raises(ValueError, match="2D navigation"):
        pctx.create_com_analysis(flat)
    with pytest.raises(ValueError, match="mask_radius_inner"):
        pctx.create_com_analysis(pds, mask_radius_inner=2)
    with pytest.raises(ValueError, match="exactly"):
        pctx.run(pctx.create_pick_analysis(pds, x=1))


def test_factories_match_jax(ctxs):
    """Every create_*_analysis of the Context gives what the JAX
    package's gives."""
    jctx, jds, pctx, pds = ctxs
    calls = [
        ("create_disk_analysis", {"cx": 11, "cy": 10, "r": 5}),
        ("create_ring_analysis", {"cx": 11, "cy": 10, "ri": 3, "ro": 8}),
        ("create_point_analysis", {"x": 3, "y": 4}),
        ("create_sum_analysis", {}),
        ("create_sumsig_analysis", {}),
        ("create_sd_analysis", {}),
        ("create_pick_analysis", {"x": 2, "y": 3}),
        ("create_com_analysis", {"cx": 11, "cy": 10, "mask_radius": 8,
                                 "mask_radius_inner": 2}),
        ("create_radial_fourier_analysis", {"n_bins": 2, "max_order": 3}),
        ("create_fem_analysis", {"ri": 2, "ro": 7}),
    ]
    for name, kw in calls:
        ours = pctx.run(getattr(pctx, name)(dataset=pds, **kw))
        theirs = jctx.run(getattr(jctx, name)(dataset=jds, **kw))
        compare_sets(name, ours, theirs)
    ours = pctx.run(pctx.create_mask_analysis(
        PARAMS["MASKS"](port)["factories"], pds))
    theirs = jctx.run(jctx.create_mask_analysis(
        PARAMS["MASKS"](libertem_tpu)["factories"], jds))
    compare_sets("create_mask_analysis", ours, theirs)


# -- goldens, through the analyses -------------------------------------------

@pytest.fixture(scope="module")
def golden_ctx():
    import golden_common as gc
    pctx = port.Context(device="cpu")
    return pctx, pctx.load("memory", data=gc.golden_data(), sig_dims=2,
                           num_partitions=4)


def test_golden_sum_bf(golden_ctx):
    """The ``sum_bf`` golden (tolerances of the JAX package's own test):
    the sum through SUM_FRAMES, the BF disk through MASKS."""
    import golden_common as gc
    from test_parity_reference import _golden
    g = _golden("sum_bf")
    pctx, ds = golden_ctx
    mp = gc.MASK_PARAMS
    h, w = gc.SIG
    total = pctx.run(pctx.create_sum_analysis(ds))
    assert pctx.run_info["fused"]
    np.testing.assert_allclose(total.intensity_lin.raw_data,
                               g["sum_intensity"], rtol=1e-4, atol=1e-2)
    bf = pctx.run(pctx.create_mask_analysis([
        lambda: port.masks.circular(mp["cx"], mp["cy"], w, h, mp["r_bf"]),
    ], ds))
    np.testing.assert_allclose(bf.mask_0.raw_data,
                               g["bf_intensity"][..., 0],
                               rtol=1e-4, atol=1e-2)


def test_golden_mask_stack_dense(golden_ctx):
    """The ``mask_stack_dense`` golden through MASKS: BF, ADF, HAADF
    and gradient_x, one channel each."""
    import golden_common as gc
    from test_parity_reference import _golden
    g = _golden("mask_stack_dense")
    pctx, ds = golden_ctx
    mp = gc.MASK_PARAMS
    h, w = gc.SIG
    res = pctx.run(pctx.create_mask_analysis([
        lambda: port.masks.circular(mp["cx"], mp["cy"], w, h, mp["r_bf"]),
        lambda: port.masks.ring(mp["cx"], mp["cy"], w, h, mp["ro_adf"],
                                mp["ri_adf"]),
        lambda: port.masks.ring(mp["cx"], mp["cy"], w, h, mp["ro_haadf"],
                                mp["ri_haadf"]),
        lambda: port.masks.gradient_x(w, h),
    ], ds))
    assert res.keys() == [f"mask_{i}" for i in range(4)]
    got = np.stack([r.raw_data for r in res], axis=-1)
    np.testing.assert_allclose(got, g["intensity"], rtol=1e-4, atol=1.0)
