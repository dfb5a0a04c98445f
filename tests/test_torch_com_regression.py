"""CoMUDF's regression and the CoM helpers against the JAX package's,
on the CPU.

The data: u16 frames of a Gaussian spot whose centre moves along a
plane over the scan (nav 8x9, sig 20x22), with Poisson(4) counts, from
a numpy seed.  Each regression option of the JAX package
(``RegressionOptions``: -1 none, 0 subtract the mean, 1 subtract a
plane; any other int is refused) and a given (3, 2) coefficient array
run with and without a roi, through ``run_udf`` and per partial through
``run_udf_iter``.  Fields agree within rtol 1e-5 with an absolute floor
of 1e-5 of the centres' magnitude, the coefficients within 1e-4
relative.  The helpers, on identical float64 inputs, agree exactly.
"""
import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
import libertem_tpu.udf.com as jcom

import libertem_tpu_torch as port
import libertem_tpu_torch.udf.com as pcom

torch.set_num_threads(1)

NAV, SIG = (8, 9), (20, 22)
RTOL = 1e-5
COEF_RTOL = 1e-4
FIELDS = ("raw_com", "raw_shifts", "field", "field_y", "field_x",
          "magnitude", "divergence", "curl")
GIVEN = np.array([[0.25, -0.5], [0.02, 0.01], [-0.03, 0.04]])
MODES = {"none": -1, "mean": 0, "linear": 1, "given": GIVEN}


def tilted_scan(seed=0) -> np.ndarray:
    """A spot at a centre that moves along a plane over the scan, with
    Poisson noise."""
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:NAV[0], 0:NAV[1]]
    cy = 9.0 + 0.3 * rows - 0.2 * cols
    cx = 11.0 - 0.1 * rows + 0.25 * cols
    y, x = np.mgrid[0:SIG[0], 0:SIG[1]]
    spot = np.exp(-((y - cy[..., None, None]) ** 2
                    + (x - cx[..., None, None]) ** 2) / 8.0)
    return rng.poisson(4.0 + 60.0 * spot).astype(np.uint16)


def _roi():
    roi = np.zeros(NAV, dtype=bool)
    roi[1:7, 2:8] = True
    roi[3, 4] = False
    return roi


@pytest.fixture(scope="module")
def ctxs():
    data = tilted_scan()
    jctx = JaxContext(executor=InlineJobExecutor())
    pctx = port.Context(device="cpu")
    return (jctx, jctx.load("memory", data=data, sig_dims=2,
                            num_partitions=3),
            pctx, pctx.load("memory", data=data, sig_dims=2,
                            num_partitions=3))


def _udf(lib, mode):
    return lib.udf.CoMUDF.with_params(cy=9.5, cx=10.5, r=9.0,
                                      scan_rotation=12.0, regression=mode)


def _compare(label, ours, theirs):
    scale = max(float(np.nanmax(np.abs(theirs["raw_com"].data))), 1.0)
    for name in FIELDS:
        a = np.asarray(ours[name].data, np.float64)
        b = np.asarray(theirs[name].data, np.float64)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=f"{label}/{name}")
        assert np.array_equal(np.isnan(a), np.isnan(b)), f"{label}/{name}"
    a = np.asarray(ours["regression"].data, np.float64)
    b = np.asarray(theirs["regression"].data, np.float64)
    assert a.dtype == b.dtype
    coef_scale = float(np.abs(b).max(initial=0.0))
    np.testing.assert_allclose(a, b, rtol=COEF_RTOL,
                               atol=COEF_RTOL * coef_scale,
                               err_msg=f"{label}/regression")
    assert np.array_equal(ours["regression"].valid_mask,
                          theirs["regression"].valid_mask)


@pytest.mark.parametrize("with_roi", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_regression_matches_jax(ctxs, mode, with_roi):
    jctx, jds, pctx, pds = ctxs
    roi = _roi() if with_roi else None
    ours = pctx.run_udf(pds, _udf(port, MODES[mode]), roi=roi)
    theirs = jctx.run_udf(jds, _udf(libertem_tpu, MODES[mode]), roi=roi)
    _compare(mode, ours, theirs)
    coef = ours["regression"].data
    if mode == "given":
        np.testing.assert_array_equal(coef, GIVEN.astype(np.float32))
    if mode == "linear":
        # the plane of the spot's motion, seen through the rotation:
        # the field left after it is small against the motion
        assert np.abs(coef[1:]).max() > 0.1
        assert np.nanmax(np.abs(ours["field"].data)) < 1.0


@pytest.mark.parametrize("with_roi", [False, True])
@pytest.mark.parametrize("mode", ["mean", "linear"])
def test_regression_per_partial_matches_jax(ctxs, mode, with_roi):
    """Under ``run_udf_iter`` each partial fits only the positions
    merged so far (and inside the roi); positions not merged yet are
    neither fitted nor changed."""
    jctx, jds, pctx, pds = ctxs
    roi = _roi() if with_roi else None
    ours = list(pctx.run_udf_iter(pds, [_udf(port, MODES[mode])], roi=roi))
    theirs = list(jctx.run_udf_iter(jds, [_udf(libertem_tpu, MODES[mode])],
                                    roi=roi))
    assert len(ours) == len(theirs) == 3
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert np.array_equal(a.damage.data, b.damage.data)
        _compare(f"{mode} partial {i}", a.buffers[0], b.buffers[0])
    # the first partial's fit is over its own rows only: it differs
    # from the final one
    first = ours[0].buffers[0]["regression"].data
    last = ours[-1].buffers[0]["regression"].data
    assert not np.allclose(first, last)


def test_regression_against_lstsq(ctxs):
    """SUBTRACT_LINEAR's coefficients are the float64 least-squares
    plane through the rotated shifts of the float64 centres."""
    _, _, pctx, pds = ctxs
    roi = _roi()
    res = pctx.run_udf(pds, _udf(port, 1), roi=roi)
    data = tilted_scan().reshape(-1, *SIG).astype(np.float64)
    y, x = np.mgrid[0:SIG[0], 0:SIG[1]]
    disk = ((y - 9.5) ** 2 + (x - 10.5) ** 2 <= 81.0).astype(np.float64)
    s = (data * disk).sum((1, 2))
    sy, sx = jcom.apply_com_correction(
        (data * disk * y).sum((1, 2)) / s - 9.5,
        (data * disk * x).sum((1, 2)) / s - 10.5, 12.0, False)
    sel = roi.reshape(-1)
    rows, cols = np.mgrid[0:NAV[0], 0:NAV[1]]
    a = np.stack([np.ones(sel.sum()), rows.reshape(-1)[sel],
                  cols.reshape(-1)[sel]], axis=-1)
    want = np.stack([np.linalg.lstsq(a, c[sel], rcond=None)[0]
                     for c in (sy, sx)], axis=-1)
    np.testing.assert_allclose(res["regression"].data, want,
                               rtol=COEF_RTOL,
                               atol=COEF_RTOL * np.abs(want).max())


def test_valid_nav_mask_only_in_get_results(ctxs):
    """``meta.get_valid_nav_mask`` is None while frames are processed
    and, in ``get_results``, the merged positions of each partial
    (roi-compressed, or over the whole nav with ``full_nav``)."""
    _, _, pctx, pds = ctxs
    seen = []

    class Probe(port.udf.UDF):
        def get_result_buffers(self):
            return {"n": self.buffer(kind="nav", dtype="float32")}

        def process_tile(self, tile):
            seen.append(("process", self.meta.get_valid_nav_mask()))
            self.results.n = self.results.n + 1

        def get_results(self):
            seen.append(("results", self.meta.get_valid_nav_mask(),
                         self.meta.get_valid_nav_mask(full_nav=True)))
            return {}

    roi = _roi()
    partials = list(pctx.run_udf_iter(pds, [Probe()], roi=roi))
    assert {m for k, m, *_ in seen if k == "process"} == {None}
    masks = [rest for k, *rest in seen if k == "results"]
    assert len(masks) == len(partials) == 3
    for (flat, full), res in zip(masks, partials):
        assert flat.shape == (roi.sum(),)
        assert np.array_equal(full, res.damage.data.reshape(-1))
        assert np.array_equal(full[roi.reshape(-1)], flat)
    assert masks[-1][0].all()


@pytest.mark.parametrize("mode", [2, -2])
def test_unknown_regression_option_raises(ctxs, mode):
    jctx, jds, pctx, pds = ctxs
    with pytest.raises(ValueError, match="unrecognized regression"):
        pctx.run_udf(pds, _udf(port, mode))
    with pytest.raises(ValueError, match="unrecognized regression"):
        jctx.run_udf(jds, _udf(libertem_tpu, mode))


def test_given_regression_of_wrong_shape_raises(ctxs):
    _, _, pctx, pds = ctxs
    with pytest.raises(ValueError, match=r"\(3, 2\)"):
        pctx.run_udf(pds, _udf(port, np.zeros((2, 2))))


def test_complex_data_has_no_regression():
    """On complex data the regression is not applied and its buffer is
    marked invalid, as in the JAX package."""
    rng = np.random.default_rng(2)
    cdata = (rng.random((4, 4, 8, 8)) + 0.5
             + 1j * rng.random((4, 4, 8, 8))).astype(np.complex64)
    pctx = port.Context(device="cpu")
    jctx = JaxContext(executor=InlineJobExecutor())
    ours = pctx.run_udf(pctx.load("memory", data=cdata, sig_dims=2),
                        port.CoMUDF.with_params(regression=1))
    theirs = jctx.run_udf(jctx.load("memory", data=cdata, sig_dims=2),
                          libertem_tpu.udf.CoMUDF.with_params(regression=1))
    assert not ours["regression"].valid_mask.any()
    assert not theirs["regression"].valid_mask.any()
    np.testing.assert_allclose(ours["field"].data, theirs["field"].data,
                               rtol=1e-4, atol=1e-4)


# -- the helpers, on identical float64 inputs ------------------------------

def _fields(seed=3):
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:12, 0:14]
    y = 0.3 * rows - 0.1 * cols + rng.normal(0, 0.05, rows.shape)
    x = -0.2 * rows + 0.25 * cols + rng.normal(0, 0.05, rows.shape)
    # a field with a known rotation, flip and centre
    y, x = jcom.apply_correction(y, x, 37.0, True, forward=False)
    return y + 1.5, x - 2.0


def test_guess_corrections_equal_to_jax():
    y, x = _fields()
    ours = pcom.guess_corrections(y, x)
    theirs = jcom.guess_corrections(y, x)
    assert tuple(ours) == tuple(theirs)
    assert ours._fields == theirs._fields
    assert ours["cy"] == ours.cy and dict(
        zip(ours.keys(), ours)) == dict(zip(theirs.keys(), theirs))
    roi = (slice(1, -2), slice(0, -1))
    assert tuple(pcom.guess_corrections(y, x, roi=roi)) == tuple(
        jcom.guess_corrections(y, x, roi=roi))


@pytest.mark.parametrize("name,args", [
    ("apply_correction", (23.0, True)),
    ("apply_correction", (-71.0, False)),
    ("divergence", ()),
    ("curl_2d", ()),
    ("magnitude", ()),
    ("coordinate_check", ()),
])
def test_helpers_equal_to_jax(name, args):
    y, x = _fields()
    ours = getattr(pcom, name)(y, x, *args)
    theirs = getattr(jcom, name)(y, x, *args)
    for a, b in zip(np.atleast_1d(ours), np.atleast_1d(theirs)):
        assert np.array_equal(a, b)
    if name == "apply_correction":
        back = pcom.apply_correction(*ours, *args, forward=False)
        np.testing.assert_allclose(back, (y, x), atol=1e-12)
        assert all(np.array_equal(a, b) for a, b in zip(
            back, jcom.apply_correction(*theirs, *args, forward=False)))


def test_center_shifts_and_mask_factories_equal_to_jax():
    rng = np.random.default_rng(4)
    s = rng.random((5, 6))
    s[1, 2] = 0.0
    iy, ix = rng.random((5, 6)), rng.random((5, 6))
    for a, b in zip(pcom.center_shifts(s, iy, ix, 3.0, 4.0),
                    jcom.center_shifts(s, iy, ix, 3.0, 4.0)):
        assert np.array_equal(a, b)
    for ours, theirs in [
        (pcom.com_masks_factory(20, 22, 9.5, 10.5, 7.0),
         jcom.com_masks_factory(20, 22, 9.5, 10.5, 7.0)),
        (pcom.com_masks_generic(20, 22, lambda: port.masks.ring(
            10, 9, 22, 20, 8, 3)),
         jcom.com_masks_generic(20, 22, lambda: libertem_tpu.masks.ring(
             10, 9, 22, 20, 8, 3))),
    ]:
        assert len(ours) == len(theirs) == 3
        for f, g in zip(ours, theirs):
            assert np.array_equal(np.asarray(f()), np.asarray(g()))


def test_analysis_reexports_helpers():
    import libertem_tpu.analysis.com as jana
    import libertem_tpu_torch.analysis.com as pana
    for name in ("GuessResult", "apply_correction", "center_shifts",
                 "com_masks_factory", "com_masks_generic",
                 "coordinate_check", "curl_2d", "divergence",
                 "guess_corrections", "magnitude"):
        assert hasattr(jana, name)
        assert getattr(pana, name) is getattr(pcom, name)


def test_golden_com():
    """The ``com`` golden (tolerances of the JAX package's own test),
    through CoMUDF and through the CENTER_OF_MASS analysis."""
    import golden_common as gc
    from test_parity_reference import _golden
    g = _golden("com")
    pctx = port.Context(device="cpu")
    ds = pctx.load("memory", data=gc.golden_data(), sig_dims=2,
                   num_partitions=4)
    res = pctx.run_udf(ds, port.CoMUDF(pcom.CoMParams(**gc.COM_PARAMS)))
    for name, rtol in [("raw_com", 1e-4), ("field", 1e-4),
                       ("magnitude", 1e-4), ("divergence", 1e-3),
                       ("curl", 1e-3)]:
        np.testing.assert_allclose(res[name].data, g[name], rtol=rtol,
                                   atol=1e-4, err_msg=name)
    p = gc.COM_PARAMS
    ana = pctx.run(pctx.create_com_analysis(
        ds, cx=p["cx"], cy=p["cy"], mask_radius=p["r"], flip_y=p["flip_y"],
        scan_rotation=p["scan_rotation"]))
    np.testing.assert_allclose(ana.y.raw_data, g["field"][..., 0],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ana.x.raw_data, g["field"][..., 1],
                               rtol=1e-4, atol=1e-4)
    for name, rtol in [("magnitude", 1e-4), ("divergence", 1e-3),
                       ("curl", 1e-3)]:
        np.testing.assert_allclose(ana[name].raw_data, g[name], rtol=rtol,
                                   atol=1e-4, err_msg=name)
