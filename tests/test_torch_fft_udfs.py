"""The port's FFT UDFs (the blobfinder correlations and holography) and
the synthetic-data generators against the JAX package on the CPU.

The same numpy-seeded inputs (nav up to 4x4, sig 64x64) go through
``libertem_tpu_torch`` (``Context(device="cpu")``, torch.fft) and
``libertem_tpu`` (jnp.fft).  Tolerances: the generators bit-equal;
correlation centres exact (the data's peaks are unique), refined
positions within 1e-4 px and peak values within 1e-4 of the largest
peak value (float32 FFTs of two libraries differ at float32 rounding);
the holography wave within 1e-4 of max|wave|; the sideband estimates
and the lattice fit equal.
"""
import warnings

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf.blobfinder as jblob
import libertem_tpu.udf.holography as jholo
import libertem_tpu.utils as jutils
import libertem_tpu.utils.generate as jgen
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.common.exceptions import UDFException as JaxUDFException
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.udf.base import UDFRunner as JaxUDFRunner

import libertem_tpu_torch as port
import libertem_tpu_torch.udf.blobfinder as pblob
import libertem_tpu_torch.udf.holography as pholo
import libertem_tpu_torch.utils as putils
import libertem_tpu_torch.utils.generate as pgen
from libertem_tpu_torch.common.exceptions import UDFException

torch.set_num_threads(1)

TOL = 1e-4
NAV, SIG = (4, 4), (64, 64)
LIBS = {"port": (port, pblob, pholo), "jax": (libertem_tpu, jblob, jholo)}


def _ctx():
    return port.Context(device="cpu")


def _jctx():
    return JaxContext(executor=InlineJobExecutor())


def _both(data, **kw):
    """The port's and the JAX package's context and memory dataset."""
    args = dict(data=data, sig_dims=2, num_partitions=3, **kw)
    pctx, jctx = _ctx(), _jctx()
    return (pctx, pctx.load("memory", **args), jctx,
            jctx.load("memory", **args))


# -- the generators ----------------------------------------------------------

CBED_ARGS = [
    dict(),
    dict(fy=64, fx=48, radius=3),
    dict(fy=64, fx=64, zero=(30.5, 33), a=(16, 0), b=(0, 16), radius=4),
    dict(fy=64, fx=64, a=(7, 3), b=(-2, 9), radius=2, all_equal=True),
    dict(fy=32, fx=32, indices=[(0, 0), (1, 0), (0, 1)], margin=0),
    dict(fy=32, fx=32, indices=np.mgrid[-2:3, -1:2]),
]


@pytest.mark.parametrize("kw", CBED_ARGS)
def test_cbed_frame(kw):
    ours = pgen.cbed_frame(**kw)
    theirs = jgen.cbed_frame(**kw)
    for o, t in zip(ours, theirs):
        assert np.asarray(o).dtype == np.asarray(t).dtype
        assert np.array_equal(o, t)


HOLO_ARGS = [
    dict(),
    dict(sampling=4.0, f_angle=10.0, visibility=0.7),
    dict(poisson_noise=0.5, counts=500.0),
    dict(gaussian_noise=1.5),
]


@pytest.mark.parametrize("kw", HOLO_ARGS)
def test_hologram_frame(kw):
    y, x = np.mgrid[0:48, 0:40]
    amp = 1 + 0.1 * np.sin(x / 7.0)
    phi = np.exp(-((y - 20) ** 2 + (x - 24) ** 2) / 90.0)
    np.random.seed(3)
    ours = pgen.hologram_frame(amp, phi, **kw)
    np.random.seed(3)
    theirs = jgen.hologram_frame(amp, phi, **kw)
    assert ours.dtype == theirs.dtype == np.float64
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("kw,exc", [
    (dict(poisson_noise="a"), ValueError),
    (dict(gaussian_noise="a"), ValueError),
])
def test_hologram_frame_errors(kw, exc):
    amp = np.ones((8, 8))
    for gen in (pgen, jgen):
        with pytest.raises(exc):
            gen.hologram_frame(amp, amp, **kw)
        with pytest.raises(ValueError):
            gen.hologram_frame(amp, np.ones((8, 9)))


@pytest.mark.parametrize("nav,sig", [((3,), (4, 5)), ((2, 3), (7,)),
                                     ((4, 4), (16, 16))])
def test_gradient_data(nav, sig):
    ours, theirs = pgen.gradient_data(nav, sig), jgen.gradient_data(nav, sig)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("sig,n", [((16, 16), 5), ((32, 8), 3),
                                   ((10, 10, 10), 4), ((16, 16), 0)])
def test_exclude_pixels(sig, n):
    ours = pgen.exclude_pixels(sig, n, rng=np.random.default_rng(2))
    theirs = jgen.exclude_pixels(sig, n, rng=np.random.default_rng(2))
    if n == 0:
        assert ours is None and theirs is None
        return
    assert np.array_equal(ours, theirs)
    assert np.array_equal(pgen.exclude_pixels(sig, n),
                          jgen.exclude_pixels(sig, n))


def test_coordinate_helpers():
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(5, 2))
    for name, args in (
        ("make_polar", (vecs,)),
        ("make_cartesian", (np.abs(vecs),)),
        ("rotate_deg", (vecs[:, 0], vecs[:, 1], 33.0)),
        ("rotate_rad", (vecs[:, 0], vecs[:, 1], 0.7)),
        ("frame_peaks_polar", ((3, 4), (5, 0), (0, 5),
                               np.mgrid[-1:2, -1:2])),
        ("regularize_indices", (np.mgrid[-2:3, -1:2],)),
        ("calc_coords", (np.array((32, 32)), (8, 1), (-1, 8),
                         np.mgrid[-2:3, -2:3].reshape(2, -1).T)),
        ("within_frame", (vecs * 30 + 20, 4, 40, 40)),
        ("frame_peaks", (64, 48, np.array((30, 20)), np.array((9, 1)),
                         np.array((1, -9)), 3, np.mgrid[-4:5, -4:5])),
    ):
        ours = getattr(putils, name)(*args)
        theirs = getattr(jutils, name)(*args)
        for o, t in zip(ours if isinstance(ours, tuple) else (ours,),
                        theirs if isinstance(theirs, tuple) else (theirs,)):
            assert np.array_equal(o, t), name
    with pytest.raises(ValueError):
        putils.regularize_indices(np.zeros((3, 3)))


# -- the correlations ------------------------------------------------------


def _cbed_data(lib_gen=pgen):
    """Lattice frames (a = (16, 0), b = (0, 16), radius 3) whose zero
    order wanders with the scan position: unequal peaks, so the argmax
    of every correlation map is unique."""
    frames = []
    for i in range(int(np.prod(NAV))):
        zero = (32 + (i % 4) - 2, 32 + (i // 4) - 1)
        f, _, _ = lib_gen.cbed_frame(*SIG, zero=zero, a=(16, 0),
                                     b=(0, 16), radius=3)
        frames.append(f[0])
    return np.stack(frames).reshape(NAV + SIG)


def _nominal_peaks(n=9):
    _, peaks = putils.frame_peaks(
        *SIG, np.array((32, 32)), np.array((16, 0)), np.array((0, 16)), 3,
        np.mgrid[-3:4, -3:4])
    order = np.argsort(np.linalg.norm(peaks - 32, axis=1), kind="stable")
    return peaks[order[:n]].astype(np.int32)


def _patterns(blob):
    return {
        "disk": blob.Disk(radius=3),
        "gradient": blob.RadialGradient(radius=3),
        "background": blob.BackgroundSubtraction(radius=3, radius_outer=5),
    }


def _check_correlation(ours, theirs):
    assert np.array_equal(ours["centers"].data, theirs["centers"].data,
                          equal_nan=True)
    scale = float(np.nanmax(np.abs(theirs["peak_values"].data)))
    assert np.allclose(ours["peak_values"].data, theirs["peak_values"].data,
                       rtol=0, atol=TOL * scale, equal_nan=True)
    assert np.allclose(ours["refineds"].data, theirs["refineds"].data,
                       rtol=0, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("pattern", ["disk", "gradient", "background"])
@pytest.mark.parametrize("sparse", [False, True])
def test_correlation_matches_jax(pattern, sparse):
    data = _cbed_data()
    pctx, ds, jctx, jds = _both(data)

    def make(blob):
        mp = _patterns(blob)[pattern]
        if sparse:
            return blob.SparseCorrelationUDF(mp, peaks=_nominal_peaks(),
                                             steps=3)
        return blob.FullFrameCorrelationUDF(mp)

    ours = pctx.run_udf(ds, make(pblob))
    theirs = jctx.run_udf(jds, make(jblob))
    assert pctx.run_info["engines"] == ["device"]
    assert not pctx.run_info["fused"]
    _check_correlation(ours, theirs)
    if not sparse:
        # the zero order is the brightest disk
        centers = ours["centers"].data.reshape(-1, 2)
        i = np.arange(len(centers))
        assert np.array_equal(centers[:, 0], 32 + (i % 4) - 2)
        assert np.array_equal(centers[:, 1], 32 + (i // 4) - 1)


def test_sparse_border_peak_wraps():
    """Peaks within ``steps`` of the border: the windows wrap with the
    circular correlation (as ``tests/test_blobfinder.py`` checks)."""
    fy = fx = 32
    frames = np.zeros((1, 1, fy, fx), dtype=np.float32)
    yy, xx = np.mgrid[0:fy, 0:fx]
    for py, px in [(1, 1), (16, 29)]:
        frames[0, 0][(yy - py) ** 2 + (xx - px) ** 2 <= 4] = 10.0
    pctx, ds, jctx, jds = _both(frames)
    peaks = np.array([[2, 2], [17, 28]])

    def make(blob):
        return blob.SparseCorrelationUDF(
            match_pattern=blob.Disk(radius=2, search=5), peaks=peaks,
            steps=4)

    ours = pctx.run_udf(ds, make(pblob))
    theirs = jctx.run_udf(jds, make(jblob))
    _check_correlation(ours, theirs)
    centers = ours["centers"].data.reshape(2, 2)
    assert np.allclose(centers[0], (1, 1), atol=1)
    assert np.allclose(centers[1], (16, 29), atol=1)


def test_subpixel_refine_clips_per_frame():
    """The full-frame refinement: the window clips at the border, and
    its minimum and sum are each frame's own."""
    rng = np.random.default_rng(5)
    corr = rng.random((6, 9, 7)).astype(np.float32)
    iy = np.array([0, 8, 4, 0, 8, 3])
    ix = np.array([0, 6, 3, 6, 0, 1])
    ry, rx = pblob._subpixel_refine(torch.from_numpy(corr),
                                    torch.from_numpy(iy),
                                    torch.from_numpy(ix))
    import jax
    jy, jx = jax.vmap(jblob._subpixel_refine)(corr, iy.astype(np.int32),
                                              ix.astype(np.int32))
    assert np.allclose(ry.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    assert np.allclose(rx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_peaks", [False, True])
@pytest.mark.parametrize("with_roi", [False, True])
def test_run_blobfinder(with_peaks, with_roi):
    data = _cbed_data()
    pctx, ds, jctx, jds = _both(data)
    roi = None
    if with_roi:
        roi = np.random.default_rng(6).random(NAV) < 0.5
    peaks = _nominal_peaks(5) if with_peaks else None
    ours = pblob.run_blobfinder(pctx, ds, pblob.RadialGradient(3),
                                peaks=peaks, steps=2, roi=roi)
    theirs = jblob.run_blobfinder(jctx, jds, jblob.RadialGradient(3),
                                  peaks=peaks, steps=2, roi=roi)
    _check_correlation(ours, theirs)
    if with_roi:
        assert np.isnan(ours["refineds"].data[~roi]).all()


def test_fit_lattice():
    """The lattice fit of the sparse correlation's refined peaks, equal
    to the JAX package's; 1% and 2% stretches of a recovered."""
    zero = np.array([32.0, 32.0])
    a = np.array([8.0, 0.0])
    b = np.array([0.0, 8.0])
    hk = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1], [1, 1]])
    peaks = zero + hk @ np.stack([a, b])
    refineds = np.zeros((2, 3, len(peaks), 2))
    rng = np.random.default_rng(7)
    for i in np.ndindex((2, 3)):
        refineds[i] = zero + hk @ np.stack([a * (1 + 0.01 * (i[0] + 1)), b])
    refineds += rng.normal(0, 1e-3, refineds.shape)
    ours = pblob.fit_lattice(refineds, peaks, zero, a, b)
    theirs = jblob.fit_lattice(refineds, peaks, zero, a, b)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert np.allclose(ours[k], theirs[k], rtol=0, atol=1e-12), k
    assert np.allclose(ours["da_rel"][1], 0.02, atol=1e-3)


def test_correlation_refuses_a_sig_split():
    """A dataset that forces sig-split tiles: UDFException, as in the
    JAX package."""
    data = _cbed_data()
    pctx, ds, jctx, jds = _both(data, tileshape=(4, 32, 64))
    with pytest.raises(UDFException):
        pctx.run_udf(ds, [pblob.FullFrameCorrelationUDF(pblob.Disk(3)),
                          port.SumUDF()])
    with pytest.raises(JaxUDFException):
        jctx.run_udf(jds, [jblob.FullFrameCorrelationUDF(jblob.Disk(3)),
                           libertem_tpu.udf.SumUDF()])


@pytest.mark.parametrize("which", ["full", "sparse", "holo"])
def test_fused_plan_follows_jax(which):
    """An FFT UDF beside Sum and StdDev: the pass is fused exactly where
    the JAX package's plan fuses it, and the results agree."""
    data = (_cbed_data() * 10).astype(np.uint16)
    pctx, ds, jctx, jds = _both(data)

    def make(lib, blob, holo):
        if which == "full":
            first = blob.FullFrameCorrelationUDF(blob.Disk(3))
        elif which == "sparse":
            first = blob.SparseCorrelationUDF(blob.Disk(3),
                                              peaks=_nominal_peaks(4))
        else:
            first = holo.HoloReconstructUDF(out_shape=(16, 16),
                                            sb_position=(8, 8), sb_size=4)
        return [first, lib.udf.SumUDF(), lib.udf.StdDevUDF()]

    jprep = JaxUDFRunner(make(*LIBS["jax"]))._prepare(jds, None, None, None)
    ours = pctx.run_udf(ds, make(*LIBS["port"]))
    assert pctx.run_info["fused"] == (jprep["fused"] is not None)
    theirs = jctx.run_udf(jds, make(*LIBS["jax"]))
    for o, t in zip(ours[1:], theirs[1:]):
        for k in t:
            want = np.asarray(t[k].data, np.float64)
            assert np.allclose(o[k].data, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1))
    if which != "holo":
        _check_correlation(ours[0], theirs[0])


def test_match_pattern_patch_mid_run():
    """``run_udf_iter`` with the match pattern patched after the first
    partial: the cached spectrum is rebuilt, and every partial equals the
    JAX package's under the same patch."""
    data = _cbed_data()
    pctx, ds, jctx, jds = _both(data)

    def partials(ctx, dset, blob):
        udf = blob.FullFrameCorrelationUDF(blob.Disk(3))
        gen = ctx.run_udf_iter(dset, udf)
        out = []
        for i, res in enumerate(gen):
            out.append(res.buffers[0])
            if i == 0:
                gen.update_parameters_experimental(
                    [{"match_pattern": blob.RadialGradient(3)}])
        return out

    ours = partials(pctx, ds, pblob)
    theirs = partials(jctx, jds, jblob)
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        for k in t:
            got = np.nan_to_num(np.asarray(o[k].data), nan=-1.0)
            want = np.nan_to_num(np.asarray(t[k].data), nan=-1.0)
            atol = TOL * np.abs(want).max() if k == "peak_values" else (
                TOL if k == "refineds" else 0)
            assert np.allclose(got, want, rtol=0, atol=atol), k
    # the patch changed the answer: the gradient's peak values differ
    plain = pctx.run_udf(ds, pblob.FullFrameCorrelationUDF(pblob.Disk(3)))
    last = ours[-1]["peak_values"].data.reshape(-1)
    assert not np.allclose(last[-5:], plain["peak_values"].data.reshape(
        -1)[-5:])


class _Template(pblob.MatchPattern):
    """A match pattern whose mask is a given array."""

    def __init__(self, mask):
        super().__init__()
        self.mask = mask

    def get_mask(self, sig_shape):
        return self.mask


def _full_spectrum_correlation(frames, mask):
    """float64 ``ifft2(fft2(x) * conj(fft2(template))).real``, the
    template centred at (0, 0)."""
    spectrum = np.conj(np.fft.fft2(np.fft.ifftshift(mask)))
    return np.fft.ifft2(np.fft.fft2(frames.astype(np.float64))
                        * spectrum).real


@pytest.mark.parametrize("sig", [(64, 64), (63, 65), (32, 48)])
def test_correlate_on_the_half_spectrum(sig):
    """``_correlate`` on real frames with ``_half_spectrum``'s plan: the
    full complex correlation in float64, within 1e-6 of the map's
    scale, as a contiguous float32 (d, h, w) map (odd widths too)."""
    rng = np.random.default_rng(11)
    frames = rng.poisson(50.0, (3,) + sig).astype(np.float32)
    mask = rng.random(sig)
    got = pblob._correlate(
        torch.from_numpy(frames),
        pblob._half_spectrum(_Template(mask), sig, torch.device("cpu")))
    want = _full_spectrum_correlation(frames, mask)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == (3,) + sig
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-6 * scale


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("sig", [(64, 64), (63, 65)])
def test_plan_holds_the_scaled_half_spectrum(sparse, sig):
    """Each correlation UDF's plan after a run: complex64 (h, w//2+1),
    ``conj(rfft2(template)) / (h * w)``."""
    data = np.random.default_rng(12).poisson(8, (2, 2) + sig).astype(
        np.uint16)
    ctx = _ctx()
    mp = pblob.RadialGradient(radius=3)
    if sparse:
        udf = pblob.SparseCorrelationUDF(mp, peaks=[[20, 20]], steps=2)
    else:
        udf = pblob.FullFrameCorrelationUDF(mp)
    ctx.run_udf(ctx.load("memory", data=data, sig_dims=2), udf)
    got = udf._plan["spectrum"] if sparse else udf._spectrum
    h, w = sig
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (h, w // 2 + 1)
    want = np.conj(np.fft.rfft2(np.fft.ifftshift(mp.get_mask(sig)))) / (
        h * w)
    assert np.allclose(got.numpy(), want, rtol=0,
                       atol=1e-6 * np.abs(want).max())


def _complex_spectrum_path(monkeypatch):
    """The correlation as it was before the half spectrum: the full
    conjugate spectrum, ``fft2``, the product, ``ifft2``, ``.real``."""
    monkeypatch.setattr(
        pblob, "_half_spectrum",
        lambda mp, sig, device: torch.from_numpy(
            mp.get_template_spectrum(sig)).to(device))
    monkeypatch.setattr(
        pblob, "_correlate",
        lambda tile, spectrum: torch.fft.ifft2(
            torch.fft.fft2(tile.to(torch.float32)) * spectrum).real)


@pytest.mark.parametrize("pattern", ["disk", "gradient", "background"])
@pytest.mark.parametrize("sparse", [False, True])
def test_half_spectrum_centres_equal_the_complex_path(pattern, sparse,
                                                      monkeypatch):
    """Both correlation UDFs on the test frames: every centre equal to
    the complex-spectrum path's, refined positions and peak values
    within float32 rounding of it."""
    data = _cbed_data()
    ctx = _ctx()
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)

    def run():
        mp = _patterns(pblob)[pattern]
        if sparse:
            udf = pblob.SparseCorrelationUDF(mp, peaks=_nominal_peaks(),
                                             steps=3)
        else:
            udf = pblob.FullFrameCorrelationUDF(mp)
        return ctx.run_udf(ds, udf)

    ours = run()
    with monkeypatch.context() as m:
        _complex_spectrum_path(m)
        theirs = run()
    _check_correlation(ours, theirs)


# -- holography ---------------------------------------------------------------


def _holograms(n=4, size=64, sampling=4.0):
    """A flat reference and smooth phase objects of growing strength."""
    y, x = np.mgrid[0:size, 0:size]
    amp = np.ones((size, size))
    frames = []
    for i in range(n):
        phase = 0.5 * i * np.exp(
            -((y - size / 2) ** 2 + (x - size / 2) ** 2) / (size * 3.0))
        frames.append(pgen.hologram_frame(amp, phase, sampling=sampling))
    return np.stack(frames).astype(np.float32)


@pytest.mark.parametrize("out_shape", [(32, 32), (31, 17), (1, 7), None,
                                       (64, 64)])
def test_holo_reconstruct_matches_jax(out_shape):
    """Even, odd, one-row and absent ``out_shape``: the wave within 1e-4
    of max|wave| of the JAX package's."""
    frames = _holograms()
    pctx, ds, jctx, jds = _both(frames.reshape(2, 2, 64, 64))
    pos = pholo.estimate_sideband_position(frames[0])
    size = pholo.estimate_sideband_size(pos, (64, 64))
    assert pos == jholo.estimate_sideband_position(frames[0])
    assert size == jholo.estimate_sideband_size(pos, (64, 64))

    def make(holo):
        return holo.HoloReconstructUDF(out_shape=out_shape,
                                       sb_position=pos, sb_size=size)

    ours = pctx.run_udf(ds, make(pholo))
    theirs = jctx.run_udf(jds, make(jholo))
    assert pctx.run_info["engines"] == ["device"]
    got, want = ours["wave"].data, theirs["wave"].data
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_holo_recovers_the_phase():
    """The phase difference object-minus-reference recovers the object
    (``tests/test_holography.py``'s check, on the port)."""
    sy = sx = 64
    y, x = np.mgrid[0:sy, 0:sx]
    phase = 1.5 * np.exp(-((y - 32) ** 2 + (x - 32) ** 2) / 200.0)
    amp = np.ones((sy, sx))
    holo = pgen.hologram_frame(amp, phase, sampling=4.0)
    ref = pgen.hologram_frame(amp, np.zeros_like(phase), sampling=4.0)
    frames = np.stack([holo, ref]).astype(np.float32).reshape(2, 1, sy, sx)
    ctx = _ctx()
    ds = ctx.load("memory", data=frames, sig_dims=2, num_partitions=1)
    pos = pholo.estimate_sideband_position(ref)
    udf = pholo.HoloReconstructUDF(
        out_shape=(32, 32), sb_position=pos,
        sb_size=pholo.estimate_sideband_size(pos, (sy, sx)))
    wave = ctx.run_udf(ds, udf)["wave"].data.reshape(2, 32, 32)
    dphi = -np.angle(wave[0] / wave[1])
    inner = np.s_[8:24, 8:24]
    delta = dphi[inner] - phase[::2, ::2][inner]
    delta -= delta.mean()
    assert np.abs(delta).max() < 0.35
    assert np.abs(delta).mean() < 0.1


@pytest.mark.parametrize("out_shape", [(65, 64), (64, 80)])
def test_holo_upsample_rejected(out_shape):
    data = np.ones((1, 1, 64, 64), dtype=np.float32)
    for lib, holo in ((port, pholo), (libertem_tpu, jholo)):
        ctx = _ctx() if lib is port else _jctx()
        ds = ctx.load("memory", data=data, sig_dims=2)
        with pytest.raises(ValueError) as err:
            ctx.run_udf(ds, holo.HoloReconstructUDF(
                out_shape=out_shape, sb_position=(8, 8), sb_size=4))
        assert "exceeds the frame shape" in str(err.value)
    for holo in (pholo, jholo):
        with pytest.raises(ValueError):
            holo.HoloReconstructUDF(out_shape=(8, 8))


@pytest.mark.parametrize("shape,radius,smooth", [((32, 32), 8.0, 0.05),
                                                 ((31, 17), 5.5, 0.2),
                                                 ((1, 7), 2.0, 0.05)])
def test_aperture_and_crop(shape, radius, smooth):
    """The aperture bit-equal; the crop index equal to the JAX package's
    roll and crop."""
    assert np.array_equal(pholo._aperture(shape, radius, smooth),
                          jholo._aperture(shape, radius, smooth))
    n, sb = 64, 21
    for out in shape:
        rolled = np.roll(np.arange(n), -sb)
        top = rolled[:out // 2 + out % 2]
        bot = rolled[-(out // 2):] if out // 2 else rolled[:0]
        assert np.array_equal(pholo._crop_index(n, out, sb),
                              np.concatenate([top, bot]))


def test_holo_patch_rebuilds_the_aperture():
    """A ``run_udf_iter`` patch of ``sb_size``: the aperture is rebuilt
    from the next partition on, as in the JAX package."""
    frames = _holograms(n=6)
    pctx, ds, jctx, jds = _both(frames.reshape(6, 64, 64))

    def partials(ctx, dset, holo):
        udf = holo.HoloReconstructUDF(out_shape=(32, 32),
                                      sb_position=(16, 9), sb_size=8)
        gen = ctx.run_udf_iter(dset, udf)
        out = []
        for i, res in enumerate(gen):
            out.append(np.asarray(res.buffers[0]["wave"].data))
            if i == 0:
                gen.update_parameters_experimental([{"sb_size": 4.0}])
        return out

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = partials(pctx, ds, pholo)
        theirs = partials(jctx, jds, jholo)
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        ok = ~np.isnan(t)
        assert np.array_equal(np.isnan(o), np.isnan(t))
        assert np.abs(o[ok] - t[ok]).max() <= TOL * np.abs(t[ok]).max()
