"""Strain mapping on the port: ``SparseCorrelationUDF`` and
``FullFrameCorrelationUDF`` over frames with a strained lattice's disks
rendered in, on the single-device loop and on four CPU workers of the
multi-device loop, against the benchmark's plain float64 reference
(``portbench/reference/strain.py``) and against the JAX package; and
the correlation's spans in a run's totals.

The reference and the specimen (``portbench/specimens/lattice.py``)
are loaded from their files.  Sizes are cut to nav 8x8, sig 64x64, 9
peaks and steps 3 from the ``strain-u16`` configuration.  Tolerances:
the centres exact (the rendered disks leave every window one clear
maximum); the refined centres and peak values within the
configuration's own limit on the group (the largest difference over the
largest magnitude of a buffer, as the benchmark compares).
"""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import libertem_tpu.udf.blobfinder as jblob
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor

import libertem_tpu_torch as port
import libertem_tpu_torch.udf.blobfinder as pblob
from libertem_tpu_torch.common import tracing
from libertem_tpu_torch.executor.sharded import ShardedJobExecutor

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "portbench"
SPANS = ("libertem.udf_process", "libertem.correlate", "libertem.refine")


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(
        f"strain_test_{kind}_{name}", BENCH / kind / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("reference", "strain")
SPECIMEN = _load("specimens", "lattice")


def _config():
    """``strain-u16`` cut to nav 8x8, sig 64x64, 9 peaks, steps 3."""
    config = json.loads((BENCH / "configs" / "strain-u16.json").read_text())
    config.update(nav=[8, 8], sig=[64, 64], steps=3, template_radius=3)
    config["specimen"].update(zero=[32, 32], a=[0, 14], b=[14, 0],
                              orders=1, radius=3, strain=0.05,
                              rotation_deg=2.0)
    return config


CONFIG = _config()
LIMIT = CONFIG["limits"]["correlation"]


def _inputs(seed=7):
    """A Poisson(1) background from ``seed``, the disks not yet in."""
    frames = np.random.default_rng(seed).poisson(
        1.0, tuple(CONFIG["nav"]) + tuple(CONFIG["sig"])).astype(np.uint16)
    return SimpleNamespace(frames=frames)


def _rendered(seed=7):
    inputs = _inputs(seed)
    SPECIMEN.render(CONFIG, inputs)
    return inputs


def _group_error(got, want):
    """The largest, over the buffers, of the largest absolute
    difference over the largest magnitude of the reference's buffer."""
    out = 0.0
    for name, w in want.items():
        g = np.asarray(got[name], dtype=np.float64)
        assert g.shape == w.shape, name
        out = max(out, float(np.abs(g - w).max() / np.abs(w).max()))
    return out


def _context(loop):
    """The single-device loop, or the multi-device loop on four CPU
    workers."""
    if loop == "inline":
        return port.Context(device="cpu")
    return port.Context(executor=ShardedJobExecutor(devices=["cpu"] * 4))


def _peaks():
    return REF.expected_peaks(CONFIG)


def _sparse(blob):
    return blob.SparseCorrelationUDF(
        blob.RadialGradient(3), _peaks(), steps=CONFIG["steps"])


@pytest.mark.parametrize("loop", ["inline", "sharded"])
def test_sparse_against_the_plain_reference(loop):
    inputs = _rendered()
    want = REF.expected(CONFIG, inputs)["correlation"]
    ctx = _context(loop)
    res = ctx.run_udf(ctx.load("memory", data=inputs.frames, sig_dims=2),
                      _sparse(pblob))
    got = {k: res[k].data for k in want}
    assert np.array_equal(got["centers"], want["centers"])
    assert _group_error(got, want) <= LIMIT
    # the strain moves the reflections off the nominal lattice
    assert not np.array_equal(want["centers"][-1, -1],
                              want["centers"][0, 0])


@pytest.mark.parametrize("loop", ["inline", "sharded"])
def test_full_frame_against_the_plain_reference(loop):
    """The full-frame maximum (the zero order, the brightest disk) and
    its 3x3 centre of mass: the reference's window over the whole map,
    then its 3x3 window around the maximum found."""
    inputs = _rendered()
    zero = np.array([CONFIG["specimen"]["zero"]])
    whole = REF.correlation(inputs.frames, CONFIG["sig"], 3.0, zero, 32)
    assert (whole["centers"] == zero).all()
    want = REF.correlation(inputs.frames, CONFIG["sig"], 3.0, zero, 1)
    want = {k: v[:, :, 0] for k, v in want.items()}
    ctx = _context(loop)
    res = ctx.run_udf(ctx.load("memory", data=inputs.frames, sig_dims=2),
                      pblob.FullFrameCorrelationUDF(pblob.RadialGradient(3)))
    got = {k: res[k].data for k in want}
    assert np.array_equal(got["centers"], want["centers"])
    assert _group_error(got, want) <= LIMIT


@pytest.mark.parametrize("sig, radius", [((64, 64), 3.0), ((256, 256), 7.0),
                                         ((48, 40), 4.5)])
def test_reference_template_is_the_ports(sig, radius):
    h, w = sig
    ours = pblob.RadialGradient(radius).get_mask(sig)
    np.testing.assert_allclose(REF.radial_gradient(sig, radius), ours,
                               rtol=0, atol=1e-15)
    assert ours[h // 2, w // 2] == 0 and ours.max() <= 1.0


def test_specimen_renders_the_same_bytes_once():
    a, b = _rendered(11), _rendered(11)
    assert np.array_equal(a.frames, b.frames)
    assert not np.array_equal(a.frames, _rendered(12).frames)
    plain = _inputs(11)
    added = a.frames.astype(np.int64) - plain.frames
    assert added.min() == 0 and added.max() == 1000
    again = a.frames.copy()
    SPECIMEN.render(CONFIG, a)
    assert np.array_equal(a.frames, again)
    # 9 disks a frame, each of about pi 3^2 pixels
    covered = (added > 0).sum(axis=(2, 3))
    assert (covered > 9 * 20).all() and (covered < 9 * 50).all()


def test_specimen_centres_follow_the_strain_field():
    pos = SPECIMEN.centres(CONFIG["specimen"], CONFIG["nav"]).reshape(
        8, 8, 9, 2)
    hk = SPECIMEN.lattice_hk(1)
    zero = hk.tolist().index([0, 0])
    assert (pos[:, :, zero] == 32).all()
    # each centre on a third of a pixel
    assert np.allclose(pos * 3, np.rint(pos * 3))
    # (h, k) = (1, 0): a = (0, 14) stretched 5% down the rows
    i = hk.tolist().index([1, 0])
    assert pos[0, 0, i].tolist() == [32, 46]
    assert abs(pos[-1, 0, i, 1] - (32 + 14 * 1.05)) <= 1 / 6


def test_port_against_the_jax_package():
    inputs = _rendered(3)
    ctx = port.Context(device="cpu")
    ours = ctx.run_udf(ctx.load("memory", data=inputs.frames, sig_dims=2),
                       _sparse(pblob))
    jctx = JaxContext(executor=InlineJobExecutor())
    theirs = jctx.run_udf(jctx.load("memory", data=inputs.frames,
                                    sig_dims=2), _sparse(jblob))
    want = {k: np.asarray(theirs[k].data, dtype=np.float64)
            for k in ("centers", "refineds", "peak_values")}
    got = {k: ours[k].data for k in want}
    assert np.array_equal(got["centers"], want["centers"])
    assert _group_error(got, want) <= LIMIT


@pytest.mark.parametrize("loop", ["inline", "sharded"])
@pytest.mark.parametrize("full", [False, True])
def test_spans_in_the_run_totals(loop, full):
    inputs = _rendered()
    ctx = _context(loop)
    udf = (pblob.FullFrameCorrelationUDF(pblob.RadialGradient(3)) if full
           else _sparse(pblob))
    ds = ctx.load("memory", data=inputs.frames, sig_dims=2)
    ctx.run_udf(ds, udf)
    spans = ctx.feed_stats["spans"]
    blocks = spans["libertem.step"][0]
    assert blocks >= (4 if loop == "sharded" else 1)
    for name in SPANS:
        count, seconds = spans[name]
        assert count == blocks and seconds > 0, name
    assert (spans["libertem.correlate"][1] + spans["libertem.refine"][1]
            <= spans["libertem.udf_process"][1])
    assert spans["libertem.udf_process"][1] <= spans["libertem.step"][1]


def test_fused_path_gains_no_span():
    ctx = port.Context(device="cpu")
    data = np.random.default_rng(0).poisson(4, (4, 4, 16, 16)).astype(
        np.uint16)
    ctx.run_udf(ctx.load("memory", data=data, sig_dims=2), port.SumUDF())
    assert ctx.run_info["fused"]
    assert not set(SPANS) & set(ctx.feed_stats["spans"])


def test_spans_reach_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    inputs = _rendered()
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=inputs.frames, sig_dims=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx.run_udf(ds, _sparse(pblob))
    names = {e.name for e in prof.events()}
    assert set(SPANS) <= names


def test_udf_span_adds_into_the_calling_runs_totals():
    # outside a run's call of a UDF: no totals, the shared no-op
    assert tracing.udf_span("libertem.correlate") is tracing.NOOP
    outer, inner = tracing.RunTrace(), tracing.RunTrace()
    with outer.udf_process():
        with tracing.udf_span("libertem.correlate"):
            pass
        with inner.udf_process():
            with tracing.udf_span("libertem.refine"):
                pass
        # the inner call's end hands the outer run its totals back
        with tracing.udf_span("libertem.refine"):
            pass
    assert tracing.udf_span("libertem.correlate") is tracing.NOOP
    assert set(outer.spans) == {"libertem.udf_process", "libertem.correlate",
                                "libertem.refine"}
    assert outer.spans["libertem.udf_process"][0] == 1
    assert outer.spans["libertem.refine"][0] == 1
    assert set(inner.spans) == {"libertem.udf_process", "libertem.refine"}
