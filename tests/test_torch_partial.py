"""Live partial results, progress, parameter patches and the dry run of
the port against the JAX package's, on the CPU (counterparts of
``tests/test_misc.py``: test_update_parameters_experimental,
test_aux_param_patch_mid_run, test_abandoned_iterator_releases_prefetch,
test_progress_and_snooze, test_progress_reporter_object and
test_inspect_and_display).

The same seeded numpy data goes through
``libertem_tpu_torch.Context(device="cpu").run_udf_iter`` and
``libertem_tpu.api.Context.run_udf_iter``: every partial's damage and
buffers, the patched final result (also against a float64 numpy
oracle) and the progress reports agree.  Passes: the fused path (the
five main-path UDFs), the generic path with a roi, and a numpy UDF on
the host engine beside the fused pass.  Buffers within 1e-5 relative
with an absolute floor of 1e-5 of the largest magnitude (float32 with
other summation orders); the centre of mass's shifts take the centres'
magnitude as that floor; damage exact.
"""
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.common.progress import ProgressReporter as JaxReporter
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet

import libertem_tpu_torch as port
import libertem_tpu_torch.udf.base as port_base
from libertem_tpu_torch.common.progress import ProgressReporter

torch.set_num_threads(1)

RTOL = 1e-5
NAV, SIG = (8, 4), (8, 8)
FROM_COM = ("raw_com", "raw_shifts", "field", "field_y", "field_x",
            "magnitude", "divergence", "curl")


def _data(seed=3):
    return np.random.default_rng(seed).poisson(6.0, NAV + SIG).astype(
        np.uint16)


def _roi():
    roi = np.zeros(NAV, dtype=bool)
    roi[1:7, 1:3] = True
    roi[0, 0] = True
    return roi


def _disk(r):
    y, x = np.mgrid[0:SIG[0], 0:SIG[1]]
    return (((y - 3.5) ** 2 + (x - 4.0) ** 2) <= r * r).astype(np.float32)


M_OLD = np.stack([_disk(2.5), 1 - _disk(2.5)])
M_NEW = np.stack([_disk(1.5), np.ones(SIG, np.float32) * 0.5])


def _numpy_max_udf(lib):
    class FrameMax(lib.udf.base.UDF):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"frame_max": self.buffer(kind="nav", dtype="float32"),
                    "pixel_max": self.buffer(kind="sig", dtype="float32")}

        def process_tile(self, tile):
            self.results.frame_max[:] = tile.max(axis=(1, 2))
            np.maximum(self.results.pixel_max, tile.max(axis=0),
                       out=self.results.pixel_max)

        def merge(self, dest, src):
            dest.frame_max[:] = src.frame_max
            np.maximum(dest.pixel_max, src.pixel_max, out=dest.pixel_max)

    return FrameMax()


def _udfs(lib, which):
    masks = lib.udf.ApplyMasksUDF(mask_factories=lambda: M_OLD,
                                  mask_count=2)
    if which == "fused":
        return [masks, lib.udf.CoMUDF.with_params(cy=3.5, cx=4.0, r=3.0),
                lib.udf.SumUDF(), lib.udf.SumSigUDF(), lib.udf.StdDevUDF()]
    if which == "generic_roi":
        return [masks, lib.udf.LogsumUDF(), lib.udf.SumUDF()]
    return [masks, lib.udf.SumUDF(), lib.udf.StdDevUDF(),
            _numpy_max_udf(lib)]


def _jctx():
    return JaxContext(executor=InlineJobExecutor())


def _datasets(data, num_partitions=4):
    ctx = port.Context(device="cpu")
    return ctx, ctx.load("memory", data=data, sig_dims=2,
                         num_partitions=num_partitions), JaxMemoryDataSet(
        data=data, sig_dims=2, num_partitions=num_partitions)


def _run_iter(ctx, ds, udfs, patch_at=None, patch=None, **kw):
    """Every partial as numpy: (damage, [{name: data}]), patching after
    the partial ``patch_at``."""
    gen = ctx.run_udf_iter(ds, udfs, **kw)
    out = []
    for i, res in enumerate(gen):
        out.append((np.asarray(res.damage.data),
                    [{k: np.asarray(v.data) for k, v in b.items()}
                     for b in res.buffers]))
        if i == patch_at:
            gen.update_parameters_experimental(patch)
    return out


def _close(got, want, name, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if got.dtype == bool:
        assert np.array_equal(got, want), name
        return
    got64, want64 = got.astype(np.float64), want.astype(np.float64)
    if scale is None:
        scale = float(np.nanmax(np.abs(want64), initial=0.0))
    scale = max(scale, 1.0)
    ok = (np.abs(got64 - want64) <= RTOL * np.abs(want64) + RTOL * scale) \
        | (np.isnan(got64) & np.isnan(want64))
    assert ok.all(), (name, float(np.nanmax(np.abs(got64 - want64))))


def _compare_partials(ours, theirs):
    assert len(ours) == len(theirs)
    for (dmg_a, bufs_a), (dmg_b, bufs_b) in zip(ours, theirs):
        assert np.array_equal(dmg_a, dmg_b)
        for ui, (a, b) in enumerate(zip(bufs_a, bufs_b)):
            assert set(a) == set(b)
            centres = (float(np.abs(b["raw_com"]).max())
                       if "raw_com" in b else None)
            for name in b:
                _close(a[name], b[name], f"{ui}/{name}",
                       scale=centres if name in FROM_COM else None)


@pytest.mark.parametrize("which", ["fused", "generic_roi", "host"])
def test_update_parameters_experimental(which):
    """Swap ApplyMasks' stack after the second partial: the partitions
    merged before the patch keep the old masks, the later ones use the
    new masks, in both packages and in the numpy oracle."""
    data = _data()
    roi = _roi() if which == "generic_roi" else None
    ctx, ds, jds = _datasets(data)
    patch = [{"mask_factories": lambda: M_NEW}] + [{}] * (
        len(_udfs(port, which)) - 1)
    ours = _run_iter(ctx, ds, _udfs(port, which), 1, patch, roi=roi)
    assert ctx.run_info["fused"] is (which != "generic_roi")
    assert ctx.run_info["engines"][-1] == (
        "host" if which == "host" else "device")
    theirs = _run_iter(_jctx(), jds, _udfs(libertem_tpu, which), 1, patch,
                       roi=roi)
    assert len(ours) == 4
    _compare_partials(ours, theirs)
    # the damage grows by one partition (8 frames, roi-selected) a step
    sel = np.ones(NAV, bool) if roi is None else roi
    flat = data.reshape(-1, SIG[0] * SIG[1]).astype(np.float64)
    for k, (dmg, bufs) in enumerate(ours):
        merged = np.zeros(NAV, bool).reshape(-1)
        merged[:8 * (k + 1)] = True
        assert np.array_equal(dmg.reshape(-1), merged & sel.reshape(-1))
    intensity = ours[-1][1][0]["intensity"].reshape(-1, 2)
    sel = sel.reshape(-1)
    want = np.where(np.arange(flat.shape[0])[:, None] < 16,
                    flat @ M_OLD.reshape(2, -1).T,
                    flat @ M_NEW.reshape(2, -1).T)
    _close(intensity[sel], want[sel], "intensity")
    assert np.isnan(intensity[~sel]).all()


def test_aux_param_patch_mid_run():
    """Patching an aux argument after the first partial rebuilds the
    aux rows: later partitions read the new weights."""
    def weighted(lib):
        class WeightedSumSigUDF(lib.udf.base.UDF):
            def get_result_buffers(self):
                return {"ws": self.buffer(kind="nav", dtype="float32")}

            def process_tile(self, tile):
                flat = tile.reshape(tile.shape[0], -1)
                self.results.ws += flat.sum(1) * self.params.weights

        return WeightedSumSigUDF(weights=lib.udf.base.UDF.aux_data(
            np.arange(32, dtype=np.float32), kind="nav", dtype="float32"))

    w2 = 3 * np.arange(32, dtype=np.float32) + 1
    data = _data(seed=4).astype(np.float32)
    ctx, ds, jds = _datasets(data)
    ours = _run_iter(ctx, ds, [weighted(port)], 0, [{
        "weights": port.udf.UDF.aux_data(w2, kind="nav", dtype="float32")}])
    theirs = _run_iter(_jctx(), jds, [weighted(libertem_tpu)], 0, [{
        "weights": libertem_tpu.udf.base.UDF.aux_data(
            w2, kind="nav", dtype="float32")}])
    _compare_partials(ours, theirs)
    sums = data.reshape(32, -1).sum(axis=1)
    want = np.where(np.arange(32) < 8, sums * np.arange(32), sums * w2)
    _close(ours[-1][1][0]["ws"].reshape(-1), want, "ws")


def test_abandoned_iterator_releases_prefetch(monkeypatch):
    """Closing a partial-results iterator, or dropping it, stops the
    host feed's reader thread, releases the feed (its pinned slots)
    and runs every UDF's cleanup, in both packages."""
    feeds = []

    class Recorded(port_base.HostFeed):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            feeds.append(weakref.ref(self))

    monkeypatch.setattr(port_base, "HostFeed", Recorded)

    def counting(lib, cleaned):
        class Counted(lib.udf.SumUDF):
            def cleanup(self):
                cleaned.append(1)

        return Counted()

    data = _data(seed=5)
    for close in (True, False):
        ctx, ds, jds = _datasets(data)
        before = set(threading.enumerate())
        cleaned, jcleaned = [], []
        gen = ctx.run_udf_iter(ds, counting(port, cleaned))
        first = next(gen)
        jgen = _jctx().run_udf_iter(jds, counting(libertem_tpu, jcleaned))
        jfirst = next(iter(jgen))
        _close(first.buffers[0]["intensity"].data,
               jfirst.buffers[0]["intensity"].data, "intensity")
        assert np.array_equal(first.damage.data, jfirst.damage.data)
        if close:
            gen.close()
            jgen.close()
        del gen, jgen
        gc.collect()
        deadline = time.time() + 5.0
        while time.time() < deadline:
            alive = [t for t in set(threading.enumerate()) - before
                     if t.name == "HostFeed-reader"]
            if not alive:
                break
            time.sleep(0.05)
        assert not alive, alive
        assert all(ref() is None for ref in feeds)
        assert cleaned and jcleaned


class _Recorder:
    def __init__(self):
        self.events = []

    def start(self, state):
        self.events.append(("start", state.num_frames_total,
                            state.num_part_total))

    def update(self, state):
        self.events.append(("update", state.num_frames_complete,
                            state.num_part_complete))

    def end(self, state):
        self.events.append(("end", state.num_frames_complete,
                            state.num_part_complete))

    def at_partition_ends(self):
        """The first report after each partition completed."""
        seen, out = set(), []
        for kind, frames, parts in self.events:
            if kind == "update" and parts and parts not in seen:
                seen.add(parts)
                out.append((frames, parts))
        return out


class Rec(_Recorder, ProgressReporter):
    pass


class JaxRec(_Recorder, JaxReporter):
    pass


@pytest.mark.parametrize("which", ["fused", "generic_roi", "host"])
def test_progress_reporter_object(which):
    data = _data(seed=6)
    roi = _roi() if which == "generic_roi" else None
    ctx, ds, jds = _datasets(data)
    ours, theirs = Rec(), JaxRec()
    res = ctx.run_udf(ds, _udfs(port, which), roi=roi, progress=ours)
    _jctx().run_udf(jds, _udfs(libertem_tpu, which), roi=roi,
                    progress=theirs)
    n = 32 if roi is None else int(roi.sum())
    assert ours.events[0] == theirs.events[0] == ("start", n, 4)
    assert ours.events[-1] == theirs.events[-1] == ("end", n, 4)
    assert ours.at_partition_ends() == theirs.at_partition_ends()
    assert res[0]["intensity"].data.shape == NAV + (2,)
    # the live iterator reports the same
    it = Rec()
    list(ctx.run_udf_iter(ds, _udfs(port, which), roi=roi, progress=it))
    assert it.events[-1] == ("end", n, 4)
    assert it.at_partition_ends() == ours.at_partition_ends()


def test_progress_and_snooze(capsys):
    """progress=True: a tqdm bar on both sides, same results."""
    data = _data(seed=7)
    ctx, ds, jds = _datasets(data, num_partitions=2)
    res = ctx.run_udf(ds, port.SumUDF(), progress=True)
    jres = _jctx().run_udf(jds, libertem_tpu.udf.SumUDF(), progress=True)
    assert np.array_equal(res["intensity"].data, jres["intensity"].data)
    assert "frame" in capsys.readouterr().err


def test_abandoned_progress_is_not_complete():
    data = _data(seed=8)
    ctx, ds, _ = _datasets(data)
    rec = Rec()
    gen = ctx.run_udf_iter(ds, port.SumUDF(), progress=rec)
    next(gen)
    gen.close()
    assert rec.events[-1] == ("end", 8, 1)


def _declarations(results):
    return {name: (buf.kind, np.dtype(buf.dtype), tuple(buf.extra_shape),
                   np.asarray(buf.data).shape)
            for name, buf in results.items()}


@pytest.mark.parametrize("which", ["fused", "generic_roi", "host"])
def test_inspect_and_display(which):
    data = _data(seed=9)
    ctx, ds, jds = _datasets(data)
    roi = _roi() if which == "generic_roi" else None
    for ours_udf, theirs_udf in zip(_udfs(port, which),
                                    _udfs(libertem_tpu, which)):
        ours = ctx.inspect_udf(ours_udf, ds, roi=roi)
        theirs = _jctx().inspect_udf(theirs_udf, jds, roi=roi)
        assert _declarations(ours) == _declarations(theirs)
        assert not np.asarray(ours.damage.data).any()
    res = ctx.inspect_udf(port.SumUDF(), ds)
    assert "intensity" in res
    assert res["intensity"].kind == "sig"
    disp = ctx.display(ds, port.SumSigUDF())
    text = str(disp)
    assert "intensity" in text and "nav" in text
    assert "intensity" in disp._repr_html_()


def test_patch_count_and_unported_options_raise():
    data = _data(seed=10)
    ctx, ds, jds = _datasets(data)
    gen = ctx.run_udf_iter(ds, [port.SumUDF(), port.SumSigUDF()])
    jgen = _jctx().run_udf_iter(jds, [libertem_tpu.udf.SumUDF(),
                                      libertem_tpu.udf.SumSigUDF()])
    for g in (gen, jgen):
        with pytest.raises(ValueError, match="one entry per UDF"):
            g.update_parameters_experimental([{}])
        g.close()
    for kw in ({"plots": True}, {"sync": False}):
        with pytest.raises(NotImplementedError, match="not ported"):
            ctx.run_udf(ds, port.SumUDF(), **kw)
        with pytest.raises(NotImplementedError, match="not ported"):
            ctx.run_udf_iter(ds, port.SumUDF(), **kw)
