"""Live plots of the port against the JAX package's, on the CPU
(counterparts of ``tests/test_viz_backends.py`` and the ``plots=``
checks of ``tests/test_api_parity.py``'s test_context_kwarg_sweep).

The same seeded numpy data goes through ``libertem_tpu_torch`` with
``device="cpu"`` and ``libertem_tpu`` with ``InlineJobExecutor()``:
channel names, titles, error messages and damage are equal; plotted
data within 1e-5 relative.  bqplot and Gatan's ``DigitalMicrograph``
are absent, so their plots run over fake modules.
"""
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor as JaxInline
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet
from libertem_tpu.viz import base as jbase

import libertem_tpu_torch as port
import libertem_tpu_torch.udf.base as port_udf_base
from libertem_tpu_torch.viz import base as pbase

torch.set_num_threads(1)

RTOL = 1e-5
NAV, SIG = (4, 5), (8, 8)


def _data(seed=9):
    return np.random.default_rng(seed).poisson(5.0, NAV + SIG).astype(
        np.float32)


def _both(parts=2):
    data = _data()
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=parts)
    jctx = JaxContext(executor=JaxInline())
    jds = JaxMemoryDataSet(data=data, sig_dims=2,
                           num_partitions=parts).initialize()
    return ctx, ds, jctx, jds, data


def _close(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.nanmax(np.abs(b), initial=0.0)), 1.0)
    assert np.allclose(a, b, rtol=RTOL, atol=RTOL * scale, equal_nan=True)


def _readers_end(timeout=1.0) -> bool:
    def alive():
        return [t for t in threading.enumerate()
                if t.name.startswith("block-reader") and t.is_alive()]
    t0 = time.perf_counter()
    while alive() and time.perf_counter() - t0 < timeout:
        time.sleep(0.01)
    return not alive()


def _single_only(lib):
    class SingleOnly(lib.udf.base.UDF):
        def get_result_buffers(self):
            return {"n": self.buffer(kind="single", dtype="float32")}

        def process_frame(self, frame):
            self.results.n += 1

        def merge(self, dest, src):
            dest.n += src.n

    return SingleOnly()


# -- channels ----------------------------------------------------------------


def test_default_and_named_channels_like_jax():
    _, ds, _, jds, _ = _both()
    for udf, judf, title in (
            (port.SumSigUDF(), libertem_tpu.udf.SumSigUDF(),
             "SumSigUDF: intensity"),
            (port.StdDevUDF(), libertem_tpu.udf.StdDevUDF(),
             "StdDevUDF: sum")):
        p = pbase.Dummy2DPlot(ds, udf)
        jp = jbase.Dummy2DPlot(jds, judf)
        assert p.channel == jp.channel and p.title == jp.title == title
        assert p.get_udf() is udf
        _close(p.data, jp.data)
    p = pbase.Dummy2DPlot(ds, port.StdDevUDF(), channel="std",
                          title="mine")
    jp = jbase.Dummy2DPlot(jds, libertem_tpu.udf.StdDevUDF(),
                           channel="std", title="mine")
    assert p.channel == jp.channel == "std" and p.title == "mine"


def test_get_plottable_channels_like_jax():
    ctx, ds, jctx, jds, _ = _both()
    dry = port_udf_base.UDFRunner([port.CoMUDF.with_params(
        cy=4, cx=4, r=3)]).dry_run(ds)
    from libertem_tpu.udf.base import UDFRunner as JRunner
    jdry = JRunner([libertem_tpu.udf.CoMUDF.with_params(
        cy=4, cx=4, r=3)]).dry_run(jds)
    assert pbase.get_plottable_2D_channels(dry.buffers[0]) == \
        jbase.get_plottable_2D_channels(jdry.buffers[0])


@pytest.mark.parametrize("case", ["none", "missing", "not_plottable",
                                  "tuple_missing"])
def test_channel_errors_like_jax(case):
    _, ds, _, jds, _ = _both()
    messages = []
    for mod, d, lib in ((pbase, ds, port), (jbase, jds, libertem_tpu)):
        if case == "none":
            udf, kw = _single_only(lib), {}
        elif case == "missing":
            udf, kw = lib.udf.SumUDF(), {"channel": "nope"}
        elif case == "not_plottable":
            udf, kw = _single_only(lib), {"channel": "n"}
        else:
            udf, kw = lib.udf.SumUDF(), {"channel": ("nope", np.abs)}
        with pytest.raises(ValueError) as e:
            mod.Dummy2DPlot(d, udf, **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_tuple_and_callable_channels_like_jax():
    ctx, ds, jctx, jds, data = _both()
    got = []
    for mod, c, d, lib in ((pbase, ctx, ds, port),
                           (jbase, jctx, jds, libertem_tpu)):
        com = lib.udf.CoMUDF.with_params(cy=4, cx=4, r=3)

        def magnitude(f):
            return np.hypot(f[..., 0], f[..., 1])

        field = mod.Dummy2DPlot(d, com, channel=("field", magnitude),
                                min_delta=0)
        sums = lib.udf.SumSigUDF()

        def double(udf_results, damage):
            return udf_results["intensity"].data * 2, damage

        fn = mod.Dummy2DPlot(d, sums, channel=double)
        sig = mod.Dummy2DPlot(d, lib.udf.SumUDF(),
                              channel=("intensity", np.sqrt))
        c.run_udf(d, [com, sums, sig.udf], plots=[field, fn, sig])
        got.append((field, fn, sig))
    for p, jp in zip(*got):
        assert p.title == jp.title
        _close(p.data, jp.data)
        assert np.array_equal(np.asarray(p.damage), np.asarray(jp.damage))
    assert got[0][0].title == "CoMUDF: magnitude(field)"
    assert got[0][1].title == "SumSigUDF: double"
    _close(got[0][1].data, data.sum(axis=(2, 3)) * 2)
    _close(got[0][2].data, np.sqrt(data.sum(axis=(0, 1))))


def test_new_data_min_delta_and_damage_like_jax():
    """``new_data``: throttled by ``min_delta`` unless forced; the
    damage intersected with where the data is finite."""
    _, ds, _, jds, _ = _both()
    out = []
    for mod, d, lib in ((pbase, ds, port), (jbase, jds, libertem_tpu)):
        calls = []

        class Rec(mod.Dummy2DPlot):
            def update(self, damage, force=False):
                calls.append((np.array(damage), force))

        p = Rec(d, lib.udf.SumSigUDF(), min_delta=3600)
        from libertem_tpu_torch.common.buffers import BufferWrapper
        buf = BufferWrapper("nav", (), "float32")
        buf.set_shape_ds(port.Shape(NAV + SIG, sig_dims=2), None)
        vals = np.arange(20, dtype=np.float32)
        vals[3] = np.nan
        damage = np.zeros(20, bool)
        damage[:10] = True
        buf.set_result(vals, valid_nav_mask=damage)

        class Res(dict):
            pass

        p.new_data(Res(intensity=buf), damage.reshape(NAV))
        first = len(calls)
        p.new_data(Res(intensity=buf), damage.reshape(NAV))
        p.new_data(Res(intensity=buf), damage.reshape(NAV), force=True)
        out.append((first, len(calls), calls[-1][0], calls[-1][1]))
    (f, n, dmg, force), (jf, jn, jdmg, jforce) = out
    assert (f, n, force) == (jf, jn, jforce) == (1, 2, True)
    want = np.zeros(20, bool)
    want[:10] = True
    want[3] = False
    assert np.array_equal(dmg.reshape(-1), want)
    assert np.array_equal(jdmg, dmg)


# -- plots in runs ----------------------------------------------------------


def test_run_udf_plots_like_jax():
    """A plot given as an object ends with the result's data; the
    same in ``run_udf_iter``, where every partial's damage grows."""
    ctx, ds, jctx, jds, data = _both(parts=4)
    for c, d, lib, mod in ((ctx, ds, port, pbase),
                           (jctx, jds, libertem_tpu, jbase)):
        udf = lib.udf.SumSigUDF()
        p = mod.Dummy2DPlot(d, udf, min_delta=0)
        res = c.run_udf(d, udf, plots=[p])
        _close(p.data, res["intensity"].data)
        assert np.asarray(p.damage).all()
        damages = []

        class Rec(mod.Dummy2DPlot):
            def update(self, damage, force=False):
                damages.append(int(np.asarray(damage).sum()))

        p2 = Rec(d, udf, min_delta=0)
        parts = list(c.run_udf_iter(d, udf, plots=[p2]))
        assert len(parts) == 4
        assert damages == [5, 10, 15, 20, 20]
        _close(p2.data, data.sum(axis=(2, 3)))


def test_plots_true_and_channel_lists_like_jax(monkeypatch):
    """``plots=True``: one plot per 2-D channel of each UDF from one
    dry run; channel lists name them; both as the JAX package."""
    ctx, ds, jctx, jds, _ = _both()
    ctx.plot_class = pbase.Dummy2DPlot
    jctx.plot_class = jbase.Dummy2DPlot
    dry_runs = []
    orig = port_udf_base.UDFRunner.dry_run

    def counted(self, *a, **kw):
        dry_runs.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(port_udf_base.UDFRunner, "dry_run", counted)
    titles = []
    for c, d, lib in ((ctx, ds, port), (jctx, jds, libertem_tpu)):
        udfs = [lib.udf.SumUDF(), lib.udf.StdDevUDF(), _single_only(lib)]
        with pytest.warns(UserWarning, match="No plottable channels"):
            plots = c._prepare_plots(True, d, udfs, None)
        titles.append([p.title for p in plots])
        plots = c._prepare_plots([["intensity"], [("std", np.sqrt)], []],
                                 d, udfs, None)
        titles.append([p.title for p in plots])
        with pytest.raises(ValueError, match="channel nope not found"):
            c._prepare_plots([["nope"], [], []], d, udfs, None)
        c.run_udf(d, udfs[:2], plots=True)
    assert titles[0] == titles[2] and titles[1] == titles[3]
    assert titles[1] == ["SumUDF: intensity", "StdDevUDF: sqrt(std)"]
    # three calls of _prepare_plots and one run: one dry run each
    assert len(dry_runs) == 4
    assert ctx._prepare_plots(None, ds, [], None) is None


def test_plot_class_default_is_matplotlib():
    from libertem_tpu_torch.viz.mpl import MPLLive2DPlot
    ctx = port.Context(device="cpu")
    assert ctx.plot_class is MPLLive2DPlot
    ctx.plot_class = pbase.Dummy2DPlot
    assert ctx.plot_class is pbase.Dummy2DPlot
    assert port.Context(device="cpu",
                        plot_class=pbase.Dummy2DPlot)._plot_class is \
        pbase.Dummy2DPlot


@pytest.mark.parametrize("how", ["run_udf", "run_udf_iter"])
def test_failing_plot_stops_the_reader(how):
    """A plot whose ``update`` raises ends the run: the error reaches
    the caller and no block reader is alive within 1 s (eight
    partitions: the reader still has blocks to read when the plot
    fails)."""
    ctx, ds, _, _, _ = _both(parts=8)
    ended = []
    ctx.executor.subscribe("run_udf:end", lambda t, m: ended.append(t))

    class Boom(pbase.Dummy2DPlot):
        def update(self, damage, force=False):
            raise KeyError("plot failed")

    udf = port.SumSigUDF()
    p = Boom(ds, udf)
    with pytest.raises(KeyError, match="plot failed"):
        if how == "run_udf":
            ctx.run_udf(ds, udf, plots=[p])
        else:
            for _ in ctx.run_udf_iter(ds, udf, plots=[p]):
                pass
    assert _readers_end(1.0)
    assert ended == ["run_udf:end"]


# -- matplotlib, GMS, bqplot ---------------------------------------------


def test_mpl_plot_like_jax():
    import matplotlib
    matplotlib.use("Agg")
    from libertem_tpu.viz.mpl import MPLLive2DPlot as JMPL

    from libertem_tpu_torch.viz.mpl import MPLLive2DPlot
    ctx, ds, jctx, jds, data = _both()
    images = []
    for cls, c, d, lib in ((MPLLive2DPlot, ctx, ds, port),
                           (JMPL, jctx, jds, libertem_tpu)):
        p = cls(d, lib.udf.SumSigUDF(), min_delta=0, cmap="gray")
        with pytest.warns(UserWarning, match="not displayed"):
            p.update(np.ones(NAV, bool))
        fig = p.display()
        assert fig is p.fig and p.axes.get_title() == p.title
        c.run_udf(d, p.udf, plots=[p])
        images.append((np.array(p.im_obj.get_array()), p.im_obj.get_clim()))
        import matplotlib.pyplot as plt
        plt.close(fig)
    (a, clim), (b, jclim) = images
    _close(a, b)
    _close(a, data.sum(axis=(2, 3)))
    assert np.allclose(clim, jclim, rtol=RTOL)


@pytest.fixture
def fake_bqplot(monkeypatch):
    class Obj:
        def __init__(self, *a, **kw):
            self.__dict__.update(kw)
            self.args = a

    bq = types.ModuleType("bqplot")
    bq.LinearScale = bq.Axis = bq.Figure = Obj
    bq.ColorScale = type("ColorScale", (Obj,), {})
    gl = types.ModuleType("bqplot_image_gl")
    gl.ImageGL = type("ImageGL", (Obj,), {})
    monkeypatch.setitem(sys.modules, "bqplot", bq)
    monkeypatch.setitem(sys.modules, "bqplot_image_gl", gl)


@pytest.fixture
def fake_gms(monkeypatch):
    dm = types.ModuleType("DigitalMicrograph")

    class FakeImage:
        def __init__(self, arr):
            self._arr = np.array(arr)
            self.name = None
            self.shown = self.updated = 0

        def SetName(self, name):  # noqa: N802
            self.name = name

        def ShowImage(self):  # noqa: N802
            self.shown += 1

        def GetNumArray(self):  # noqa: N802
            return self._arr

        def UpdateImage(self):  # noqa: N802
            self.updated += 1

    dm.CreateImage = FakeImage
    monkeypatch.setitem(sys.modules, "DigitalMicrograph", dm)


def test_bq_live_plot_like_jax(fake_bqplot):
    from libertem_tpu.viz.bqp import BQLive2DPlot as JBQ

    from libertem_tpu_torch.viz.bqp import BQLive2DPlot
    ctx, ds, jctx, jds, data = _both()
    got = []
    for cls, c, d, lib in ((BQLive2DPlot, ctx, ds, port),
                           (JBQ, jctx, jds, libertem_tpu)):
        plot = cls(dataset=d, udf=lib.udf.SumSigUDF(), min_delta=0.0)
        assert plot.display() is plot.figure
        assert plot.figure.marks == (plot.image,)
        c.run_udf(d, plot.udf, plots=[plot])
        cs = plot.image.scales["image"]
        got.append((np.asarray(plot.image.image), cs.min, cs.max))
    (a, lo, hi), (b, jlo, jhi) = got
    _close(a, b)
    _close(a, data.sum(axis=(2, 3)))
    assert np.isclose(lo, jlo, rtol=RTOL) and np.isclose(hi, jhi, rtol=RTOL)


def test_gms_live_plot_like_jax(fake_gms):
    from libertem_tpu.viz.gms import GMSLive2DPlot as JGMS

    from libertem_tpu_torch.viz.gms import GMSLive2DPlot
    _, ds, _, jds, _ = _both()
    for cls, d, lib in ((GMSLive2DPlot, ds, port),
                        (JGMS, jds, libertem_tpu)):
        plot = cls(dataset=d, udf=lib.udf.SumSigUDF())
        plot.display()
        assert plot.image.name == "SumSigUDF: intensity"
        assert plot.image.shown == 1
        plot.data = np.full(NAV, 7.5)
        plot.update(np.ones(NAV, dtype=bool), force=True)
        assert plot.image.updated == 1
        assert np.allclose(plot.image.GetNumArray(), 7.5)


def test_bq_and_gms_need_their_modules():
    from libertem_tpu_torch.viz.bqp import BQLive2DPlot
    from libertem_tpu_torch.viz.gms import GMSLive2DPlot
    _, ds, _, _, _ = _both()
    assert "bqplot" not in sys.modules
    with pytest.raises(ImportError, match="bqplot"):
        BQLive2DPlot(dataset=ds, udf=port.SumSigUDF())
    assert "DigitalMicrograph" not in sys.modules
    with pytest.raises(ImportError, match="Digital"):
        GMSLive2DPlot(dataset=ds, udf=port.SumSigUDF())


# -- images and colour maps --------------------------------------------------


def test_encode_image_like_jax():
    rgba = (np.arange(4 * 6 * 4) % 256).astype(np.uint8).reshape(4, 6, 4)
    a = pbase.encode_image(rgba).getvalue()
    b = jbase.encode_image(rgba).getvalue()
    assert a == b and a[:8] == b"\x89PNG\r\n\x1a\n"


def test_make_colormap_like_jax():
    import libertem_tpu.viz as jviz

    import libertem_tpu_torch.viz as pviz
    cmap, jcmap = pbase.make_colormap(), jbase.make_colormap()
    x = np.linspace(0, 1, 50)
    assert cmap.name == jcmap.name == "libertem_cyclic"
    assert np.array_equal(cmap(x), jcmap(x))
    assert np.array_equal(pviz.libertem_cyclic(x), jviz.libertem_cyclic(x))
    with pytest.raises(AttributeError):
        pviz.nothing_here
