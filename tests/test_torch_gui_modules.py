"""The small modules around the port's web GUI against the JAX
package's, on the CPU (counterparts of ``tests/test_client_geometry.py``
and of the web modules' helpers): the client geometry and the port's
own ``index.html`` drift guard, the file browser's listings and
``FSError.alternative``, the dataset converters and their schemas,
``coordinates``, ``preload``, ``versioning``, the engine's channel
encoding, the executor helpers, the event bus, the CLUST controller's
result set and ``daskadapter._read_partition``.

The same calls go through both packages with inputs made from numpy
seeds.  Tolerances: geometry, listings, converters, schemas, messages
and coordinates equal (the same float64 arithmetic); analysis results
and partition reads within rtol 1e-5 of the JAX package's, with an
absolute floor of 1e-5 of the largest magnitude (float32 device sums
in other orders); the CLUST labels equal.
"""
import asyncio
import logging
import os
import pickle
import queue
import re

import numpy as np
import pytest
import torch

import libertem_tpu.analysis  # noqa: F401
from libertem_tpu import masks as jax_masks
from libertem_tpu.analysis.base import Analysis as JaxAnalysis
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.common import coordinates as jax_coords
from libertem_tpu.common import messageconverter as jax_mc
from libertem_tpu.contrib import daskadapter as jax_dask
from libertem_tpu.executor.inline import InlineJobExecutor as JaxInline
from libertem_tpu.io import fs as jax_fs
from libertem_tpu.io.dataset import converters as jax_conv
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemory
from libertem_tpu import preload as jax_preload
from libertem_tpu.web import client_geometry as jax_geom
from libertem_tpu.web import engine as jax_engine
from libertem_tpu.web import event_bus as jax_bus
from libertem_tpu.web import helpers as jax_helpers

import libertem_tpu_torch as port
import libertem_tpu_torch.io.dataset as port_datasets
from libertem_tpu_torch.analysis.base import Analysis as PortAnalysis
from libertem_tpu_torch.common import coordinates as port_coords
from libertem_tpu_torch.common import messageconverter as port_mc
from libertem_tpu_torch.common.analysis import AnalysisResult
from libertem_tpu_torch.contrib import daskadapter as port_dask
from libertem_tpu_torch.io import fs as port_fs
from libertem_tpu_torch.io.dataset import converters as port_conv
from libertem_tpu_torch import preload as port_preload
from libertem_tpu_torch import versioning as port_versioning
from libertem_tpu_torch.web import client_geometry as port_geom
from libertem_tpu_torch.web import engine as port_engine
from libertem_tpu_torch.web import event_bus as port_bus
from libertem_tpu_torch.web import helpers as port_helpers

torch.set_num_threads(1)

RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.nanmax(np.abs(want), initial=0.0))
    assert np.allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                       equal_nan=True), float(np.nanmax(np.abs(got - want)))


def _mk_random(shape, seed):
    return np.random.default_rng(seed).normal(1.0, 3.0, shape).astype(
        np.float32)


# -- client geometry and the port's page -------------------------------------


def _client_src():
    path = os.path.join(REPO, "libertem_tpu_torch", "web", "client",
                        "index.html")
    with open(path) as f:
        return f.read()


def _js_formulas():
    m = re.search(r"const GEOM_FORMULAS = \{(.*?)\n\};", _client_src(),
                  re.DOTALL)
    assert m, "client GEOM_FORMULAS table not found"
    return dict(re.findall(r'^\s*([a-z_0-9]+):\s*"([^"]*)",?\s*$',
                           m.group(1), re.MULTILINE))


def _tokens(expr):
    return re.findall(r"[A-Za-z_][A-Za-z_0-9]*|\d+\.\d+|\d+|\S", expr)


def test_formula_tables_identical():
    """The port's page and its Python twin hold one table, the JAX
    package's."""
    js = _js_formulas()
    assert set(js) == set(port_geom.FORMULAS), set(js) ^ set(
        port_geom.FORMULAS)
    for name, expr in port_geom.FORMULAS.items():
        assert _tokens(js[name]) == _tokens(expr), name
    assert port_geom.FORMULAS == jax_geom.FORMULAS


def test_client_uses_the_table():
    src = _client_src()
    overlay = src[src.index("GEOM_FORMULAS"):]
    raw_math = re.findall(r"Math\.(hypot|round|SQRT1_2)", overlay)
    assert raw_math.count("hypot") == 1, raw_math
    assert raw_math.count("SQRT1_2") == 0, raw_math
    for name in port_geom.FORMULAS:
        assert re.search(rf'geomEval\("{name}"', overlay), name


def test_client_page_names_the_port():
    src = _client_src()
    assert "<title>libertem_tpu_torch</title>" in src
    assert "<h1>libertem_tpu_torch</h1>" in src
    assert "Stop the libertem_tpu_torch server?" in src
    assert "in libertem_tpu_torch/web/client_geometry.py" in src
    assert "tests/test_torch_gui_modules.py" in src


@pytest.mark.parametrize("seed", range(4))
def test_synthetic_drags_like_jax(seed):
    """The same random mouse tracks through both twins."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        x0, y0, x1, y1 = (float(v) for v in rng.uniform(-5, 40, 4))
        rect = tuple(float(v) for v in rng.uniform(1, 300, 4))
        params = {"cx": x0, "cy": y0, "r": abs(x1), "ri": 1.0, "ro": 9.5}
        roi = {"shape": "rect", "x": x0, "y": y0, "width": 3.0,
               "height": 4.0}
        calls = [
            lambda g: g.event_to_data(x0, y0, rect, 128, 96),
            lambda g: g.drag_center(params, x1, y1),
            lambda g: g.drag_radius(params, "ro", x1, y1),
            lambda g: g.draw_rect_roi(x0, y0, x1, y1),
            lambda g: g.resize_rect_roi(roi, x1, y1),
            lambda g: g.draw_disk_roi(x0, y0, x1, y1),
            lambda g: g.pick_nav(x1, y1),
            lambda g: g.radius_handle_pos(x0, y0, abs(x1)),
        ]
        for call in calls:
            assert call(port_geom) == call(jax_geom)


def test_drag_math_values():
    g = port_geom
    assert g.event_to_data(74, 148, (10, 20, 256, 256), 128, 128) == (
        32.0, 64.0)
    params = {"cx": 8.0, "cy": 8.0, "r": 2.0}
    assert g.drag_radius(params, "r", 11.0, 12.0)["r"] == 5.0
    hx, hy = g.radius_handle_pos(8.0, 6.0, 5.0)
    assert g.drag_radius({"cx": 8.0, "cy": 6.0, "r": 5.0}, "r", hx,
                         hy)["r"] == pytest.approx(5.0, abs=0.06)
    expected = {"shape": "rect", "x": 2.0, "y": 3.0, "width": 3.0,
                "height": 4.0}
    for corners in ((2, 3, 5, 7), (5, 7, 2, 3), (5, 3, 2, 7),
                    (2, 7, 5, 3)):
        assert g.draw_rect_roi(*corners) == expected
    out = g.resize_rect_roi(expected, 0.0, 0.0)
    assert out["width"] == 1.0 and out["height"] == 1.0
    assert g.pick_nav(2.5, 2.5) == {"x": 3.0, "y": 3.0}


def test_dragged_params_run_analysis_like_jax():
    """A dragged disk detector and a drawn nav roi, run as analyses on
    both packages."""
    data = np.random.default_rng(1).poisson(6.0, (6, 6, 16, 16)).astype(
        np.float32)
    params = port_geom.drag_radius({"cx": 8.0, "cy": 8.0, "r": 4.0}, "r",
                                   11.0, 12.0)
    params["roi"] = port_geom.draw_disk_roi(2.0, 2.0, 4.4, 2.0)
    assert params["r"] == 5.0 and params["roi"]["r"] == 2.4
    jctx = JaxContext(executor=JaxInline())
    jds = JaxMemory(data=data, sig_dims=2, num_partitions=1).initialize()
    jres = jctx.run(JaxAnalysis.get_analysis_by_type("APPLY_DISK_MASK")(
        dataset=jds, parameters=params))
    pctx = port.Context(device="cpu")
    pds = pctx.load("memory", data=data, sig_dims=2, num_partitions=1)
    pres = pctx.run(PortAnalysis.get_analysis_by_type("APPLY_DISK_MASK")(
        dataset=pds, parameters=params))
    close(pres.intensity.raw_data, jres.intensity.raw_data)
    mask = port.masks.circular(8.0, 8.0, 16, 16, 5.0, antialiased=True)
    assert np.array_equal(mask, jax_masks.circular(8.0, 8.0, 16, 16, 5.0,
                                                   antialiased=True))
    yy, xx = np.mgrid[0:6, 0:6]
    inside = (yy - 2.0) ** 2 + (xx - 2.0) ** 2 <= 2.4 ** 2
    want = np.where(inside, (data * mask).sum(axis=(2, 3)), np.nan)
    close(pres.intensity.raw_data, want)


# -- the file browser ---------------------------------------------------------


@pytest.fixture
def tree(tmp_path):
    rng = np.random.default_rng(7)
    (tmp_path / "sub" / "deeper").mkdir(parents=True)
    (tmp_path / "empty").mkdir()
    for i in range(4):
        (tmp_path / f"file{i}.bin").write_bytes(
            rng.bytes(int(rng.integers(0, 9000))))
    (tmp_path / "sub" / "inner.raw").write_bytes(rng.bytes(100))
    os.symlink(tmp_path / "gone", tmp_path / "broken-link")
    return tmp_path


def _listing(fs, path):
    out = fs.get_fs_listing(str(path))
    rows = {}
    for kind in ("dirs", "files"):
        rows[kind] = [(e["name"], e["stat"].st_size, e["owner"])
                      for e in out[kind]]
    return out["path"], rows, out["drives"], out["places"]


def test_fs_listing_like_jax(tree):
    for path in (tree, tree / "sub", tree / "empty", tree / "sub" / ".."):
        want = _listing(jax_fs, path)
        assert _listing(port_fs, path) == want
    path, rows, drives, places = _listing(port_fs, tree)
    assert [r[0] for r in rows["dirs"]] == ["..", "empty", "sub"]
    # the broken link is skipped
    assert [r[0] for r in rows["files"]] == [f"file{i}.bin"
                                             for i in range(4)]
    assert "/" in drives and places[0]["key"] == "home"


@pytest.mark.parametrize("rel, code", [
    ("nope", "NOT_FOUND"),
    ("nope/deeper/still", "NOT_FOUND"),
    ("file0.bin", "NOT_FOUND"),
    ("sub/inner.raw/x", "NOT_FOUND"),
])
def test_fs_error_alternative_like_jax(tree, rel, code):
    errs = []
    for fs in (jax_fs, port_fs):
        with pytest.raises(fs.FSError) as e:
            fs.get_fs_listing(str(tree / rel))
        errs.append(e.value)
    j, p = errs
    assert (p.code, p.alternative, str(p.args[0])) == (
        j.code, j.alternative, str(j.args[0]))
    assert p.code == code
    # the nearest accessible ancestor
    assert p.alternative in (str(tree), str(tree / "sub"))
    back = pickle.loads(pickle.dumps(p))
    assert (back.code, back.alternative) == (p.code, p.alternative)


def test_fs_stat_path_like_jax(tree):
    for rel in ("file1.bin", "sub", "."):
        assert port_fs.stat_path(str(tree / rel)) == jax_fs.stat_path(
            str(tree / rel))
    with pytest.raises(port_fs.FSError) as e:
        port_fs.stat_path(str(tree / "missing" / "x"))
    assert e.value.code == "NOT_FOUND"
    assert e.value.alternative == str(tree)
    st = os.stat(tree / "file2.bin")
    from libertem_tpu.io.utils import get_owner_name as jax_owner
    from libertem_tpu_torch.io.utils import get_owner_name
    assert get_owner_name(str(tree), st) == jax_owner(str(tree), st)


# -- converters and schemas ---------------------------------------------------


def _valid_params(type_id, rng):
    nav = [int(v) for v in rng.integers(1, 50, int(rng.integers(1, 4)))]
    sig = [int(v) for v in rng.integers(1, 300, 2)]
    if type_id == "MEMORY":
        return {"type": "MEMORY", "tileshape": [1] + sig,
                "num_partitions": int(rng.integers(1, 9)),
                "sig_dims": 2, "nav_shape": nav, "sig_shape": sig,
                "tiledelay": 0.01, "datashape": nav + sig,
                "sync_offset": int(rng.integers(-5, 5))}
    out = {"type": type_id, "path": f"/data/scan{int(rng.integers(99))}",
           "nav_shape": nav, "sig_shape": sig,
           "sync_offset": int(rng.integers(-50, 50)),
           "name": "a scan", "enable_direct": False,
           "io_backend": "buffered"}
    if type_id == "RAW":
        out["dtype"] = "uint16"
    if type_id == "HDF5":
        out["ds_path"] = "/entry/data"
    return out


INVALID = [
    lambda p: {k: v for k, v in p.items() if k != "type"},
    lambda p: {**p, "type": "SOMETHING_ELSE"},
    lambda p: {**p, "nav_shape": [0, 4]},
    lambda p: {**p, "sig_shape": []},
    lambda p: {**p, "sig_shape": "128,128"},
    lambda p: {**p, "sync_offset": True},
    lambda p: {**p, "sync_offset": 1.5},
    lambda p: {**p, "nav_shape": [2.0, 3]},
]


@pytest.mark.parametrize("type_id", sorted(jax_conv.CONVERTERS))
def test_converter_like_jax(type_id):
    jcls, pcls = jax_conv.CONVERTERS[type_id], port_conv.CONVERTERS[type_id]
    assert pcls().SCHEMA == jcls().SCHEMA
    assert port_conv.get_converter(type_id.lower()) is pcls
    rng = np.random.default_rng(sum(map(ord, type_id)))
    for _ in range(5):
        params = _valid_params(type_id, rng)
        got = pcls().to_python(dict(params))
        assert got == jcls().to_python(dict(params))
        assert type(got.get("nav_shape")) is type(
            jcls().to_python(dict(params)).get("nav_shape"))
        for make in INVALID:
            bad = make(params)
            outcome = []
            for cls, err in ((jcls, jax_mc.ValidationError),
                             (pcls, port_mc.ValidationError)):
                try:
                    outcome.append(("ok", cls().to_python(dict(bad))))
                except err as e:
                    outcome.append(("error", str(e)))
            assert outcome[0] == outcome[1], bad
    if type_id == "RAW":
        assert isinstance(pcls().to_python(_valid_params("RAW", rng))[
            "nav_shape"], list)
        with pytest.raises(port_mc.ValidationError, match="dtype"):
            pcls().to_python({"type": "RAW", "path": "/x",
                              "nav_shape": [1], "sig_shape": [1]})


def test_msg_converter_of_each_dataset_class():
    assert set(port_conv.CLASS_CONVERTERS) == set(jax_conv.CLASS_CONVERTERS)
    for type_id in port_datasets.filetypes:
        cls = port_datasets.get_dataset_cls(type_id)
        conv = cls.get_msg_converter()
        want = jax_conv.CLASS_CONVERTERS.get(cls.__name__)
        if want is None:
            assert conv is None, cls
        else:
            assert conv is port_conv.CONVERTERS[want.TYPE], cls


@pytest.mark.parametrize("seed", range(3))
def test_validate_schema_like_jax(seed):
    rng = np.random.default_rng(seed)
    schema = {"type": "object", "required": ["a"], "properties": {
        "a": {"type": "array", "items": {"type": "integer", "minimum": 0},
              "minItems": 1, "maxItems": 3},
        "b": {"type": "number", "minimum": -1.0},
        "c": {"const": "C"}, "d": {"type": "boolean"},
        "e": {"type": "string"}}}
    pool = [None, True, 0, -3, 2.5, "C", "x", [], [1], [1, 2, 3, 4],
            [-1], [1.5], {"k": 1}]
    for _ in range(60):
        data = {k: pool[int(rng.integers(len(pool)))]
                for k in "abcde" if rng.random() < 0.7}
        outcome = []
        for mc in (jax_mc, port_mc):
            try:
                mc.validate_schema(data, schema)
                outcome.append(None)
            except mc.ValidationError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], data


# -- coordinates --------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_coordinates_like_jax(seed):
    rng = np.random.default_rng(seed)
    for name in ("identity", "flip_y", "flip_x"):
        assert np.array_equal(getattr(port_coords, name)(),
                              getattr(jax_coords, name)())
    for _ in range(20):
        s, a = float(rng.uniform(0.1, 5)), float(rng.uniform(-7, 7))
        for name, arg in (("scale", s), ("rotate", a), ("rotate_deg",
                                                         a * 50)):
            assert np.array_equal(getattr(port_coords, name)(arg),
                                  getattr(jax_coords, name)(arg))
        flip = bool(rng.integers(2))
        mat = port_coords.scale(s) @ port_coords.rotate(a) @ (
            port_coords.flip_y() if flip else port_coords.identity())
        got = port_coords.scale_rotate_flip_y(mat)
        assert got == jax_coords.scale_rotate_flip_y(mat)
        assert got[0] == pytest.approx(s) and got[2] == flip
        assert np.allclose(port_coords.rotate(got[1]),
                           port_coords.rotate(a))
        bad = mat @ np.array([[1.0, float(rng.uniform(0.1, 1))],
                              [0.0, 1.0]])
        msgs = []
        for c in (jax_coords, port_coords):
            with pytest.raises(ValueError) as e:
                c.scale_rotate_flip_y(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# -- preload and versioning ---------------------------------------------------


def test_preload_like_jax(monkeypatch, caplog):
    spec = "json; nonexistent_module_xyz ;;colorsys"
    monkeypatch.setenv("LIBERTEM_TPU_PRELOAD", spec)
    monkeypatch.setenv("LIBERTEM_TPU_TORCH_PRELOAD", spec)
    logs = []
    for mod in (jax_preload, port_preload):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            mod.do_preloads()
            mod.preload_modules(["json", "another_missing_module"])
        logs.append([r.getMessage() for r in caplog.records])
    assert logs[0] == logs[1]
    assert len(logs[1]) == 2 and "nonexistent_module_xyz" in logs[1][0]
    # each package reads its own variable
    monkeypatch.delenv("LIBERTEM_TPU_TORCH_PRELOAD")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        port_preload.do_preloads()
    assert not caplog.records


def test_versioning_names_torch_not_jax():
    versions = port_versioning.get_backend_versions()
    assert versions == {
        "libertem_tpu_torch": port.__version__,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "numpy": np.__version__}
    assert not any("jax" in k for k in versions)
    assert port_versioning.get_version() == port.__version__


# -- the engine's channel encoding, helpers, event bus ------------------------


@pytest.mark.parametrize("renders", [True, False])
def test_encode_channel_like_jax(renders, caplog):
    """A channel's description, and its PNG or, where it cannot be
    rendered, a logged failure and no image."""
    from libertem_tpu.common.analysis import AnalysisResult as JaxResult

    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (6, 7, 4)).astype(np.uint8)

    def vis():
        if not renders:
            raise ImportError("No module named 'matplotlib'")
        return img

    out = []
    for cls, engine in ((JaxResult, jax_engine),
                        (AnalysisResult, port_engine)):
        res = cls(raw_data=img[..., 0], visualized=vis, key="k",
                  title="t", desc="d")
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            meta, png = engine._encode_channel(res)
        out.append((meta, png, len(caplog.records)))
    assert out[0] == out[1]
    meta, png, logged = out[1]
    assert meta == {"title": "t", "desc": "d", "key": "k",
                    "includeInDownload": True}
    assert (png is not None, logged) == ((True, 0) if renders
                                         else (False, 1))


def test_executor_helpers_like_jax():
    for raw in ({}, {0: 2, 1: "3"}, {"a": None, 2: 1}):
        assert port_helpers._convert_device_map(raw) == \
            jax_helpers._convert_device_map(raw)
    for bad in (0, -1, 1.5, "2"):
        msgs = []
        for h in (jax_helpers, port_helpers):
            with pytest.raises(ValueError) as e:
                h.create_executor(connection={"type": "local",
                                              "numWorkers": bad})
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_local_executor_is_the_card(monkeypatch):
    """Without a card the port's "local" executor raises; with the
    default device mapped to the CPU it is built, records numWorkers,
    and wrapped by create_executor_external."""
    import libertem_tpu_torch.executor.base as base
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_helpers.create_executor(connection={"type": "local"})
    monkeypatch.setattr(base, "resolve_device",
                        lambda d=None: torch.device("cpu"))
    ex = port_helpers.create_executor(
        connection={"type": "local", "numWorkers": 3, "cudas": {0: 1}})
    assert ex.devices == [torch.device("cpu")] and ex._cpu_workers == 3
    wrapped, params = port_helpers.create_executor_external(
        {"cpus": 2, "cudas": 1})
    assert params == {"connection": {"type": "LOCAL", "numWorkers": 2,
                                     "cudas": {0: 1}}}
    assert wrapped.ensure_sync().get_resource_details() == [
        {"host": "localhost", "cpu": 2, "cuda": 0, "service": 1}]


def test_event_bus_pumps_from_threads():
    """Messages sent from other threads reach the registry in order,
    through both packages' pumps."""
    import threading

    got = {}
    for name, mod in (("jax", jax_bus), ("port", port_bus)):
        bus = mod.EventBus()
        seen = []

        class Registry:
            async def broadcast_event(self, msg):
                seen.append(msg)

        async def go():
            pump = asyncio.ensure_future(
                mod.MessagePump(bus, Registry()).run())
            threads = [threading.Thread(target=bus.send,
                                        args=({"i": i},))
                       for i in range(5)]
            for t in threads:
                t.start()
                t.join(timeout=5)
            for _ in range(200):
                if len(seen) == 5:
                    break
                await asyncio.sleep(0.01)
            pump.cancel()

        asyncio.run(go())
        with pytest.raises(queue.Empty):
            bus.get(timeout=0.01)
        got[name] = seen
    assert got["jax"] == got["port"] == [{"i": i} for i in range(5)]


# -- the CLUST controller -----------------------------------------------------


@pytest.mark.parametrize("cancelled", [False, True])
def test_cluster_controller_like_jax(cancelled):
    pytest.importorskip("sklearn")
    data = _mk_random((8, 8, 12, 12), seed=11)
    params = {"n_clust": 3, "n_peaks": 6}
    jctx = JaxContext(executor=JaxInline())
    pctx = port.Context(device="cpu")
    out = []
    for ctx, ds, cls in (
            (jctx, JaxMemory(data=data, sig_dims=2,
                             num_partitions=2).initialize(),
             JaxAnalysis.get_analysis_by_type("CLUST")),
            (pctx, pctx.load("memory", data=data, sig_dims=2,
                             num_partitions=2),
             PortAnalysis.get_analysis_by_type("CLUST"))):
        sent = []

        async def send_results(result_set, finished):
            sent.append((result_set, finished))

        analysis = cls(dataset=ds, parameters=params)
        res = asyncio.run(analysis.controller(
            ctx=ctx, cancel_id="job", send_results=send_results,
            job_is_cancelled=lambda: cancelled))
        assert sent == [(res, True)]
        out.append(res)
    j, p = out
    assert [r.key for r in p] == [r.key for r in j]
    if cancelled:
        assert len(p) == 0
        return
    assert [r.key for r in p] == ["intensity"]
    labels = p.intensity.raw_data
    assert labels.shape == (8, 8)
    assert np.array_equal(labels, j.intensity.raw_data)
    assert set(np.unique(labels)) == {0.0, 1.0, 2.0}


# -- daskadapter --------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_read_partition_like_jax(seed):
    rng = np.random.default_rng(seed)
    nav = (int(rng.integers(3, 9)), int(rng.integers(3, 9)))
    data = rng.integers(0, 4096, nav + (6, 5)).astype(np.uint16)
    roi = rng.random(nav) < 0.5
    n_parts = int(rng.integers(1, 5))
    jds = JaxMemory(data=data, sig_dims=2,
                    num_partitions=n_parts).initialize()
    pds = port.Context(device="cpu").load("memory", data=data, sig_dims=2,
                                          num_partitions=n_parts)
    jparts, pparts = list(jds.get_partitions()), list(pds.get_partitions())
    assert [(p.start_frame, p.num_frames) for p in pparts] == [
        (p.start_frame, p.num_frames) for p in jparts]
    flat_roi = roi.reshape(-1)
    for jp, pp in zip(jparts, pparts):
        for dtype in (np.float32, np.uint16, np.int64):
            for r in (None, flat_roi):
                got = port_dask._read_partition(pp, dtype, r)
                want = jax_dask._read_partition(jp, dtype, r)
                assert got.dtype == want.dtype == np.dtype(dtype)
                assert np.array_equal(got, want)
        assert pp.frames_in_roi(flat_roi) == jp.frames_in_roi(flat_roi)
    stacked = np.concatenate([port_dask._read_partition(p, np.float32)
                              for p in pparts])
    assert np.array_equal(stacked, data.reshape(-1, 6, 5))


def test_make_dask_array_needs_dask():
    try:
        import dask  # noqa: F401
        pytest.skip("dask is installed here")
    except ImportError:
        pass
    ds = port.Context(device="cpu").load(
        "memory", data=np.zeros((2, 2, 3, 3), np.float32), sig_dims=2)
    with pytest.raises(ImportError, match="requires dask"):
        port_dask.make_dask_array(ds)
