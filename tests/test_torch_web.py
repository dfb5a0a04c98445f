"""The web GUI's server of the port against the JAX package's, on the
CPU (counterparts of the 27 scenarios of ``tests/test_web.py``).

Each test serves both ``make_app``s on one tornado loop, drives the
same REST and websocket calls into each with the same seeded numpy
data, and compares what comes back.  The JAX side runs on
``InlineJobExecutor()``, the port's on ``InlineJobExecutor(device=
"cpu")`` (a ``"local"`` connection with the port's default device
patched to the CPU).  Tolerances: JSON replies equal once timestamps,
the version and the devices are dropped and the package name is
normalised (numbers within 1e-5 relative); the jobs' raw results within
rtol 1e-5 (float32 with other summation orders, absolute floor 1e-5 of
the largest magnitude); decoded PNGs within 1 level.  Where a reply
differs by design, the test says so and compares the rest.
"""
import io
import json
import os
import re
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch
import tornado.gen
import tornado.httpclient
import tornado.httpserver
import tornado.testing
import tornado.websocket

import libertem_tpu.analysis  # noqa: F401  (registers the analyses)
import libertem_tpu.web as jax_web
from libertem_tpu.analysis.base import Analysis as JaxAnalysis
from libertem_tpu.executor.async_adapter import AsyncAdapter as JaxAdapter
from libertem_tpu.executor.inline import InlineJobExecutor as JaxInline
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemory
from libertem_tpu.udf.base import UDFRunner as JaxRunner
from libertem_tpu.web import notebook_generator as jax_nb
from libertem_tpu.web.server import make_app as jax_make_app
from libertem_tpu.web.state import SharedState as JaxState

import libertem_tpu_torch.analysis  # noqa: F401
import libertem_tpu_torch.executor.base as port_executor_base
import libertem_tpu_torch.web as port_web
from libertem_tpu_torch.analysis.base import Analysis as PortAnalysis
from libertem_tpu_torch.executor.async_adapter import (
    AsyncAdapter as PortAdapter,
)
from libertem_tpu_torch.executor.inline import (
    InlineJobExecutor as PortInline,
)
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet as PortMemory
from libertem_tpu_torch.udf.base import UDFRunner as PortRunner
from libertem_tpu_torch.web import notebook_generator as port_nb
from libertem_tpu_torch.web.server import make_app as port_make_app
from libertem_tpu_torch.web.state import SharedState as PortState

from conftest import _mk_random

torch.set_num_threads(1)

RTOL = 1e-5
# keys whose values differ between two runs or two packages by nature
DROPPED = {"version", "devices", "ctime", "mtime", "cwd"}


def _norm_str(s):
    return s.replace("libertem_tpu_torch", "libertem_tpu")


def same(a, b, where="$"):
    """JSON-like ``a`` and ``b`` equal: dicts without DROPPED keys,
    strings with the package name normalised, numbers within RTOL."""
    if isinstance(a, dict) and isinstance(b, dict):
        ka = set(a) - DROPPED
        kb = set(b) - DROPPED
        assert ka == kb, (where, ka ^ kb)
        for k in sorted(ka):
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, str) and isinstance(b, str):
        assert _norm_str(a) == _norm_str(b), (where, a, b)
    elif isinstance(a, bool) or isinstance(b, bool) or a is None \
            or b is None:
        assert a == b, (where, a, b)
    elif isinstance(a, (int, float)) and isinstance(b, (int, float)):
        assert np.isclose(a, b, rtol=RTOL, atol=0, equal_nan=True), (
            where, a, b)
    else:
        assert a == b, (where, a, b)


def close(got, want, where=""):
    """Arrays within RTOL, with an absolute floor of RTOL of the
    largest magnitude; nan where nan."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    finite = np.abs(want[np.isfinite(want)])
    scale = float(finite.max()) if finite.size else 0.0
    assert np.allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                       equal_nan=True), (
        where, float(np.nanmax(np.abs(got - want))), scale)


def same_results(a, b):
    """Two AnalysisResultSets: the same channels, raw results close."""
    assert [r.key for r in a] == [r.key for r in b]
    for ra, rb in zip(a, b):
        assert (ra.title, ra.desc) == (rb.title, rb.desc), ra.key
        close(rb.raw_data, ra.raw_data, ra.key)


def same_pngs(a, b):
    from PIL import Image
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.startswith(b"\x89PNG") and y.startswith(b"\x89PNG")
        ix = np.asarray(Image.open(io.BytesIO(x))).astype(int)
        iy = np.asarray(Image.open(io.BytesIO(y))).astype(int)
        assert ix.shape == iy.shape
        assert np.abs(ix - iy).max() <= 1


class Side:
    """One package's app, state and classes, driven through the test
    case's loop and HTTP client."""

    def __init__(self, case, name, app, state, base):
        self.case = case
        self.name = name
        self.app = app
        self.state = state
        self.base = base
        jax = name == "jax"
        self.memory = JaxMemory if jax else PortMemory
        self.adapter = JaxAdapter if jax else PortAdapter
        self.inline = JaxInline if jax else (
            lambda: PortInline(device="cpu"))
        self.runner = JaxRunner if jax else PortRunner
        self.analysis = JaxAnalysis if jax else PortAnalysis
        self.nb = jax_nb if jax else port_nb
        self.web = jax_web if jax else port_web

    @property
    def ws_url(self):
        return self.base.replace("http://", "ws://") + "/api/events/"

    def connect(self):
        adapter = self.adapter(wrapped=self.inline())
        self.case.io_loop.run_sync(
            lambda: self.state.executor_state.set_executor(
                adapter, {"connection": {"type": "inline"}}))

    def register(self, uuid, data, num_partitions=2, params=None):
        ds = self.memory(data=data, sig_dims=2,
                         num_partitions=num_partitions).initialize()
        self.state.dataset_state.register(
            uuid, ds, {"params": params or {"type": "MEMORY"}},
            converted={})
        return ds

    def fetch(self, path, method="GET", body=None, **kw):
        if body is not None:
            kw["body"] = json.dumps(body)
        return self.case.fetch(self.base + path, method=method, **kw)

    def fetch_json(self, path, method="GET", body=None):
        resp = self.fetch(path, method=method, body=body)
        assert resp.code == 200, (self.name, resp.body)
        return json.loads(resp.body)

    def wait_job(self, job_id, deadline=400):
        engine = self.app.job_engine
        while deadline > 0:
            if job_id in engine.finished_jobs:
                return
            self.case.io_loop.run_sync(lambda: tornado.gen.sleep(0.02))
            deadline -= 1
        raise AssertionError(f"{self.name}: job {job_id} did not finish")

    def run_job(self, job_id, analysis_id):
        resp = self.fetch_json(f"/api/jobs/{job_id}/", method="PUT",
                               body={"job": {"analysis": analysis_id}})
        self.wait_job(job_id)
        return resp

    def put_analysis(self, ca, an, ds, analysis_type, parameters=None):
        return self.fetch_json(
            f"/api/compoundAnalyses/{ca}/analyses/{an}/", method="PUT",
            body={"dataset": ds, "details": {
                "analysisType": analysis_type,
                "parameters": parameters or {}}})

    def results(self, analysis_id):
        return self.state.analysis_state.get_results(analysis_id).results

    def client_src(self):
        path = os.path.join(os.path.dirname(os.path.abspath(
            self.web.__file__)), "client", "index.html")
        with open(path) as f:
            return f.read()

    def drive_ws(self, job_id, analysis_id):
        """PUT the job with a websocket open; (every JSON message,
        FINISH_JOB's header, the PNG frames that follow it)."""
        async def go():
            conn = await tornado.websocket.websocket_connect(self.ws_url)
            await conn.read_message()  # INITIAL_STATE
            resp = await tornado.httpclient.AsyncHTTPClient().fetch(
                self.base + f"/api/jobs/{job_id}/", method="PUT",
                body=json.dumps({"job": {"analysis": analysis_id}}))
            assert resp.code == 200
            msgs, frames, finish, pending = [], [], None, None
            while True:
                msg = await conn.read_message()
                if isinstance(msg, bytes):
                    frames.append(msg)
                    if finish is not None and len(frames) == pending:
                        break
                    continue
                data = json.loads(msg)
                msgs.append(data)
                if data["messageType"] in ("TASK_RESULT", "FINISH_JOB"):
                    # each header's image count matches the frames
                    # that follow it
                    frames = []
                    pending = data["followup"]["numMessages"]
                if data["messageType"] == "JOB_ERROR":
                    break
                if data["messageType"] == "FINISH_JOB":
                    finish = data
                    if pending == 0:
                        break
            conn.close()
            return msgs, finish, frames

        out = self.case.io_loop.run_sync(go, timeout=60)
        # the job's coroutine may still be tidying up after its last
        # message (a failed job is removed after JOB_ERROR is sent)
        self.wait_job(job_id)
        return out


class WebParity(tornado.testing.AsyncHTTPTestCase):
    """The JAX package's app on the test case's own server, the port's
    on a second server of the same loop."""

    def get_app(self):
        self.jax_state = JaxState()
        return jax_make_app(state=self.jax_state)

    def setUp(self):
        super().setUp()
        self.port_state = PortState()
        port_app = port_make_app(state=self.port_state)
        sock, port = tornado.testing.bind_unused_port()
        self.port_server = tornado.httpserver.HTTPServer(port_app)
        self.port_server.add_sockets([sock])
        self.sides = [
            Side(self, "jax", self._app, self.jax_state,
                 f"http://127.0.0.1:{self.get_http_port()}"),
            Side(self, "port", port_app, self.port_state,
                 f"http://127.0.0.1:{port}"),
        ]

    def tearDown(self):
        self.port_server.stop()
        self.io_loop.run_sync(self.port_server.close_all_connections)
        self.jax_state.executor_state.shutdown()
        self.port_state.executor_state.shutdown()
        super().tearDown()

    def both(self, scenario):
        """``scenario(side)`` on the JAX side, then on the port's."""
        return [scenario(s) for s in self.sides]


class TestConfig(WebParity):
    def test_config(self):
        j, p = self.both(lambda s: s.fetch_json("/api/config/"))
        assert j["status"] == p["status"] == "ok"
        jc, pc = j["config"], p["config"]
        # by design (ROADMAP queue 3, the last formats): the port's
        # default io backend is "buffered", the JAX package's "mmap";
        # the port's HDF5 (h5py's own reads) and array-like DASK list
        # no io backends.  The rest is equal.
        for type_id, info in pc["datasetTypes"].items():
            if type_id in ("HDF5", "DASK"):
                assert info["supported_io_backends"] == []
                assert info["default_io_backend"] is None
            elif jc["datasetTypes"][type_id]["default_io_backend"]:
                assert info["default_io_backend"] == "buffered"
        for cfg in (jc, pc):
            for type_id, info in cfg["datasetTypes"].items():
                info.pop("default_io_backend")
                if type_id in ("HDF5", "DASK"):
                    info.pop("supported_io_backends")
        same(jc, pc)
        assert "version" in pc and "cudas" in pc["devices"]

    def test_browse(self):
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.default_rng(3)
            os.makedirs(os.path.join(tmp, "sub", "deeper"))
            for i in range(3):
                with open(os.path.join(tmp, f"f{i}.raw"), "wb") as f:
                    f.write(rng.bytes(int(rng.integers(1, 5000))))
            j, p = self.both(lambda s: s.fetch_json(
                f"/api/browse/localfs/?path={tmp}"))
        assert j["messageType"] == "DIRECTORY_LISTING"
        same(j, p)
        assert [f["name"] for f in p["files"]] == ["f0.raw", "f1.raw",
                                                   "f2.raw"]

    def test_browse_missing(self):
        j, p = self.both(lambda s: s.fetch_json(
            "/api/browse/localfs/?path=/nonexistent-dir-xyz"))
        assert j["status"] == "error"
        same(j, p)
        assert p["alternative"] == "/"


class TestDatasetAndJob(WebParity):
    def test_dataset_lifecycle_raw(self):
        raw = _mk_random((4, 5, 8, 8), dtype="float32")
        with tempfile.NamedTemporaryFile(suffix=".raw",
                                         delete=False) as f:
            raw.tofile(f.name)
            path = f.name

        def scenario(s):
            s.connect()
            opened = s.fetch_json("/api/datasets/ds-raw/", method="PUT",
                                  body={"dataset": {"params": {
                                      "type": "RAW", "path": path,
                                      "dtype": "float32",
                                      "nav_shape": [4, 5],
                                      "sig_shape": [8, 8]}}})
            deleted = s.fetch_json("/api/datasets/ds-raw/",
                                   method="DELETE")
            return opened, deleted

        try:
            (jo, jd), (po, pd) = self.both(scenario)
        finally:
            os.unlink(path)
        assert po["status"] == "ok", po
        assert po["details"]["params"]["shape"] == [4, 5, 8, 8]
        # the diagnostics list each package's own partition layout
        same({**jo["details"], "diagnostics": None},
             {**po["details"], "diagnostics": None})
        same({**jo, "details": None}, {**po, "details": None})
        same(jd, pd)

    def test_analysis_and_job(self):
        data = _mk_random((6, 7, 12, 12), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-1", data)
            created = s.put_analysis("ca-1", "an-1", "ds-1", "SUM_FRAMES")
            started = s.run_job("job-1", "an-1")
            assert s.state.analysis_state.have_results("an-1")
            return created, started, s.results("an-1")

        (jc, js, jr), (pc, ps, pr) = self.both(scenario)
        same(jc, pc)
        same(js, ps)
        assert ps["details"] == {"id": "job-1", "analysis": "an-1"}
        same_results(jr, pr)

    def test_download(self):
        data = _mk_random((6, 7, 12, 12), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-2", data)
            s.put_analysis("ca-2", "an-2", "ds-2", "SUM_FRAMES")
            s.run_job("job-2", "an-2")
            resp = s.fetch(
                "/api/compoundAnalyses/ca-2/analyses/an-2/download/NPZ/")
            assert resp.code == 200
            return dict(np.load(io.BytesIO(resp.body)))

        j, p = self.both(scenario)
        assert set(j) == set(p) and "intensity" in p
        for k in j:
            close(p[k], j[k], k)
        close(p["intensity"], data.astype(np.float64).sum(axis=(0, 1)))


class TestEvents(WebParity):
    def test_initial_state_ws(self):
        data = _mk_random((4, 4, 8, 8), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-ws", data)

            async def go():
                conn = await tornado.websocket.websocket_connect(
                    s.ws_url)
                msg = json.loads(await conn.read_message())
                conn.close()
                return msg

            return self.io_loop.run_sync(go)

        j, p = self.both(scenario)
        assert p["messageType"] == "INITIAL_STATE"
        for m in (j, p):
            for ds in m["datasets"]:
                ds["diagnostics"] = None
        same(j, p)

    def test_cross_origin_ws_rejected(self):
        def scenario(s):
            s.connect()
            port = s.base.rsplit(":", 1)[1]

            async def go():
                req = tornado.httpclient.HTTPRequest(
                    s.ws_url, headers={"Origin": "http://evil.example"})
                with pytest.raises(tornado.httpclient.HTTPClientError) \
                        as err:
                    await tornado.websocket.websocket_connect(req)
                req2 = tornado.httpclient.HTTPRequest(
                    s.ws_url,
                    headers={"Origin": f"http://127.0.0.1:{port}"})
                conn = await tornado.websocket.websocket_connect(req2)
                msg = json.loads(await conn.read_message())
                conn.close()
                return err.value.code, msg["messageType"]

            return self.io_loop.run_sync(go)

        j, p = self.both(scenario)
        assert j == p == (403, "INITIAL_STATE")


class TestConnectionAndRPC(WebParity):
    def test_connection(self):
        conn = {"type": "local", "numWorkers": 2}

        def scenario(s):
            before = s.fetch_json("/api/config/connection/")
            put = s.fetch_json("/api/config/connection/", method="PUT",
                               body={"connection": conn})
            got = s.fetch_json("/api/config/connection/")
            cluster = s.fetch_json("/api/config/cluster/")
            return before, put, got, cluster

        # the port's "local" connection is every CUDA card: mapped to
        # the CPU here, as the port's tests do
        with mock.patch.object(port_executor_base, "resolve_device",
                               lambda d=None: torch.device("cpu")):
            j, p = self.both(scenario)
        same(j, p)
        assert p[0] == {"status": "disconnected", "connection": {}}
        assert p[1] == p[2] == {"status": "ok", "connection": conn}
        assert p[3]["details"] == [
            {"host": "localhost", "cpu": 2, "cuda": 0, "service": 1}]

    def test_local_connection_without_a_card_fails(self):
        """Unpatched, the port's "local" connection wants the card and
        fails to connect here; the JAX package's takes its CPU mesh."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA card")
        side = self.sides[1]
        resp = side.fetch("/api/config/connection/", method="PUT",
                          body={"connection": {"type": "local"}})
        assert resp.code == 500
        msg = json.loads(resp.body)
        assert msg["messageType"] == "CLUSTER_CONN_ERROR"
        assert "CUDA" in msg["msg"]
        assert not side.state.executor_state.have_executor()

    def test_com_guess_rpc(self):
        data = _mk_random((5, 5, 16, 16), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-rpc", data, num_partitions=1)
            body = {"dataset": "ds-rpc", "details": {
                "mainType": "CENTER_OF_MASS", "analyses": []}}
            s.fetch_json("/api/compoundAnalyses/ca/", method="PUT",
                         body=body)
            s.put_analysis("ca", "an-rpc", "ds-rpc", "CENTER_OF_MASS",
                           {"cx": 8, "cy": 8})
            early = s.fetch_json(
                "/api/compoundAnalyses/ca/rpc/guess_parameters/",
                method="PUT", body={})
            body["details"]["analyses"] = ["an-rpc"]
            s.fetch_json("/api/compoundAnalyses/ca/", method="PUT",
                         body=body)
            guess = s.fetch_json(
                "/api/compoundAnalyses/ca/rpc/guess_parameters/",
                method="PUT", body={})
            return early, guess

        (je, jg), (pe, pg) = self.both(scenario)
        assert je["status"] == pe["status"] == "error"
        assert pg["status"] == "ok"
        assert set(pg["guess"]) == {"scan_rotation", "flip_y", "cy", "cx"}
        assert 4.0 < pg["guess"]["cy"] < 12.0
        assert 4.0 < pg["guess"]["cx"] < 12.0
        same(jg, pg)

    def test_notebook_download(self):
        data = _mk_random((4, 4, 8, 8), dtype="float32")

        def scenario(s):
            s.register("ds-nb", data, num_partitions=1)
            s.fetch_json("/api/compoundAnalyses/ca-nb/", method="PUT",
                         body={"dataset": "ds-nb", "details": {
                             "mainType": "SUM_FRAMES",
                             "analyses": ["an-nb"]}})
            s.put_analysis("ca-nb", "an-nb", "ds-nb", "SUM_FRAMES")
            resp = s.fetch("/api/compoundAnalyses/ca-nb/download/notebook/")
            assert resp.code == 200
            return json.loads(resp.body)

        j, p = self.both(scenario)
        assert p["nbformat"] == 4
        same(j, p)
        src = "".join("".join(c["source"]) for c in p["cells"])
        assert "from libertem_tpu_torch import Context" in src


class TestClientPage(WebParity):
    def test_index(self):
        j, p = self.both(lambda s: s.fetch("/"))
        assert j.code == p.code == 200
        assert b"<title>libertem_tpu_torch</title>" in p.body
        assert b"/api/events/" in p.body
        # the port's own copy of the page: the JAX page with the
        # package's name in its title, heading, stop prompt and the
        # drift guard's comment
        differ = [
            (a, b) for a, b in zip(j.body.decode().splitlines(),
                                   p.body.decode().splitlines()) if a != b]
        assert len(j.body.splitlines()) == len(p.body.splitlines())
        assert len(differ) == 5, differ
        for a, b in differ:
            assert "libertem_tpu_torch" in b or "test_torch_gui" in b


class TestJobError(WebParity):
    def test_job_error_broadcast(self):
        data = _mk_random((4, 4, 8, 8), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-err", data, num_partitions=1)
            # a ring selecting no pixels: ValueError in the run
            s.put_analysis("ca", "an-err", "ds-err", "FEM",
                           {"cx": 4, "cy": 4, "ri": 7, "ro": 7.1})
            msgs, finish, _ = s.drive_ws("job-err", "an-err")
            assert "job-err" not in s.state.job_state.jobs
            assert not s.state.analysis_state.have_results("an-err")
            return [m["messageType"] for m in msgs], finish

        j, p = self.both(scenario)
        assert p[1] is None and p[0][-1] == "JOB_ERROR"
        assert j[0][-1] == "JOB_ERROR"


class TestParamValidation(WebParity):
    def test_invalid_raw_params_rejected(self):
        j, p = self.both(lambda s: s.fetch_json(
            "/api/datasets/ds-bad/", method="PUT",
            body={"dataset": {"params": {
                "type": "RAW", "path": "/nonexistent.raw"}}}))
        assert p["status"] == "error"
        same(j, p)


class TestWebRound2(WebParity):
    def test_binary_result_frames(self):
        data = _mk_random((6, 7, 12, 12), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-1", data)
            s.put_analysis("ca-1", "an-b", "ds-1", "SUM_FRAMES")
            msgs, finish, frames = s.drive_ws("job-b", "an-b")
            heads = [m for m in msgs if m["messageType"] == "TASK_RESULT"]
            assert heads, s.name
            for h in heads:
                for ch in h["channels"]:
                    assert "image" not in ch
            return finish, frames, s.results("an-b")

        (jf, jp, jr), (pf, pp, pr) = self.both(scenario)
        assert pf["followup"]["numMessages"] == len(pp) >= 1
        same(jf, pf)
        same_pngs(jp, pp)
        same_results(jr, pr)

    def test_need_rerun_short_circuit(self):
        data = _mk_random((6, 7, 12, 12), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-1", data)
            calls = []
            orig = s.runner.run_for_dataset_iter

            def counted(self_, *a, **kw):
                calls.append(1)
                return orig(self_, *a, **kw)

            counts, results = [], []
            with mock.patch.object(s.runner, "run_for_dataset_iter",
                                   counted):
                for i, params in enumerate((
                        {"cx": 6.0, "cy": 6.0, "scan_rotation": 0.0},
                        {"cx": 6.0, "cy": 6.0, "scan_rotation": 90.0},
                        {"cx": 6.0, "cy": 6.0, "scan_rotation": 90.0,
                         "r": 4.0})):
                    s.put_analysis("ca-1", "an-c", "ds-1",
                                   "CENTER_OF_MASS", params)
                    s.run_job(f"job-c{i}", "an-c")
                    counts.append(len(calls))
                    results.append(s.results("an-c"))
            return counts, results

        (jc, jr), (pc, pr) = self.both(scenario)
        assert jc == pc == [1, 1, 2]
        for a, b in zip(jr, pr):
            same_results(a, b)

    def test_cluster_controller_job(self):
        pytest.importorskip("sklearn")
        data = _mk_random((8, 8, 12, 12), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-1", data)
            s.put_analysis("ca-1", "an-k", "ds-1", "CLUST",
                           {"n_clust": 3, "n_peaks": 6})
            msgs, finish, frames = s.drive_ws("job-k", "an-k")
            assert finish is not None, msgs[-1]
            assert "intensity" in [c["key"] for c in finish["channels"]]
            return finish, s.results("an-k")

        (jf, jr), (pf, pr) = self.both(scenario)
        same(jf, pf)
        # the labels of the same features, clustered by scikit-learn
        same_results(jr, pr)


class TestCompoundAnalysisProtocol(WebParity):
    def test_create_compound_top_level_dataset(self):
        data = _mk_random((4, 5, 8, 8), dtype="float32")

        def scenario(s):
            s.register("ds-ca", data)
            out = []
            for analyses in ([], ["an-x"]):
                out.append(s.fetch_json(
                    "/api/compoundAnalyses/ca-top/", method="PUT",
                    body={"dataset": "ds-ca", "details": {
                        "mainType": "APPLY_RING_MASK",
                        "analyses": analyses}}))
            return out, s.state.compound_analysis_state["ca-top"]

        (j, jst), (p, pst) = self.both(scenario)
        assert [m["messageType"] for m in p] == [
            "COMPOUND_ANALYSIS_CREATED", "COMPOUND_ANALYSIS_UPDATED"]
        assert p[0]["dataset"] == "ds-ca"
        assert pst["details"]["analyses"] == ["an-x"]
        same(j, p)
        same(jst, pst)

    def test_download_all_formats(self):
        import h5py
        from PIL import Image

        data = _mk_random((4, 5, 8, 8), dtype="float32")

        def scenario(s):
            s.connect()
            s.register("ds-dl", data)
            s.put_analysis("ca-dl", "an-dl", "ds-dl", "SUM_FRAMES")
            s.run_job("job-dl", "an-dl")
            out = {}
            for fmt in ("NPZ", "NPZ_COMPRESSED", "HDF5", "TIFF", "RAW"):
                resp = s.fetch("/api/compoundAnalyses/ca-dl/analyses/"
                               f"an-dl/download/{fmt}/")
                assert resp.code == 200, (s.name, fmt)
                assert len(resp.body) > 100, (s.name, fmt)
                out[fmt] = resp.body
            return out

        j, p = self.both(scenario)
        for fmt in ("NPZ", "NPZ_COMPRESSED"):
            a = dict(np.load(io.BytesIO(j[fmt])))
            b = dict(np.load(io.BytesIO(p[fmt])))
            assert set(a) == set(b)
            for k in a:
                close(b[k], a[k], (fmt, k))
        with h5py.File(io.BytesIO(j["HDF5"]), "r") as fa, \
                h5py.File(io.BytesIO(p["HDF5"]), "r") as fb:
            assert set(fa) == set(fb)
            for k in fa:
                close(fb[k][()], fa[k][()], ("HDF5", k))
        ta = np.asarray(Image.open(io.BytesIO(j["TIFF"])))
        tb = np.asarray(Image.open(io.BytesIO(p["TIFF"])))
        close(tb, ta, "TIFF")
        assert len(j["RAW"]) == len(p["RAW"])
        close(np.frombuffer(p["RAW"], np.float32),
              np.frombuffer(j["RAW"], np.float32), "RAW")


class TestNotebookRoi(WebParity):
    def test_roi_analysis_uses_registry_form(self):
        def scenario(s):
            nb = s.nb.notebook_for(
                "RAW", {"path": "/t.raw", "dtype": "float32",
                        "nav_shape": [4, 4], "sig_shape": [8, 8]},
                [{"analysisType": "CENTER_OF_MASS", "parameters": {
                    "cx": 4, "cy": 4, "r": 3,
                    "roi": {"shape": "disk", "cx": 1, "cy": 1,
                            "r": 1}}}])
            return nb, "".join("".join(c["source"]) for c in nb["cells"]
                               if c["cell_type"] == "code")

        (jn, js), (pn, ps) = self.both(scenario)
        assert "get_analysis_by_type" in ps
        assert "'roi'" in ps or '"roi"' in ps
        assert "from libertem_tpu_torch.analysis import Analysis" in ps
        same(jn, pn)


class TestGuiWorkflow(WebParity):
    def test_dataset_schemas(self):
        from libertem_tpu_torch.io.dataset.converters import CONVERTERS

        j, p = self.both(lambda s: s.fetch_json("/api/datasets/schema/"))
        same(j, p)
        schemas = p["schemas"]
        assert set(schemas) == set(CONVERTERS)
        assert "dtype" in schemas["RAW"]["required"]
        assert "ds_path" in schemas["HDF5"]["schema"]["properties"]

    def test_open_pick_disk_com_roi_flow(self):
        rng = np.random.default_rng(0)
        nav, sig = (6, 6), (16, 16)
        frames = rng.poisson(6.0, nav + sig).astype(np.float32)
        with tempfile.NamedTemporaryFile(suffix=".raw",
                                         delete=False) as f:
            frames.tofile(f.name)
            path = f.name
        cx, cy, r = 8.0, 8.0, 5.0

        def npz(s, an):
            resp = s.fetch(f"/api/compoundAnalyses/ca-g/analyses/{an}/"
                           "download/NPZ/")
            assert resp.code == 200
            return dict(np.load(io.BytesIO(resp.body)))

        def scenario(s):
            s.connect()
            resp = s.fetch_json("/api/datasets/ds-gui/", method="PUT",
                                body={"dataset": {"params": {
                                    "type": "RAW", "path": path,
                                    "dtype": "float32",
                                    "nav_shape": list(nav),
                                    "sig_shape": list(sig)}}})
            assert resp["status"] == "ok", resp
            s.put_analysis("ca-g", "an-sum", "ds-gui", "SUM_FRAMES")
            s.run_job("job-sum", "an-sum")
            s.put_analysis("ca-g", "an-disk", "ds-gui", "APPLY_DISK_MASK",
                           {"cx": cx, "cy": cy, "r": r})
            s.run_job("job-disk", "an-disk")
            s.put_analysis("ca-g", "an-com", "ds-gui", "CENTER_OF_MASS",
                           {"cx": cx, "cy": cy, "r": 7.0,
                            "roi": {"shape": "disk", "cx": 2, "cy": 2,
                                    "r": 2}})
            s.run_job("job-com", "an-com")
            return [npz(s, an) for an in ("an-sum", "an-disk", "an-com")]

        try:
            j, p = self.both(scenario)
        finally:
            os.unlink(path)
        for a, b in zip(j, p):
            assert set(a) == set(b)
            for k in a:
                close(b[k], a[k], k)
        from libertem_tpu_torch import masks as mask_lib
        mask = mask_lib.circular(cx, cy, sig[1], sig[0], r,
                                 antialiased=True)
        want = (frames.reshape(-1, *sig) * mask).sum(axis=(1, 2))
        close(p[1]["intensity"].reshape(nav), want.reshape(nav))
        assert "field" not in p[2]
        yy, xx = np.mgrid[0:nav[0], 0:nav[1]]
        inside = (yy - 2) ** 2 + (xx - 2) ** 2 <= 4
        for chan in ("x", "y"):
            comp = p[2][chan].reshape(nav)
            assert np.isfinite(comp[inside]).all(), chan
            assert np.isnan(comp[~inside]).all(), chan


class TestClientConsistency(WebParity):
    def test_analysis_types_match_registry(self):
        def scenario(s):
            m = re.search(r"const ANALYSES = \{(.*?)\n\};", s.client_src(),
                          re.DOTALL)
            assert m, "client ANALYSES registry not found"
            client = set(re.findall(r"^\s*([A-Z][A-Z0-9_]+):", m.group(1),
                                    re.MULTILINE))
            assert client == set(s.analysis.registry), s.name
            return client

        j, p = self.both(scenario)
        assert j == p

    def test_client_api_paths_exist(self):
        def scenario(s):
            src = s.client_src()
            called = set(re.findall(r'"(/api/[a-zA-Z/]*?)[?"]', src))
            called |= {p.split("${")[0]
                       for p in re.findall(r"`(/api/[^`]+)`", src)}
            codes = {}
            for prefix in sorted(called):
                probe = prefix
                if not probe.endswith("/"):
                    probe = probe.rsplit("/", 1)[0] + "/"
                resp = s.fetch(probe + "x/" if probe.count("/") < 3
                               else probe)
                assert resp.code != 404 or "jobs" in probe or \
                    "compoundAnalyses" in probe or "datasets" in probe, (
                        s.name, probe, resp.code)
                codes[probe] = resp.code
            return codes

        j, p = self.both(scenario)
        assert j == p

    def test_message_vocabulary_covered(self):
        def scenario(s):
            path = os.path.join(os.path.dirname(os.path.abspath(
                s.web.__file__)), "messages.py")
            with open(path) as f:
                vocabulary = set(re.findall(r'"messageType": "([A-Z_]+)"',
                                            f.read()))
            assert len(vocabulary) > 25
            src = s.client_src()
            missing = {m for m in vocabulary if m not in src}
            assert not missing, (s.name, sorted(missing))
            return vocabulary

        j, p = self.both(scenario)
        assert j == p


class TestNotebookTemplates(WebParity):
    IDS = (
        "SUM_FRAMES", "SD_FRAMES", "SUM_SIG", "PICK_FRAME",
        "APPLY_DISK_MASK", "APPLY_RING_MASK", "APPLY_POINT_SELECTOR",
        "MASKS", "CENTER_OF_MASS", "RADIAL_FOURIER", "FEM", "CLUST",
        "APPLY_FFT_MASK", "PICK_FFT_FRAME", "FFTSUM_FRAMES",
    )
    PARAMS = {
        "cx": 4, "cy": 4, "r": 3, "ri": 1, "ro": 4, "x": 1, "y": 1,
        "n_bins": 2, "max_order": 2, "flip_y": False,
        "scan_rotation": 0.0, "rad_in": 1, "rad_out": 4, "n_clust": 3,
        "n_peaks": 5,
    }

    def test_every_analysis_id_has_pretty_template(self):
        def scenario(s):
            for id_ in self.IDS:
                assert s.analysis.get_analysis_by_type(id_) is not None
                assert id_ in s.nb.ANALYSIS_TEMPLATES, id_
            nb = s.nb.notebook_for(
                "RAW", {"path": "/t.raw", "dtype": "float32",
                        "nav_shape": [4, 4], "sig_shape": [8, 8]},
                [{"analysisType": i, "parameters": dict(self.PARAMS)}
                 for i in self.IDS])
            cells = ["".join(c["source"]) for c in nb["cells"]
                     if c["cell_type"] == "code"]
            assert "get_analysis_by_type" not in "".join(cells)
            for src in cells:
                compile(src, "<nb>", "exec")
            return nb

        j, p = self.both(scenario)
        same(j, p)

    def test_notebook_download_inline_analysis_dicts(self):
        data = _mk_random((4, 4, 8, 8), dtype="float32")

        def scenario(s):
            s.register("ds-nb2", data, num_partitions=1)
            s.fetch_json("/api/compoundAnalyses/ca-nb2/", method="PUT",
                         body={"dataset": "ds-nb2", "details": {
                             "mainType": "SUM_FRAMES",
                             "analyses": [{"analysisType": "SUM_FRAMES",
                                           "parameters": {}}]}})
            resp = s.fetch(
                "/api/compoundAnalyses/ca-nb2/download/notebook/")
            assert resp.code == 200
            return json.loads(resp.body), resp.headers[
                "Content-Disposition"]

        (jn, jh), (pn, ph) = self.both(scenario)
        assert jh == ph
        same(jn, pn)
        src = "".join("".join(c["source"]) for c in pn["cells"]
                      if c["cell_type"] == "code")
        assert "create_sum_analysis" in src
