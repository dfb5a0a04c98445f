"""Tornado web API server (counterpart of
``libertem_tpu/web/server.py``): the JAX package's REST and websocket
protocol, word for word, with the port's engine behind it.  Jobs run
on the connected executor's devices: every visible CUDA card for a
``"local"`` connection.  tornado is imported here and nowhere else.

REST + websocket protocol:
  GET  /api/config/                         server/config info
  GET  /api/config/cluster/                 per-host resource rows
  GET/PUT /api/config/connection/           executor lifecycle
  GET  /api/datasets/detect/?path=          format auto-detection
  GET  /api/datasets/schema/                per-format open schemas
  PUT  /api/datasets/<uuid>/                open a dataset
  DELETE /api/datasets/<uuid>/              close
  PUT  /api/compoundAnalyses/<cuuid>/       create/update compound
  PUT  .../analyses/<uuid>/                 create/update analysis
  GET  .../analyses/<uuid>/download/<FMT>/  download results
  PUT  /api/compoundAnalyses/<cuuid>/rpc/<proc>/   analysis RPC
  GET  /api/compoundAnalyses/<cuuid>/copy/notebook/     code cells
  GET  /api/compoundAnalyses/<cuuid>/download/notebook/ .ipynb
  PUT  /api/jobs/<uuid>/                    start analysis job
  DELETE /api/jobs/<uuid>/                  cancel
  GET  /api/browse/localfs/?path=           filesystem browser
  GET  /api/browse/localfs/stat/?path=      stat one path
  DELETE /api/shutdown/                     stop the server
  WS   /api/events/                         state + result stream

Result images are streamed as binary PNG websocket frames following
a TASK_RESULT/FINISH_JOB JSON header carrying the followup count.
"""
from __future__ import annotations

import asyncio
import hashlib
import hmac
import io
import json
import logging
import os
import stat as stat_mod
from typing import Optional

import tornado.escape
import tornado.ioloop
import tornado.web
import tornado.websocket

from .engine import JobEngine
from .messages import Message
from .state import SharedState
from .rpc import RPCContext

log = logging.getLogger(__name__)


class EventRegistry:
    """Connected websocket clients and broadcast."""

    # a client whose TCP window closed without erroring accumulates
    # outgoing buffer; above this many queued bytes it is dropped
    # instead of growing server RSS unboundedly
    MAX_CLIENT_BACKLOG = 64 * 1024 * 1024

    def __init__(self):
        self.handlers: list = []

    def add_handler(self, h):
        self.handlers.append(h)

    def remove_handler(self, h):
        if h in self.handlers:
            self.handlers.remove(h)

    def _backlogged(self, h) -> bool:
        try:
            stream = h.ws_connection.stream
            return (
                stream.writing()
                and len(stream._write_buffer)
                > self.MAX_CLIENT_BACKLOG
            )
        except Exception:
            return False

    def broadcast_event(self, message, binary: bool = False):
        """Send to every client; returns an awaitable gathering the
        per-client writes."""
        if isinstance(message, (dict, list)):
            payload = json.dumps(message)
        else:
            payload = message
        futures = []
        for handler in list(self.handlers):
            if self._backlogged(handler):
                log.warning(
                    "dropping websocket client with >%d MB backlog",
                    self.MAX_CLIENT_BACKLOG // (1024 * 1024),
                )
                self.remove_handler(handler)
                try:
                    handler.close()
                except Exception:
                    pass
                continue
            try:
                futures.append(
                    handler.write_message(payload, binary=binary)
                )
            except tornado.websocket.WebSocketClosedError:
                self.remove_handler(handler)
        return asyncio.gather(*futures, return_exceptions=True)

    async def broadcast(self, message):
        await self.broadcast_event(message)

    async def broadcast_binary(self, payload: bytes):
        await self.broadcast_event(payload, binary=True)


def _get_token(request) -> str:
    token = request.query_arguments.get("token", [b""])[0] \
        .decode("utf-8")
    if not token:
        token = request.headers.get("X-Api-Key", "")
    return token


class CheckTokenAuthApp(tornado.web.Application):
    """Application-level token gate: every request (REST, static,
    websocket handshake) 403s without the right token."""

    def __init__(self, *args, auth_token=None, **kwargs):
        if auth_token is None:
            self._auth_token_hash = None
        else:
            self._auth_token_hash = hashlib.sha256(
                auth_token.encode("utf8")
            ).hexdigest()
        super().__init__(*args, **kwargs)

    def find_handler(self, request, **kwargs):
        from tornado.web import ErrorHandler
        if self._auth_token_hash is not None:
            given = hashlib.sha256(
                _get_token(request).encode("utf8")
            ).hexdigest()
            if not hmac.compare_digest(given, self._auth_token_hash):
                return self.get_handler_delegate(
                    request, ErrorHandler, {"status_code": 403}
                )
        return super().find_handler(request, **kwargs)


class _BaseHandler(tornado.web.RequestHandler):
    def initialize(self, state: SharedState, registry: EventRegistry,
                   engine: JobEngine):
        self.state = state
        self.registry = registry
        self.engine = engine

    def write_json(self, obj):
        self.set_header("Content-Type", "application/json")
        self.write(json.dumps(obj))


class ConfigHandler(_BaseHandler):
    def get(self):
        self.write_json(
            Message().config(config=self.state.get_config())
        )


class ClusterDetailHandler(_BaseHandler):
    async def get(self):
        details = \
            await self.state.executor_state.get_resource_details()
        self.write_json(Message().cluster_details(details=details))


class ConnectionHandler(_BaseHandler):
    """Executor lifecycle over REST: 'connecting a cluster' selects
    an executor of this process (``state.ExecutorState``); a 'tcp'
    address is checked for reachability."""

    async def get(self):
        try:
            await self.state.executor_state.get_executor()
            params = self.state.executor_state.get_cluster_params()
            self.write_json({
                "status": "ok",
                "connection": params["connection"],
            })
        except RuntimeError:
            self.write_json({
                "status": "disconnected",
                "connection": {},
            })

    async def put(self):
        request_data = tornado.escape.json_decode(self.request.body)
        from ..executor.async_adapter import AsyncAdapter
        pool = AsyncAdapter.make_pool()
        try:
            executor = await self.state.executor_state.make_executor(
                request_data, pool
            )
        except Exception as e:
            msg = Message().cluster_conn_error(msg=str(e))
            self.set_status(500)
            self.write_json(msg)
            return
        await self.state.executor_state.set_executor(
            executor, request_data
        )
        await self.state.dataset_state.verify()
        datasets = await self.state.dataset_state.serialize_all()
        msg = Message().initial_state(
            jobs=self.state.job_state.serialize_all(),
            datasets=datasets,
            analyses=self.state.analysis_state.serialize_all(),
            compound_analyses=(
                self.state.compound_analysis_state.serialize_all()
            ),
        )
        self.registry.broadcast_event(msg)
        await self.engine.send_existing_job_results()
        self.write_json({
            "status": "ok",
            "connection": request_data["connection"],
        })


class DataSetSchemaHandler(_BaseHandler):
    """GUI open-form schemas, one per registered format: the forms
    are driven by the server's MessageConverter schemas
    (``io/dataset/converters.py``), so format and form cannot drift
    apart."""

    def get(self):
        from ..io.dataset.converters import CONVERTERS
        schemas = {}
        for type_id, cls in CONVERTERS.items():
            conv = cls()
            schemas[type_id] = {
                "schema": conv.SCHEMA,
                "required": list(
                    conv.SCHEMA.get("required", ())
                ),
            }
        self.write_json({
            "status": "ok",
            "messageType": "DATASET_SCHEMAS",
            "schemas": schemas,
        })


class DataSetDetectHandler(_BaseHandler):
    async def get(self):
        path = self.get_argument("path")
        from ..io.dataset import detect
        # header probing can read GBs over slow filesystems: keep it
        # off the event loop
        detected = await self.engine.run_sync(detect, path)
        if not detected:
            self.write_json(Message().dataset_detect_failed(path))
            return
        params = dict(detected["parameters"])
        info = dict(detected.get("info", {}))
        params["type"] = detected["type"].upper()
        info["type"] = detected["type"].upper()
        self.write_json(
            Message().dataset_detect(params=params, info=info)
        )


class DataSetDetailHandler(_BaseHandler):
    async def put(self, uuid: str):
        request_data = tornado.escape.json_decode(self.request.body)
        params = request_data["dataset"]["params"]
        params["type"] = ds_type = params["type"].upper()
        try:
            from ..io.dataset.converters import get_converter
            conv_cls = get_converter(ds_type)
            if conv_cls is not None:
                converted = conv_cls().to_python(params)
            else:
                converted = {
                    k: tuple(v) if k in ("nav_shape", "sig_shape")
                    and v is not None else v
                    for k, v in params.items() if k != "type"
                }
            ctx = await self.state.executor_state.get_context()
            # dataset initialize can scan GBs of headers: keep it
            # off the event loop
            ds = await self.engine.run_sync(
                lambda: ctx.load(ds_type.lower(), **converted)
            )
            # the first job must not wait for nvcc
            await self.engine.run_sync(
                prime_numba_cache, ds, ctx.executor.devices
            )
            if uuid in self.state.dataset_state:
                # re-opening an existing uuid replaces the dataset;
                # stale analyses/results must not survive
                await self.state.dataset_state.remove(uuid)
            self.state.dataset_state.register(
                uuid=uuid, dataset=ds,
                params=request_data["dataset"],
                converted=converted,
            )
            details = await self.state.dataset_state.serialize(uuid)
            msg = Message().create_dataset(
                dataset=uuid, details=details
            )
            self.write_json(msg)
            self.registry.broadcast_event(msg)
        except Exception as e:
            log.exception("error creating dataset %s", uuid)
            if uuid in self.state.dataset_state:
                await self.state.dataset_state.remove(uuid)
            self.write_json(
                Message().create_dataset_error(uuid, str(e))
            )

    async def delete(self, uuid: str):
        if uuid not in self.state.dataset_state:
            self.set_status(
                404, "dataset with uuid %s not found" % uuid
            )
            return
        await self.state.dataset_state.remove(uuid)
        msg = Message().delete_dataset(uuid)
        self.registry.broadcast_event(msg)
        self.write_json(msg)


class CompoundAnalysisHandler(_BaseHandler):
    async def put(self, uuid: str):
        request_data = tornado.escape.json_decode(self.request.body)
        dataset_id = request_data["dataset"]
        details = request_data["details"]
        created = self.state.compound_analysis_state.create_or_update(
            uuid, details["mainType"], dataset_id,
            details["analyses"],
        )
        serialized = \
            self.state.compound_analysis_state.serialize(uuid)
        if created:
            msg = Message().compound_analysis_created(serialized)
        else:
            msg = Message().compound_analysis_updated(serialized)
        self.registry.broadcast_event(msg)
        self.write_json(msg)

    async def delete(self, uuid: str):
        ca = self.state.compound_analysis_state[uuid]
        for analysis_id in ca["details"]["analyses"]:
            removed = await self.state.analysis_state.remove(
                analysis_id
            )
            if removed:
                msg = Message().analysis_removed(analysis_id)
            else:
                msg = Message().analysis_removal_failed(
                    analysis_id, "analysis could not be removed"
                )
            self.registry.broadcast_event(msg)
        self.state.compound_analysis_state.remove(uuid)
        msg = Message().compound_analysis_removed(uuid)
        self.registry.broadcast_event(msg)
        self.write_json(msg)


class AnalysisDetailHandler(_BaseHandler):
    async def put(self, compound_uuid: str, uuid: str):
        request_data = tornado.escape.json_decode(self.request.body)
        dataset_id = request_data["dataset"]
        details = request_data["details"]
        params = details["parameters"]
        analysis_type = details["analysisType"]
        existing = self.state.analysis_state.get(uuid)
        if existing is None:
            self.state.analysis_state.create(
                uuid, dataset_id, analysis_type, params
            )
            msg = Message().create_analysis(
                uuid, dataset_id, analysis_type, params
            )
        else:
            self.state.analysis_state.update(
                uuid, analysis_type, params
            )
            msg = Message().update_analysis(
                uuid, dataset_id, analysis_type, params
            )
        self.registry.broadcast_event(msg)
        self.write_json(msg)

    async def delete(self, compound_uuid: str, uuid: str):
        removed = await self.state.analysis_state.remove(uuid)
        if removed:
            msg = Message().analysis_removed(uuid)
        else:
            msg = Message().analysis_removal_failed(
                uuid, "analysis could not be removed"
            )
        self.registry.broadcast_event(msg)
        self.write_json(msg)


class JobDetailHandler(_BaseHandler):
    async def put(self, job_id: str):
        request_data = tornado.escape.json_decode(self.request.body)
        analysis_id = request_data["job"]["analysis"]
        await self.engine.register_job(analysis_id, job_id)
        serialized_job = self.state.job_state.serialize(job_id)
        msg = Message().start_job(
            serialized_job=serialized_job, analysis_id=analysis_id,
        )
        self.write_json(msg)
        await self.finish()
        await self.engine.run_analysis(analysis_id, job_id)

    async def delete(self, job_id: str):
        removed = await self.state.job_state.remove(job_id)
        if removed:
            msg = Message().cancel_job(job_id)
        else:
            log.warning("tried to remove unknown job %s", job_id)
            msg = Message().cancel_failed(job_id)
        self.registry.broadcast_event(msg)
        self.write_json(msg)


class DownloadDetailHandler(_BaseHandler):
    async def get(self, compound_uuid: str, uuid: str,
                  file_format_id: str):
        from ..io.writers import ResultFormat
        info = self.state.analysis_state.get_results(uuid)
        fmt_cls = ResultFormat.registry[file_format_id.upper()]
        formatter = fmt_cls({
            r.key: r for r in info.results
        })
        buf = io.BytesIO()
        # serialization reads device buffers / encodes: off-loop
        await self.engine.run_sync(formatter.serialize_to, buf)
        buf.seek(0)
        self.set_header(
            "Content-Type", "application/octet-stream"
        )
        self.set_header(
            "Content-Disposition",
            f'attachment; filename="result.{fmt_cls.extension}"',
        )
        self.write(buf.read())


class AnalysisRPCHandler(_BaseHandler):
    """Compound-analysis RPC procedures, e.g. CoM parameter
    guessing."""

    async def put(self, compound_analysis_id: str, proc_name: str):
        import inspect
        from ..analysis.base import Analysis
        rpc_context = RPCContext(
            state=self.state,
            compound_analysis_id=compound_analysis_id,
            engine=self.engine,
        )
        try:
            comp_ana = rpc_context.get_compound_analysis()
        except KeyError:
            self.set_status(404, "unknown compound analysis")
            self.write_json({
                "status": "error",
                "msg": "unknown compound analysis",
            })
            return
        ana_type = comp_ana["details"]["mainType"]
        analysis_cls = Analysis.get_analysis_by_type(ana_type)
        rpc_def = analysis_cls.get_rpc_definitions()
        if proc_name not in rpc_def:
            self.set_status(400, "Bad request: unknown RPC method")
            self.write_json({
                "status": "error",
                "msg": "unknown RPC method",
            })
            return
        proc = rpc_def[proc_name]()
        if inspect.iscoroutinefunction(proc.__call__):
            result = await proc(rpc_context)
        else:
            result = proc(rpc_context)
        self.write_json(result)

    get = put


class NotebookDownloadHandler(_BaseHandler):
    async def get(self, compound_uuid: str):
        from .notebook_generator import notebook_for, \
            notebook_to_bytes
        ds_type, ds_params, analyses, ds_name = \
            _collect_notebook_inputs(self.state, compound_uuid)
        nb = notebook_for(ds_type, ds_params, analyses)
        self.set_header(
            "Content-Type", "application/x-ipynb+json"
        )
        self.set_header(
            "Content-Disposition",
            f'attachment; filename="{ds_name}.ipynb"',
        )
        self.write(notebook_to_bytes(nb))


class CopyScriptHandler(_BaseHandler):
    async def get(self, compound_uuid: str):
        from .notebook_generator import copy_notebook
        ds_type, ds_params, analyses, _ = \
            _collect_notebook_inputs(self.state, compound_uuid)
        conn = self.state.executor_state.get_cluster_params()
        self.write_json(
            copy_notebook(conn, ds_type, ds_params, analyses)
        )


def _collect_notebook_inputs(state: SharedState,
                             compound_uuid: str):
    """(ds_type, loader params, analysis details list, filename
    stem) for a compound analysis."""
    ca = state.compound_analysis_state[compound_uuid]
    listed = ca["details"].get("analyses", [])
    analysis_ids = [
        a for a in listed
        if isinstance(a, str) and a in state.analysis_state
    ]
    # tolerated protocol variant: inline analysis detail dicts
    # instead of analysis uuids
    inline = [
        a for a in listed
        if isinstance(a, dict) and "analysisType" in a
    ]
    if analysis_ids:
        ds_id = state.analysis_state[analysis_ids[0]]["dataset"]
    else:
        ds_id = ca["dataset"]
    entry = state.dataset_state.datasets[ds_id]
    raw_params = entry["params"]["params"]
    ds_type = raw_params.get("type", "MEMORY")
    analyses = [
        state.analysis_state[a]["details"] for a in analysis_ids
    ] + inline
    if not analyses:
        analyses = [
            e["details"]
            for e in state.analysis_state.analyses.values()
            if e["dataset"] == ds_id
        ]
    main_type = ca["details"].get("mainType", "analysis").lower()
    ds_name = "{}_{}".format(
        main_type, raw_params.get("name", "dataset"),
    )
    return ds_type, entry["converted"], analyses, ds_name


def prime_numba_cache(ds, devices=()):
    """Build and load the CUDA kernels ahead of the first GUI job on
    a card (the JAX package's hook of this name has nothing to
    compile ahead of a run): ``ops/build.py`` compiles the fused
    kernel's sources (``ops.moments.LIBRARIES``) with nvcc, at once,
    unless current libraries are in ``build/``.  Nothing happens where
    no device is a CUDA one."""
    import torch

    if any(torch.device(d).type == "cuda" for d in devices):
        from ..ops import build
        from ..ops.moments import LIBRARIES
        build.build(LIBRARIES)


class BrowseHandler(_BaseHandler):
    async def get(self):
        from ..io.fs import FSError, get_fs_listing
        path = self.get_argument("path")
        try:
            # a large NFS directory must not stall the event loop
            listing = await self.engine.run_sync(
                get_fs_listing, path
            )
        except FSError as e:
            # offer the nearest accessible ancestor so the GUI can
            # recover
            self.write_json(Message().browse_failed(
                path, code=e.code, msg=str(e.args[0]),
                alternative=e.alternative,
            ))
            return
        self.write_json(Message().directory_listing(
            path, files=listing["files"], dirs=listing["dirs"],
            drives=listing["drives"], places=listing["places"],
        ))


class StatHandler(_BaseHandler):
    async def get(self):
        path = self.get_argument("path")
        try:
            st = await self.engine.run_sync(os.stat, path)
        except OSError as e:
            self.write_json(Message().stat_failed(
                path, code="NOT_FOUND", msg=str(e),
            ))
            return
        # a directory given without a trailing separator stats as
        # dirname == itself
        if stat_mod.S_ISDIR(st.st_mode) and \
                not path.endswith(os.path.sep):
            path_slash = path + os.path.sep
        else:
            path_slash = path
        self.write_json(Message().browse_stat_result(
            path=path,
            dirname=os.path.dirname(path_slash),
            basename=os.path.basename(path_slash),
            stat_result=st,
        ))


class ShutdownHandler(_BaseHandler):
    async def delete(self):
        log.info("Handling shutdown request")
        self.state.executor_state.shutdown()
        self.set_header("Content-Type", "application/json")
        await self.finish(json.dumps({
            "status": "ok", "messageType": "SERVER_SHUTDOWN",
        }))
        tornado.ioloop.IOLoop.current().stop()


class ResultEventHandler(tornado.websocket.WebSocketHandler):
    def initialize(self, state, registry, engine):
        self.state = state
        self.registry = registry
        self.engine = engine

    def check_origin(self, origin):
        # Tornado's same-origin check: without it any website open
        # in the browser could connect cross-origin to the localhost
        # GUI websocket.  A configured token is an explicit
        # cross-origin credential.
        app = self.application
        if getattr(app, "_auth_token_hash", None) is not None:
            return True
        return super().check_origin(origin)

    async def open(self):
        self.registry.add_handler(self)
        if self.state.executor_state.have_executor():
            await self.state.dataset_state.verify()
            datasets = \
                await self.state.dataset_state.serialize_all()
            msg = Message().initial_state(
                jobs=self.state.job_state.serialize_all(),
                datasets=datasets,
                analyses=self.state.analysis_state.serialize_all(),
                compound_analyses=(
                    self.state.compound_analysis_state
                        .serialize_all()
                ),
            )
            await self.write_message(json.dumps(msg))
            await self.engine.send_existing_job_results()

    def on_close(self):
        self.registry.remove_handler(self)

    def on_message(self, message):
        pass


# the handler names of the JAX package's reference layout
ConnectHandler = ConnectionHandler
LocalFSBrowseHandler = BrowseHandler
LocalFSStatHandler = StatHandler


def make_app(event_registry: Optional[EventRegistry] = None,
             shared_state: Optional[SharedState] = None,
             token: Optional[str] = None, *,
             state: Optional[SharedState] = None
             ) -> tornado.web.Application:
    """Assemble the web application; ``state=`` is a keyword alias
    of ``shared_state``."""
    if shared_state is None:
        shared_state = state
    if shared_state is None:
        shared_state = SharedState()
    if event_registry is None:
        event_registry = EventRegistry()
    engine = JobEngine(shared_state, event_registry)
    common = dict(
        state=shared_state, registry=event_registry, engine=engine,
    )
    client_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "client"
    )
    app = CheckTokenAuthApp([
        (r"/api/config/", ConfigHandler, common),
        (r"/api/config/cluster/", ClusterDetailHandler, common),
        (r"/api/config/connection/", ConnectionHandler, common),
        (r"/api/datasets/detect/", DataSetDetectHandler, common),
        (r"/api/datasets/schema/", DataSetSchemaHandler, common),
        (r"/api/datasets/([^/]+)/", DataSetDetailHandler, common),
        (r"/api/compoundAnalyses/([^/]+)/analyses/([^/]+)/download/"
         r"([^/]+)/", DownloadDetailHandler, common),
        (r"/api/compoundAnalyses/([^/]+)/analyses/([^/]+)/",
         AnalysisDetailHandler, common),
        (r"/api/compoundAnalyses/([^/]+)/rpc/([^/]+)/",
         AnalysisRPCHandler, common),
        (r"/api/compoundAnalyses/([^/]+)/copy/notebook/",
         CopyScriptHandler, common),
        (r"/api/compoundAnalyses/([^/]+)/download/notebook/",
         NotebookDownloadHandler, common),
        (r"/api/compoundAnalyses/([^/]+)/", CompoundAnalysisHandler,
         common),
        (r"/api/jobs/([^/]+)/", JobDetailHandler, common),
        (r"/api/browse/localfs/stat/", StatHandler, common),
        (r"/api/browse/localfs/", BrowseHandler, common),
        (r"/api/shutdown/", ShutdownHandler, common),
        (r"/api/events/", ResultEventHandler, common),
        (r"/()", tornado.web.StaticFileHandler, {
            "path": client_path,
            "default_filename": "index.html",
        }),
    ], auth_token=token)
    app.shared_state = shared_state
    app.event_registry = event_registry
    app.job_engine = engine
    return app


def run_server(host="localhost", port=9000, token=None,
               browser=False, executor_spec=None,
               snooze_timeout=None, local_directory=None,
               preload=(), open_ds=None):
    """Start the server loop (blocks until a shutdown request)."""
    from .event_bus import EventBus, MessagePump
    from .state import ExecutorState

    try:
        loop = asyncio.get_event_loop()
    except RuntimeError:  # pragma: no cover
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

    event_bus = EventBus()
    event_registry = EventRegistry()
    pump = MessagePump(
        event_bus=event_bus, event_registry=event_registry
    )
    executor_state = ExecutorState(
        event_bus=event_bus, snooze_timeout=snooze_timeout,
        loop=loop,
    )
    shared_state = SharedState(executor_state=executor_state)
    executor_state.set_local_directory(local_directory)
    executor_state.set_preload(preload)

    app = make_app(event_registry, shared_state, token)
    app.listen(port, address=host)
    url = f"http://{host}:{port}"
    if open_ds is not None:
        url = f"{url}/#action=open&path={open_ds}"
    # the phrase the JAX package's server logs here
    log.info("\n\n    LiberTEM listening on %s\n", url)

    async def _startup():
        if executor_spec is not None:
            await shared_state.create_and_set_executor(
                executor_spec
            )

    if browser:  # pragma: no cover
        import urllib.parse
        import webbrowser
        burl = url
        if token is not None:
            # the client threads ?token= through every API call; a
            # browser opened without it gets an unusable GUI
            burl += "?token=" + urllib.parse.quote(token)
        webbrowser.open(burl)
    asyncio.ensure_future(pump.run())
    asyncio.ensure_future(_startup())
    try:
        tornado.ioloop.IOLoop.current().start()
    finally:
        executor_state.shutdown()
