"""The server's shared state (counterpart of
``libertem_tpu/web/state.py``): the executor and its Context, the
datasets, analyses, compound analyses and jobs.  "Connecting a
cluster" selects an executor of this process: ``"local"`` every
visible CUDA card (``helpers.create_executor``), ``"inline"`` the
card, ``"tcp"`` a reachable address checked and then the local
executor, as in the JAX package.
"""
from __future__ import annotations

import copy
import itertools
import logging
import os
import socket
import typing
import urllib.parse
from collections import defaultdict
from typing import NamedTuple, Optional

from ..common.snooze import SnoozeMessage
from .event_bus import EventBus
from .messages import Message

log = logging.getLogger(__name__)


class AnalysisResultInfo(NamedTuple):
    """Cached results of a finished analysis job."""
    details: dict
    results: typing.Any
    job_id: str
    udf_results: typing.Any


def _check_tcp_reachable(address: str):
    """'tcp://host:port' must accept a connection: a bad scheduler
    address fails fast."""
    parsed = urllib.parse.urlparse(address)
    host, port = parsed.hostname, parsed.port
    if host is None or port is None:
        raise ValueError(
            f"invalid scheduler address: {address!r}"
        )
    with socket.create_connection((host, port), timeout=5):
        pass


class ExecutorState:
    """Executor lifecycle for the web API.  Call :meth:`shutdown`
    explicitly to clean up."""

    def __init__(self, event_bus: Optional[EventBus] = None,
                 loop=None, snooze_timeout: Optional[float] = None):
        self.executor = None  # AsyncAdapter
        self.cluster_params: dict = {}
        self.cluster_details = None
        self.context = None
        self._event_bus = event_bus if event_bus is not None \
            else EventBus()
        self._snooze_timeout = snooze_timeout
        self._loop = loop
        self.local_directory = "libertem-tpu-torch-scratch"
        self.preload: tuple = ()

    # -- preload / scratch dir --------------------------------------

    def set_preload(self, preload) -> None:
        self.preload = tuple(preload)

    def get_preload(self):
        return self.preload

    def set_local_directory(self, local_directory) -> None:
        if local_directory is not None:
            self.local_directory = local_directory

    def get_local_directory(self):
        return self.local_directory

    # -- snooze plumbing ---------------------------------------------

    def _snooze_message_callback(self, topic: SnoozeMessage,
                                 msg_dict: dict):
        if topic == SnoozeMessage.SNOOZE:
            self._event_bus.send(Message().snooze("snoozing"))
        elif topic == SnoozeMessage.UNSNOOZE_START:
            self._event_bus.send(Message().unsnooze("unsnoozing"))
        elif topic == SnoozeMessage.UNSNOOZE_DONE:
            self._event_bus.send(
                Message().unsnooze_done("unsnooze done")
            )
        elif topic == SnoozeMessage.UPDATE_ACTIVITY:
            log.debug("_update_last_activity")

    # -- executor lifecycle ------------------------------------------

    async def make_executor(self, params, pool):
        """An AsyncAdapter-wrapped executor from GUI connection
        params: 'tcp' checks that the scheduler address is reachable,
        then runs on the local executor; 'local' every visible card
        (validating numWorkers); 'inline' the card."""
        from ..common.async_utils import sync_to_async
        from ..executor.async_adapter import AsyncAdapter

        connection = params["connection"]
        ctype = connection["type"].lower()
        if ctype == "tcp":
            await sync_to_async(
                _check_tcp_reachable, connection["address"],
                pool=pool,
            )
            from ..executor.sharded import ShardedJobExecutor
            sync_executor = await sync_to_async(
                ShardedJobExecutor.make_local, pool=pool,
            )
        elif ctype == "local":
            from .helpers import create_executor
            sync_executor = await sync_to_async(
                create_executor,
                connection=connection,
                local_directory=self.get_local_directory(),
                preload=self.get_preload(),
                snooze_timeout=self._snooze_timeout,
                pool=pool,
            )
        elif ctype == "inline":
            # one device: the card
            from ..executor.inline import InlineJobExecutor
            sync_executor = InlineJobExecutor()
        else:
            raise ValueError("unknown connection type")
        return AsyncAdapter(wrapped=sync_executor, pool=pool)

    async def get_executor(self):
        if self.executor is None:
            raise RuntimeError("wrong state: executor is None")
        manager = self.executor.snooze_manager
        if manager is not None:
            # unsnoozes if snoozed, resets the idle timer either way
            manager.touch()
        return self.executor

    def have_executor(self) -> bool:
        return self.executor is not None

    async def get_resource_details(self):
        if self.cluster_details is None:
            executor = await self.get_executor()
            self.cluster_details = \
                await executor.get_resource_details()
        return self.cluster_details

    async def get_context(self):
        _ = await self.get_executor()
        return self.context

    def shutdown(self):
        if self.context is not None:
            # Context.close() releases the sync executor and stops
            # its snooze timer
            try:
                self.context.close()
            except Exception:
                log.exception("error closing context on shutdown")
            self.context = None
        self.executor = None

    async def set_executor(self, executor, params):
        """Install a new executor and the params used to create it;
        ownership transfers here."""
        if self.executor is not None:
            old_ctx, self.context = self.context, None
            if old_ctx is not None:
                try:
                    old_ctx.close()
                except Exception:
                    log.exception("error closing replaced context")
            self.executor = None
        self._set_executor(executor, params)

    def _set_executor(self, executor, params):
        from ..api import Context
        self.executor = executor
        self.cluster_params = params
        self.cluster_details = None
        self.context = Context(
            executor=executor.ensure_sync(),
            snooze_timeout=self._snooze_timeout,
        )
        if self.context.snooze_manager is not None:
            self.context.snooze_manager.subscribe(
                (
                    SnoozeMessage.SNOOZE,
                    SnoozeMessage.UNSNOOZE_START,
                    SnoozeMessage.UNSNOOZE_DONE,
                    SnoozeMessage.UPDATE_ACTIVITY,
                ),
                self._snooze_message_callback,
            )

    def get_cluster_params(self):
        if (
            self.executor is not None
            and self.executor.snooze_manager is not None
        ):
            self.executor.snooze_manager._update_last_activity()
        return self.cluster_params


class AnalysisState:
    """The analyses by uuid, and the results of their last job."""

    def __init__(self, executor_state: ExecutorState,
                 job_state: "JobState"):
        self.analyses: dict = {}
        self.results: dict = {}
        self.job_state = job_state

    def create(self, uuid: str, dataset_uuid: str,
               analysis_type: str, parameters: dict) -> None:
        assert uuid not in self.analyses
        self.analyses[uuid] = {
            "dataset": dataset_uuid,
            "analysis": uuid,
            "jobs": [],
            "details": {
                "analysisType": analysis_type,
                "parameters": parameters,
            },
        }

    def add_job(self, analysis_id: str, job_id: str) -> None:
        self.analyses[analysis_id]["jobs"].append(job_id)

    def update(self, uuid: str, analysis_type: str,
               parameters: dict) -> None:
        self.analyses[uuid]["details"]["parameters"] = parameters
        self.analyses[uuid]["details"]["analysisType"] = analysis_type

    def get(self, uuid: str, default=None):
        return self.analyses.get(uuid, default)

    def filter(self, predicate) -> list:
        return [
            analysis for analysis in self.analyses.values()
            if predicate(analysis)
        ]

    async def remove(self, uuid: str) -> bool:
        if uuid not in self.analyses:
            return False
        if uuid in self.results:
            self.remove_results(uuid)
        await self.remove_jobs(uuid)
        del self.analyses[uuid]
        return True

    async def remove_jobs(self, uuid: str) -> None:
        jobs = copy.copy(self.job_state.get_for_analysis_id(uuid))
        for job_id in jobs:
            await self.job_state.remove(job_id)

    def remove_results(self, uuid: str) -> None:
        del self.results[uuid]

    def set_results(self, analysis_id: str, details: dict, results,
                    job_id: str, udf_results) -> None:
        self.results[analysis_id] = AnalysisResultInfo(
            copy.deepcopy(details), results, job_id, udf_results,
        )

    def have_results(self, analysis_id: str) -> bool:
        return analysis_id in self.results

    def get_results(self, analysis_id: str) -> AnalysisResultInfo:
        return self.results[analysis_id]

    def get_all_results(self):
        return self.results.items()

    def __getitem__(self, analysis_id: str) -> dict:
        return self.analyses[analysis_id]

    def __contains__(self, analysis_id: str) -> bool:
        return analysis_id in self.analyses

    def serialize(self, analysis_id: str) -> dict:
        result = copy.copy(self[analysis_id])
        result["jobs"] = [
            job_id for job_id in result["jobs"]
            if not self.job_state.is_cancelled(job_id)
        ]
        return result

    def serialize_all(self) -> list:
        return [
            self.serialize(analysis_id)
            for analysis_id in self.analyses
        ]


class CompoundAnalysisState:
    """The compound analyses (the GUI's analysis cards) by uuid."""

    def __init__(self, analysis_state: AnalysisState):
        self.analysis_state = analysis_state
        self.analyses: dict = {}

    def create_or_update(self, uuid: str, main_type: str,
                         dataset_id: str, analyses: list) -> bool:
        created = uuid not in self.analyses
        self.analyses[uuid] = {
            "dataset": dataset_id,
            "compoundAnalysis": uuid,
            "details": {
                "mainType": main_type,
                "analyses": analyses,
            },
        }
        return created

    def remove(self, uuid: str) -> None:
        del self.analyses[uuid]

    def __getitem__(self, uuid: str) -> dict:
        return self.analyses[uuid]

    def __contains__(self, uuid: str) -> bool:
        return uuid in self.analyses

    def filter(self, predicate) -> list:
        return [ca for ca in self.analyses.values() if predicate(ca)]

    def serialize(self, uuid: str) -> dict:
        return self[uuid]

    def serialize_all(self) -> list:
        return [self.serialize(uuid) for uuid in self.analyses]


class DatasetState:
    """The open datasets by uuid, with the params they were opened
    with."""

    def __init__(self, executor_state: ExecutorState,
                 analysis_state: AnalysisState,
                 compound_analysis_state: CompoundAnalysisState):
        self.datasets: dict = {}
        self.dataset_to_id: dict = {}
        self.executor_state = executor_state
        self.analysis_state = analysis_state
        self.compound_analysis_state = compound_analysis_state

    def register(self, uuid: str, dataset, params: dict,
                 converted: dict):
        assert uuid not in self.datasets
        self.datasets[uuid] = {
            "dataset": dataset,
            "params": params,
            "converted": converted,
        }
        self.dataset_to_id[dataset] = uuid
        return self

    async def serialize(self, dataset_id: str) -> dict:
        executor = await self.executor_state.get_executor()
        dataset = self.datasets[dataset_id]
        diag = await executor.run_function(
            lambda: dataset["dataset"].diagnostics
        )
        return {
            "id": dataset_id,
            "params": {
                **dataset["params"]["params"],
                "shape": tuple(dataset["dataset"].shape),
            },
            "diagnostics": diag,
        }

    async def serialize_all(self) -> list:
        return [
            await self.serialize(dataset_id)
            for dataset_id in self.datasets.keys()
        ]

    def id_for_dataset(self, dataset) -> str:
        return self.dataset_to_id[dataset]

    def __getitem__(self, uuid: str):
        return self.datasets[uuid]["dataset"]

    def __contains__(self, uuid: str) -> bool:
        return uuid in self.datasets

    async def verify(self):
        from ..io.dataset.base import DataSetException
        executor = await self.executor_state.get_executor()
        for uuid, params in list(self.datasets.items()):
            dataset = params["dataset"]
            try:
                await executor.run_function(dataset.check_valid)
            except DataSetException:
                await self.remove(uuid)

    async def remove(self, uuid: str):
        """Remove the dataset and every analysis and compound analysis
        (and their jobs) attached to it."""
        ds = self.datasets[uuid]["dataset"]
        analyses = self.analysis_state.filter(
            lambda a: a["dataset"] == uuid
        )
        compound_analyses = self.compound_analysis_state.filter(
            lambda ca: ca["dataset"] == uuid
        )
        del self.datasets[uuid]
        self.dataset_to_id.pop(ds, None)
        for analysis in analyses:
            await self.analysis_state.remove(analysis["analysis"])
        for ca in compound_analyses:
            self.compound_analysis_state.remove(
                ca["compoundAnalysis"]
            )

    remove_dataset = remove


class JobState:
    """The jobs by uuid.  A removed job is a cancelled job
    (``is_cancelled``: not registered)."""

    def __init__(self, executor_state: ExecutorState):
        self.jobs: dict = {}
        self.executor_state = executor_state
        self.jobs_for_dataset = defaultdict(set)
        self.jobs_for_analyses = defaultdict(set)

    def register(self, job_id: str, analysis_id: str,
                 dataset_id: str):
        assert job_id not in self.jobs
        self.jobs[job_id] = {
            "id": job_id,
            "analysis": analysis_id,
            "dataset": dataset_id,
        }
        self.jobs_for_dataset[dataset_id].add(job_id)
        self.jobs_for_analyses[analysis_id].add(job_id)
        return self

    async def remove(self, uuid: str) -> bool:
        try:
            executor = await self.executor_state.get_executor()
            await executor.cancel(uuid)
            del self.jobs[uuid]
            for ds, jobs in itertools.chain(
                self.jobs_for_dataset.items(),
                self.jobs_for_analyses.items(),
            ):
                if uuid in jobs:
                    jobs.remove(uuid)
            return True
        except KeyError:
            return False

    def get_for_dataset_id(self, dataset_id: str) -> set:
        return self.jobs_for_dataset[dataset_id]

    def get_for_analysis_id(self, analysis_id: str) -> set:
        return self.jobs_for_analyses[analysis_id]

    def __getitem__(self, uuid: str) -> dict:
        return self.jobs[uuid]

    def __contains__(self, uuid: str) -> bool:
        return uuid in self.jobs

    def is_cancelled(self, uuid: str) -> bool:
        return uuid not in self.jobs

    def serialize(self, job_id: str) -> dict:
        job = self[job_id]
        return {"id": job["id"], "analysis": job["analysis"]}

    def serialize_all(self) -> list:
        return [self.serialize(job_id) for job_id in self.jobs]


class SharedState:
    """Everything the handlers and the engine share."""

    def __init__(self,
                 executor_state: Optional[ExecutorState] = None):
        if executor_state is None:
            executor_state = ExecutorState(event_bus=EventBus())
        self.executor_state = executor_state
        self.job_state = JobState(self.executor_state)
        self.analysis_state = AnalysisState(
            self.executor_state, job_state=self.job_state,
        )
        self.compound_analysis_state = CompoundAnalysisState(
            self.analysis_state
        )
        self.dataset_state = DatasetState(
            self.executor_state,
            analysis_state=self.analysis_state,
            compound_analysis_state=self.compound_analysis_state,
        )

    def get_local_cores(self, default: int = 2) -> int:
        try:
            import psutil
            cores = psutil.cpu_count(logical=False)
        except Exception:
            cores = None
        if cores is None:
            cores = os.cpu_count() or default
        return cores

    def get_ds_type_info(self, ds_type_id: str) -> dict:
        from ..io.dataset import get_dataset_cls
        cls = get_dataset_cls(ds_type_id)
        converter_cls = cls.get_msg_converter()
        schema = (
            converter_cls().SCHEMA if converter_cls is not None
            else {"type": "object", "properties": {}}
        )
        supported = cls.get_supported_io_backends()
        default_backend = cls.get_default_io_backend()
        if not supported:
            default_backend = None
        return {
            "schema": schema,
            "default_io_backend": default_backend,
            "supported_io_backends": supported,
        }

    def _ds_type_info_or_none(self, ds_type_id: str):
        # a format whose backing module can't import in this env
        # (e.g. dask absent) must not break the config endpoint
        try:
            return self.get_ds_type_info(ds_type_id)
        except Exception:
            return None

    def get_config(self) -> dict:
        from .. import __version__
        from ..io.dataset import filetypes
        from ..io.writers import ResultFormat
        from ..utils import devices
        detected = devices.detect()
        return {
            "version": __version__,
            "resultFileFormats":
                ResultFormat.get_available_formats(),
            "revision": "",
            "localCores": self.get_local_cores(),
            "devices": detected,
            "datasetTypes": {
                ds_type_id.upper(): info
                for ds_type_id in filetypes.keys()
                if (info := self._ds_type_info_or_none(ds_type_id))
                is not None
            },
            "cwd": os.getcwd(),
            # '/' works on Windows, too
            "separator": "/",
        }

    async def create_and_set_executor(self, spec: dict):
        """Create and install an executor from a --cpus/--cudas style
        spec."""
        from .helpers import create_executor_external
        executor, params = create_executor_external(
            spec,
            self.executor_state.get_local_directory(),
            self.executor_state.get_preload(),
            snooze_timeout=self.executor_state._snooze_timeout,
        )
        self.executor_state._set_executor(executor, params)
