"""The executor protocol over torch devices (counterpart of
``libertem_tpu/executor/base.py``).

An executor owns the devices a run may use and runs host functions;
the run itself (the host feed and the fused or generic step) lives in
:class:`libertem_tpu_torch.udf.base.UDFRunner`.  Each process is its
own controller: the workers are the executor's devices, a worker's
resource key is ``"CUDA"`` or ``"CPU"`` from its ``torch.device``, and
the queues and scatter handles below are in-process.  Under a
``torch.distributed`` group of several processes only
``ShardedJobExecutor`` runs across them (its ``global_workers``); the
utility API here reports and runs on this process, as the JAX
package's single-process versions do.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Iterable, Optional, Sequence

import torch

from ..common.backend import resolve_device


class WorkerQueueEmpty(Exception):
    """A non-blocking get on an empty queue, or a blocking get that
    timed out."""


class WorkerQueue:
    """Main <-> worker streaming queue; ``get`` is a context manager
    yielding ``(header, payload)``."""

    def get(self, block: bool = True, timeout=None):
        raise NotImplementedError()

    def put(self, header, payload=None):
        raise NotImplementedError()

    def put_nocopy(self, header, size: int):
        """Context manager yielding a writable memoryview of ``size``
        bytes, enqueued on exit."""
        raise NotImplementedError()

    def close(self, drain: bool = True, force: bool = False):
        raise NotImplementedError()

    def size(self) -> int:
        raise NotImplementedError()


class SimpleWorkerQueue(WorkerQueue):
    """A WorkerQueue over ``queue.Queue``, for threads of one
    process."""

    def __init__(self):
        import queue as _queue
        self._queue_mod = _queue
        self.q = _queue.Queue()

    def put(self, header, payload=None):
        self.q.put((header, payload))

    @contextmanager
    def put_nocopy(self, header, size: int):
        import numpy as _np
        payload = _np.zeros(size, dtype=_np.uint8)
        yield memoryview(payload)
        self.q.put((header, payload))

    @contextmanager
    def get(self, block: bool = True, timeout=None):
        try:
            item = self.q.get(block=block, timeout=timeout)
        except self._queue_mod.Empty:
            raise WorkerQueueEmpty()
        yield item

    def close(self, drain: bool = True, force: bool = False):
        pass

    def size(self) -> int:
        return self.q.qsize()


class SimpleMPWorkerQueue(WorkerQueue):
    """A WorkerQueue over a spawn-context ``multiprocessing.Queue``;
    header and payload cross the process boundary cloudpickled (where
    cloudpickle imports, else pickled).  The port's own loops are one
    process with threads (:class:`SimpleWorkerQueue`)."""

    def __init__(self):
        import multiprocessing as mp
        import queue as _queue
        self._queue_mod = _queue
        self.q = mp.get_context("spawn").Queue()
        self._closed = False

    @staticmethod
    def _dumps(obj):
        try:
            import cloudpickle as pickler
        except ImportError:
            import pickle as pickler
        return pickler.dumps(obj)

    def put(self, header, payload=None):
        self.q.put((self._dumps(header), self._dumps(payload)))

    @contextmanager
    def put_nocopy(self, header, size: int):
        import numpy as _np
        payload = _np.zeros(size, dtype=_np.uint8)
        yield memoryview(payload)
        self.q.put((self._dumps(header), self._dumps(payload)))

    @contextmanager
    def get(self, block: bool = True, timeout=None):
        import pickle
        try:
            res = self.q.get(block=block, timeout=timeout)
        except self._queue_mod.Empty:
            raise WorkerQueueEmpty()
        yield (pickle.loads(res[0]), pickle.loads(res[1]))

    def close(self, drain: bool = True, force: bool = False):
        if self._closed:
            return
        if drain:
            while True:
                try:
                    self.q.get_nowait()
                except self._queue_mod.Empty:
                    break
        self.q.close()
        self._closed = True

    def size(self) -> int:
        return self.q.qsize()


class WorkerContext:
    """Streaming communication handle between main process and
    workers."""

    def get_worker_queue(self) -> WorkerQueue:
        raise NotImplementedError()

    def signal(self, ident: str, topic: str, msg_dict: dict):
        raise NotImplementedError()


class SimpleWorkerContext(WorkerContext):
    """An in-process WorkerContext on one queue: ``signal`` enqueues
    ``(topic, {..., 'ident': ident})``."""

    def __init__(self, queue: WorkerQueue):
        self._queue = queue

    def get_worker_queue(self) -> WorkerQueue:
        return self._queue

    def signal(self, ident: str, topic: str, msg_dict: dict):
        if "ident" in msg_dict:
            raise ValueError("'ident' is a reserved message key")
        self._queue.put((topic, {**msg_dict, "ident": ident}))


class TaskCommHandler:
    """Implemented by datasets that talk to the processing loop:
    messages come back through :meth:`monitor`, live data goes out
    through :meth:`handle_task`."""

    def handle_task(self, task, queue: WorkerQueue):
        pass

    def start(self):
        pass

    def done(self):
        pass

    @property
    def subscriptions(self) -> dict:
        try:
            return self._subscriptions
        except AttributeError:
            self._subscriptions = {}
            return self._subscriptions

    def subscribe(self, topic: str, callback) -> None:
        """``callback(topic, message_dict)`` for messages on ``topic``;
        a message carries its sender under ``'ident'``."""
        self.subscriptions.setdefault(topic, []).append(callback)

    @contextmanager
    def monitor(self, queue: WorkerQueue):
        """Dispatch the queue's messages to the subscribed callbacks
        from a background thread for the duration of the block."""
        from ..common.progress import CommsDispatcher
        with CommsDispatcher(queue, self.subscriptions):
            yield


class NoopCommHandler(TaskCommHandler):
    """A comm handler that streams nothing."""


class JobCancelledError(Exception):
    """The current job was cancelled, raised from inside a task."""


class Environment:
    """What a task learns of where it runs."""

    def __init__(self, threads_per_worker: int = 1,
                 threaded_executor: bool = False, worker_context=None,
                 gpu_id=None, device=None):
        self.threads_per_worker = threads_per_worker
        self.threaded_executor = threaded_executor
        self.worker_context = worker_context
        self.gpu_id = gpu_id
        self.device = device

    def enter(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# resource name -> amount requested or provided
ResourceDef = dict


class TaskProtocol:
    """What an executor expects of a task: callable with
    ``(params, env)``, with its partition and resources."""

    def __call__(self, params, env):
        pass

    def get_partition(self):
        ...

    def get_resources(self) -> dict:
        ...


def _resource_key(device: torch.device) -> str:
    return torch.device(device).type.upper()


class Worker:
    def __init__(self, name: str, host: str, device=None,
                 resources: Optional[dict] = None, nthreads: int = 1):
        self.name = name
        self.host = host
        self.device = device
        self.resources = {} if resources is None else resources
        self.nthreads = nthreads

    def __eq__(self, other) -> bool:
        if not isinstance(other, Worker):
            return NotImplemented
        return (self.name == other.name and self.host == other.host
                and self.device == other.device
                and self.resources == other.resources
                and self.nthreads == other.nthreads)

    def __hash__(self):
        return hash((self.name, self.host))

    def __repr__(self):
        return f"<Worker {self.name} device={self.device}>"


class WorkerSet:
    def __init__(self, workers: Sequence[Worker]):
        self.workers = list(workers)

    def __len__(self):
        return len(self.workers)

    def __iter__(self):
        return iter(self.workers)

    def __eq__(self, other) -> bool:
        if not isinstance(other, WorkerSet):
            return NotImplemented
        return self.workers == other.workers

    def extend(self, other: "WorkerSet") -> "WorkerSet":
        return WorkerSet(self.workers + list(other))

    def has_cuda(self) -> bool:
        """Whether a worker runs on a CUDA device."""
        return any(w.device is not None
                   and torch.device(w.device).type == "cuda"
                   for w in self.workers)

    def has_tpu(self) -> bool:
        """The JAX package's name: no worker of the port is a TPU."""
        return False

    def hosts(self) -> set:
        return {w.host for w in self.workers}


class _ScatterHandle:
    """An in-process handle of a scattered object."""

    def __init__(self, obj):
        self.obj = obj

    def get(self):
        return self.obj


class JobExecutor:
    """Owns the devices of a run and runs host functions.  Without
    ``devices`` it uses the CUDA card (``resolve_device``: raises
    without one)."""

    def __init__(self, devices: Optional[Sequence] = None):
        self._devices = [
            resolve_device(d) for d in (
                devices if devices is not None else [None])
        ]
        if not self._devices:
            raise ValueError("an executor needs at least one device")

    @property
    def devices(self) -> list:
        return self._devices

    @property
    def main_device(self) -> torch.device:
        return self._devices[0]

    def run_function(self, fn: Callable, *args, **kwargs) -> Any:
        return fn(*args, **kwargs)

    def map(self, fn: Callable, iterable: Iterable) -> list:
        return [fn(item) for item in iterable]

    def run_each_worker(self, fn: Callable, *args, **kwargs) -> dict:
        return {f"device-{i}": fn(*args, **kwargs)
                for i, _ in enumerate(self._devices)}

    def get_available_workers(self) -> WorkerSet:
        return WorkerSet([
            Worker(name=f"device-{i}", host="localhost", device=d,
                   resources={"compute": 1, _resource_key(d): 1})
            for i, d in enumerate(self._devices)
        ])

    def get_resource_details(self) -> list:
        """One row per host, ``{host, cpu, cuda, service}``, as the GUI's
        cluster page reads it: ``cpu`` the advertised CPU-worker count
        (``_cpu_workers`` when set, else the host's workers), ``cuda``
        the host's workers on a CUDA card.  Under a process group of
        several processes: this process's workers only (the JAX
        package's version has no multi-process branch either)."""
        workers = self.get_available_workers()
        cpu_workers = getattr(self, "_cpu_workers", None)
        details = []
        for host in sorted(workers.hosts()):
            on_host = [w for w in workers if w.host == host]
            details.append({
                "host": host,
                "cpu": cpu_workers if cpu_workers is not None
                else len(on_host),
                "cuda": sum(1 for w in on_host
                            if torch.device(w.device).type == "cuda"),
                "service": 1,
            })
        return details

    def run_process_local(self, task, args=(), kwargs=None):
        return task(*args, **(kwargs or {}))

    def run_each_partition(self, partitions, fn, all_nodes=False):
        """``fn(partition)`` for each partition; ``all_nodes`` changes
        nothing with one process."""
        for p in partitions:
            yield fn(p)

    def run_each_host(self, fn, *args, **kwargs) -> dict:
        """``fn`` once, on this process's host (also under a process
        group of several processes: each runs it for itself, as the
        JAX package's single-process version does)."""
        return {"localhost": fn(*args, **kwargs)}

    def scatter(self, obj):
        """A context manager yielding a handle of ``obj`` for the
        workers: an in-process box, the workers being this process's
        devices."""
        @contextmanager
        def _scatter():
            yield _ScatterHandle(obj)

        return _scatter()

    def scatter_update(self, handle, obj):
        handle.obj = obj

    def scatter_update_patch(self, handle, patch):
        handle.obj.patch(patch)

    def modify_buffer_type(self, buf):
        return buf

    def get_udf_runner(self):
        from ..udf.base import UDFRunner
        return UDFRunner

    @property
    def snooze_manager(self):
        """The Context's snooze manager, when one is set up."""
        return getattr(self, "_snooze_manager", None)

    @property
    def subscriptions(self):
        from ..common.subscriptions import SubscriptionManager
        if getattr(self, "_subscriptions", None) is None:
            self._subscriptions = SubscriptionManager()
        return self._subscriptions

    def subscribe(self, topic: str, callback) -> str:
        """``callback(topic, msg)`` on the executor's events;
        ``Context.run_udf`` and ``run_udf_iter`` send ``run_udf:start``
        and ``run_udf:end``."""
        return self.subscriptions.subscribe(topic, callback)

    def unsubscribe(self, key: str) -> bool:
        return self.subscriptions.unsubscribe(key)

    def ensure_sync(self) -> "JobExecutor":
        return self

    def ensure_async(self, pool=None):
        from .async_adapter import AsyncAdapter
        return AsyncAdapter(self, pool=pool)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ExecutorError(Exception):
    """A generic executor failure."""


class ResourceError(RuntimeError):
    """A task asks for resources the workers lack."""


# the JAX package's name of the concrete executors' base
BaseJobExecutor = JobExecutor


class GenericTaskProtocol:
    """A generic (non-UDF) task for the run_function-style calls."""

    def __call__(self, args, kwargs, environment):
        raise NotImplementedError()


def make_canonical(main_gpu) -> Optional[int]:
    """A main-device spec as a CUDA device index, or None: True picks
    card 0 and raises without one; an int is checked against
    ``torch.cuda.device_count()``; False and None give None."""
    def n_devices():
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    if main_gpu is None or main_gpu is False:
        return None
    if main_gpu is True:
        if n_devices() < 1:
            raise ResourceError("main_gpu=True but no CUDA device present")
        return 0
    idx = int(main_gpu)
    if idx < 0 or idx >= n_devices():
        raise ResourceError(
            f"main_gpu={idx} is not present ({n_devices()} devices)")
    return idx


def __getattr__(name):
    # AsyncAdapter is importable from here, as in the JAX package;
    # lazy against the import cycle
    if name in ("AsyncAdapter", "AsyncJobExecutor"):
        from .async_adapter import AsyncAdapter
        return AsyncAdapter
    raise AttributeError(name)
