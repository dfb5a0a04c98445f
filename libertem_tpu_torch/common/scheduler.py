"""Which workers can run a task (counterpart of
``libertem_tpu/common/scheduler.py``): a task's ``get_resources()``
against each worker's resources."""
from __future__ import annotations

from ..executor.base import Worker, WorkerSet


class Scheduler:
    def __init__(self, all_workers: WorkerSet):
        self.workers = all_workers

    def workers_for_task(self, task) -> WorkerSet:
        """Workers whose resources satisfy ``task.get_resources()``."""
        resources = {}
        if hasattr(task, "get_resources"):
            resources = task.get_resources() or {}

        def fits(worker: Worker) -> bool:
            return all(worker.resources.get(key, 0) >= amount
                       for key, amount in resources.items())

        return WorkerSet([w for w in self.workers if fits(w)])

    def effective_worker_count(self) -> int:
        return max(1, len([w for w in self.workers
                           if w.resources.get("compute", 0) > 0]))
