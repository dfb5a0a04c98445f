"""JobEngine: run analyses asynchronously and stream partial results
over the websocket (counterpart of ``libertem_tpu/web/engine.py``):
result pushes are throttled, channels PNG-encoded and sent as binary
followup frames.

The compute runs through ``Context.run_udf_iter`` on a producer
thread of the loop's default executor, so the card's launches happen
there; each partial is the run's host snapshot.  A cancelled job
closes the run's generator, which stops its readers.  This module
owns the protocol framing around it.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import numpy as np

from ..analysis.base import Analysis
from ..common.exceptions import JobCancelledError
from ..common.progress import ProgressReporter
from ..viz.base import encode_image
from .messages import Message

log = logging.getLogger(__name__)

RESULT_THROTTLE = 0.3  # min seconds between TASK_RESULT pushes


class WebProgressReporter(ProgressReporter):
    """Streams JOB_PROGRESS websocket messages.  Must subclass
    ProgressReporter: the runner type-checks it.  Invoked from the
    compute thread, so messages hop onto the web event loop; the
    loop's tasks are held here until they are done."""

    def __init__(self, loop, registry, job_uuid):
        self._loop = loop
        self._registry = registry
        self._job = job_uuid
        self._tasks: set = set()

    def _send(self, event, state):
        msg = Message().job_progress(self._job, state, event)

        def _post():
            task = self._loop.create_task(
                _await_gather(self._registry.broadcast_event(msg))
            )
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        self._loop.call_soon_threadsafe(_post)

    def start(self, state):
        self._send("start", state)

    def update(self, state):
        self._send("update", state)

    def end(self, state):
        self._send("end", state)


async def _await_gather(fut):
    try:
        await fut
    except Exception:  # pragma: no cover - client went away
        pass


def _encode_channel(result) -> tuple[dict, Optional[bytes]]:
    """(description dict, png bytes or None): images travel as
    binary websocket followup frames.  A channel that cannot be
    rendered (matplotlib or PIL absent, a failed visualization) is
    logged and sent without an image."""
    png = None
    try:
        vis = result.visualized
        if vis is not None:
            png = encode_image(np.asarray(vis)).read()
    except Exception:
        log.exception("visualization failed for %s", result.key)
    return {
        "title": result.title,
        "desc": result.desc,
        "key": result.key,
        "includeInDownload": result.include_in_download,
    }, png


class JobEngine:
    def __init__(self, state, event_registry):
        self.state = state
        self.event_registry = event_registry
        # job ids whose run_analysis completed (any outcome) — a
        # deterministic completion signal for test harnesses whose
        # event loop only runs while being driven
        self.finished_jobs: set = set()

    async def run_sync(self, fn, *args, **kwargs):
        """Run blocking work off the event loop."""
        loop = asyncio.get_running_loop()
        import functools
        return await loop.run_in_executor(
            None, functools.partial(fn, *args, **kwargs)
        )

    async def register_job(self, analysis_id: str, job_id: str):
        analysis_state = self.state.analysis_state[analysis_id]
        self.state.job_state.register(
            job_id=job_id, analysis_id=analysis_id,
            dataset_id=analysis_state["dataset"],
        )
        self.state.analysis_state.add_job(analysis_id, job_id)

    async def run_analysis(self, analysis_id: str, job_id: str):
        """Run one analysis job end to end, streaming partial
        results; returns the final AnalysisResultSet."""
        try:
            analysis_state = self.state.analysis_state[analysis_id]
            ds = self.state.dataset_state[analysis_state["dataset"]]
            details = analysis_state["details"]
            analysis = Analysis.get_analysis_by_type(
                details["analysisType"]
            )(dataset=ds, parameters=details.get("parameters", {}))
            if job_id not in self.state.job_state:
                await self.register_job(analysis_id, job_id)
            return await self._run_udf(
                job_id=job_id, dataset=ds, analysis=analysis,
                analysis_id=analysis_id, details=details,
            )
        except JobCancelledError:
            msg = Message().cancel_done(job_id)
            await _await_gather(
                self.event_registry.broadcast_event(msg)
            )
            return None
        except Exception as e:
            log.exception("error running job %s", job_id)
            msg = Message().job_error(
                job_id, "error running job: %s" % str(e)
            )
            await _await_gather(
                self.event_registry.broadcast_event(msg)
            )
            await self.state.job_state.remove(job_id)
            return None
        finally:
            self.finished_jobs.add(job_id)

    def _is_cancelled(self, job_id: str) -> bool:
        return self.state.job_state.is_cancelled(job_id)

    async def _run_udf(self, job_id, dataset, analysis, analysis_id,
                       details):
        ctx = await self.state.executor_state.get_context()
        serialized_job = self.state.job_state.serialize(job_id)
        await _await_gather(self.event_registry.broadcast_event(
            Message().start_job(
                serialized_job=serialized_job,
                analysis_id=analysis_id,
            )
        ))

        # analysis-owned multi-pass controller (ClusterAnalysis):
        # the analysis drives its own pipeline against the Context
        controller = getattr(analysis, "controller", None)
        if controller is not None:
            result_set = await controller(
                ctx=ctx, cancel_id=job_id,
                job_is_cancelled=lambda: self._is_cancelled(job_id),
            )
            if self._is_cancelled(job_id):
                raise JobCancelledError()
            await self.send_results(
                result_set, job_id, analysis_id, details,
                finished=True, udf_results=None,
            )
            return result_set

        roi = analysis.get_roi()

        # visualization-only parameter change: reuse cached raw
        # results, no pass over the data
        if self.state.analysis_state.have_results(analysis_id):
            old = self.state.analysis_state.get_results(analysis_id)
            if not analysis.need_rerun(
                old.details["parameters"], details["parameters"],
            ):
                results = await self.run_sync(
                    self._get_analysis_results, analysis,
                    old.udf_results, roi,
                )
                await self.send_results(
                    results, job_id, analysis_id, details,
                    finished=True, udf_results=old.udf_results,
                )
                return results

        udf = analysis.get_udf()
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        reporter = WebProgressReporter(
            loop, self.event_registry, job_id
        )

        def producer():
            try:
                gen = ctx.run_udf_iter(
                    dataset, udf, roi=roi, progress=reporter,
                )
                try:
                    for partial in gen:
                        if self._is_cancelled(job_id):
                            loop.call_soon_threadsafe(
                                queue.put_nowait, ("cancelled", None)
                            )
                            return
                        loop.call_soon_threadsafe(
                            queue.put_nowait, ("partial", partial)
                        )
                finally:
                    # a cancelled job leaves the loop mid-run: closing
                    # the generator stops its readers now
                    gen.close()
                loop.call_soon_threadsafe(
                    queue.put_nowait, ("done", None)
                )
            except Exception as e:
                loop.call_soon_threadsafe(
                    queue.put_nowait, ("error", e)
                )

        fut = loop.run_in_executor(None, producer)
        last_push = 0.0
        latest = None
        final_results = None
        try:
            while True:
                kind, payload = await queue.get()
                if kind == "error":
                    raise payload
                if kind == "cancelled":
                    raise JobCancelledError()
                if kind == "partial":
                    latest = payload
                    now = time.monotonic()
                    if now - last_push < RESULT_THROTTLE:
                        continue
                    results = await self.run_sync(
                        self._get_analysis_results, analysis,
                        latest, roi,
                    )
                    await self.send_results(
                        results, job_id, analysis_id, details,
                        finished=False, udf_results=latest,
                    )
                    # measure from AFTER the push: broadcast may
                    # stall on network backpressure
                    last_push = time.monotonic()
                if kind == "done":
                    if self._is_cancelled(job_id):
                        raise JobCancelledError()
                    final_results = await self.run_sync(
                        self._get_analysis_results, analysis,
                        latest, roi,
                    )
                    await self.send_results(
                        final_results, job_id, analysis_id, details,
                        finished=True, udf_results=latest,
                    )
                    break
        finally:
            await fut
        return final_results

    @staticmethod
    def _get_analysis_results(analysis, udf_results, roi):
        from ..api import SingleUDFResults
        wrapped = SingleUDFResults(
            udf_results.buffers[0], udf_results.damage
        )
        return analysis.get_udf_results(
            wrapped, roi, udf_results.damage
        )

    async def send_results(self, results, job_id, analysis_id,
                           details, finished=False,
                           udf_results=None):
        """TASK_RESULT / FINISH_JOB header, then one binary PNG
        websocket frame per rendered channel."""
        if self._is_cancelled(job_id):
            raise JobCancelledError()
        # PNG encoding is CPU work: off the event loop
        loop = asyncio.get_running_loop()
        encoded = await loop.run_in_executor(
            None, lambda: [_encode_channel(r) for r in results],
        )
        if self._is_cancelled(job_id):
            raise JobCancelledError()
        descriptions = [meta for meta, _ in encoded]
        images = [png for _, png in encoded if png is not None]
        # channel rows with hasImage let the single-page client map
        # the binary followup frames to channels
        channels = [
            {**meta, "hasImage": png is not None}
            for meta, png in encoded
        ]
        if finished:
            serialized_job = self.state.job_state.serialize(job_id)
            msg = Message().finish_job(
                serialized_job=serialized_job,
                num_images=len(images),
                image_descriptions=descriptions,
            )
            self.state.analysis_state.set_results(
                analysis_id, details, results, job_id, udf_results,
            )
        else:
            msg = Message().task_result(
                job_id=job_id,
                num_images=len(images),
                image_descriptions=descriptions,
            )
        msg["channels"] = channels
        # send header + followups back-to-back so no other message
        # interleaves between them
        futures = [self.event_registry.broadcast_event(msg)]
        for png in images:
            futures.append(
                self.event_registry.broadcast_event(
                    png, binary=True
                )
            )
        for f in futures:
            await _await_gather(f)

    async def send_existing_job_results(self):
        """Replay finished results to a reconnecting GUI."""
        for analysis_id, info in list(
            self.state.analysis_state.get_all_results()
        ):
            details, result_set, job_id, udf_results = info
            if job_id in self.state.job_state:
                serialized_job = \
                    self.state.job_state.serialize(job_id)
            else:
                serialized_job = {
                    "id": job_id, "analysis": analysis_id,
                }
            await _await_gather(self.event_registry.broadcast_event(
                Message().start_job(
                    serialized_job=serialized_job,
                    analysis_id=analysis_id,
                )
            ))
            try:
                await self.send_results(
                    result_set, job_id, analysis_id, details,
                    finished=True, udf_results=udf_results,
                )
            except JobCancelledError:
                continue
