"""Context: the public entry point (counterpart of
``libertem_tpu/api.py``): datasets, UDF runs (synchronous, awaitable,
lazy, with live plots), ``map``, export and the analyses, on the
devices of an executor."""
from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .common.buffers import BufferWrapper  # noqa: F401  (the JAX API's name)
from .common.snooze import keep_alive
from .executor.base import JobExecutor
from .executor.inline import InlineJobExecutor
from .io.corrections import CorrectionSet
from .io.dataset.base import DataSet
from .udf.base import (
    UDF,
    SingleUDFResults,
    UDFResults,
    UDFRunner,
    executor_devices,
)

# the least partition count of a loaded dataset; a Context splits into
# max(MIN_PARTITIONS, 2 x its executor's workers), as the JAX package
MIN_PARTITIONS = 4


class ResultGenerator:
    """Iterator of partial results (``UDFResults``, one per merged
    partition; the last is the final result) of
    :meth:`Context.run_udf_iter`, with mid-run parameter patches.
    Live ``plots`` are updated with every partial, and once more,
    forced, with the last.  The run's end (exhaustion or
    :meth:`close`) sends ``run_udf:end`` and lets the snooze manager
    sleep again."""

    def __init__(self, gen, runner: UDFRunner, ctx: "Context",
                 plots=None, udfs=None):
        self._gen = gen
        self._runner = runner
        self._ctx = ctx
        self._plots = plots
        self._udfs = udfs
        self._last = None
        self._ended = False
        manager = ctx.snooze_manager
        if manager is not None:
            manager.keep_alive_enter()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            res = next(self._gen)
        except StopIteration:
            if self._plots and self._last is not None:
                self._ctx._update_plots(self._plots, self._last,
                                        self._udfs, final=True)
                self._plots = None
            self._emit_end()
            raise
        except BaseException:
            self._emit_end()
            raise
        finally:
            self._ctx.feed_stats = self._runner.feed_stats
            self._ctx.run_info = self._runner.run_info
        if self._plots:
            self._last = res
            try:
                self._ctx._update_plots(self._plots, res, self._udfs)
            except BaseException:
                # a failing plot abandons the run: the reader stops
                self.close()
                raise
        return res

    def _emit_end(self):
        if self._ended:
            return
        self._ended = True
        self._ctx._emit_run_event("run_udf:end", self._udfs)
        manager = self._ctx.snooze_manager
        if manager is not None:
            manager.keep_alive_exit()

    def update_parameters_experimental(self, patches):
        """One dict of constructor arguments per UDF (``{}`` for no
        change), applied from the next partition on."""
        self._runner.update_parameters_experimental(patches)

    def throw(self, *args):
        return self._gen.throw(*args)

    def close(self):
        """Abandon the run: stops the host feed's reader, releases its
        slots and runs the UDFs' cleanup."""
        try:
            self._gen.close()
        finally:
            self._emit_end()

    def __del__(self):
        # dropped without an end: the snooze manager must not stay awake
        if not getattr(self, "_ended", True):
            self._emit_end()


class AsyncResultGenerator:
    """The async counterpart of :class:`ResultGenerator`
    (``run_udf_iter(..., sync=False)``): ``async for``, ``await
    .update_parameters_experimental(...)``, ``athrow`` and ``aclose``.
    A producer thread drains the run up to 8 partials ahead (each a
    host copy, never a view of device state); ``aclose`` stops it and
    closes the run there, in the thread that ran it."""

    def __init__(self, agen, sync_gen: ResultGenerator):
        self._agen = agen
        self._sync_gen = sync_gen
        self._started = False

    def __aiter__(self):
        return self

    def __anext__(self):
        self._started = True
        return self._agen.__anext__()

    async def update_parameters_experimental(self, patches):
        self._sync_gen.update_parameters_experimental(patches)

    def athrow(self, *args):
        self._started = True
        return self._agen.athrow(*args)

    async def aclose(self):
        await self._agen.aclose()
        if not self._started:
            # no producer ever ran the run: close it here
            self._sync_gen.close()


class Context:
    """Loads datasets and runs UDFs on the devices of an executor:
    ``InlineJobExecutor()`` (the CUDA card, raising when there is none)
    by default, or ``InlineJobExecutor(device=device)`` for a
    ``device`` given (``"cpu"``).  ``plot_class``: the live plots of
    ``plots=True`` (matplotlib's by default); ``snooze_timeout``:
    seconds idle after which the CUDA caching allocator releases its
    free blocks."""

    def __init__(self, executor: Optional[JobExecutor] = None,
                 plot_class=None, snooze_timeout: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None):
        from .common.tracing import maybe_setup_tracing
        maybe_setup_tracing("libertem-tpu-torch")
        if executor is not None and device is not None:
            raise ValueError(
                "pass either an executor or a device, not both")
        if executor is None:
            executor = InlineJobExecutor(device=device)
        self.executor = executor
        self.device = executor.main_device
        self._plot_class = plot_class
        self.snooze_manager = None
        if snooze_timeout is not None:
            from .common.snooze import SnoozeManager
            self.snooze_manager = SnoozeManager(
                down=self._snooze_down, timeout=snooze_timeout)
        executor._snooze_manager = self.snooze_manager
        # host feed timings of the last run (HostFeed.stats, with the
        # host engine's time in "host_s") and what it ran
        # (UDFRunner.run_info: engines, fused, compacted blocks)
        self.feed_stats: Optional[dict] = None
        self.run_info: Optional[dict] = None

    def _snooze_down(self) -> None:
        """The snooze manager's ``down``: no run is in flight (runs
        hold it awake), so the caching allocator releases its free
        blocks; nothing to release on the CPU."""
        if any(d.type == "cuda" for d in self.executor.devices):
            torch.cuda.empty_cache()

    @property
    def plot_class(self):
        """The live-plot class of ``plots=True``: matplotlib's
        (``viz.mpl.MPLLive2DPlot``) unless one was given."""
        if self._plot_class is None:
            from .viz.mpl import MPLLive2DPlot
            self._plot_class = MPLLive2DPlot
        return self._plot_class

    @plot_class.setter
    def plot_class(self, value):
        self._plot_class = value

    @classmethod
    def make_with(
        cls, executor_spec: str = "inline", /, *,
        cpus=None, gpus=None, tpus=None, main_process_gpu=None,
        plot_class=None, snooze_timeout=None, **kwargs,
    ) -> "Context":
        """A Context with a named executor, the JAX package's names:

        ``"inline"``, ``"synchronous"``, ``"threads"``, ``"concurrent"``
            one device (the card): :class:`InlineJobExecutor`
        ``"sharded"``, ``"tpu"``, ``"dask"``, ``"dask-make-default"``,
        ``"dask-integration"``, ``"pipelined"``
            every CUDA device (``tpus=``: their indices):
            :class:`ShardedJobExecutor`
        ``"delayed"``
            lazy results, computed on first access:
            :class:`DelayedJobExecutor` (``**kwargs`` go to it)

        ``cpus=``/``gpus=`` are refused where the JAX package refuses
        them; ``gpus`` and ``main_process_gpu`` need a CUDA device.

        Several processes (the JAX package's multi-host branch): call
        ``torch.distributed.init_process_group(...)`` in each process
        (``backend="nccl"`` with one card a process, else ``"gloo"``),
        then ``make_with("sharded")`` and the identical calls on every
        process.  Its workers are this process's card (``LOCAL_RANK``)
        or cards, and a run goes over every process's, each reading
        only its own shards; every process gets the same results.
        Closing an iterator early or raising in one process leaves the
        others waiting in a collective until the group's timeout, as
        in any SPMD program."""
        from .common.exceptions import ExecutorSpecException

        limited = ("inline", "synchronous", "dask-integration", "delayed")
        if cpus is not None and executor_spec in limited:
            raise ExecutorSpecException(
                f"Executor type {executor_spec} does not support "
                f"specifying CPU workers at this time")
        if gpus is not None and executor_spec in limited + ("threads",):
            raise ExecutorSpecException(
                f"Executor type {executor_spec} does not support "
                f"specifying GPU workers at this time")
        if gpus or main_process_gpu is True or (
                isinstance(main_process_gpu, int)
                and not isinstance(main_process_gpu, bool)):
            from .utils.devices import detect
            if not detect()["cudas"]:
                raise ExecutorSpecException(
                    "Cannot specify GPU workers as no GPUs detected"
                    if gpus else
                    "main_process_gpu requested but no CUDA device is "
                    "available on this host")
        opts = dict(plot_class=plot_class, snooze_timeout=snooze_timeout)
        if executor_spec in ("inline", "synchronous"):
            return cls(executor=InlineJobExecutor(), **opts)
        if executor_spec in ("threads", "concurrent"):
            from .executor.compat import ConcurrentJobExecutor
            return cls(executor=ConcurrentJobExecutor(), **opts)
        if executor_spec in ("sharded", "tpu", "pipelined", "dask",
                             "dask-make-default", "dask-integration"):
            from .executor.sharded import ShardedJobExecutor
            devices = None
            if tpus is not None:
                devices = [torch.device("cuda", int(i)) for i in tpus]
            return cls(executor=ShardedJobExecutor(devices=devices),
                       **opts)
        if executor_spec == "delayed":
            from .executor.delayed import DelayedJobExecutor
            return cls(executor=DelayedJobExecutor(**kwargs), **opts)
        raise ExecutorSpecException(
            f"Argument `executor_spec` is {executor_spec}. Allowed "
            f'are "synchronous", "inline", "threads", "dask", '
            f'"dask-integration", "dask-make-default", "delayed", '
            f'"pipelined" (or this framework\'s "sharded"/"tpu").'
        )

    def close(self) -> None:
        """Stops the snooze manager's timer and closes the executor; a
        run's threads end with the run."""
        if self.snooze_manager is not None:
            self.snooze_manager.close()
        self.executor.close()

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def load(self, filetype: str, *args, **kwargs) -> DataSet:
        """Open a dataset of a format id of ``io.dataset.filetypes``
        (``memory``, ``raw``, ``npy``, ``mib``, ``empad``, ``blo``,
        ``mrc``, ``seq``, ``tvips``, ``dm``, ``frms6``, ``k2is``,
        ``ser``, ``hdf5`` (needs h5py), ``raw_csr``, ``dask`` (any
        array-like), or a registered one) with the JAX package's
        arguments for it, or ``"auto"`` with a path: the format that
        ``io.dataset.detect`` finds, its detected arguments overridden
        by the keywords given.  Without a given ``num_partitions`` the
        dataset splits into at least max(``MIN_PARTITIONS``, 2 x the
        executor's workers) partitions, as in the JAX package; under a
        process group of several processes the workers of every process
        count, so that every process makes the same partitions."""
        from .io.dataset import make
        ds = make(filetype, *args, **kwargs)
        workers = (getattr(self.executor, "global_workers", None)
                   or self.executor.get_available_workers())
        ds.set_num_cores(max(MIN_PARTITIONS, 2 * len(workers)))
        return ds.initialize()

    def export_dataset(self, dataset: DataSet, *, path: str,
                       progress=False, overwrite: bool = False) -> None:
        """Write the dataset's frames to a ``.npy`` file of its full
        shape (``io.writers.write_dataset_npy``); an existing file is
        kept unless ``overwrite``."""
        if not str(path).endswith(".npy"):
            raise ValueError(
                f"unrecognized file extension in {path!r}: only .npy "
                "is currently supported")
        if not overwrite and os.path.isfile(path):
            raise FileExistsError(
                f"cannot export dataset to existing path {path}; use "
                "overwrite=True to force export")
        from .io.writers import write_dataset_npy
        return write_dataset_npy(self, dataset, path, progress=progress)

    @keep_alive
    def run_udf(
        self,
        dataset: DataSet,
        udf: Union[UDF, Sequence[UDF]],
        roi=None,
        corrections: Optional[CorrectionSet] = None,
        progress=False,
        backends=None,
        plots=None,
        sync: bool = True,
    ):
        """Run one or more UDFs over a dataset in a single pass.

        ``roi`` selects the frames to process: a bool array over the
        nav positions (nav-shaped or flat; another dtype is cast, with
        a warning), a scipy.sparse or ``.todense()`` mask, one
        coordinate tuple ``(y, x)``, an iterable of ``(coord, value)``
        pairs with one truth value (``False`` selects every position
        except those), or an iterable of coordinate tuples; nav results
        hold nan (0 for integers) elsewhere.  ``corrections``: dark
        frame, gain map and excluded pixels applied to every frame.
        ``backends`` restricts the engines for this run (``("numpy",)``
        sends every UDF that can run there to the host engine).
        ``progress``: True for a tqdm bar, or a
        ``common.progress.ProgressReporter``.  ``plots``: True (a
        ``plot_class`` plot of every 2-D channel of each UDF), a list
        of channel lists per UDF (a name, or ``(name, fn)``), or
        ``viz.base.Live2DPlot`` objects; each is updated as partitions
        merge.  ``sync=False`` returns an awaitable of the results
        instead (:meth:`run_udf_async`).  With the delayed executor the
        results are lazy: the pass runs on the first access to data.

        Returns a dict of result buffers for a single UDF, or a list of
        dicts for a sequence of UDFs."""
        if not sync:
            return self.run_udf_async(
                dataset, udf, roi=roi, corrections=corrections,
                progress=progress, backends=backends, plots=plots,
            )
        udfs, single = self._normalize_udfs(udf)
        roi = self._normalize_roi(roi, dataset)
        device = self._run_device()
        if getattr(self.executor, "is_delayed", False) and not plots:
            # the events mark the lazy results' construction; the pass
            # runs on the first access to data
            self._emit_run_event("run_udf:start", udfs, dataset)
            try:
                from .executor.delayed import make_delayed_results
                return make_delayed_results(
                    self, dataset, udfs, single, roi, corrections,
                    progress=progress, backends=backends,
                )
            finally:
                self._emit_run_event("run_udf:end", udfs)
        plots = self._prepare_plots(plots, dataset, udfs, roi)
        runner = self._runner(udfs, backends)
        self._emit_run_event("run_udf:start", udfs, dataset)
        try:
            if plots:
                gen = runner.run_for_dataset_iter(
                    dataset, device, roi=roi, corrections=corrections,
                    progress=progress, devices=self._run_devices())
                try:
                    results = None
                    for results in gen:
                        self._update_plots(plots, results, udfs)
                finally:
                    # a failing plot stops the reader here
                    gen.close()
                self._update_plots(plots, results, udfs, final=True)
            else:
                results = runner.run_for_dataset(
                    dataset, device, roi=roi, corrections=corrections,
                    progress=progress, devices=self._run_devices())
        finally:
            self.feed_stats = runner.feed_stats
            self.run_info = runner.run_info
            self._emit_run_event("run_udf:end", udfs)
        return self._wrap(results, single)

    def run_udf_iter(
        self,
        dataset: DataSet,
        udf: Union[UDF, Sequence[UDF]],
        roi=None,
        corrections: Optional[CorrectionSet] = None,
        progress=False,
        backends=None,
        plots=None,
        sync: bool = True,
    ):
        """Live partial results: a :class:`ResultGenerator` of
        ``UDFResults`` (``.buffers``, one dict per UDF, and
        ``.damage``), one after every merged partition, the last of them
        the final result.  Its ``update_parameters_experimental`` patches
        the UDFs' arguments from the next partition on; ``close()``
        abandons the run.  ``sync=False`` gives an
        :class:`AsyncResultGenerator` (``async for``), its partials made
        on a producer thread.  Arguments as :meth:`run_udf`."""
        if not sync:
            sync_gen = self.run_udf_iter(
                dataset, udf, roi=roi, corrections=corrections,
                progress=progress, backends=backends, plots=plots,
            )
            from .common.async_utils import async_generator_eager
            return AsyncResultGenerator(
                async_generator_eager(sync_gen, queue_size=8), sync_gen)
        udfs, _ = self._normalize_udfs(udf)
        roi = self._normalize_roi(roi, dataset)
        device = self._run_device()
        plots = self._prepare_plots(plots, dataset, udfs, roi)
        runner = self._runner(udfs, backends)
        self._emit_run_event("run_udf:start", udfs, dataset)
        gen = runner.run_for_dataset_iter(
            dataset, device, roi=roi, corrections=corrections,
            progress=progress, devices=self._run_devices(),
        )
        return ResultGenerator(gen, runner, self, plots=plots, udfs=udfs)

    async def run_udf_iter_async(self, dataset, udf, roi=None,
                                 corrections=None, progress=False,
                                 backends=None, plots=None):
        """Async generator of the partial results; the plots are
        updated on the producer thread."""
        agen = self.run_udf_iter(
            dataset, udf, roi=roi, corrections=corrections,
            progress=progress, backends=backends, plots=plots, sync=False,
        )
        try:
            async for item in agen:
                yield item
        finally:
            await agen.aclose()

    async def run_udf_async(self, dataset, udf, roi=None,
                            corrections=None, progress=False,
                            backends=None, plots=None):
        """:meth:`run_udf` on a pool thread, awaited
        (``run_udf(..., sync=False)``)."""
        from .common.async_utils import sync_to_async
        return await sync_to_async(
            self.run_udf, dataset, udf, roi=roi, corrections=corrections,
            progress=progress, backends=backends, plots=plots,
        )

    def _runner(self, udfs, backends) -> UDFRunner:
        return UDFRunner(
            udfs, backends=backends,
            debug=getattr(self.executor, "_debug", False),
            threads_per_worker=getattr(
                self.executor, "threads_per_worker", 1),
        )

    def _run_devices(self):
        """The workers of the multi-device loop when there are several
        (the executor's devices; a ``ShardedJobExecutor``'s
        ``global_workers`` where they span the processes of a
        ``torch.distributed`` group), else None (the single-device
        loop)."""
        return executor_devices(self.executor)[1]

    def _run_device(self) -> torch.device:
        """The device of a run: the executor's main device (the first
        worker's, with several)."""
        return self.executor.main_device

    def _emit_run_event(self, topic, udfs, dataset=None):
        subs = getattr(self.executor, "subscriptions", None)
        if subs is None:
            return
        msg = {"udfs": [type(u).__name__ for u in udfs]}
        if dataset is not None:
            msg["dataset_shape"] = tuple(dataset.shape)
        subs.send(topic, msg)

    @staticmethod
    def _wrap(results: UDFResults, single: bool):
        wrapped = [SingleUDFResults(b, results.damage)
                   for b in results.buffers]
        return wrapped[0] if single else wrapped

    def _prepare_plots(self, plots, dataset, udfs, roi):
        """``plots=``: True gives a ``plot_class`` plot of every 2-D
        channel of each UDF; a list of channel lists (one a UDF: names
        or ``(name, fn)``) gives those, each name checked; plot objects
        (anything with ``new_data``) pass through.  One dry run serves
        every plot."""
        if not plots:
            return None
        from .viz.base import Live2DPlot
        chan_lists = (
            isinstance(plots, (list, tuple))
            and all(isinstance(p, (list, tuple)) for p in plots)
            and all(all(isinstance(pp, (str, list, tuple)) for pp in p)
                    for p in plots)
        )
        prepared = []
        if plots is True or chan_lists:
            dry = UDFRunner(udfs).dry_run(dataset, roi)
            if plots is True:
                channels = []
                for idx, udf in enumerate(udfs):
                    chans = [
                        k for k, buf in dry.buffers[idx].items()
                        if buf.data is not None
                        and len(np.squeeze(buf.data).shape) == 2
                    ]
                    if not chans:
                        warnings.warn(
                            f"No plottable channels found for UDF "
                            f"#{idx}: {type(udf).__name__}, not plotting.")
                    channels.append(chans)
            else:
                channels = plots
                for idx, udf_channels in enumerate(channels):
                    for ch in udf_channels:
                        name = ch[0] if isinstance(ch, (list, tuple)) \
                            else ch
                        if name not in dry.buffers[idx]:
                            raise ValueError(
                                f"channel {name} not found, have: "
                                f"{list(dry.buffers[idx].keys())}")
            for idx, (udf, udf_channels) in enumerate(zip(udfs, channels)):
                for channel in udf_channels:
                    if isinstance(channel, list):
                        channel = tuple(channel)
                    p = self.plot_class(
                        dataset, udf, roi=roi, channel=channel,
                        udfresult=UDFResults((dry.buffers[idx],),
                                             dry.damage),
                    )
                    p.display()
                    prepared.append(p)
            return prepared or None
        for p in plots:
            if isinstance(p, Live2DPlot) or hasattr(p, "new_data"):
                prepared.append(p)
        return prepared or None

    @staticmethod
    def _update_plots(plots, results, udfs, final=False):
        """Each plot's UDF's buffers of a (partial) result, with the
        nav damage; the results are host copies already, so this adds
        no device synchronisation."""
        damage = np.asarray(results.damage.data)
        for p in plots:
            get_udf = getattr(p, "get_udf", None)
            udf = get_udf() if get_udf is not None else getattr(
                p, "udf", None)
            try:
                idx = udfs.index(udf)
            except ValueError:
                idx = 0
            p.new_data(results.buffers[idx], damage, force=final)

    def inspect_udf(self, udf: UDF, dataset: DataSet, roi=None):
        """The result buffers ``udf`` declares on ``dataset`` (kind,
        dtype, extra shape), from zero state, without reading data."""
        results = UDFRunner([udf]).dry_run(
            dataset, self._normalize_roi(roi, dataset))
        return SingleUDFResults(results.buffers[0], results.damage)

    def display(self, dataset: DataSet, udf: UDF, roi=None):
        """A summary of what ``udf`` would produce, as text and as an
        HTML table (``_repr_html_``) for notebooks."""
        rows = [(name, buf.kind, buf.dtype, buf.extra_shape)
                for name, buf in self.inspect_udf(udf, dataset, roi).items()]
        return _UDFDisplay(f"{type(udf).__name__} on {dataset}:", rows)

    def map(self, dataset: DataSet, f, roi=None, progress=False,
            corrections: Optional[CorrectionSet] = None, backends=None):
        """``f(frame)`` on every frame (of the roi): the ``result``
        buffer of an :class:`~libertem_tpu_torch.udf.auto.AutoUDF`.
        ``f`` written with torch runs on the device; one written with
        numpy, or returning other objects, on the host engine."""
        from .udf.auto import AutoUDF
        results = self.run_udf(
            dataset, AutoUDF(f=f), roi=roi, progress=progress,
            corrections=corrections, backends=backends,
        )
        return results["result"]

    # -- analyses ---------------------------------------------------------

    @keep_alive
    def run(self, analysis, roi=None, progress=False,
            corrections: Optional[CorrectionSet] = None):
        """Run an analysis (``create_*_analysis``) and post-process its
        UDF's results into an ``AnalysisResultSet``; without a ``roi``,
        the analysis's own (its GUI roi parameter, or PickFrame's
        frame)."""
        if roi is None:
            roi = analysis.get_roi()
        udf_results = self.run_udf(
            analysis.dataset, analysis.get_udf(), roi=roi,
            progress=progress, corrections=corrections,
        )
        return analysis.get_udf_results(udf_results, roi,
                                        udf_results.damage)

    def create_mask_analysis(self, factories, dataset, **kwargs):
        from .analysis.masks import MasksAnalysis
        return MasksAnalysis(dataset=dataset,
                             parameters=dict(factories=factories, **kwargs))

    def create_disk_analysis(self, dataset, cx=None, cy=None, r=None):
        from .analysis.disk import DiskMaskAnalysis
        return DiskMaskAnalysis(dataset=dataset,
                                parameters={"cx": cx, "cy": cy, "r": r})

    def create_ring_analysis(self, dataset, cx=None, cy=None, ri=None,
                             ro=None):
        from .analysis.ring import RingMaskAnalysis
        return RingMaskAnalysis(
            dataset=dataset,
            parameters={"cx": cx, "cy": cy, "ri": ri, "ro": ro},
        )

    def create_point_analysis(self, dataset, x=None, y=None):
        from .analysis.point import PointMaskAnalysis
        return PointMaskAnalysis(dataset=dataset,
                                 parameters={"cx": x, "cy": y})

    def create_sum_analysis(self, dataset):
        from .analysis.sum import SumAnalysis
        return SumAnalysis(dataset=dataset, parameters={})

    def create_sumsig_analysis(self, dataset):
        from .analysis.sumsig import SumSigAnalysis
        return SumSigAnalysis(dataset=dataset, parameters={})

    def create_sd_analysis(self, dataset):
        from .analysis.sd import SDAnalysis
        return SDAnalysis(dataset=dataset, parameters={})

    def create_pick_analysis(self, dataset, x, y=None, z=None):
        from .analysis.raw import PickFrameAnalysis
        params = {"x": x, "y": y, "z": z}
        return PickFrameAnalysis(dataset=dataset, parameters=params)

    def create_com_analysis(self, dataset, cx=None, cy=None,
                            mask_radius=None, flip_y=False,
                            scan_rotation=0.0, mask_radius_inner=None):
        """Needs a 2-D nav and a 2-D sig; the annular mode
        (``mask_radius_inner``) needs ``mask_radius`` too."""
        if dataset.shape.nav.dims != 2:
            raise ValueError(
                "CoM analysis needs a 2D navigation shape, got "
                f"{tuple(dataset.shape.nav)}")
        if dataset.shape.sig.dims != 2:
            raise ValueError(
                "CoM analysis needs a 2D signal shape, got "
                f"{tuple(dataset.shape.sig)}")
        if mask_radius_inner is not None and mask_radius is None:
            raise ValueError(
                "mask_radius_inner requires mask_radius (annular mode "
                "needs both radii)")
        from .analysis.com import COMAnalysis
        return COMAnalysis(dataset=dataset, parameters={
            "cx": cx, "cy": cy, "r": mask_radius, "ri": mask_radius_inner,
            "flip_y": flip_y, "scan_rotation": scan_rotation,
        })

    def create_radial_fourier_analysis(self, dataset, cx=None, cy=None,
                                       ri=None, ro=None, n_bins=None,
                                       max_order=None, use_sparse=None):
        """``use_sparse`` is accepted as in the JAX package; whether the
        stack is compacted is the engine's choice."""
        from .analysis.radialfourier import RadialFourierAnalysis
        return RadialFourierAnalysis(dataset=dataset, parameters={
            "cx": cx, "cy": cy, "ri": ri, "ro": ro, "n_bins": n_bins,
            "max_order": max_order, "use_sparse": use_sparse,
        })

    def create_fem_analysis(self, dataset, cx=None, cy=None, ri=None,
                            ro=None):
        from .analysis.fem import FEMAnalysis
        return FEMAnalysis(
            dataset=dataset,
            parameters={"cx": cx, "cy": cy, "ri": ri, "ro": ro},
        )

    @staticmethod
    def _normalize_udfs(udf) -> tuple[list, bool]:
        if isinstance(udf, UDF):
            return [udf], True
        udfs = list(udf)
        if not udfs:
            raise ValueError("empty list of UDFs - nothing to do!")
        return udfs, False

    @staticmethod
    def _normalize_roi(roi, dataset) -> Optional[np.ndarray]:
        """Any of ``run_udf``'s roi forms as a flat bool array."""
        if roi is None:
            return None
        if hasattr(roi, "toarray"):  # scipy.sparse
            roi = np.asarray(roi.toarray())
        elif hasattr(roi, "todense"):
            roi = np.asarray(roi.todense())
        if isinstance(roi, np.ndarray):
            if roi.dtype != np.dtype(bool):
                warnings.warn(
                    f"ROI dtype is {roi.dtype}, expected bool. "
                    "Attempting cast to bool."
                )
            return roi.astype(bool).reshape(-1)
        nav_shape = tuple(dataset.shape.nav)
        entries = list(roi)
        if not entries:
            # an empty coordinate iterable selects nothing
            return np.zeros(int(np.prod(nav_shape)), dtype=bool)
        if all(isinstance(e, (int, np.integer)) for e in entries):
            # one coordinate
            entries = [(tuple(entries), True)]
        else:
            norm = []
            for e in entries:
                e = tuple(e)
                if len(e) == 2 and isinstance(e[-1], (bool, np.bool_)):
                    coord = e[0]
                    if isinstance(coord, (int, np.integer)):
                        coord = (coord,)
                    norm.append((tuple(coord), bool(e[1])))
                else:
                    norm.append((e, True))
            entries = norm
        values = {v for _, v in entries}
        if len(values) > 1:
            raise ValueError(
                "cannot cast iterable roi coords with more than one "
                f"truth value {values}"
            )
        val = values.pop()
        mask = np.full(nav_shape, not val, dtype=bool)
        for coord, v in entries:
            mask[coord] = v
        return mask.reshape(-1)


class _UDFDisplay:
    """``Context.display``'s result."""

    def __init__(self, title, rows):
        self._title = title
        self._rows = rows

    def __str__(self):
        return "\n".join([self._title] + [
            f"  {name}: kind={kind} dtype={dtype} extra_shape={extra}"
            for name, kind, dtype, extra in self._rows
        ])

    __repr__ = __str__

    def _repr_html_(self):
        cells = "".join(
            f"<tr><td>{name}</td><td>{kind}</td><td>{dtype}</td>"
            f"<td>{extra}</td></tr>"
            for name, kind, dtype, extra in self._rows
        )
        return (f"<p>{self._title}</p><table><tr><th>name</th><th>kind"
                f"</th><th>dtype</th><th>extra_shape</th></tr>{cells}"
                f"</table>")
