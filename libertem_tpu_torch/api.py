"""Context: the public entry point (counterpart of
``libertem_tpu/api.py``): datasets, UDF runs, ``map`` and the
analyses."""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .common.backend import resolve_device
from .io.corrections import CorrectionSet
from .io.dataset.base import DataSet
from .udf.base import UDF, UDFRunner

# the least partition count of a loaded dataset: the JAX package's
# max(4, 2 x workers), with one worker (the card)
MIN_PARTITIONS = 4


class SingleUDFResults(dict):
    """One UDF's result buffers by name, with attribute access and the
    run's ``damage`` buffer."""

    def __init__(self, buffers: dict, damage):
        super().__init__(buffers)
        self.damage = damage

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


class ResultGenerator:
    """Iterator of partial results (``UDFResults``, one per merged
    partition; the last is the final result) of
    :meth:`Context.run_udf_iter`, with mid-run parameter patches."""

    def __init__(self, gen, runner: UDFRunner, ctx: "Context"):
        self._gen = gen
        self._runner = runner
        self._ctx = ctx

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        finally:
            self._ctx.feed_stats = self._runner.feed_stats
            self._ctx.run_info = self._runner.run_info

    def update_parameters_experimental(self, patches):
        """One dict of constructor arguments per UDF (``{}`` for no
        change), applied from the next partition on."""
        self._runner.update_parameters_experimental(patches)

    def throw(self, *args):
        return self._gen.throw(*args)

    def close(self):
        """Abandon the run: stops the host feed's reader, releases its
        slots and runs the UDFs' cleanup."""
        self._gen.close()


def _not_ported(plots, sync) -> None:
    if plots:
        raise NotImplementedError(
            "plots are not ported yet: they come with the visualisation "
            "layer (ROADMAP queue 1, item 10)")
    if not sync:
        raise NotImplementedError(
            "sync=False is not ported yet: it comes with the executors "
            "(ROADMAP queue 1, item 9)")


class Context:
    """Loads datasets and runs UDFs on one device: the CUDA card by
    default (raising when there is none), or the CPU when asked for
    with ``device="cpu"``."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        # host feed timings of the last run (HostFeed.stats, with the
        # host engine's time in "host_s") and what it ran
        # (UDFRunner.run_info: engines, fused, compacted blocks)
        self.feed_stats: Optional[dict] = None
        self.run_info: Optional[dict] = None

    def close(self) -> None:
        """Nothing to release: a run's threads end with the run."""

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
        by the keywords given.  Without a given
        ``num_partitions`` the dataset splits into at least
        ``MIN_PARTITIONS`` partitions, as in the JAX package."""
        from .io.dataset import make
        ds = make(filetype, *args, **kwargs)
        ds.set_num_cores(MIN_PARTITIONS)
        return ds.initialize()

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
        ``common.progress.ProgressReporter``.  ``plots`` and
        ``sync=False`` are not ported yet and raise.

        Returns a dict of result buffers for a single UDF, or a list of
        dicts for a sequence of UDFs."""
        _not_ported(plots, sync)
        udfs, single = self._normalize_udfs(udf)
        runner = UDFRunner(udfs, backends=backends)
        results = runner.run_for_dataset(
            dataset, self.device, roi=self._normalize_roi(roi, dataset),
            corrections=corrections, progress=progress,
        )
        self.feed_stats = runner.feed_stats
        self.run_info = runner.run_info
        wrapped = [
            SingleUDFResults(b, results.damage) for b in results.buffers
        ]
        return wrapped[0] if single else wrapped

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
    ) -> ResultGenerator:
        """Live partial results: a :class:`ResultGenerator` of
        ``UDFResults`` (``.buffers``, one dict per UDF, and
        ``.damage``), one after every merged partition, the last of them
        the final result.  Its ``update_parameters_experimental`` patches
        the UDFs' arguments from the next partition on; ``close()``
        abandons the run.  Arguments as :meth:`run_udf`."""
        _not_ported(plots, sync)
        udfs, _ = self._normalize_udfs(udf)
        runner = UDFRunner(udfs, backends=backends)
        gen = runner.run_for_dataset_iter(
            dataset, self.device, roi=self._normalize_roi(roi, dataset),
            corrections=corrections, progress=progress,
        )
        return ResultGenerator(gen, runner, self)

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
