"""UDF contract and the runner (counterpart of
``libertem_tpu/udf/base.py``).

A run streams the dataset (the frames of its roi, when it has one) as
fixed-depth, zero-padded ``(depth, pixels)`` blocks of raw-dtype
frames; with corrections, each block is dark-subtracted, gain-scaled
and repaired on the device first (``UDFRunner._apply_corrections``).
Each UDF runs on one of two engines, chosen once per run in
``_prepare`` and kept for the whole run:

* the **device engine** (``get_backends()`` includes ``"torch"``, the
  default): torch operations on the block on the run's device, on one
  of two paths:

  - **fused**: when every device UDF of the set declares a
    ``fused_moments_spec`` (ApplyMasks, CoM, Sum, SumSig, StdDev,
    NoOp), the whole pass is one fused moments op per block
    (:func:`libertem_tpu_torch.ops.moments.fused_moments`), and its
    three outputs are distributed into each UDF's state; a masks-only
    pass whose stack touches few 128-pixel blocks gathers those
    blocks first (``ops/sparse_masks.py``);
  - **generic**: otherwise every device UDF runs its own
    ``process_*`` method on the block, eagerly: ``process_tile`` and
    ``process_partition`` once per sig tile of the scheme,
    ``process_frame`` under ``torch.func.vmap`` when the UDF writes
    only nav buffers, else as a loop over the block's valid frames;

* the **host engine** (``udf/host.py``): UDFs that declare only
  numpy-like backends, and UDFs whose ``process_*`` or ``merge`` the
  device engine cannot run (probed on meta tensors, with a warning),
  process the pinned host copy of the same block with numpy and
  mutable-view semantics.

Per partition, every UDF's ``preprocess`` runs before its first block
and ``postprocess`` after its last, before the merge; ``cleanup`` runs
at the end of the run, after the results are wrapped.  Aux buffers
(``UDF.aux_data``) are roi-compressed and handed out per block as
``self.params.<name>``.

Device state:

* ``kind='nav'`` buffers: one tensor each, roi-compressed, with
  ``depth`` pad rows so every block has a full-depth view.  A UDF gets
  a clone of its block's rows; only the rows ``< valid`` are written
  back, so writes to padding never reach the next block's frames.
* ``kind='sig'|'single'`` buffers accumulate per partition, starting
  from zeros; at the end of the partition ``UDF.merge`` folds them
  into the run's state.

Results come back to the host at the end, or after every merged
partition for live partial results (``run_for_dataset_iter``, with a
damage mask of the nav positions merged so far), where
``UDF.get_results`` post-processes them with numpy; nav results are
expanded from the roi to the full nav shape there.  A parameter patch
(``update_parameters_experimental``) applies from the next partition
on; progress goes to a ``common.progress.ProgressReporter``.

Not ported yet: the sharded loop.
"""
from __future__ import annotations

import contextlib
import enum
import queue
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.buffers import ArrayWithMask, AuxBufferWrapper, BufferWrapper
from ..common.exceptions import UDFException
from ..warnings import UseDiscouragedWarning
from ..common.shape import Shape
from ..common.slice import Slice
from ..io.corrections import CorrectionSet
from ..io.dataset.base import (
    DataSet,
    Partition,
    ReadCancelled,
    densify_into,
)
from ..io.tiling import (
    TILE_DEPTH_DEFAULT,
    TILE_DEPTH_MAX,
    TILE_SIZE_BEST_FIT,
    TILE_SIZE_MAX,
    Negotiator,
    TilingScheme,
)
from ..ops.moments import fused_moments
from ..ops.sparse_masks import (
    compaction_pays,
    gather_blocks,
    plan_compaction,
)


class _LegacyBufferView(np.ndarray):
    """A host buffer as ``self.results["name"]`` returns it: an ndarray
    view that also answers ``.raw_data`` and ``.data``, as the result
    buffers of older versions did."""

    @property
    def raw_data(self):
        return np.asarray(self)

    @property
    def data(self):
        return np.asarray(self)


class UDFData:
    """Attribute-style accessor over a dict of arrays; records writes.
    Dict-style access (``results["x"]``) works too, with a
    UseDiscouragedWarning."""

    def __init__(self, data: dict):
        object.__setattr__(self, "_data", dict(data))
        object.__setattr__(self, "_touched", set())

    def __getattr__(self, k):
        try:
            return object.__getattribute__(self, "_data")[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self._data[k] = v
        self._touched.add(k)

    def __getitem__(self, k):
        warnings.warn(
            "dict-style access on UDF results is discouraged; use "
            "attribute access (self.results.name)",
            UseDiscouragedWarning, stacklevel=2,
        )
        v = self._data[k]
        if isinstance(v, np.ndarray):
            return v.view(_LegacyBufferView)
        return v

    def __setitem__(self, k, v):
        self._data[k] = v
        self._touched.add(k)

    def __contains__(self, k) -> bool:
        return k in self._data

    def _get(self, k):
        return self._data[k]

    def get(self, k, default=None):
        return self._data.get(k, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def as_dict(self) -> dict:
        return dict(self._data)


class UDFParams:
    """Attribute access to a UDF's constructor arguments; while a UDF
    processes frames, its aux arguments resolve to the rows of those
    frames (``aux_views``).  ``keys``, ``items`` and ``as_dict`` list
    the arguments as given."""

    def __init__(self, kwargs: dict, aux_views: Optional[dict] = None):
        object.__setattr__(self, "_kwargs", kwargs)
        object.__setattr__(self, "_aux_views", aux_views or {})

    def __getattr__(self, k):
        aux_views = object.__getattribute__(self, "_aux_views")
        if k in aux_views:
            return aux_views[k]
        try:
            return object.__getattribute__(self, "_kwargs")[k]
        except KeyError:
            raise AttributeError(k) from None

    def __getitem__(self, k):
        if k in self._aux_views:
            return self._aux_views[k]
        return self._kwargs[k]

    def __contains__(self, k) -> bool:
        return k in self._kwargs

    def get(self, k, default=None):
        if k in self._aux_views:
            return self._aux_views[k]
        return self._kwargs.get(k, default)

    def keys(self):
        return self._kwargs.keys()

    def items(self):
        return self._kwargs.items()

    def as_dict(self) -> dict:
        return dict(self._kwargs)


class UDFMethod(str, enum.Enum):
    """Which ``process_*`` entry point a UDF runs through."""

    TILE = "tile"
    FRAME = "frame"
    PARTITION = "partition"

    def __str__(self):
        return self.value


class UDFMeta:
    """What a UDF sees of the run as ``self.meta``.

    Per block, while a UDF processes it, the runner sets
    ``coordinates`` ((depth, nav_dims) int32 tensor of the frames' nav
    positions, zeros in padding rows; (nav_dims,) in
    ``process_frame``), ``tile_valid`` ((depth,) bool tensor),
    ``valid_frames`` (int), ``global_offset`` (int: the block's first
    frame in the roi-compressed nav order), ``sig_slice`` (the sig
    tile, a :class:`Slice`) and ``tiling_scheme_idx``.  On the host
    engine the same fields hold numpy arrays over the block's valid
    frames, ``array_backend`` is ``"numpy"`` (``"torch"`` on the
    device engine) and ``slice`` is the block's (or frame's, or
    tile's) flat-nav :class:`Slice`.  During ``get_task_data``,
    ``coordinates`` holds the numpy coordinates of every frame of the
    run, and ``slice`` covers them (of the partition, when the engine
    calls it again per partition; ``partition_slice`` too then).
    ``device_class`` is the run's device type (``"cuda"`` or
    ``"cpu"``), ``corrections`` the run's CorrectionSet or None.
    """

    def __init__(self, dataset_shape: Shape, dataset_dtype, input_dtype,
                 roi: Optional[np.ndarray] = None,
                 tiling_scheme: Optional[TilingScheme] = None,
                 device: Optional[torch.device] = None,
                 corrections: Optional[CorrectionSet] = None,
                 threads_per_worker: int = 1,
                 partition_slice: Optional[Slice] = None):
        self.dataset_shape = dataset_shape
        self.dataset_dtype = np.dtype(dataset_dtype)
        self.input_dtype = np.dtype(input_dtype)
        self._roi = roi
        self.tiling_scheme = tiling_scheme
        self.device = torch.device("cpu") if device is None else device
        self.device_class = self.device.type
        self.corrections = corrections
        self.threads_per_worker = threads_per_worker
        self.array_backend = "torch"
        self.coordinates = None
        self.tile_valid = None
        self.valid_frames = None
        self.global_offset = None
        self.sig_slice: Optional[Slice] = None
        self.tiling_scheme_idx = 0
        self._valid_nav_mask: Optional[np.ndarray] = None
        # the concrete slices, where there are (host engine,
        # get_task_data); None on the device engine
        self._slice: Optional[Slice] = None
        self._partition_slice: Optional[Slice] = partition_slice

    @property
    def roi(self) -> Optional[np.ndarray]:
        """The run's roi in nav shape, or None."""
        if self._roi is None:
            return None
        return np.asarray(self._roi, dtype=bool).reshape(
            tuple(self.dataset_shape.nav)
        )

    @roi.setter
    def roi(self, value) -> None:
        self._roi = value

    @property
    def slice(self) -> Slice:
        """The flat-nav :class:`Slice` being processed, where the
        engine has a concrete one: on the host engine and during
        ``get_task_data``.  The device engine raises AttributeError:
        use ``global_offset``, ``coordinates`` and ``sig_slice``
        there."""
        if self._slice is not None:
            return self._slice
        raise AttributeError(
            "meta.slice is not available on the device engine; use "
            "meta.global_offset / meta.coordinates / meta.sig_slice "
            "(see UDFMeta docs)"
        )

    @property
    def partition_slice(self) -> Slice:
        """The current partition's flat-nav :class:`Slice` (roi-
        compressed), where the engine has a concrete one (a host
        ``process_partition``, ``get_task_data`` per partition); else
        AttributeError."""
        if self._partition_slice is not None:
            return self._partition_slice
        raise AttributeError(
            "partition_slice is not available on the device engine; "
            "use meta.coordinates / meta.global_offset (see UDFMeta "
            "docs)"
        )

    @property
    def partition_shape(self) -> Shape:
        """The current partition's shape, roi-compressed."""
        return self.partition_slice.shape

    @property
    def sig_shape(self) -> tuple:
        return tuple(self.dataset_shape.sig)

    def get_valid_nav_mask(self, full_nav: bool = False
                           ) -> Optional[np.ndarray]:
        """The nav positions merged so far, flat (roi-compressed, or
        over the whole nav with ``full_nav``): set while
        ``get_results`` runs (for a partial result too), else None."""
        if self._valid_nav_mask is None:
            return None
        m = np.asarray(self._valid_nav_mask, dtype=bool).reshape(-1)
        if full_nav and self._roi is not None:
            full = np.zeros(self.dataset_shape.nav.size, dtype=bool)
            full[np.asarray(self._roi, dtype=bool).reshape(-1)] = m
            return full
        return m

    def set_valid_nav_mask(self, new_valid_nav_mask) -> None:
        self._valid_nav_mask = new_valid_nav_mask


class UDF:
    """Base class of user-defined functions: declare result buffers in
    ``get_result_buffers``, implement one of ``process_tile(tile)``,
    ``process_frame(frame)`` or ``process_partition(partition)`` with
    torch operations on the tensors it is given (on the run's device,
    ``self.meta.device``), and ``merge(dest, src)`` when declaring
    non-nav buffers.  A UDF that declares ``fused_moments_spec`` can
    also join the fused pass.

    Inside ``process_*``, update buffers by assignment
    (``self.results.x = self.results.x + v``) or in place
    (``self.results.x += v``); a nav buffer holds the block's rows.

    A UDF written with numpy declares ``get_backends() ->
    (self.BACKEND_NUMPY,)`` and runs on the host engine, where its
    buffers are mutable numpy views (``self.results.x[:] += v``).
    ``self.xp`` is ``torch`` on the device engine and ``numpy`` on the
    host engine.
    """

    USE_NATIVE_DTYPE = np.bool_  # result_type(bool, x) == x
    TILE_SIZE_BEST_FIT = TILE_SIZE_BEST_FIT
    TILE_SIZE_MAX = TILE_SIZE_MAX
    TILE_DEPTH_DEFAULT = TILE_DEPTH_DEFAULT
    TILE_DEPTH_MAX = TILE_DEPTH_MAX

    # the device engine's spelling; the JAX package's is "jax"
    BACKEND_TORCH = "torch"
    BACKEND_NUMPY = "numpy"
    # further backend spellings of UDFs written for other engines:
    # the sparse ones run on the host engine like numpy (it converts
    # the dense host block), the CUDA ones on the device engine
    BACKEND_CUPY = "cupy"
    BACKEND_CUDA = "cuda"
    BACKEND_SPARSE_COO = "sparse.COO"
    BACKEND_SPARSE_GCXS = "sparse.GCXS"
    BACKEND_SPARSE_DOK = "sparse.DOK"
    BACKEND_SCIPY_COO = "scipy.sparse.coo_matrix"
    BACKEND_SCIPY_CSR = "scipy.sparse.csr_matrix"
    BACKEND_SCIPY_CSC = "scipy.sparse.csc_matrix"
    BACKEND_SCIPY_COO_ARRAY = "scipy.sparse.coo_array"
    BACKEND_SCIPY_CSR_ARRAY = "scipy.sparse.csr_array"
    BACKEND_SCIPY_CSC_ARRAY = "scipy.sparse.csc_array"
    BACKEND_CUPY_SCIPY_COO = "cupyx.scipy.sparse.coo_matrix"
    BACKEND_CUPY_SCIPY_CSR = "cupyx.scipy.sparse.csr_matrix"
    BACKEND_CUPY_SCIPY_CSC = "cupyx.scipy.sparse.csc_matrix"
    BACKEND_ALL = (
        BACKEND_TORCH, BACKEND_NUMPY, BACKEND_CUPY, BACKEND_CUDA,
        BACKEND_SPARSE_COO, BACKEND_SPARSE_GCXS, BACKEND_SPARSE_DOK,
        BACKEND_SCIPY_COO, BACKEND_SCIPY_CSR, BACKEND_SCIPY_CSC,
        BACKEND_SCIPY_COO_ARRAY, BACKEND_SCIPY_CSR_ARRAY,
        BACKEND_SCIPY_CSC_ARRAY, BACKEND_CUPY_SCIPY_COO,
        BACKEND_CUPY_SCIPY_CSR, BACKEND_CUPY_SCIPY_CSC,
    )

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self.params = UDFParams(kwargs)
        self.results: Optional[UDFData] = None
        self.meta: Optional[UDFMeta] = None
        self.task_data: Optional[UDFData] = None
        self._host_mode = False

    def copy(self) -> "UDF":
        """A new instance with the same constructor arguments."""
        return type(self)(**self._kwargs)

    def get_result_buffers(self) -> dict:
        raise NotImplementedError()

    @staticmethod
    def buffer(kind, extra_shape=(), dtype="float32", where=None, use=None):
        """A result buffer declaration (``where`` is accepted for the
        JAX package's signature; the engine places the state)."""
        return BufferWrapper(kind, extra_shape, dtype, where, use)

    @classmethod
    def aux_data(cls, data, kind="nav", extra_shape=(), dtype="float32"):
        """Per-frame input data, passed as a constructor argument."""
        return AuxBufferWrapper(kind, extra_shape, dtype, data=data)

    @staticmethod
    def with_mask(data, mask):
        """Mark the valid region of a ``get_results`` value."""
        return ArrayWithMask(data, mask)

    def merge(self, dest: UDFData, src: UDFData):
        raise UDFException(
            f"{type(self).__name__} declares non-nav buffers and must "
            f"implement merge(dest, src)"
        )

    def merge_all(self, ordered_results: Sequence[UDFData]) -> dict:
        """Fold a sequence of partial sig/single states (``UDFData``)
        pairwise with ``merge``, into a dict.  The engine folds with
        ``merge`` as it goes and never calls this; it is for code that
        folds recorded partial results."""
        if not ordered_results:
            return {}
        acc = UDFData(dict(ordered_results[0].items()))
        for src in ordered_results[1:]:
            self.merge(acc, src)
        return acc.as_dict()

    def get_results(self) -> dict:
        return {}

    def preprocess(self):
        """Called per partition before its first block."""

    def postprocess(self):
        """Called per partition after its last block, before the
        merge, with the partition's buffers bound as numpy arrays."""

    def cleanup(self):
        """Called after the run (and before ``get_task_data`` is called
        again per partition): release task_data resources here."""

    def on_params_updated(self):
        """Drop caches derived from the parameters or the dataset's sig
        shape (called when an instance is reused on another sig
        shape)."""

    def get_backends(self):
        return (self.BACKEND_TORCH,)

    @property
    def xp(self):
        return np if self._host_mode else torch

    def forbuf(self, arr, target):
        """``arr`` as the array type of ``target`` (a buffer view)."""
        if isinstance(target, torch.Tensor):
            return torch.as_tensor(arr, device=target.device)
        if isinstance(arr, torch.Tensor):
            return arr.cpu().numpy()
        return arr

    def _has_custom_merge(self) -> bool:
        return type(self).merge is not UDF.merge

    def get_preferred_input_dtype(self):
        return np.float32

    def get_tiling_preferences(self) -> dict:
        return {
            "depth": TILE_DEPTH_DEFAULT,
            "total_size": TILE_SIZE_MAX,
        }

    def get_task_data(self) -> dict:
        """Per-run data, available as ``self.task_data`` in the
        ``process_*`` methods; called once per run."""
        return {}

    def get_method(self) -> UDFMethod:
        """Which entry point to dispatch through: tile before frame
        before partition, TypeError when nothing is implemented."""
        if hasattr(self, "process_tile"):
            return UDFMethod.TILE
        if hasattr(self, "process_frame"):
            return UDFMethod.FRAME
        if hasattr(self, "process_partition"):
            return UDFMethod.PARTITION
        raise TypeError(
            f"{type(self).__name__} must implement one of process_tile / "
            f"process_frame / process_partition"
        )

    def requires_custom_merge(self, decls: dict) -> bool:
        return any(
            b.kind != "nav" for b in decls.values()
            if b.use != "result_only"
        )


# markers of the process_* and hook methods a UDF implements; the
# engine finds them by name, so the mixins carry no behaviour
class UDFFrameMixin:
    """Declares process_frame(frame)."""


class UDFTileMixin:
    """Declares process_tile(tile)."""


class UDFPartitionMixin:
    """Declares process_partition(partition)."""


class UDFPreprocessMixin:
    """Declares preprocess()."""


class UDFPostprocessMixin:
    """Declares postprocess()."""


class UDFMergeAllMixin:
    """Declares merge_all(ordered_results)."""


class NoOpUDF(UDF):
    """Reads the data and does nothing: an I/O benchmark."""

    def process_tile(self, tile):
        pass

    def get_result_buffers(self):
        return {}

    def fused_moments_spec(self):
        return {"mode": "noop"}


@dataclass
class UDFResults:
    """One dict of result BufferWrappers per UDF, plus the damage
    buffer (which nav positions hold merged results)."""

    buffers: list
    damage: BufferWrapper


def _get_input_dtype(udfs: Sequence[UDF], ds_dtype) -> np.dtype:
    """result_type of all UDF preferences and the dataset dtype."""
    parts = [u.get_preferred_input_dtype() for u in udfs]
    return np.result_type(*parts, ds_dtype)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _state_dtype(dtype) -> torch.dtype:
    """Device state dtype of a declared buffer: 64-bit floats (and
    complex128) run in 32 bits on the device, as in the JAX package;
    the result is cast back to the declared dtype on the host."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        dtype = np.dtype(np.float32)
    elif dtype == np.complex128:
        dtype = np.dtype(np.complex64)
    return _torch_dtype(dtype)


def _as_state(value, like: torch.Tensor) -> torch.Tensor:
    """A UDF's buffer value as a tensor of ``like``'s dtype (and
    device)."""
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


@contextlib.contextmanager
def _full_fp32_matmul():
    """TF32 off for the run's float32 products (the generic ApplyMasks
    and CoM matmuls): TF32 keeps about three decimal digits, the
    results' contract is 1e-5."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# backend spellings each engine serves
_HOST_LIKE = frozenset({
    UDF.BACKEND_NUMPY, UDF.BACKEND_SPARSE_COO, UDF.BACKEND_SPARSE_GCXS,
    UDF.BACKEND_SPARSE_DOK, UDF.BACKEND_SCIPY_COO, UDF.BACKEND_SCIPY_CSR,
    UDF.BACKEND_SCIPY_CSC, UDF.BACKEND_SCIPY_COO_ARRAY,
    UDF.BACKEND_SCIPY_CSR_ARRAY, UDF.BACKEND_SCIPY_CSC_ARRAY,
})
_DEVICE_LIKE = frozenset({
    UDF.BACKEND_TORCH, UDF.BACKEND_CUPY, UDF.BACKEND_CUDA,
    UDF.BACKEND_CUPY_SCIPY_COO, UDF.BACKEND_CUPY_SCIPY_CSR,
    UDF.BACKEND_CUPY_SCIPY_CSC,
})


class _UDFPlanEntry:
    """Per-UDF static plan: declarations split by residency, the
    ``process_*`` method the UDF runs through, and its engine
    (``host``): the host engine when its backends, narrowed by the
    run's restriction (``Context.run_udf(backends=...)``) and the
    instance's own (``_backend_restriction``), are host-like only."""

    def __init__(self, udf: UDF, decls: dict, run_restriction=None):
        self.udf = udf
        self.decls = decls
        self.nav_names = [
            n for n, b in decls.items()
            if b.kind == "nav" and b.use != "result_only"
        ]
        self.part_names = [
            n for n, b in decls.items()
            if b.kind in ("sig", "single") and b.use != "result_only"
        ]
        self.result_only_names = [
            n for n, b in decls.items() if b.use == "result_only"
        ]
        method = udf.get_method()
        if method not in tuple(UDFMethod):
            raise UDFException(
                f"{type(udf).__name__}.get_method() returned "
                f"unrecognized method {method!r}"
            )
        self.method = UDFMethod(method).value
        if not hasattr(udf, f"process_{self.method}"):
            raise UDFException(
                f"{type(udf).__name__}.get_method() chose "
                f"{self.method!r} but process_{self.method} is not "
                f"implemented"
            )
        backends = udf.get_backends()
        if isinstance(backends, str):
            backends = (backends,)
        restriction = getattr(udf, "_backend_restriction", None)
        if run_restriction is not None:
            restriction = (
                tuple(set(restriction) & set(run_restriction))
                if restriction is not None else tuple(run_restriction)
            )
        if restriction is not None:
            allowed = set(backends) & set(restriction)
            if not allowed:
                raise UDFException(
                    f"{type(udf).__name__} supports backends {backends}, "
                    f"none of which are in the requested restriction "
                    f"{restriction}"
                )
            backends = tuple(b for b in backends if b in allowed)
        bset = set(backends)
        if not bset & (_HOST_LIKE | _DEVICE_LIKE):
            raise UDFException(
                f"{type(udf).__name__} declares backends {backends}, none "
                f"of which this engine can provide (torch/numpy or "
                f"another spelling of either)"
            )
        self.host = bool(bset & _HOST_LIKE) and UDF.BACKEND_TORCH not in bset
        # the host block's format: the first host-like spelling in the
        # UDF's declared order
        self.host_array_backend = next(
            (b for b in backends if b in _HOST_LIKE), UDF.BACKEND_NUMPY
        )
        # frame-mode UDFs that only write nav buffers can be vmapped
        self.frame_navonly = self.method == "frame" and not self.part_names


@dataclass
class FusedPlan:
    """The cross-UDF fused pass: one mask stack for all projections and
    where each UDF's share of the outputs goes.

    masks_t: (M, pixels) float32; rows of each ``masks`` spec at its
             ``off``, and a ones row for ``sumsig``
    specs:   one dict per UDF: ``ui`` (index in the UDF list),
             ``mode`` (masks | sumsig | colsum | stats | noop) and, by
             mode, ``name``, ``off``, ``n``
    compaction: for a masks-only pass whose stack's union support is
             at most half the frame, ``ops.sparse_masks.plan_compaction``
             of ``masks_t`` (``support``, ``n_blocks``, ``block``,
             ``operand_c`` (S*block, M), ``fill``), else None; a run
             uses it where ``compaction_pays`` on its device
    """

    masks_t: np.ndarray
    specs: list
    need_var: bool
    need_colsum: bool
    compaction: Optional[dict] = None


class HostFeed:
    """Streams a dataset's blocks to the device, overlapped with
    compute (counterpart of ``UDFRunner._prefetch``).

    A background thread reads each block straight into one of
    ``SLOTS`` page-locked host buffers and, on the CUDA path, copies it
    to the matching device buffer with ``non_blocking=True`` on a side
    stream.  A sparse block (raw CSR) is read into page-locked staging
    for its ``(vals, rows, cols)`` entries instead, sized once for the
    largest entry budget of the run; only the block's entries cross to
    the device, where the side stream zeroes the slot's dense buffer
    and adds them into it (``densify_into``), so the steps see a dense
    block as before.  The ordering rules:

    * the step that reads a device buffer waits (on the device) for the
      event recorded after its copy (and densify);
    * a copy into a device buffer waits (on the device) for the event
      recorded after the previous step that read it;
    * the thread refills a host buffer only after the copy out of it
      has finished (a host wait on the copy event), and only after the
      consumer has released the slot.

    On the CPU the host buffers are the blocks themselves (a sparse
    block is densified into one by the thread).  Each item is usable
    until the consumer asks for the next one: ``Block.data`` is the
    pinned host slot itself, which the host engine reads in place (with
    ``host_reads``, the consumer also waits on the host for the slot's
    copy, so what the host engine does to the slot cannot reach the
    device).  Without ``to_device`` (no UDF runs on the device engine)
    nothing is copied and the device block is None.

    Stopping (the consumer went away): the thread gives up where it
    waits for a slot, and a read that waits for data gives up too
    (``Partition.stop_event``, ``ReadCancelled``).
    """

    SLOTS = 3

    def __init__(self, block_shape: tuple, dtype, device: torch.device,
                 to_device: bool = True, host_reads: bool = False):
        self._block_shape = tuple(block_shape)
        self._tdtype = _torch_dtype(dtype)
        self._device = device
        self._cuda = device.type == "cuda" and to_device
        self._to_device = to_device
        self._host_reads = host_reads
        self._host = self._dev = self._staging = self._dev_staging = None
        if self._cuda:
            self._dev = [
                torch.empty(block_shape, dtype=self._tdtype, device=device)
                for _ in range(self.SLOTS)
            ]
            self._copied = [torch.cuda.Event() for _ in range(self.SLOTS)]
            self._consumed = [
                torch.cuda.Event() for _ in range(self.SLOTS)
            ]
            self._stream = torch.cuda.Stream(device)
        # read_s: the reader filling host buffers; slot_wait_s: the
        # reader waiting for a free slot (the consumer is behind);
        # wait_s: the consumer waiting for a block (the feed is behind);
        # h2d_bytes: what crossed to the device
        self.stats = {
            "read_s": 0.0, "slot_wait_s": 0.0, "wait_s": 0.0, "blocks": 0,
            "h2d_bytes": 0,
        }

    def _allocate(self, nnz: Optional[int]) -> None:
        """The host buffers: dense slots, or (``nnz``: the largest
        entry budget of a sparse run) staging for that many entries a
        slot, beside dense CPU slots to densify into on the CPU."""
        pin = self._cuda
        if nnz is None or not self._cuda:
            self._host = [
                torch.empty(self._block_shape, dtype=self._tdtype,
                            pin_memory=pin)
                for _ in range(self.SLOTS)
            ]
            if not self._cuda:
                self._dev = self._host
        if nnz is None:
            return
        types = (self._tdtype, torch.int32, torch.int32)
        self._staging = [
            tuple(torch.empty(nnz, dtype=t, pin_memory=pin) for t in types)
            for _ in range(self.SLOTS)
        ]
        if self._cuda:
            self._dev_staging = [
                tuple(torch.empty(nnz, dtype=t, device=self._device)
                      for t in types)
                for _ in range(self.SLOTS)
            ]

    def run(self, partitions: Sequence[Partition], scheme: TilingScheme,
            roi: Optional[np.ndarray] = None):
        """Yield ``(partition index, device block, Block)`` for every
        block of every partition (of the roi's frames), in order."""
        budgets = [p.sparse_nnz_budget(scheme, roi) for p in partitions]
        sparse = any(b is not None for b in budgets)
        self._allocate(max(b or 0 for b in budgets) if sparse else None)
        free = threading.Semaphore(self.SLOTS)
        stop = threading.Event()
        q: queue.Queue = queue.Queue()
        slot_of_next = [0]
        sig = tuple(scheme.dataset_shape.sig)

        def wait_for_slot() -> int:
            t0 = time.perf_counter()
            while not free.acquire(timeout=0.1):
                if stop.is_set():
                    raise ReadCancelled()
            slot = slot_of_next[0] % self.SLOTS
            if self._cuda:
                self._copied[slot].synchronize()
            self.stats["slot_wait_s"] += time.perf_counter() - t0
            return slot

        def acquire() -> np.ndarray:
            slot = wait_for_slot()
            return self._host[slot].numpy().reshape((scheme.depth,) + sig)

        def acquire_sparse(nnz: int) -> tuple:
            slot = wait_for_slot()
            return tuple(a[:nnz].numpy() for a in self._staging[slot])

        def to_device(slot: int, block) -> None:
            """The slot's copy to the device (densified there when the
            block is sparse: its own entries, not the budget's
            padding), on the side stream; on the CPU, a sparse block
            densified into the slot."""
            if block.sparse is not None:
                n = block.nnz
                if not self._cuda:
                    if self._to_device:
                        densify_into(self._dev[slot], *(
                            torch.from_numpy(a[:n]) for a in block.sparse))
                    return
                self.stats["h2d_bytes"] += sum(
                    a[:n].nbytes for a in block.sparse)
            elif not self._cuda:
                return
            else:
                self.stats["h2d_bytes"] += self._host[slot].nbytes
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(self._consumed[slot])
                if block.sparse is None:
                    self._dev[slot].copy_(self._host[slot],
                                          non_blocking=True)
                else:
                    staged = []
                    for d, h in zip(self._dev_staging[slot],
                                    self._staging[slot]):
                        d[:n].copy_(h[:n], non_blocking=True)
                        staged.append(d[:n])
                    densify_into(self._dev[slot], *staged)
                self._copied[slot].record(self._stream)

        def worker():
            try:
                if self._cuda:
                    torch.cuda.set_device(self._device)
                for pi, part in enumerate(partitions):
                    part.stop_event = stop
                    blocks = (
                        part.gen_blocks(scheme, roi,
                                        sparse_out=acquire_sparse)
                        if sparse else
                        part.gen_blocks(scheme, roi, out=acquire)
                    )
                    while True:
                        t0 = time.perf_counter()
                        waited = self.stats["slot_wait_s"]
                        block = next(blocks, None)
                        self.stats["read_s"] += (
                            time.perf_counter() - t0
                            - (self.stats["slot_wait_s"] - waited)
                        )
                        if block is None:
                            break
                        slot = slot_of_next[0] % self.SLOTS
                        slot_of_next[0] += 1
                        to_device(slot, block)
                        q.put(("item", (pi, slot, block)))
                q.put(("done", None))
            except ReadCancelled:
                pass
            except BaseException as e:  # handed to the consumer
                q.put(("error", e))

        thread = threading.Thread(target=worker, daemon=True,
                                  name="HostFeed-reader")
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                kind, payload = q.get()
                self.stats["wait_s"] += time.perf_counter() - t0
                if kind == "done":
                    break
                if kind == "error":
                    raise payload
                pi, slot, block = payload
                if self._cuda:
                    torch.cuda.current_stream(self._device).wait_event(
                        self._copied[slot]
                    )
                    if self._host_reads:
                        self._copied[slot].synchronize()
                self.stats["blocks"] += 1
                yield pi, self._dev[slot] if self._to_device else None, block
                if self._cuda:
                    self._consumed[slot].record(
                        torch.cuda.current_stream(self._device)
                    )
                free.release()
        finally:
            stop.set()
            thread.join(timeout=60)


class UDFRunner:
    """Runs a set of UDFs over a dataset in one read pass: the device
    UDFs fused when each can join the fused moments op, else generic;
    the host UDFs on the host engine, on the same blocks."""

    def __init__(self, udfs: Sequence[UDF], backends=None):
        self._udfs = list(udfs)
        self._backends = (
            None if backends is None
            else (backends,) if isinstance(backends, str)
            else tuple(backends)
        )
        self._params_patched = False
        self.feed_stats: Optional[dict] = None
        # what the last run did: each UDF's engine ("device" or "host"),
        # whether the device UDFs ran fused, on how many 128-pixel
        # blocks when the fused pass ran compacted (else None), and the
        # fused pass's compaction plan, used or not (else None); after
        # a parameter patch, what the run does from then on
        self.run_info: Optional[dict] = None

    def update_parameters_experimental(self, patches: Sequence[dict]
                                       ) -> None:
        """Patch the UDFs' constructor arguments mid-run, one dict per
        UDF (``{}`` for no change); the patch applies from the next
        partition on.  Each patched UDF drops its derived caches in
        ``on_params_updated``."""
        if len(patches) != len(self._udfs):
            raise ValueError(
                f"got {len(patches)} patches for {len(self._udfs)} UDFs "
                f"- pass one entry per UDF ({{}} for no change)"
            )
        for udf, patch in zip(self._udfs, patches):
            if not patch:
                continue
            udf._kwargs.update(patch)
            udf.params = UDFParams(udf._kwargs)
            udf.on_params_updated()
        self._params_patched = True

    def run_for_dataset(self, dataset: DataSet, device: torch.device,
                        roi: Optional[np.ndarray] = None,
                        corrections: Optional[CorrectionSet] = None,
                        progress=False) -> UDFResults:
        gen = self.run_for_dataset_iter(
            dataset, device, roi=roi, corrections=corrections,
            progress=progress, yield_partial=False,
        )
        result = next(gen)
        for _ in gen:  # runs the cleanup
            pass
        return result

    def run_for_dataset_iter(self, dataset: DataSet, device: torch.device,
                             roi: Optional[np.ndarray] = None,
                             corrections: Optional[CorrectionSet] = None,
                             progress=False, yield_partial: bool = True):
        """Generator of UDFResults: one after every merged partition,
        the last of them the final result (only the final one with
        ``yield_partial=False``).  ``progress``: False, True (a tqdm
        bar) or a ``ProgressReporter``.  Closing the generator early
        stops the host feed's reader and releases its slots."""
        prep = self._prepare(dataset, device, roi, corrections)
        self.run_info = self._run_info(prep)
        try:
            yield from self._run_loop(prep, dataset, progress, yield_partial)
        finally:
            # the final result is wrapped before this: get_results may
            # read task_data, which cleanup releases
            for udf in self._udfs:
                udf.cleanup()

    def dry_run(self, dataset: DataSet, roi: Optional[np.ndarray] = None
                ) -> UDFResults:
        """The result buffers a run would declare, from zero state,
        without reading data (prepared on the CPU)."""
        prep = self._prepare(dataset, torch.device("cpu"), roi)
        try:
            return self._wrap_results(
                prep, self._init_state(prep), {},
                np.zeros(prep["n_nav"], dtype=bool),
            )
        finally:
            for udf in self._udfs:
                udf.cleanup()

    @staticmethod
    def _run_info(prep) -> dict:
        fused = prep["fused"]
        return {
            "engines": ["host" if e.host else "device" for e in prep["plan"]],
            "fused": fused is not None,
            "compacted_blocks": (
                None if prep["support"] is None
                else int(prep["support"].numel())
            ),
            "compaction": None if fused is None else fused.compaction,
        }

    # -- preparation ---------------------------------------------------

    def _prepare(self, dataset: DataSet, device: torch.device,
                 roi: Optional[np.ndarray] = None,
                 corrections: Optional[CorrectionSet] = None) -> dict:
        udfs = self._udfs
        meta0 = dataset.meta
        nav_shape = tuple(meta0.shape.nav)
        if roi is not None:
            roi = np.asarray(roi).reshape(-1).astype(bool)
            if roi.size != meta0.shape.nav.size:
                raise ValueError(
                    f"roi size {roi.size} != nav size "
                    f"{meta0.shape.nav.size}"
                )
        # an instance reused on a dataset of another sig shape drops
        # its shape-derived caches (mask stacks, operands)
        sig_key = tuple(meta0.shape.sig)
        for u in udfs:
            prev = getattr(u, "_prepared_sig_shape", None)
            if prev is not None and prev != sig_key:
                u.on_params_updated()
            u._prepared_sig_shape = sig_key
        input_dtype = _get_input_dtype(udfs, meta0.native_dtype)
        # the device computes in 32 bits, as the JAX package does
        if input_dtype == np.float64:
            input_dtype = np.dtype(np.float32)
        elif input_dtype == np.complex128:
            input_dtype = np.dtype(np.complex64)
        if corrections is None:
            # the corrections the dataset carries (an FRMS6 dark file,
            # SEQ sidecars), as the JAX package applies them
            corrections = dataset.get_correction_data()
        # meta.corrections: the run's set, empty or not, as in the JAX
        # package; the engine drops an empty one
        meta_corrections = corrections
        if corrections is not None and not corrections.have_corrections():
            corrections = None
        if corrections is not None and input_dtype.kind not in "fc":
            # dark subtraction and gain in integer arithmetic would
            # wrap around and truncate
            input_dtype = np.dtype(np.float32)
        partitions = list(dataset.get_partitions())
        max_part_frames = max(
            (p.frames_in_roi(roi) for p in partitions), default=1
        )
        # meta is usable in get_tiling_preferences already
        meta = UDFMeta(
            dataset_shape=meta0.shape,
            dataset_dtype=meta0.native_dtype,
            input_dtype=input_dtype,
            roi=roi,
            device=device,
            corrections=meta_corrections,
        )
        for udf in udfs:
            udf.meta = meta
        scheme = Negotiator().get_scheme(
            udfs, meta0.shape, input_dtype,
            max_partition_frames=max(1, max_part_frames),
            corrections=corrections,
            max_io_size=dataset.get_max_io_size(),
        )
        scheme = self._dataset_scheme(dataset, scheme, roi)
        meta.tiling_scheme = scheme
        n_nav = (
            int(np.count_nonzero(roi)) if roi is not None
            else meta0.shape.nav.size
        )
        # get_task_data runs once per run and sees the coordinates of
        # every selected frame
        flat_ids = np.flatnonzero(roi) if roi is not None else np.arange(
            n_nav
        )
        meta.coordinates = np.stack(
            np.unravel_index(flat_ids, nav_shape), axis=-1
        ).astype(np.int32).reshape(n_nav, len(nav_shape))
        sig = tuple(meta0.shape.sig)
        meta._slice = Slice((0,) * (1 + len(sig)),
                            Shape((n_nav,) + sig, sig_dims=len(sig)))
        plan = []
        try:
            for udf in udfs:
                # aux arguments bind to the dataset before the buffer
                # declarations, which may read their shape
                for v in udf._kwargs.values():
                    if isinstance(v, AuxBufferWrapper):
                        v.set_shape_ds(meta0.shape, roi)
                entry = self._plan_entry(udf, meta0.shape, roi)
                if (udf.requires_custom_merge(entry.decls)
                        and not udf._has_custom_merge()):
                    raise NotImplementedError(
                        f"{type(udf).__name__} declares non-nav buffers "
                        f"and must implement merge()"
                    )
                udf.task_data = UDFData(udf.get_task_data() or {})
                plan.append(entry)
        finally:
            # the probe must not see the run's slice: a UDF that reads
            # meta.slice runs on the host engine
            meta.coordinates = None
            meta._slice = None
        self._auto_host_fallback(plan, meta, scheme, input_dtype,
                                 min(scheme.depth, max(1, max_part_frames)))
        # the 64-bit clamp above is for the device; a run whose UDFs
        # all ended up on the host engine keeps 64-bit precision
        raw_dtype = _get_input_dtype(udfs, meta0.native_dtype)
        if corrections is not None and raw_dtype.kind not in "fc":
            raw_dtype = np.dtype(np.float32)
        if raw_dtype != input_dtype and plan and all(e.host for e in plan):
            input_dtype = raw_dtype
            meta.input_dtype = np.dtype(raw_dtype)
            # declarations may follow meta.input_dtype: rebuild them,
            # keeping the engines chosen
            for i, entry in enumerate(plan):
                plan[i] = self._plan_entry(entry.udf, meta0.shape, roi)
                plan[i].host = entry.host
        aux, aux_host = self._build_aux(udfs, roi, n_nav, scheme, device)
        return {
            **self._fused_operands(plan, meta, device),
            "corr_plan": self._device_corr_plan(
                corrections, meta0.shape.sig, device
            ),
            "corrections": corrections,
            "input_dtype": input_dtype,
            "input_tdtype": _torch_dtype(input_dtype),
            "meta": meta,
            "plan": plan,
            "scheme": scheme,
            "partitions": partitions,
            "roi": roi,
            "n_nav": n_nav,
            "device": device,
            "aux": aux,
            "aux_host": aux_host,
        }

    def _dataset_scheme(self, dataset, scheme, roi) -> TilingScheme:
        """The dataset's say on the scheme (``adjust_tileshape``): it
        may change the sig tiles of any scheme, and the depth of a
        scheme that is not one block per partition.  A dataset that
        splits the frame cannot serve a ``process_frame`` UDF."""
        shape = tuple(scheme.shape)
        adjusted = dataset.adjust_tileshape(shape, roi)
        if adjusted is not None and scheme.intent == "partition":
            adjusted = shape[:1] + tuple(adjusted)[1:]
        if adjusted is not None and tuple(adjusted) != shape:
            ds_shape = scheme.dataset_shape
            scheme = TilingScheme.make_for_shape(
                Shape(tuple(adjusted), sig_dims=ds_shape.sig.dims),
                ds_shape, intent=scheme.intent,
            )
        if len(scheme) > 1 and any(
            str(u.get_method()) == "frame" for u in self._udfs
        ):
            raise UDFException(
                "a process_frame UDF needs whole frames, but the "
                "dataset forces sig-split tiles "
                f"({len(scheme)} sig slices)"
            )
        return scheme

    def _fused_operands(self, plan, meta, device) -> dict:
        """The fused plan (None: the device UDFs run generic), its mask
        operand on the device and, where compaction pays there, the
        support blocks."""
        fused = self._build_fused_plan(plan, meta)
        masks_t = support = None
        if fused is not None:
            comp = fused.compaction
            if not compaction_pays(comp, device, "fused_moments"):
                comp = None
            masks_t = torch.from_numpy(np.ascontiguousarray(
                fused.masks_t if comp is None else comp["operand_c"].T
            )).to(device)
            if comp is not None:
                support = torch.from_numpy(
                    comp["support"].astype(np.int64)
                ).to(device)
        return {"fused": fused, "masks_t": masks_t, "support": support}

    def _apply_param_patch(self, prep) -> None:
        """A parameter patch, at a partition boundary: rebuild what
        derives from the UDFs' arguments -- the fused plan and its
        operand (which also decide fused or generic) and the aux
        arrays of both engines."""
        for udf in self._udfs:
            for v in udf._kwargs.values():
                if isinstance(v, AuxBufferWrapper):
                    v.set_shape_ds(prep["meta"].dataset_shape, prep["roi"])
        prep.update(self._fused_operands(prep["plan"], prep["meta"],
                                         prep["device"]))
        prep["aux"], prep["aux_host"] = self._build_aux(
            self._udfs, prep["roi"], prep["n_nav"], prep["scheme"],
            prep["device"],
        )
        self.run_info = self._run_info(prep)

    def _plan_entry(self, udf, ds_shape, roi) -> _UDFPlanEntry:
        decls = dict(udf.get_result_buffers())
        for b in decls.values():
            b.set_shape_ds(ds_shape, roi)
        return _UDFPlanEntry(udf, decls, run_restriction=self._backends)

    def _auto_host_fallback(self, plan, meta, scheme, input_dtype,
                            valid: int):
        """UDFs written with numpy semantics often declare no backends:
        probe each device entry with the default ``get_backends`` on
        meta tensors (no data, no device: ``np.asarray``, ``.item()``
        and data-dependent Python control flow raise there, on any
        machine), and route the ones the device engine cannot run to
        the host engine, with a warning.  Declared backends are
        trusted."""
        for entry in plan:
            if entry.host:
                continue
            udf = entry.udf
            if type(udf).get_backends is not UDF.get_backends:
                continue
            what = None
            if not self._probe_traceable(entry, meta, scheme, input_dtype,
                                         valid):
                what = f"process_{entry.method}"
            elif not self._probe_merge_traceable(entry, meta):
                what = "merge"
            if what is not None:
                warnings.warn(
                    f"{type(udf).__name__}.{what} cannot run on the "
                    f"device engine (torch tensors on the device); "
                    f"running it on the HOST engine with numpy "
                    f"semantics. Declare get_backends() explicitly to "
                    f"silence this warning."
                )
                entry.host = True

    _ON_META = {"device": torch.device("meta")}

    def _probe_merge_traceable(self, entry, meta) -> bool:
        """Run a custom merge as ``_merge`` calls it, on meta tensors of
        the sig/single buffers' shapes."""
        udf = entry.udf
        if not udf._has_custom_merge() or not entry.part_names:
            return True

        def part():
            return UDFData(self._init_part_state_one(self._ON_META, entry))

        try:
            udf.merge(part(), part())
            return True
        except Exception:
            return False

    def _probe_traceable(self, entry, meta, scheme, input_dtype,
                         valid: int) -> bool:
        """One ``process_*`` call through ``_run_udf_on_tile``, as the
        device engine makes it, on meta tensors of the real shapes: a
        block of ``valid`` frames, or of one frame for
        ``process_frame`` (whose calls do not depend on the block)."""
        udf = entry.udf
        depth = scheme.depth
        if entry.method == "frame":
            depth = valid = 1
        sig = tuple(meta.dataset_shape.sig)
        state_u = {
            n: self._zeros(self._ON_META, entry.decls[n],
                           (depth,) + entry.decls[n].extra_shape)
            for n in entry.nav_names
        }
        aux = {
            k: torch.zeros(
                (depth,) + v.extra_shape, dtype=_torch_dtype(v.dtype),
                device="meta",
            )
            for k, v in udf._kwargs.items()
            if isinstance(v, AuxBufferWrapper)
        }
        block = torch.zeros(
            (depth,) + sig, dtype=_torch_dtype(input_dtype), device="meta"
        )
        coords = torch.zeros((depth, meta.dataset_shape.nav.dims),
                             dtype=torch.int32, device="meta")
        part_u = self._init_part_state_one(self._ON_META, entry)
        valid_mask = torch.ones(depth, dtype=torch.bool, device="meta")
        device = meta.device
        meta.device = torch.device("meta")
        try:
            self._run_udf_on_tile(
                entry, block, 0, Slice.from_shape(sig, sig_dims=len(sig)),
                meta, state_u, part_u, 0, coords, valid_mask, valid, depth,
                aux,
            )
            return True
        except Exception:
            return False
        finally:
            meta.device = device
            udf.results = None
            udf.params = UDFParams(udf._kwargs)
            meta.coordinates = None
            meta.tile_valid = None
            meta.valid_frames = None
            meta.global_offset = None
            # drop what the UDF cached from meta tensors during the
            # probe
            udf.on_params_updated()

    @staticmethod
    def _build_aux(udfs, roi, n_nav, scheme, device):
        """Per UDF, its aux arguments' rows, roi-compressed and padded
        by one block depth of zeros (so the last block's slice is full
        depth): as tensors on the device and as host numpy arrays."""
        aux, aux_host = [], []
        for udf in udfs:
            dev, host = {}, {}
            for k, v in udf._kwargs.items():
                if not isinstance(v, AuxBufferWrapper):
                    continue
                data = v.aux_data
                if data is None:
                    raise UDFException(f"aux buffer {k} has no data")
                if roi is not None:
                    data = data[roi]
                if data.shape[0] != n_nav:
                    raise ValueError(
                        f"aux buffer {k}: {data.shape[0]} rows != "
                        f"{n_nav} selected frames"
                    )
                pad = np.zeros((scheme.depth,) + data.shape[1:], data.dtype)
                host[k] = np.concatenate([data, pad], axis=0)
                dev[k] = torch.from_numpy(host[k]).to(device)
            aux.append(dev)
            aux_host.append(host)
        return aux, aux_host

    @staticmethod
    def _device_corr_plan(corrections, sig_shape, device) -> Optional[dict]:
        """The correction plan as flat-pixel tensors on the device."""
        if corrections is None:
            return None
        plan = corrections.make_plan(tuple(sig_shape))
        if plan is None:
            return None

        def put(name, dtype):
            arr = plan[name]
            if arr is None:
                return None
            if name in ("dark", "gain"):
                arr = arr.reshape(-1)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device, dtype=dtype
            )

        return {
            "dark": put("dark", torch.float32),
            "gain": put("gain", torch.float32),
            "repair_idx": put("repair_idx", torch.long),
            "nbr_idx": put("nbr_idx", torch.long),
            "nbr_w": put("nbr_w", torch.float32),
        }

    def _build_fused_plan(self, plan, meta) -> Optional[FusedPlan]:
        """Collapse the device UDFs into one fused moments pass, or None
        when some device UDF cannot join it (or there is none).  Host
        entries do not take part and do not switch fusion off."""
        if np.dtype(meta.input_dtype).kind not in "fiu":
            return None
        device_entries = [(ui, e) for ui, e in enumerate(plan) if not e.host]
        if not device_entries:
            return None
        pixels = int(np.prod(meta.sig_shape))
        mask_rows = []
        specs = []
        need_var = False
        need_colsum = False
        col_off = 0
        for ui, entry in device_entries:
            spec_fn = getattr(entry.udf, "fused_moments_spec", None)
            s = None if spec_fn is None else spec_fn()
            if s is None:
                return None
            mode = s["mode"]
            if mode == "masks":
                op = np.asarray(s["operand"], dtype=np.float32)
                if op.ndim != 2 or op.shape[1] != pixels:
                    return None
                mask_rows.append(op)
                specs.append({
                    "ui": ui, "mode": "masks", "name": s["name"],
                    "off": col_off, "n": op.shape[0],
                })
                col_off += op.shape[0]
            elif mode == "sumsig":
                specs.append({
                    "ui": ui, "mode": "sumsig", "name": s["name"],
                    "off": None,
                })
            elif mode == "colsum":
                need_colsum = True
                specs.append({
                    "ui": ui, "mode": "colsum", "name": s["name"],
                })
            elif mode == "stats":
                need_var = True
                need_colsum = True
                specs.append({"ui": ui, "mode": "stats"})
            elif mode == "noop":
                specs.append({"ui": ui, "mode": "noop"})
            else:
                return None
        sumsig = any(s["mode"] == "sumsig" for s in specs)
        if sumsig:
            mask_rows.append(np.ones((1, pixels), dtype=np.float32))
            for s in specs:
                if s["mode"] == "sumsig":
                    s["off"] = col_off
            col_off += 1
        if col_off == 0:
            # one zero row, so the op always has a mask operand
            mask_rows.append(np.zeros((1, pixels), dtype=np.float32))
        masks_t = np.concatenate(mask_rows, axis=0)
        # a masks-only pass has a compaction plan when the stack's union
        # support is small; _prepare uses it where it pays on the device
        compaction = None
        if not need_var and not need_colsum and not sumsig:
            compaction = plan_compaction(masks_t)
        return FusedPlan(
            masks_t=masks_t, specs=specs, need_var=need_var,
            need_colsum=need_colsum, compaction=compaction,
        )

    # -- state -----------------------------------------------------------

    def _zeros(self, prep, decl, shape):
        return torch.zeros(
            shape, dtype=_state_dtype(decl.dtype), device=prep["device"]
        )

    def _init_state(self, prep) -> list:
        """Per device UDF a dict name -> tensor (host UDFs: empty).  Nav
        buffers get ``depth`` pad rows past the roi-compressed nav, so
        the last block has a full-depth view too."""
        depth = prep["scheme"].depth
        state = []
        for e in prep["plan"]:
            bufs = {}
            if not e.host:
                bufs = {
                    n: self._zeros(
                        prep, e.decls[n],
                        (prep["n_nav"] + depth,) + e.decls[n].extra_shape,
                    )
                    for n in e.nav_names
                }
                bufs.update(self._init_part_state_one(prep, e))
            state.append(bufs)
        return state

    def _init_part_state_one(self, prep, entry) -> dict:
        if entry.host:
            return {}
        return {
            n: self._zeros(prep, entry.decls[n], entry.decls[n].shape)
            for n in entry.part_names
        }

    def _init_part_state(self, prep) -> list:
        return [self._init_part_state_one(prep, e) for e in prep["plan"]]

    # -- per-partition hooks ---------------------------------------------

    def _refresh_task_data(self, prep, partition, roi) -> None:
        """``cleanup`` and ``get_task_data`` again per partition, with
        the partition's coordinates, where it shows: for host UDFs and
        UDFs that override pre- or postprocess (others keep the
        once-per-run task data of ``_prepare``)."""
        meta = prep["meta"]
        nav_shape = tuple(meta.dataset_shape.nav)
        for entry in prep["plan"]:
            udf = entry.udf
            if type(udf).get_task_data is UDF.get_task_data:
                continue
            if not (entry.host
                    or type(udf).postprocess is not UDF.postprocess
                    or type(udf).preprocess is not UDF.preprocess):
                continue
            meta.coordinates = np.stack(
                np.unravel_index(partition.local_frame_ids(roi), nav_shape),
                axis=-1,
            ).astype(np.int32)
            sig = tuple(meta.dataset_shape.sig)
            meta._slice = meta._partition_slice = Slice(
                (partition.roi_offset(roi),) + (0,) * len(sig),
                Shape((partition.frames_in_roi(roi),) + sig,
                      sig_dims=len(sig)),
            )
            try:
                udf.cleanup()
                udf.task_data = UDFData(udf.get_task_data() or {})
            finally:
                meta.coordinates = None
                meta._slice = meta._partition_slice = None

    @staticmethod
    def _bind_device_postprocess(prep, state, part_state, goff0, n_sel):
        """Host copies of the partition's rows of a device UDF's nav
        state and of its partition buffers, bound as ``udf.results``
        for an overridden ``postprocess``."""
        bound = []
        for ui, entry in enumerate(prep["plan"]):
            udf = entry.udf
            if entry.host or type(udf).postprocess is UDF.postprocess:
                bound.append(False)
                continue
            views = {
                n: state[ui][n][goff0:goff0 + n_sel].cpu().numpy().copy()
                for n in entry.nav_names
            }
            views.update({
                n: part_state[ui][n].cpu().numpy().copy()
                for n in entry.part_names
            })
            udf.results = UDFData(views)
            bound.append(True)
        return bound

    @staticmethod
    def _writeback_device_postprocess(prep, state, part_state, goff0,
                                      n_sel, bound) -> None:
        """The bound copies, as ``postprocess`` left them, back into the
        device state (every bound buffer: numpy mutation is not
        observable)."""
        for ui, entry in enumerate(prep["plan"]):
            if not bound[ui]:
                continue
            res = entry.udf.results
            for n in entry.nav_names:
                state[ui][n][goff0:goff0 + n_sel] = _as_state(
                    np.asarray(res._get(n)), state[ui][n]
                )
            for n in entry.part_names:
                part_state[ui][n] = _as_state(
                    np.asarray(res._get(n)), part_state[ui][n]
                ).reshape(part_state[ui][n].shape)
            entry.udf.results = None

    # -- the step ----------------------------------------------------------

    def _apply_corrections(self, block, prep, valid: int):
        """Cast to the input dtype and apply the corrections, on the
        device.  The zero-padded tail rows become ``(0 - dark) *
        gain`` there and are zeroed again, so no reduction sees them."""
        x = block.to(prep["input_tdtype"])
        cp = prep["corr_plan"]
        if cp is None:
            return x
        flat = x.reshape(x.shape[0], -1)
        if cp["dark"] is not None:
            flat = flat - cp["dark"]
        if cp["gain"] is not None:
            flat = flat * cp["gain"]
        if flat.data_ptr() == block.data_ptr():
            # the feed's own buffer: write to a copy
            flat = flat.clone()
        if cp["repair_idx"] is not None:
            vals = flat[:, cp["nbr_idx"]]  # (depth, k, m)
            flat[:, cp["repair_idx"]] = (vals * cp["nbr_w"]).sum(dim=-1)
        flat[valid:] = 0
        return flat.reshape(x.shape)

    def _fused_step(self, prep, state, part_state, block, goff: int,
                    valid: int) -> None:
        """One fused op on a block (on its support blocks, when the
        run uses the compaction plan), then each UDF's share of its
        outputs into the state.  Updates the state tensors in place:
        nav rows of different blocks never overlap, and the
        per-partition sums are private to this run."""
        from .stddev import _combine

        fused: FusedPlan = prep["fused"]
        sig_shape = tuple(prep["meta"].dataset_shape.sig)
        if prep["corr_plan"] is not None:
            block = self._apply_corrections(block, prep, valid)
        if prep["support"] is not None:
            block = gather_blocks(
                block.reshape(block.shape[0], -1), prep["support"],
                fused.compaction["block"],
            )
        y, colsum, colvar = fused_moments(
            block, prep["masks_t"], valid, compute_var=fused.need_var,
        )
        for spec in fused.specs:
            ui = spec["ui"]
            mode = spec["mode"]
            if mode in ("masks", "sumsig"):
                name = spec["name"]
                decl = prep["plan"][ui].decls[name]
                if mode == "masks" and len(decl.extra_shape):
                    rows = y[:valid, spec["off"]:spec["off"] + spec["n"]]
                else:
                    rows = y[:valid, spec["off"]]
                state[ui][name][goff:goff + valid] += rows
            elif mode == "colsum":
                part_state[ui][spec["name"]] += colsum.reshape(sig_shape)
            elif mode == "stats":
                ps = part_state[ui]
                n, s_, v = _combine(
                    ps["num_frames"], ps["sum"], ps["varsum"],
                    torch.full_like(ps["num_frames"], float(valid)),
                    colsum.reshape(sig_shape), colvar.reshape(sig_shape),
                )
                ps["num_frames"], ps["sum"], ps["varsum"] = n, s_, v

    def _generic_step(self, prep, state, part_state, block, goff: int,
                      coords, valid: int) -> None:
        """Every device UDF's own ``process_*`` on a (corrected) block,
        one sig tile of the scheme after another."""
        meta = prep["meta"]
        scheme = prep["scheme"]
        depth = scheme.depth
        sig_shape = tuple(meta.dataset_shape.sig)
        block = self._apply_corrections(
            block.reshape((depth,) + sig_shape), prep, valid
        )
        valid_mask = torch.arange(depth, device=block.device) < valid
        # the block's rows of each UDF's aux arguments
        aux = [
            {k: arr[goff:goff + depth] for k, arr in a.items()}
            for a in prep["aux"]
        ]
        for k, sig_slice in scheme.slices:
            tile = (
                block if len(scheme) == 1
                else block[(slice(None),) + sig_slice.get()]
            )
            for ui, entry in enumerate(prep["plan"]):
                if entry.host:
                    continue
                self._run_udf_on_tile(
                    entry, tile, k, sig_slice, meta, state[ui],
                    part_state[ui], goff, coords, valid_mask, valid,
                    depth, aux[ui],
                )

    def _run_udf_on_tile(self, entry, tile, scheme_idx, sig_slice, meta,
                         state_u, part_u, goff, coords, valid_mask, valid,
                         depth, aux_views) -> None:
        udf = entry.udf
        decls = entry.decls
        whole_sig = tuple(sig_slice.shape) == tuple(meta.dataset_shape.sig)
        # a clone of the block's nav rows: what the UDF writes to rows
        # >= valid must not reach the next block's frames
        nav_old = {
            n: state_u[n][goff:goff + depth].clone()
            for n in entry.nav_names
        }

        def sig_index(name):
            return sig_slice.get() + (slice(None),) * len(
                decls[name].extra_shape
            )

        def part_view(name):
            if decls[name].kind != "sig" or whole_sig:
                return part_u[name]
            return part_u[name][sig_index(name)].clone()

        def part_writeback(name, value):
            value = _as_state(value, part_u[name])
            if decls[name].kind != "sig" or whole_sig:
                part_u[name] = value
            else:
                part_u[name][sig_index(name)] = value

        def nav_writeback(name, rows):
            state_u[name][goff:goff + valid] = _as_state(
                rows, state_u[name]
            )[:valid]

        meta.sig_slice = sig_slice
        meta.tiling_scheme_idx = scheme_idx
        meta.global_offset = goff
        meta.tile_valid = valid_mask
        meta.valid_frames = valid
        ro_views = {n: None for n in entry.result_only_names}
        if entry.method in ("tile", "partition"):
            views = dict(nav_old)
            views.update({n: part_view(n) for n in entry.part_names})
            views.update(ro_views)
            udf.results = UDFData(views)
            udf.params = UDFParams(udf._kwargs, aux_views)
            meta.coordinates = coords
            if entry.method == "tile":
                udf.process_tile(tile)
            else:
                udf.process_partition(tile)
            res = udf.results
            for n in entry.nav_names:
                nav_writeback(n, res._get(n))
            for n in entry.part_names:
                part_writeback(n, res._get(n))
        elif entry.frame_navonly:
            # every frame on its own: vmap over the block's frames
            # (counterpart of jax.vmap); the per-frame rows come in as
            # vmapped arguments, so in-place updates stay per frame
            def per_frame(frame, coord, olds, auxr):
                udf.results = UDFData(dict(olds, **ro_views))
                udf.params = UDFParams(udf._kwargs, auxr)
                meta.coordinates = coord
                udf.process_frame(frame)
                return {
                    n: _as_state(udf.results._get(n), olds[n])
                    for n in entry.nav_names
                }

            out = torch.func.vmap(per_frame)(tile, coords, nav_old, aux_views)
            for n in entry.nav_names:
                nav_writeback(n, out[n])
        else:
            # frames accumulate into sig/single buffers: one after
            # another over the valid frames (counterpart of lax.scan)
            carry = {n: part_view(n) for n in entry.part_names}
            for i in range(valid):
                views = {n: nav_old[n][i] for n in entry.nav_names}
                views.update(carry)
                views.update(ro_views)
                udf.results = UDFData(views)
                udf.params = UDFParams(
                    udf._kwargs, {k: v[i] for k, v in aux_views.items()}
                )
                meta.coordinates = coords[i]
                udf.process_frame(tile[i])
                res = udf.results
                for n in entry.nav_names:
                    nav_old[n][i] = _as_state(res._get(n), nav_old[n])
                for n in entry.part_names:
                    carry[n] = _as_state(res._get(n), carry[n])
            for n in entry.nav_names:
                nav_writeback(n, nav_old[n])
            for n in entry.part_names:
                part_writeback(n, carry[n])
        udf.results = None
        udf.params = UDFParams(udf._kwargs)

    def _merge(self, prep, state, part_state) -> None:
        """Fold a partition's sig/single state into the run's state
        with each device UDF's ``merge``."""
        for ui, entry in enumerate(prep["plan"]):
            if not entry.part_names or entry.host:
                continue
            dest = UDFData({n: state[ui][n] for n in entry.part_names})
            src = UDFData({n: part_state[ui][n] for n in entry.part_names})
            entry.udf.merge(dest, src)
            for n in entry.part_names:
                if n in dest._touched:
                    state[ui][n] = _as_state(dest._get(n), state[ui][n])

    # -- main loop -------------------------------------------------------

    def _make_progress(self, progress, prep):
        """A ProgressManager for ``progress`` (False: None; True: a
        tqdm bar; or a ProgressReporter), with the partitions' frame
        budgets by partition index."""
        if not progress:
            return None
        from ..common.progress import (
            ProgressManager,
            ProgressReporter,
            TQDMProgressReporter,
        )
        reporter = (progress if isinstance(progress, ProgressReporter)
                    else TQDMProgressReporter())
        parts = prep["partitions"]
        return ProgressManager(
            prep["n_nav"], len(parts), reporter, progress_id=str(id(prep)),
            task_max={pi: p.frames_in_roi(prep["roi"])
                      for pi, p in enumerate(parts)},
        )

    def _run_loop(self, prep, dataset, progress, yield_partial):
        """Yields the wrapped results after every merged partition but
        the last (with ``yield_partial``), then the final results once;
        applies a pending parameter patch before each partition."""
        from .host import HostUDFRunner

        scheme = prep["scheme"]
        device = prep["device"]
        plan = prep["plan"]
        roi = prep["roi"]
        pixels = int(np.prod(prep["meta"].sig_shape))
        on_device = any(not e.host for e in plan)
        host_entries = [(ui, e) for ui, e in enumerate(plan) if e.host]
        host = HostUDFRunner(host_entries, prep) if host_entries else None
        host_global = host.init_global() if host else {}
        feed = HostFeed(
            (scheme.depth, pixels), dataset.meta.native_dtype, device,
            to_device=on_device, host_reads=host is not None,
        )
        feed.stats["host_s"] = 0.0
        self.feed_stats = feed.stats
        state = self._init_state(prep)
        # the nav positions merged so far (roi-compressed)
        damage = np.zeros(prep["n_nav"], dtype=bool)
        part = {}

        def start(pi):
            partition = prep["partitions"][pi]
            part.update(
                pi=pi,
                partition=partition,
                goff0=partition.roi_offset(roi),
                n_sel=partition.frames_in_roi(roi),
                state=self._init_part_state(prep),
                host=host.init_partition() if host else None,
            )
            self._refresh_task_data(prep, partition, roi)
            # preprocess sees the partition's views on the host engine
            if host:
                host.bind_partition_views(
                    host_global, part["host"], part["goff0"], part["n_sel"]
                )
            for udf in self._udfs:
                udf.preprocess()
            if host:
                host.unbind_views()
                part["host_init"] = host.snapshot_init(
                    host_global, part["goff0"], part["n_sel"]
                )
            if pm is not None:
                pm.partition_start(pi)

        def finish():
            goff0, n_sel = part["goff0"], part["n_sel"]
            if host:
                host.bind_partition_views(
                    host_global, part["host"], goff0, n_sel
                )
            bound = self._bind_device_postprocess(
                prep, state, part["state"], goff0, n_sel
            )
            for udf in self._udfs:
                udf.postprocess()
            self._writeback_device_postprocess(
                prep, state, part["state"], goff0, n_sel, bound
            )
            if host:
                host.unbind_views()
            self._merge(prep, state, part["state"])
            if host:
                host.merge_partition(
                    host_global, part["host"], goff0, n_sel,
                    init_rows=part["host_init"],
                )
            arrived = getattr(dataset, "frames_valid_count", None)
            if arrived is None:
                damage[goff0:goff0 + n_sel] = True
            else:
                # a live acquisition that finished early: the frames
                # past the last one pushed read as zeros, not merged
                ids = part["partition"].local_frame_ids(roi)
                cut = int(np.searchsorted(ids, int(arrived())))
                damage[goff0:goff0 + cut] = True
            if pm is not None:
                pm.partition_done(n_sel, ident=part["pi"])

        current = None
        pm = self._make_progress(progress, prep)
        try:
            with contextlib.closing(
                feed.run(prep["partitions"], scheme, roi)
            ) as blocks:
                for pi, block_t, block in blocks:
                    if pi != current:
                        if current is not None:
                            with _full_fp32_matmul():
                                finish()
                            if yield_partial:
                                yield self._wrap_results(
                                    prep, state, host_global, damage.copy()
                                )
                        if self._params_patched:
                            self._params_patched = False
                            self._apply_param_patch(prep)
                        start(pi)
                        current = pi
                    with _full_fp32_matmul():
                        if prep["fused"] is not None:
                            self._fused_step(
                                prep, state, part["state"], block_t,
                                block.global_offset, block.valid,
                            )
                        elif on_device:
                            coords = torch.from_numpy(block.coords).to(
                                device)
                            self._generic_step(
                                prep, state, part["state"], block_t,
                                block.global_offset, coords, block.valid,
                            )
                    if host:
                        # the pinned host slot itself, done with before
                        # the feed refills it
                        t0 = time.perf_counter()
                        host.process_block(
                            host_global, part["host"], block.data,
                            block.global_offset, block.coords, block.valid,
                        )
                        feed.stats["host_s"] += time.perf_counter() - t0
                    if pm is not None:
                        pm.frames_done(block.valid, ident=pi)
            if current is not None:
                with _full_fp32_matmul():
                    finish()
            # the last partition's partial, or the only result
            yield self._wrap_results(prep, state, host_global, damage)
        finally:
            if pm is not None:
                pm.close()

    # -- results -----------------------------------------------------------

    def _wrap_results(self, prep, state, host_global, damage_host
                      ) -> UDFResults:
        """Device state -> host numpy (host UDFs: copies of their numpy
        buffers, zeros before the run made them) -> ``get_results`` ->
        one dict of BufferWrappers per UDF; ``damage_host`` marks the
        nav positions merged so far."""
        meta = prep["meta"]
        n_nav = prep["n_nav"]
        buffers = []
        for ui, entry in enumerate(prep["plan"]):
            if entry.host:
                bufs = host_global.get(ui, {})
                raw = {
                    n: (np.array(bufs[n], copy=True) if n in bufs
                        else np.zeros(entry.decls[n].shape,
                                      entry.decls[n].dtype))
                    for n in entry.nav_names + entry.part_names
                }
            else:
                # copies: a partial result must not follow the state
                # the run goes on updating (on the CPU .cpu() is the
                # state itself)
                raw = {
                    n: state[ui][n][:n_nav].to("cpu", copy=True).numpy()
                    for n in entry.nav_names
                }
                raw.update({
                    n: state[ui][n].to("cpu", copy=True).numpy()
                    for n in entry.part_names
                })
            buffers.append(
                self._wrap_one(entry, raw, damage_host, meta, prep["roi"])
            )
        damage = BufferWrapper("nav", (), bool)
        damage.set_shape_ds(meta.dataset_shape, prep["roi"])
        damage.set_result(damage_host, valid_nav_mask=damage_host)
        return UDFResults(buffers=buffers, damage=damage)

    @staticmethod
    def _wrap_one(entry, raw, damage_host, meta, roi) -> dict:
        udf = entry.udf
        udf.meta = meta
        udf.results = UDFData(
            dict(raw, **{n: None for n in entry.result_only_names})
        )
        # results are wrapped on the host with numpy: self.xp is numpy
        # in get_results, whichever engine ran the UDF
        udf._host_mode = True
        meta.set_valid_nav_mask(damage_host)
        try:
            derived = udf.get_results() or {}
        finally:
            udf._host_mode = False
            meta.set_valid_nav_mask(None)
        for name in derived:
            if name not in entry.decls:
                raise KeyError(
                    f"get_results returned {name!r} which is not "
                    f"declared in get_result_buffers"
                )
            if entry.decls[name].use == "private":
                raise UDFException(
                    f"get_results must not include the use='private' "
                    f"buffer {name!r}"
                )
        for name in entry.result_only_names:
            if name not in derived:
                raise UDFException(
                    f"don't know how to set use='result_only' buffer "
                    f"{name!r}; please implement `get_results`"
                )
        nav_full = tuple(meta.dataset_shape.nav)
        buffers = {}
        for name, decl in entry.decls.items():
            if decl.use == "private":
                continue
            custom_mask = None
            full_data = None
            if name in derived:
                data = derived[name]
                if isinstance(data, ArrayWithMask):
                    custom_mask = data.mask
                    data = data.arr
                data = np.asarray(data)
                if (decl.kind == "nav" and roi is not None
                        and data.shape == nav_full + decl.extra_shape):
                    # get_results embedded the roi itself: keep its
                    # full-nav array as .data, the roi rows as raw
                    full_data = data
                    data = data.reshape(
                        (len(roi),) + decl.extra_shape
                    )[roi]
            else:
                data = raw[name].astype(decl.dtype, copy=False)
            out = BufferWrapper(decl.kind, decl.extra_shape, decl.dtype)
            out.set_shape_ds(meta.dataset_shape, roi)
            out.set_result(
                data, valid_nav_mask=damage_host,
                custom_mask=custom_mask, full_data=full_data,
            )
            buffers[name] = out
        return buffers
