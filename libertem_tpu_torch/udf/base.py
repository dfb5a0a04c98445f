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

With several devices (``devices=``) the run takes the multi-device
loop instead (``UDFRunner._run_loop_sharded``): one worker per device
entry, each with its own shard of the nav axis, feed and state, folded
with the UDFs' ``merge`` for every result.
"""
from __future__ import annotations

import contextlib
import enum
import hashlib
import logging
import os
import pickle
import queue
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.buffers import (
    ArrayWithMask,
    AuxBufferWrapper,
    BufferWrapper,
    PlaceholderBufferWrapper,
)
from ..common.exceptions import UDFException, UDFRunCancelled  # noqa: F401
from ..warnings import UseDiscouragedWarning
from ..common.shape import Shape
from ..common.slice import Slice
from ..common.tracing import NOOP, RunTrace, span
from ..io.corrections import CorrectionSet
from ..io.dataset.base import (
    Block,
    DataSet,
    Partition,
    ReadCancelled,
    densify_into,
    read_ids_across,
)
from ..io.tiling import (
    TILE_DEPTH_DEFAULT,
    TILE_DEPTH_MAX,
    TILE_SIZE_BEST_FIT,
    TILE_SIZE_MAX,
    Negotiator,
    TileDepthEnum,  # noqa: F401  (the JAX module's names)
    TileSizeEnum,  # noqa: F401
    TilingPreferences,  # noqa: F401
    TilingScheme,
)
from ..executor.base import JobCancelledError  # noqa: F401
from ..ops.moments import _matmul_precision, fused_moments
from ..ops.sparse_masks import (
    compaction_pays,
    gather_blocks,
    plan_compaction,
)

log = logging.getLogger(__name__)


class MergeAttrMapping:
    """Attribute access over a dict of arrays, for code that builds
    the ``dest``/``src`` of a host ``merge`` itself: assigning an
    attribute writes into the array in place (``[:] =``).  The engine
    passes :class:`UDFData`."""

    def __init__(self, dict_input: dict):
        object.__setattr__(self, "_dict", dict_input)

    def __iter__(self):
        return iter(self._dict)

    def __contains__(self, k) -> bool:
        return k in self._dict

    def __getattr__(self, k):
        try:
            return object.__getattribute__(self, "_dict")[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self._dict[k][:] = v

    def __getitem__(self, k):
        warnings.warn(
            "dict-style access on merge arguments is discouraged; "
            "use attribute access (dest.name)",
            UseDiscouragedWarning, stacklevel=2,
        )
        return self._dict[k]


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

    @classmethod
    def from_udfs(cls, udfs, roi=None, corrections=None,
                  tiling_scheme=None) -> "UDFParams":
        """The parameters of a partition run of ``udfs`` as
        :meth:`UDFPartRunner.run_for_partition` takes them."""
        return cls({
            "kwargs": [dict(u._kwargs) for u in udfs],
            "roi": roi,
            "corrections": corrections,
            "tiling_scheme": tiling_scheme,
        })


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
    ``"cpu"``; a caller building a meta may give it, as
    ``array_backend``), ``corrections`` the run's CorrectionSet or
    None, ``matmul_precision`` the run's precision of float32 products
    that follow it (``"highest"`` or ``"default"``, latched once a run
    from ``LIBERTEM_TPU_TORCH_MATMUL_PRECISION``).
    """

    def __init__(self, dataset_shape: Shape, dataset_dtype, input_dtype,
                 roi: Optional[np.ndarray] = None,
                 tiling_scheme: Optional[TilingScheme] = None,
                 device: Optional[torch.device] = None,
                 corrections: Optional[CorrectionSet] = None,
                 threads_per_worker: int = 1,
                 partition_slice: Optional[Slice] = None,
                 device_class: Optional[str] = None,
                 array_backend: Optional[str] = None):
        self.dataset_shape = dataset_shape
        self.dataset_dtype = np.dtype(dataset_dtype)
        self.input_dtype = np.dtype(input_dtype)
        self._roi = roi
        self.tiling_scheme = tiling_scheme
        self.device = torch.device("cpu") if device is None else device
        self.device_class = (self.device.type if device_class is None
                             else device_class)
        self.corrections = corrections
        self.threads_per_worker = threads_per_worker
        self.array_backend = ("torch" if array_backend is None
                              else array_backend)
        self.coordinates = None
        self.tile_valid = None
        self.valid_frames = None
        self.global_offset = None
        self.sig_slice: Optional[Slice] = None
        self.tiling_scheme_idx = 0
        self.matmul_precision = "highest"
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
    UDF_METHOD = UDFMethod
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

    # -- the worker protocol ----------------------------------------------
    # The runner binds buffers and meta itself; these are for code that
    # drives a UDF over one partition by hand, as UDFPartRunner does,
    # with numpy buffers on the host.

    def copy_for_partition(self, partition, roi=None) -> "UDF":
        """A new instance to process one partition with."""
        return type(self)(**self._kwargs)

    def set_backend(self, backend: str) -> None:
        self._array_backend = backend

    def set_meta(self, meta: "UDFMeta") -> None:
        self.meta = meta

    def set_slice(self, slc: Slice) -> None:
        if self.meta is not None:
            self.meta._slice = slc

    def set_tile_idx(self, idx: int) -> None:
        if self.meta is not None:
            self.meta.tiling_scheme_idx = idx

    def init_result_buffers(self, executor=None) -> None:
        """Declare this instance's result buffers; their shapes are
        bound by :meth:`allocate_for_part`."""
        self._part_decls = self.get_result_buffers()

    def allocate_for_part(self, partition, roi) -> None:
        """Zeroed numpy buffers for one partition's results: a nav
        buffer holds the partition's frames of the roi, a sig or single
        buffer its whole shape; a ``result_only`` buffer is None."""
        decls = getattr(self, "_part_decls", None)
        if decls is None:
            self.init_result_buffers()
            decls = self._part_decls
        n_sel = partition.frames_in_roi(
            None if roi is None else np.asarray(roi).reshape(-1))
        sig = tuple(partition.meta.shape.sig)
        bufs = {}
        for name, decl in decls.items():
            if decl.use == "result_only":
                bufs[name] = None
            elif decl.kind == "nav":
                bufs[name] = np.zeros((n_sel,) + decl.extra_shape,
                                      dtype=decl.dtype)
            elif decl.kind == "sig":
                bufs[name] = np.zeros(sig + decl.extra_shape,
                                      dtype=decl.dtype)
            else:  # 'single'
                bufs[name] = np.zeros(decl.extra_shape or (1,),
                                      dtype=decl.dtype)
        self.results = UDFData(bufs)

    def clear_views(self) -> None:
        pass

    def init_task_data(self) -> None:
        self.task_data = UDFData(self.get_task_data())

    def get_result_buffers(self) -> dict:
        raise NotImplementedError()

    @staticmethod
    def buffer(kind, extra_shape=(), dtype="float32", where=None, use=None):
        """A result buffer declaration (``where`` is accepted for the
        JAX package's signature; the engine places the state)."""
        if use == "result_only":
            return PlaceholderBufferWrapper(kind, extra_shape, dtype)
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

    def requires_custom_merge_all(self, decls: dict) -> bool:
        """As :meth:`requires_custom_merge`, ``result_only`` buffers
        counted too: ``merge_all`` must handle them."""
        return any(b.kind != "nav" for b in decls.values())


# the JAX package's name of the protocol of UDF constants; the port's
# UDF carries them itself
UDFProtocol = UDF


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


class UDFResults:
    """One dict of result BufferWrappers per UDF, plus the damage
    buffer (which nav positions hold merged results).  Built from
    ``buffers_thunk``, the buffers are made when first read."""

    def __init__(self, buffers: Optional[Sequence[dict]] = None,
                 damage: Optional[BufferWrapper] = None,
                 buffers_thunk=None):
        self._buffers = list(buffers) if buffers is not None else None
        self._buffers_thunk = buffers_thunk
        self.damage = damage

    @property
    def buffers(self) -> list:
        if self._buffers is None:
            self._buffers = list(self._buffers_thunk())
        return self._buffers


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
def _tf32_matmul(allow: bool):
    """``torch.backends.cuda.matmul.allow_tf32`` set to ``allow``
    inside, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _full_fp32_matmul():
    """TF32 off for the run's float32 products (the generic ApplyMasks
    and CoM matmuls): TF32 keeps about three decimal digits, the
    results' contract is 1e-5.  ApplyMasks' own product follows the
    run's ``meta.matmul_precision`` inside this."""
    return _tf32_matmul(False)


def _canonical_backends(backends) -> tuple:
    """A backend spec as a tuple (a bare string is one backend)."""
    if backends is None:
        return ()
    if isinstance(backends, str):
        return (backends,)
    return tuple(backends)


def get_resources_for_backends(udf_backends, user_backends) -> dict:
    """The resources a run of UDFs with these backends needs, narrowed
    by the user's restriction: ``CPU`` when every UDF can run on the
    host engine only, ``CUDA`` when one can run on the device engine
    only, ``ndarray`` unless a UDF takes bare ``"cuda"``; ValueError
    when both engines are needed at once."""
    user = _canonical_backends(user_backends)
    needs_cuda = needs_cpu = needs_ndarray = 0
    for backend_set in (_canonical_backends(b) for b in udf_backends):
        backends = (set(user).intersection(backend_set) if user
                    else set(backend_set))
        needs_cuda += backends.isdisjoint(CPU_BACKENDS)
        needs_cpu += backends.isdisjoint(CUDA_BACKENDS)
        needs_ndarray += UDF.BACKEND_CUDA not in backends
    if needs_cuda and needs_cpu:
        raise ValueError(
            "There is no common supported UDF backend "
            f"(have: {udf_backends!r}, limited to {user!r})"
        )
    result = {"compute": 1}
    if needs_cpu:
        result["CPU"] = 1
    if needs_cuda:
        result["CUDA"] = 1
    if needs_ndarray:
        result["ndarray"] = 1
    return result


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
# the resource classes of get_resources_for_backends, as the JAX
# package's: "torch" counts with the CPU ones there, since the process
# that runs the loop owns the card, so a torch UDF runs wherever it
# runs; the CUDA ones are the spellings of code written for CuPy
CPU_BACKENDS = _HOST_LIKE | {UDF.BACKEND_TORCH}
CUDA_BACKENDS = _DEVICE_LIKE - {UDF.BACKEND_TORCH}


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

    The slot and copy logic is in :meth:`acquire_slot`,
    :meth:`host_block`, :meth:`push` (reader side) and :meth:`take`,
    :meth:`release` (consumer side); :meth:`run` drives them from its
    one reader thread, the multi-device loop drives one feed per
    worker from its reader pool.

    Stopping (the consumer went away): the thread gives up where it
    waits for a slot, and a read that waits for data gives up too
    (``Partition.stop_event``, ``ReadCancelled``).  :meth:`close`
    releases the buffers.
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
        self._free: Optional[threading.Semaphore] = None
        self._next = 0
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

    def open(self, nnz: Optional[int] = None) -> None:
        """The host buffers (:meth:`_allocate`) and an empty slot
        ring: every slot free, the next one slot 0."""
        self._allocate(nnz)
        self._free = threading.Semaphore(self.SLOTS)
        self._next = 0

    def close(self) -> None:
        """Release the buffers, once the side stream's copies are
        done."""
        if self._cuda:
            self._stream.synchronize()
        self._host = self._dev = self._staging = self._dev_staging = None

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

    # -- reader side -----------------------------------------------------

    def acquire_slot(self, stop: threading.Event) -> int:
        """The next slot, once the consumer has released it and the
        copy out of it has finished; ReadCancelled once ``stop`` is
        set."""
        with span("libertem.slot_wait", timed=True) as waited:
            while not self._free.acquire(timeout=0.1):
                if stop.is_set():
                    raise ReadCancelled()
            slot = self._next % self.SLOTS
            self._next += 1
            if self._cuda:
                self._copied[slot].synchronize()
        self.stats["slot_wait_s"] += waited.seconds
        return slot

    def host_block(self, slot: int, shape: tuple) -> np.ndarray:
        """The slot's host buffer as a numpy array of ``shape``."""
        return self._host[slot].numpy().reshape(shape)

    def staging(self, slot: int, nnz: int) -> tuple:
        """The slot's sparse staging, ``nnz`` entries of each of
        ``(vals, rows, cols)``."""
        return tuple(a[:nnz].numpy() for a in self._staging[slot])

    def push(self, slot: int, block) -> None:
        """The slot's copy to the device (densified there when the
        block is sparse: its own entries, not the budget's padding),
        on the side stream; on the CPU, a sparse block densified into
        the slot."""
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
        with span("libertem.h2d"), torch.cuda.device(self._device), \
                torch.cuda.stream(self._stream):
            self._stream.wait_event(self._consumed[slot])
            if block.sparse is None:
                self._dev[slot].copy_(self._host[slot], non_blocking=True)
            else:
                staged = []
                for d, h in zip(self._dev_staging[slot],
                                self._staging[slot]):
                    d[:n].copy_(h[:n], non_blocking=True)
                    staged.append(d[:n])
                densify_into(self._dev[slot], *staged)
            self._copied[slot].record(self._stream)

    # -- consumer side -----------------------------------------------------

    def take(self, slot: int) -> Optional[torch.Tensor]:
        """The slot's device block, for a step on the current stream of
        the feed's device (which waits for the copy); None without
        ``to_device``."""
        if self._cuda:
            torch.cuda.current_stream(self._device).wait_event(
                self._copied[slot]
            )
            if self._host_reads:
                self._copied[slot].synchronize()
        self.stats["blocks"] += 1
        return self._dev[slot] if self._to_device else None

    def release(self, slot: int) -> None:
        """The consumer is done with the slot: the next copy into its
        device buffer waits for the steps enqueued so far."""
        if self._cuda:
            self._consumed[slot].record(
                torch.cuda.current_stream(self._device)
            )
        self._free.release()

    def run(self, partitions: Sequence[Partition], scheme: TilingScheme,
            roi: Optional[np.ndarray] = None,
            spans: Optional[dict] = None):
        """Yield ``(partition index, device block, Block)`` for every
        block of every partition (of the roi's frames), in order.
        ``spans``: the run's span totals (:class:`RunTrace`), for the
        consumer's spans here."""
        budgets = [p.sparse_nnz_budget(scheme, roi) for p in partitions]
        sparse = any(b is not None for b in budgets)
        stop = threading.Event()
        q: queue.Queue = queue.Queue()
        # the slot of the block gen_blocks is reading
        last = [0]
        shape = (scheme.depth,) + tuple(scheme.dataset_shape.sig)

        def acquire() -> np.ndarray:
            last[0] = self.acquire_slot(stop)
            return self.host_block(last[0], shape)

        def acquire_sparse(nnz: int) -> tuple:
            last[0] = self.acquire_slot(stop)
            return self.staging(last[0], nnz)

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
                        waited = self.stats["slot_wait_s"]
                        with span("libertem.read", timed=True) as read:
                            block = next(blocks, None)
                        self.stats["read_s"] += (
                            read.seconds
                            - (self.stats["slot_wait_s"] - waited)
                        )
                        if block is None:
                            break
                        self.push(last[0], block)
                        q.put(("item", (pi, last[0], block)))
                q.put(("done", None))
            except ReadCancelled:
                pass
            except BaseException as e:  # handed to the consumer
                q.put(("error", e))

        thread = threading.Thread(target=worker, daemon=True,
                                  name="HostFeed-reader")
        with span("libertem.open", spans):
            self.open(max(b or 0 for b in budgets) if sparse else None)
            thread.start()
        try:
            while True:
                with span("libertem.feed_wait", spans, True) as waited:
                    kind, payload = q.get()
                self.stats["wait_s"] += waited.seconds
                if kind == "done":
                    break
                if kind == "error":
                    raise payload
                pi, slot, block = payload
                yield pi, self.take(slot), block
                with span("libertem.release", spans):
                    self.release(slot)
        finally:
            with span("libertem.close", spans):
                stop.set()
                thread.join(timeout=60)
                self.close()


def executor_devices(executor) -> tuple:
    """``(main device, devices of the multi-device loop or None)`` of
    an executor: its devices when there are several, a
    ``ShardedJobExecutor``'s ``global_workers`` where they span the
    processes of a ``torch.distributed`` group."""
    workers = getattr(executor, "global_workers", None)
    if workers and len({w.rank for w in workers}) > 1:
        return executor.main_device, workers
    devs = executor.devices
    return executor.main_device, (devs if len(devs) > 1 else None)


class UDFRunner:
    """Runs a set of UDFs over a dataset in one read pass: the device
    UDFs fused when each can join the fused moments op, else generic;
    the host UDFs on the host engine, on the same blocks."""

    def __init__(self, udfs: Sequence[UDF], backends=None,
                 debug: bool = False, threads_per_worker: int = 1,
                 progress_reporter=None):
        """``backends`` restricts the engines for this runner's runs;
        ``debug`` round-trips the UDFs through pickle before each run
        (``InlineJobExecutor(debug=True)``); ``threads_per_worker``,
        the executor's, is the UDFs' ``meta.threads_per_worker``;
        ``progress_reporter`` is the reporter of a run with
        ``progress=True`` (a tqdm bar without one)."""
        self._udfs = list(udfs)
        self._debug = debug
        self._progress_reporter = progress_reporter
        self._threads_per_worker = max(1, int(threads_per_worker))
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
        # the multi-device loop's stage timings (with
        # LIBERTEM_TPU_SHARDED_STATS set), else None
        self.last_sharded_stats: Optional[dict] = None

    def _debug_check_picklable(self) -> None:
        """Each UDF's class and arguments through a pickle round trip,
        and the UDF rebuilt from them: an argument that cannot cross a
        process boundary fails here, before the run."""
        for udf in self._udfs:
            try:
                clone_kwargs = pickle.loads(pickle.dumps(udf._kwargs))
                pickle.loads(pickle.dumps(type(udf)))
                type(udf)(**clone_kwargs)
            except Exception as e:
                raise UDFException(
                    f"{type(udf).__name__} is not pickle-safe "
                    f"(debug=True check): {e}"
                ) from e

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

    def run_for_dataset(self, dataset: DataSet,
                        device: Optional[torch.device] = None,
                        roi: Optional[np.ndarray] = None,
                        corrections: Optional[CorrectionSet] = None,
                        progress=False, devices=None, executor=None,
                        backends=None, dry: bool = False) -> UDFResults:
        """The final results of a run (:meth:`run_for_dataset_iter`).

        ``executor`` (also as the second positional argument, the JAX
        package's place for it) gives the devices of the run, as a
        Context's does; ``backends`` restricts the engines from this
        run on; ``dry`` returns :meth:`dry_run`'s buffers."""
        if device is not None and not isinstance(
                device, (str, torch.device)):
            executor, device = device, None
        if executor is not None:
            main, several = executor_devices(executor)
            device = main if device is None else device
            devices = several if devices is None else devices
        if backends is not None:
            self._backends = _canonical_backends(backends)
        if dry:
            return self.dry_run(dataset, roi=roi)
        gen = self.run_for_dataset_iter(
            dataset, device, roi=roi, corrections=corrections,
            progress=progress, yield_partial=False, devices=devices,
        )
        result = next(gen)
        for _ in gen:  # runs the cleanup
            pass
        return result

    def run_for_dataset_async(self, dataset: DataSet, executor=None,
                              roi: Optional[np.ndarray] = None,
                              corrections: Optional[CorrectionSet] = None,
                              progress=False, cancel_id=None, device=None,
                              devices=None):
        """An async generator of the partial results of
        :meth:`run_for_dataset_iter`, run on a producer thread up to 8
        partials ahead (as ``Context.run_udf_iter(sync=False)``);
        ``cancel_id`` is accepted as in the JAX package: closing the
        generator ends the run."""
        from ..common.async_utils import async_generator_eager
        if executor is not None:
            main, several = executor_devices(executor.ensure_sync())
            device = main if device is None else device
            devices = several if devices is None else devices
        gen = self.run_for_dataset_iter(
            dataset, device, roi=roi, corrections=corrections,
            progress=progress, devices=devices)
        return async_generator_eager(gen, queue_size=8)

    def run_for_dataset_iter(self, dataset: DataSet,
                             device: Optional[torch.device] = None,
                             roi: Optional[np.ndarray] = None,
                             corrections: Optional[CorrectionSet] = None,
                             progress=False, yield_partial: bool = True,
                             devices=None):
        """Generator of UDFResults: one after every merged partition,
        the last of them the final result (only the final one with
        ``yield_partial=False``).  ``progress``: False, True (a tqdm
        bar) or a ``ProgressReporter``.  Closing the generator early
        stops the host feed's reader and releases its slots.

        ``device``: the device of the run (the CUDA card by default).
        ``devices``: with more than one, the run goes to the
        multi-device loop (:meth:`_run_loop_sharded`): one worker per
        entry, a device given twice being two workers on it; a
        one-entry list runs on that device.

        Under an initialised ``torch.distributed`` group of several
        processes, ``devices`` (this process's devices, or the
        :class:`~libertem_tpu_torch.common.distributed.GlobalWorker`
        list of a ``ShardedJobExecutor``) always takes the multi-device
        loop, over every process's workers; each process makes the
        identical call.  Numpy UDFs are refused there."""
        trace = RunTrace()
        with span("libertem.run", trace.spans,
                  udfs=[type(u).__name__ for u in self._udfs]) as run:
            trace.run = run
            yield from self._run_iter(dataset, device, roi, corrections,
                                      progress, yield_partial, devices,
                                      trace)

    def _run_iter(self, dataset, device, roi, corrections, progress,
                  yield_partial, devices, trace: RunTrace):
        """:meth:`run_for_dataset_iter`'s body, inside its
        ``libertem.run`` span."""
        from ..common import distributed
        from ..common.backend import resolve_device

        rank, n_proc = distributed.world()
        refused = None
        udf_names = [type(u).__name__ for u in self._udfs]
        if devices is not None and (len(devices) > 1 or n_proc > 1):
            blocked = [
                type(u).__name__ for u in self._udfs
                if not getattr(u, "SUPPORTS_SHARDED", True)
            ]
            if blocked:
                raise UDFException(
                    f"{', '.join(blocked)} cannot run on the sharded "
                    "executor; use an InlineJobExecutor / "
                    "single-device Context"
                )
            part_udfs = [
                type(u).__name__ for u in self._udfs
                if str(u.get_method()) == "partition"
            ]
            if part_udfs:
                # each worker's block plays the partition role, not the
                # dataset's partitions
                log.warning(
                    "sharded run: process_partition receives device "
                    "blocks, not whole dataset partitions (%s) - "
                    "per-partition-identity statistics need the "
                    "single-device loop", ", ".join(part_udfs),
                )
            if all(isinstance(d, distributed.GlobalWorker)
                   for d in devices):
                workers = list(devices)
            else:
                workers = distributed.global_workers(
                    [resolve_device(d) for d in devices])
            local = [w.device for w in workers if w.rank == rank]
            if not local:
                raise UDFException(
                    f"no worker of the run belongs to process {rank}")
            # the rank's first local worker: copies keyed by device
            # never reach another process's device
            with trace.span("libertem.prepare", udfs=udf_names):
                prep = self._prepare(dataset, local[0], roi, corrections)
            prep["dist"] = None if n_proc == 1 else {
                "rank": rank, "transport": distributed.transport(),
                "collective_s": 0.0,
            }
            if n_proc > 1 and any(e.host for e in prep["plan"]):
                refused = UDFException(
                    "numpy-backend UDFs process the host block feed, "
                    "which is split across processes on a multi-host "
                    "mesh — run them single-host or on an "
                    "InlineJobExecutor"
                )
            loop = self._run_loop_sharded(prep, dataset, progress,
                                          yield_partial, workers)
        else:
            if device is None and devices:
                device = devices[0]
            with trace.span("libertem.prepare", udfs=udf_names):
                prep = self._prepare(dataset, resolve_device(device), roi,
                                     corrections)
            prep["dist"] = None
            loop = self._run_loop(prep, dataset, progress, yield_partial)
        prep["trace"] = trace
        meta = prep["meta"]
        trace.run.set_attributes(
            frames=int(prep["n_nav"]),
            bytes=int(prep["n_nav"] * meta.dataset_shape.sig.size
                      * np.dtype(meta.dataset_dtype).itemsize))
        self.run_info = self._run_info(prep)
        try:
            if refused is not None:
                # on every rank, before any collective of the run
                raise refused
            yield from loop
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
            "matmul_precision": prep["matmul_precision"],
            # how state crosses processes (None: one process)
            "transport": (None if prep.get("dist") is None
                          else prep["dist"]["transport"]),
        }

    # -- preparation ---------------------------------------------------

    def _prepare(self, dataset: DataSet, device: torch.device,
                 roi: Optional[np.ndarray] = None,
                 corrections: Optional[CorrectionSet] = None) -> dict:
        udfs = self._udfs
        if self._debug:
            self._debug_check_picklable()
        # latched once a run: a change of the environment takes effect
        # at the next run, never inside one
        precision = _matmul_precision()
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
            threads_per_worker=self._threads_per_worker,
        )
        meta.matmul_precision = precision
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
            "matmul_precision": precision,
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

    def _init_state(self, prep, nav_rows: Optional[int] = None) -> list:
        """Per device UDF a dict name -> tensor (host UDFs: empty).  Nav
        buffers get ``depth`` pad rows past the roi-compressed nav (or
        past ``nav_rows``, a worker's shard), so the last block has a
        full-depth view too."""
        depth = prep["scheme"].depth
        if nav_rows is None:
            nav_rows = prep["n_nav"]
        state = []
        for e in prep["plan"]:
            bufs = {}
            if not e.host:
                bufs = {
                    n: self._zeros(
                        prep, e.decls[n],
                        (nav_rows + depth,) + e.decls[n].extra_shape,
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
    def _bind_device_postprocess(prep, state, part_state, goff0, n_sel,
                                 udfs=None):
        """Host copies of the partition's rows of a device UDF's nav
        state and of its partition buffers, bound as ``udf.results``
        for an overridden ``postprocess`` (on ``udfs[ui]``, a shard's
        clones, where given)."""
        bound = []
        for ui, entry in enumerate(prep["plan"]):
            udf = entry.udf if udfs is None else udfs[ui]
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
                                      n_sel, bound, udfs=None) -> None:
        """The bound copies, as ``postprocess`` left them, back into the
        device state (every bound buffer: numpy mutation is not
        observable)."""
        for ui, entry in enumerate(prep["plan"]):
            if not bound[ui]:
                continue
            udf = entry.udf if udfs is None else udfs[ui]
            res = udf.results
            for n in entry.nav_names:
                state[ui][n][goff0:goff0 + n_sel] = _as_state(
                    np.asarray(res._get(n)), state[ui][n]
                )
            for n in entry.part_names:
                part_state[ui][n] = _as_state(
                    np.asarray(res._get(n)), part_state[ui][n]
                ).reshape(part_state[ui][n].shape)
            udf.results = None

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
        trace = prep["trace"]
        if prep["corr_plan"] is not None:
            block = self._apply_corrections(block, prep, valid)
        if prep["support"] is not None:
            block = gather_blocks(
                block.reshape(block.shape[0], -1), prep["support"],
                fused.compaction["block"],
            )
        with trace.span("libertem.fused_moments"):
            y, colsum, colvar = fused_moments(
                block, prep["masks_t"], valid, compute_var=fused.need_var,
                precision=prep["matmul_precision"],
            )
        with trace.span("libertem.state_update"):
            for spec in fused.specs:
                ui = spec["ui"]
                mode = spec["mode"]
                if mode in ("masks", "sumsig"):
                    name = spec["name"]
                    decl = prep["plan"][ui].decls[name]
                    if mode == "masks" and len(decl.extra_shape):
                        rows = y[:valid,
                                 spec["off"]:spec["off"] + spec["n"]]
                    else:
                        rows = y[:valid, spec["off"]]
                    state[ui][name][goff:goff + valid] += rows
                elif mode == "colsum":
                    part_state[ui][spec["name"]] += colsum.reshape(
                        sig_shape)
                elif mode == "stats":
                    ps = part_state[ui]
                    n, s_, v = _combine(
                        ps["num_frames"], ps["sum"], ps["varsum"],
                        torch.full_like(ps["num_frames"], float(valid)),
                        colsum.reshape(sig_shape),
                        colvar.reshape(sig_shape),
                    )
                    ps["num_frames"], ps["sum"], ps["varsum"] = n, s_, v

    def _generic_step(self, prep, state, part_state, block, goff: int,
                      coords, valid: int, loff: Optional[int] = None
                      ) -> None:
        """Every device UDF's own ``process_*`` on a (corrected) block,
        one sig tile of the scheme after another.  ``goff``: the
        block's first frame in the roi-compressed nav order (aux rows,
        ``meta.global_offset``); ``loff``: its first row in the nav
        state (a worker's own rows in the multi-device loop; ``goff``
        by default)."""
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
                    depth, aux[ui], loff=loff, trace=prep["trace"],
                )

    def _run_udf_on_tile(self, entry, tile, scheme_idx, sig_slice, meta,
                         state_u, part_u, goff, coords, valid_mask, valid,
                         depth, aux_views, loff: Optional[int] = None,
                         trace: Optional[RunTrace] = None) -> None:
        """One device UDF's ``process_*`` on a tile of a block, its
        results written back into the state; ``trace``: the run's
        spans, which take the call as ``libertem.udf_process``."""
        udf = entry.udf
        call = NOOP if trace is None else trace.udf_process()
        decls = entry.decls
        if loff is None:
            loff = goff
        whole_sig = tuple(sig_slice.shape) == tuple(meta.dataset_shape.sig)
        # a clone of the block's nav rows: what the UDF writes to rows
        # >= valid must not reach the next block's frames
        nav_old = {
            n: state_u[n][loff:loff + depth].clone()
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
            state_u[name][loff:loff + valid] = _as_state(
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
            with call:
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

            with call:
                out = torch.func.vmap(per_frame)(tile, coords, nav_old,
                                                 aux_views)
            for n in entry.nav_names:
                nav_writeback(n, out[n])
        else:
            # frames accumulate into sig/single buffers: one after
            # another over the valid frames (counterpart of lax.scan)
            carry = {n: part_view(n) for n in entry.part_names}
            with call:
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

    def _make_progress(self, progress, prep, n_steps=None):
        """A ProgressManager for ``progress`` (False: None; True: a
        tqdm bar; or a ProgressReporter), with the partitions' frame
        budgets by partition index; with ``n_steps`` (the multi-device
        loop's super-steps, which play the partitions' role in the
        count) no budgets."""
        if not progress:
            return None
        from ..common.progress import (
            ProgressManager,
            ProgressReporter,
            TQDMProgressReporter,
        )
        reporter = (progress if isinstance(progress, ProgressReporter)
                    else self._progress_reporter
                    or TQDMProgressReporter())
        parts = prep["partitions"]
        if n_steps is not None:
            return ProgressManager(prep["n_nav"], n_steps, reporter,
                                   progress_id=str(id(prep)))
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
        trace = prep["trace"]
        trace.run.set_attributes(workers=1)
        pixels = int(np.prod(prep["meta"].sig_shape))
        on_device = any(not e.host for e in plan)
        host_entries = [(ui, e) for ui, e in enumerate(plan) if e.host]
        with trace.span("libertem.open"):
            host = (HostUDFRunner(host_entries, prep) if host_entries
                    else None)
            host_global = host.init_global() if host else {}
            feed = HostFeed(
                (scheme.depth, pixels), dataset.meta.native_dtype, device,
                to_device=on_device, host_reads=host is not None,
            )
            feed.stats["host_s"] = 0.0
            feed.stats["spans"] = trace.spans
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
            with trace.span("libertem.hooks"):
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
            # the partition's partials folded into the run's state
            with trace.span("libertem.fold"):
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

        def wrap(damage_now):
            with trace.span("libertem.wrap"):
                return self._wrap_results(prep, state, host_global,
                                          damage_now)

        current = None
        pm = self._make_progress(progress, prep)
        try:
            with contextlib.closing(
                feed.run(prep["partitions"], scheme, roi, trace.spans)
            ) as blocks:
                for pi, block_t, block in blocks:
                    if pi != current:
                        if current is not None:
                            with _full_fp32_matmul():
                                finish()
                            if yield_partial:
                                yield wrap(damage.copy())
                        if self._params_patched:
                            self._params_patched = False
                            self._apply_param_patch(prep)
                        with trace.span("libertem.hooks"):
                            start(pi)
                        current = pi
                    with trace.span("libertem.step"), _full_fp32_matmul():
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
                        with trace.span("libertem.host_step",
                                        timed=True) as stepped:
                            host.process_block(
                                host_global, part["host"], block.data,
                                block.global_offset, block.coords,
                                block.valid,
                            )
                        feed.stats["host_s"] += stepped.seconds
                    if pm is not None:
                        pm.frames_done(block.valid, ident=pi)
            if current is not None:
                with _full_fp32_matmul():
                    finish()
            # the last partition's partial, or the only result
            yield wrap(damage)
        finally:
            if pm is not None:
                pm.close()

    # -- multi-device loop -------------------------------------------------

    def _worker_preps(self, prep, workers) -> list:
        """Per worker, ``prep`` with its device tensors (the fused
        operand, the compaction support, the corrections plan, the aux
        arrays) on the worker's device: one copy per distinct device,
        shared by the workers on it (counterpart of the JAX package's
        ``put_replicated``)."""
        per_dev = {}
        for dev in workers:
            if dev in per_dev:
                continue
            if dev == prep["device"]:
                per_dev[dev] = prep
                continue

            def put(t, dev=dev):
                return None if t is None else t.to(dev)

            cp = prep["corr_plan"]
            per_dev[dev] = dict(
                prep, device=dev,
                masks_t=put(prep["masks_t"]),
                support=put(prep["support"]),
                corr_plan=(None if cp is None
                           else {k: put(v) for k, v in cp.items()}),
                aux=[{k: put(v) for k, v in a.items()} for a in prep["aux"]],
            )
        return [per_dev[dev] for dev in workers]

    def _run_loop_sharded(self, prep, dataset, progress, yield_partial,
                          workers):
        """The multi-device loop: ``workers`` (a
        :class:`~libertem_tpu_torch.common.distributed.GlobalWorker`
        each, ``(rank, device)``; a device given twice is two workers on
        it), driven by this process for its own workers.

        The roi-compressed nav axis splits into one contiguous shard
        per worker.  Every super-step reads each local worker's next
        block of ``depth`` frames in a reader pool (one thread per
        worker, at most 8), straight into that worker's pinned slot:
        each worker has its own :class:`HostFeed`, copied on its own
        side stream.  Then the step (fused or generic) runs on each
        worker's block with that worker's device current, on its
        current stream.  Nav state is the worker's own (its shard's
        rows, plus ``depth`` pad rows); sig/single state accumulates per
        worker and is folded with each UDF's ``merge``
        (:meth:`_make_sharded_fold`) for every partial result and the
        final one; :meth:`_collapse_sharded` places the nav shards.

        Under a process group of several processes (counterpart of the
        JAX package's multi-host branch), every process computes all of
        the global metadata (ids, bounds, super-steps, damage spans),
        but reads, copies and steps only the shards of its own workers;
        the plan is checked to agree on every process before the first
        read, and the fold and the collapse gather the other processes'
        states (``common/distributed.py``), so every process wraps the
        same results.

        A source that reads in order only (``supports_concurrent_reads
        = False``, the live ring) takes block-cyclic shards instead:
        super-step ``s`` covers the next ``n_dev * depth`` frames of
        the acquisition, worker ``d`` the ``d``-th run of ``depth`` of
        them, read serially in worker order; the depth is capped so
        that one super-step fits the source's in-flight window.  Such a
        source lives in one process and is refused across several.

        Host UDFs process the host copy of each worker's block into one
        partition buffer per shard, merged in shard order at the end.
        Preprocess and postprocess run once per local shard, on the
        real instances for the process's first shard and on clones
        (with their own task data, cleaned up after their postprocess)
        for the others: across processes each shard's hooks run once,
        in the process that holds its state.  A parameter patch
        applies at the next super-step.  One partial result a
        super-step, then the final one after postprocess."""
        from concurrent.futures import ThreadPoolExecutor

        from ..common import distributed
        from .host import HostUDFRunner

        n_dev = len(workers)
        n_nav = prep["n_nav"]
        roi = prep["roi"]
        plan = prep["plan"]
        meta = prep["meta"]
        sig = tuple(meta.dataset_shape.sig)
        nav_shape = tuple(meta.dataset_shape.nav)
        partitions = prep["partitions"]
        scheme = prep["scheme"]
        depth = scheme.depth
        dist_info = prep["dist"]
        rank = 0 if dist_info is None else dist_info["rank"]
        # this process's workers, by global index; the devices of the
        # others are another process's and never touched here
        local = [d for d, w in enumerate(workers) if w.rank == rank]
        devs = [w.device for w in workers]
        main = prep["device"]
        trace = prep["trace"]

        # the shards, each worker's blocks, the super-steps
        with trace.span("libertem.shard_plan"):
            # per-stage wall seconds (timing a stage synchronises the
            # devices: set only when measuring)
            stats = None
            if os.environ.get("LIBERTEM_TPU_SHARDED_STATS"):
                stats = {
                    "assembly_s": 0.0, "h2d_s": 0.0, "step_s": 0.0,
                    "host_udf_s": 0.0, "fold_s": 0.0, "wrap_s": 0.0,
                    "n_steps": 0, "n_devices": n_dev,
                    "collective_s": 0.0,
                    "transport": (None if dist_info is None
                                  else dist_info["transport"]),
                }
            self.last_sharded_stats = stats

            ids_all = (np.flatnonzero(roi) if roi is not None
                       else np.arange(n_nav, dtype=np.int64))
            block_cyclic = not dataset.supports_concurrent_reads
            if block_cyclic:
                # one super-step's reads must fit the source's in-flight
                # window, or the producer and the reader block each other
                cap = getattr(dataset, "max_inflight_frames", None)
                if cap is not None and n_dev * depth > int(cap):
                    depth = max(1, int(cap) // n_dev)
                    scheme = TilingScheme(
                        depth, [sl for _, sl in scheme.slices],
                        scheme.dataset_shape, intent=scheme.intent,
                    )
                    prep["scheme"] = meta.tiling_scheme = scheme
            bounds = np.linspace(0, n_nav, n_dev + 1).astype(np.int64)
            shard_max = int(np.diff(bounds).max()) if n_nav else 0
            # each shard's (first position, frames) runs in the
            # roi-compressed nav order: one contiguous run, or one a
            # super-step (block-cyclic); its state's rows are their
            # concatenation
            if block_cyclic:
                shard_runs = [
                    [(lo, min(depth, n_nav - lo))
                     for lo in range(d * depth, n_nav, n_dev * depth)]
                    for d in range(n_dev)
                ]
            else:
                shard_runs = [[(int(lo), int(hi - lo))]
                              for lo, hi in zip(bounds[:-1], bounds[1:])]
            # each worker's blocks, (first, end) positions: block s of a
            # worker is super-step s, at row s * depth of its nav state
            worker_blocks = [
                [(lo + k, lo + min(k + depth, n))
                 for lo, n in runs for k in range(0, n, depth)]
                for runs in shard_runs
            ]
            n_steps = max([1] + [len(b) for b in worker_blocks])
            # block-cyclic: a worker's n_steps * depth rows fit
            # shard_max + depth
            prep["block_cyclic"] = (depth, n_steps) if block_cyclic else None
            frames_valid_count = getattr(dataset, "frames_valid_count", None)
            trace.run.set_attributes(workers=n_dev, super_steps=n_steps)

        on_device = any(not e.host for e in plan)
        host_entries = [(ui, e) for ui, e in enumerate(plan) if e.host]
        with trace.span("libertem.open"):
            host = (HostUDFRunner(host_entries, prep) if host_entries
                    else None)
            host_global = host.init_global() if host else {}
            host_parts = ({d: host.init_partition() for d in local}
                          if host else None)
            wpreps = dict(zip(local, self._worker_preps(
                prep, [devs[d] for d in local])))
            states = {d: self._init_state(wpreps[d], shard_max)
                      for d in local}

        totals = {"read_s": 0.0, "slot_wait_s": 0.0, "wait_s": 0.0,
                  "blocks": 0, "h2d_bytes": 0, "host_s": 0.0,
                  "collective_s": 0.0, "workers": [],
                  "transport": (None if dist_info is None
                                else dist_info["transport"]),
                  "spans": trace.spans}
        self.feed_stats = totals
        if dist_info is not None:
            # what every process must agree on before the first read:
            # a difference would hang a gather or misplace rows
            t0 = time.perf_counter()
            distributed.check_agreement("run plan", {
                "n_nav": n_nav,
                "roi": (len(ids_all), hashlib.sha1(
                    ids_all.astype(np.int64).tobytes()).hexdigest()),
                "depth": depth,
                "bounds": bounds.tolist(),
                "block_cyclic": block_cyclic,
                "dataset": (tuple(meta.dataset_shape),
                            str(np.dtype(meta.dataset_dtype))),
                "input_dtype": str(np.dtype(prep["input_dtype"])),
                "fused": prep["fused"] is not None,
                "matmul_precision": prep["matmul_precision"],
                "plan": [
                    (type(e.udf).__name__, e.host, [
                        (n, e.decls[n].kind, tuple(t.shape), str(t.dtype))
                        for n, t in states[local[0]][ui].items()])
                    for ui, e in enumerate(plan)
                ],
            })
            dist_info["collective_s"] += time.perf_counter() - t0
            if block_cyclic:
                raise UDFException(
                    f"{type(dataset).__name__} reads in order from one "
                    "process (block-cyclic shards); it cannot feed a run "
                    "over several processes - run it in one process")

        feeds = {}
        # the feeds, the hooks' instances, the readers' pool
        with trace.span("libertem.open"):
            for d in local:
                feeds[d] = HostFeed(
                    (depth, int(np.prod(sig))), dataset.meta.native_dtype,
                    devs[d], to_device=on_device,
                    host_reads=host is not None)
                feeds[d].open()
                totals["workers"].append(feeds[d].stats)
            # the hooks' instances: the first local shard the real ones,
            # clones for the others (get_task_data sees the run's
            # coordinates, as in _prepare)
            shard_udfs = {local[0]: list(self._udfs)}
            meta.coordinates = np.stack(
                np.unravel_index(ids_all, nav_shape), axis=-1
            ).astype(np.int32).reshape(n_nav, len(nav_shape))
            meta._slice = Slice((0,) * (1 + len(sig)),
                                Shape((n_nav,) + sig, sig_dims=len(sig)))
            try:
                for d in local[1:]:
                    clones = []
                    for udf in self._udfs:
                        clone = udf.copy()
                        clone.meta = udf.meta
                        clone.task_data = UDFData(clone.get_task_data() or {})
                        clones.append(clone)
                    shard_udfs[d] = clones
            finally:
                meta.coordinates = None
                meta._slice = None

            stop = threading.Event()
            for p in partitions:
                p.stop_event = stop
            q: queue.Queue = queue.Queue()
            pool = ThreadPoolExecutor(max_workers=min(len(local), 8),
                                      thread_name_prefix="shard-reader")

        # with stats: each worker's copies, waited for by its reader
        h2d_s = [0.0] * n_dev

        def read_chunk(d, s):
            """Worker ``d``'s block of super-step ``s``, read into its
            next pinned slot and copied to its device: ``(slot, Block,
            first local row)``, or None past the worker's shard."""
            if s >= len(worker_blocks[d]):
                return None
            base, end = worker_blocks[d][s]
            loff = s * depth
            feed = feeds[d]
            slot = feed.acquire_slot(stop)
            with span("libertem.read", timed=True) as read:
                out = feed.host_block(slot, (depth,) + sig)
                chunk = ids_all[base:end]
                read_ids_across(partitions, chunk, out)
                coords = np.zeros((depth, len(nav_shape)), dtype=np.int32)
                if nav_shape:
                    for k, u in enumerate(
                            np.unravel_index(chunk, nav_shape)):
                        coords[:len(chunk), k] = u
                block = Block(global_offset=base, coords=coords,
                              valid=len(chunk), data=out)
            feed.stats["read_s"] += read.seconds
            t1 = time.perf_counter()
            feed.push(slot, block)
            if stats and feed._cuda:
                feed._copied[slot].synchronize()
                h2d_s[d] += time.perf_counter() - t1
            return slot, block, loff

        def assemble():
            try:
                for s in range(n_steps):
                    t0 = time.perf_counter()
                    if block_cyclic:
                        # in order, one worker after another: the ring
                        # frees what was read
                        items = {d: read_chunk(d, s) for d in local}
                    else:
                        items = dict(zip(local, pool.map(
                            read_chunk, local, [s] * len(local))))
                    # every worker's block of the step, this process's
                    # or another's (global knowledge)
                    spans = [worker_blocks[d][s] for d in range(n_dev)
                             if s < len(worker_blocks[d])]
                    frames = sum(hi - lo for lo, hi in spans)
                    if frames_valid_count is not None:
                        # an acquisition that finished early: damage
                        # only the frames that arrived
                        vc = int(frames_valid_count())
                        spans = [
                            (lo, lo + cut) for lo, hi in spans
                            for cut in [int(np.searchsorted(
                                ids_all[lo:hi], vc))]
                            if cut > 0
                        ]
                    if stats:
                        stats["assembly_s"] += time.perf_counter() - t0
                    q.put(("item", (items, spans, frames)))
                q.put(("done", None))
            except ReadCancelled:
                pass
            except BaseException as e:  # handed to the consumer
                q.put(("error", e))

        def on(dev):
            return (torch.cuda.device(dev) if dev.type == "cuda"
                    else contextlib.nullcontext())

        def sync():
            for dev in {devs[d] for d in local}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

        def snapshot(damage_now):
            with trace.span("libertem.fold", True, workers=n_dev) as folded:
                collapsed = self._collapse_sharded(prep, states, bounds,
                                                   fold)
            with trace.span("libertem.wrap", True) as wrapped:
                out = self._wrap_results(prep, collapsed, host_global,
                                         damage_now)
            if stats:
                stats["fold_s"] += folded.seconds
                stats["wrap_s"] += wrapped.seconds
            return out

        def hook(d, name):
            """``preprocess`` or ``postprocess`` of shard ``d``'s
            instances, as the single-device loop calls them for a
            partition: the host UDFs with the shard's views bound, the
            device UDFs (postprocess) with host copies of the worker's
            rows and sig/single state, written back after."""
            udfs = shard_udfs[d]
            n_rows = sum(n for _, n in shard_runs[d])
            if host is not None:
                host.bind_partition_views(host_global, host_parts[d],
                                          runs=shard_runs[d], udfs=udfs)
            bound = None
            if name == "postprocess":
                bound = self._bind_device_postprocess(
                    prep, states[d], states[d], 0, n_rows, udfs=udfs)
            for udf in udfs:
                getattr(udf, name)()
            if bound is not None:
                self._writeback_device_postprocess(
                    prep, states[d], states[d], 0, n_rows, bound,
                    udfs=udfs)
            if host is not None:
                host.unbind_views()

        damage = np.zeros(n_nav, dtype=bool)
        with trace.span("libertem.open"):
            fold = self._make_sharded_fold(prep, workers)
            pm = self._make_progress(progress, prep, n_steps=n_steps)
            thread = threading.Thread(target=assemble, daemon=True,
                                      name="shard-reader-main")

        try:
            with trace.span("libertem.hooks"):
                for d in local:
                    hook(d, "preprocess")
            with trace.span("libertem.open"):
                thread.start()
            while True:
                # the super-step up to its slots' release: its parts
                # and the stretches between them
                with trace.span("libertem.super_step"):
                    with trace.span("libertem.feed_wait", True) as waited:
                        kind, payload = q.get()
                    totals["wait_s"] += waited.seconds
                    if kind == "done":
                        break
                    if kind == "error":
                        raise payload
                    items, spans, frames = payload
                    if self._params_patched:
                        self._params_patched = False
                        self._apply_param_patch(prep)
                        wpreps = dict(zip(local, self._worker_preps(
                            prep, [devs[d] for d in local])))
                    t0 = time.perf_counter()
                    # every worker's step first, then the host engine on
                    # the host copies while the devices work
                    for d, item in items.items():
                        if item is None:
                            continue
                        slot, block, loff = item
                        with trace.span("libertem.step"), on(devs[d]), \
                                _full_fp32_matmul():
                            block_t = feeds[d].take(slot)
                            meta.device = devs[d]
                            if prep["fused"] is not None:
                                self._fused_step(
                                    wpreps[d], states[d], states[d], block_t,
                                    loff, block.valid,
                                )
                            elif on_device:
                                coords = torch.from_numpy(block.coords).to(
                                    devs[d])
                                self._generic_step(
                                    wpreps[d], states[d], states[d], block_t,
                                    block.global_offset, coords, block.valid,
                                    loff=loff,
                                )
                    meta.device = main
                    if stats:
                        sync()
                        t1 = time.perf_counter()
                        stats["step_s"] += t1 - t0
                        stats["n_steps"] += 1
                        t0 = t1
                    if host is not None:
                        with trace.span("libertem.host_step", True) as stepped:
                            for d, item in items.items():
                                if item is not None:
                                    _, block, _ = item
                                    host.process_block(
                                        host_global, host_parts[d], block.data,
                                        block.global_offset, block.coords,
                                        block.valid,
                                    )
                        totals["host_s"] += stepped.seconds
                        if stats:
                            stats["host_udf_s"] += stepped.seconds
                    with trace.span("libertem.release"):
                        for d, item in items.items():
                            if item is not None:
                                with on(devs[d]):
                                    feeds[d].release(item[0])
                        for lo, hi in spans:
                            damage[lo:hi] = True
                        if pm is not None:
                            pm.frames_done(frames)
                if yield_partial:
                    yield snapshot(damage.copy())
            # postprocess once a shard, the clones cleaned up after it
            # (the real instances at the run's end: get_results may
            # read their task data)
            with trace.span("libertem.hooks"):
                for d in local:
                    hook(d, "postprocess")
                    if d != local[0]:
                        for udf in shard_udfs[d]:
                            udf.cleanup()
            if host is not None:
                # each shard's partition buffers, in shard order (host
                # UDFs run in one process); the valid nav mask shows
                # what is merged so far
                merged = np.zeros_like(damage)
                with trace.span("libertem.fold"):
                    for d in local:
                        runs = shard_runs[d] or [(0, 0)]
                        meta._valid_nav_mask = merged.copy()
                        try:
                            if len(runs) > 1:
                                host.merge_partition(
                                    host_global, host_parts[d], runs=runs)
                            else:
                                host.merge_partition(
                                    host_global, host_parts[d], *runs[0])
                        finally:
                            meta._valid_nav_mask = None
                        for lo, n in runs:
                            merged[lo:lo + n] = damage[lo:lo + n]
            yield snapshot(damage)
        finally:
            # no collective here: after an exception the other
            # processes meet this one's absence in their next gather
            with trace.span("libertem.close"):
                stop.set()
                if thread.is_alive():
                    thread.join(timeout=60)
                pool.shutdown(wait=True)
                for feed in feeds.values():
                    feed.close()
            meta.device = main
            for k in ("read_s", "slot_wait_s", "blocks", "h2d_bytes"):
                totals[k] = sum(feed.stats[k] for feed in feeds.values())
            if dist_info is not None:
                totals["collective_s"] = dist_info["collective_s"]
            if stats:
                stats["h2d_s"] = sum(h2d_s)
                stats["collective_s"] = totals["collective_s"]
            if pm is not None:
                pm.close()

    def _gathered(self, prep, states, keys, device) -> list:
        """Every worker's state tensors ``keys`` (``(entry, name)``
        pairs), a dict each in global worker order, on ``device``: with
        one process straight from ``states`` (copies where it is another
        device), else this process's gathered with the others' over the
        process group (one packed gather; its time in the run's
        ``collective_s``)."""
        from ..common import distributed

        dist_info = prep["dist"]
        local = sorted(states)
        if dist_info is None:
            return [{k: states[d][k[0]][k[1]].to(device) for k in keys}
                    for d in local]
        t0 = time.perf_counter()
        gathered = distributed.gather_buffers(
            [[states[d][ui][n] for ui, n in keys] for d in local], device)
        dist_info["collective_s"] += time.perf_counter() - t0
        return [dict(zip(keys, ts)) for ts in gathered]

    def _make_sharded_fold(self, prep, workers):
        """The fold of the workers' sig/single states (counterpart of
        the JAX package's ``all_gather`` and traced sequential merge):
        each worker's state on this process's main device (a copy
        between cards waits for the current streams of both; across
        processes the gathered copies, :meth:`_gathered`), folded in
        global worker order with each UDF's ``merge``, worker 0 a copy
        as ``dest``, with TF32 off as in ``_merge``: every process folds
        the same states the same way.  Host entries fold on the host
        (``merge_partition``)."""
        main = prep["device"]
        keys = [(ui, n) for ui, e in enumerate(prep["plan"])
                if not e.host for n in e.part_names]

        def fold(states) -> list:
            per_worker = self._gathered(prep, states, keys, main)
            out = []
            for entry_i, entry in enumerate(prep["plan"]):
                names = entry.part_names
                if not names or entry.host:
                    out.append({})
                    continue
                acc = {n: per_worker[0][(entry_i, n)].to(main, copy=True)
                       for n in names}
                for st in per_worker[1:]:
                    dest = UDFData(dict(acc))
                    src = UDFData({n: st[(entry_i, n)] for n in names})
                    with _full_fp32_matmul():
                        entry.udf.merge(dest, src)
                    for n in names:
                        if n in dest._touched:
                            acc[n] = _as_state(dest._get(n), acc[n])
                out.append(acc)
            return out

        return fold

    def _collapse_sharded(self, prep, states, bounds, fold) -> list:
        """The workers' states as one run state for ``_wrap_results``:
        nav shards (gathered across processes) placed positionally on
        the host (contiguous windows, or, block-cyclic, worker ``d``'s
        local row ``(s, k)`` at ``s * n_dev * depth + d * depth + k``: a
        ``(worker, step, depth) -> (step, worker, depth)`` transpose),
        sig/single states folded on the main device.  The same on every
        process: the results are replicated."""
        n_nav = prep["n_nav"]
        plan = prep["plan"]
        bc = prep["block_cyclic"]
        folded = (fold(states)
                  if any(e.part_names and not e.host for e in plan)
                  else None)
        nav_keys = [(ui, n) for ui, e in enumerate(plan)
                    if not e.host for n in e.nav_names]
        shards = (self._gathered(prep, states, nav_keys, "cpu")
                  if nav_keys else [])
        out = []
        for ui, entry in enumerate(plan):
            bufs = {}
            if entry.host:
                out.append(bufs)
                continue
            for n in entry.nav_names:
                xs = [sh[(ui, n)] for sh in shards]
                extra = tuple(xs[0].shape[1:])
                if bc is not None:
                    bdepth, n_steps = bc
                    inter = torch.stack(
                        [x[:n_steps * bdepth] for x in xs]
                    ).reshape((len(xs), n_steps, bdepth) + extra)
                    bufs[n] = inter.transpose(0, 1).reshape(
                        (-1,) + extra)[:n_nav].clone()
                else:
                    bufs[n] = torch.cat([
                        x[:int(bounds[d + 1] - bounds[d])]
                        for d, x in enumerate(xs)
                    ])
            if folded is not None:
                bufs.update(folded[ui])
            out.append(bufs)
        return out

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


class UDFPartRunner:
    """Runs UDFs over one partition on the host CPU with numpy, tile by
    tile (or frame by frame, or the whole partition), through the
    UDFs' worker protocol (``set_meta``, ``allocate_for_part``, ...):
    for code that drives partitions by hand, with
    :meth:`UDFParams.from_udfs`.  The runner's loop never goes through
    it.  Corrections apply to whole-frame schemes only; a scheme that
    splits the frame with corrections raises NotImplementedError."""

    def __init__(self, udfs: Sequence[UDF], debug: bool = False):
        self._udfs = list(udfs)
        self._debug = debug

    def run_for_partition(self, partition, params, env,
                          backend_choice=None) -> tuple:
        """Each UDF's ``results`` (UDFData of numpy buffers over the
        partition's frames of the roi) after processing ``partition``;
        ``params`` from :meth:`UDFParams.from_udfs`, ``env`` an
        ``executor.base.Environment`` (its ``threads_per_worker``)."""
        roi = params.get("roi")
        corrections = params.get("corrections")
        scheme = params.get("tiling_scheme")
        ds_shape = partition.meta.shape
        sig = ds_shape.sig
        if scheme is None:
            scheme = TilingScheme.make_for_shape(
                Shape((max(1, min(32, partition.num_frames)),) + tuple(sig),
                      sig_dims=sig.dims),
                ds_shape,
            )
        if self._debug:
            for udf in self._udfs:
                pickle.loads(pickle.dumps(udf._kwargs))
        have_corr = (corrections is not None
                     and corrections.have_corrections())
        if have_corr and len(scheme) > 1:
            raise NotImplementedError(
                "UDFPartRunner applies corrections only for whole-sig "
                "tiling schemes; use Context.run_udf for the corrected "
                "path"
            )
        input_dtype = _get_input_dtype(self._udfs,
                                       partition.meta.native_dtype)
        if have_corr and np.dtype(input_dtype).kind not in "fc":
            input_dtype = np.dtype(np.float32)
        flat_roi = None if roi is None else np.asarray(roi).reshape(-1)
        pslice = partition.slice.adjust_for_roi(flat_roi)
        methods = []
        for udf in self._udfs:
            method = udf.get_method()
            if method not in tuple(UDFMethod):
                raise UDFException(
                    f"{type(udf).__name__}.get_method() returned "
                    f"unrecognized method {method!r}")
            method = UDFMethod(method).value
            if not hasattr(udf, f"process_{method}"):
                raise UDFException(
                    f"{type(udf).__name__}.get_method() chose {method!r} "
                    f"but process_{method} is not implemented")
            methods.append(method)
            udf.set_backend(UDF.BACKEND_NUMPY)
            udf.set_meta(UDFMeta(
                dataset_shape=ds_shape,
                dataset_dtype=partition.meta.native_dtype,
                input_dtype=input_dtype, roi=roi, tiling_scheme=scheme,
                corrections=corrections,
                threads_per_worker=getattr(env, "threads_per_worker", 1)
                or 1,
                partition_slice=pslice, array_backend=UDF.BACKEND_NUMPY,
            ))
            udf.init_result_buffers()
            udf.allocate_for_part(partition, roi)
            udf.init_task_data()
            udf._host_mode = True
            udf.preprocess()

        def corrected(data):
            data = data.astype(input_dtype, copy=False)
            if have_corr:
                data = corrections.apply_numpy(data).astype(
                    input_dtype, copy=False)
            return data

        goff0 = partition.roi_offset(flat_roi)
        try:
            for udf, method in zip(self._udfs, methods):
                if method == "partition":
                    data = partition._read_selected_with_offset(
                        partition.local_frame_ids(flat_roi))
                    udf.meta._slice = pslice
                    udf.meta.sig_slice = scheme[0]
                    udf.process_partition(corrected(data))
                    continue
                for tile in partition.get_tiles(scheme, roi=flat_roi):
                    self._run_tile(udf, method, tile, corrected(tile.data),
                                   scheme, sig, goff0)
        finally:
            for udf in self._udfs:
                try:
                    udf.postprocess()
                finally:
                    udf._host_mode = False
                    if udf.meta is not None:
                        udf.meta._slice = None
        return tuple(udf.results for udf in self._udfs)

    @staticmethod
    def _run_tile(udf, method, tile, data, scheme, sig, goff0) -> None:
        """One tile through ``udf``: its buffers bound as views of the
        tile's nav rows (and of the sig tile, written back after)."""
        sig_slice = scheme[tile.scheme_idx]
        whole_sig = tuple(sig_slice.shape) == tuple(sig)
        udf.set_slice(tile.tile_slice)
        udf.set_tile_idx(tile.scheme_idx)
        udf.meta.sig_slice = sig_slice
        r0 = tile.tile_slice.origin[0] - goff0
        n = tile.tile_slice.shape[0]
        full = udf.results
        views = {}
        sig_wb = []
        for name, decl in udf._part_decls.items():
            arr = full._get(name)
            if decl.use == "result_only":
                views[name] = None
            elif decl.kind == "nav":
                views[name] = arr[r0:r0 + n]
            elif decl.kind == "sig" and not whole_sig:
                idx = sig_slice.get() + (slice(None),) * len(
                    decl.extra_shape)
                cont = np.ascontiguousarray(arr[idx])
                views[name] = cont
                sig_wb.append((arr, idx, cont))
            else:
                views[name] = arr
        udf.results = UDFData(views)
        try:
            if method == "tile":
                udf.process_tile(data)
                return
            if not whole_sig:
                raise UDFException(
                    "process_frame needs whole frames but the tiling "
                    "scheme splits the signal dimensions")
            origin = tile.tile_slice.origin
            for i in range(n):
                udf.results = UDFData({
                    k: (v[i:i + 1] if v is not None
                        and udf._part_decls[k].kind == "nav" else v)
                    for k, v in views.items()
                })
                udf.meta._slice = Slice(
                    origin=(origin[0] + i,) + tuple(origin[1:]),
                    shape=Shape((1,) + tuple(tile.tile_slice.shape)[1:],
                                sig_dims=sig.dims),
                )
                udf.process_frame(data[i])
        finally:
            for arr, idx, cont in sig_wb:
                arr[idx] = cont
            udf.results = full
