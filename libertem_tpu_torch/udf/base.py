"""UDF contract and the runner (counterpart of
``libertem_tpu/udf/base.py``).

A run streams the dataset (the frames of its roi, when it has one) as
fixed-depth, zero-padded ``(depth, pixels)`` blocks of raw-dtype
frames; with corrections, each block is dark-subtracted, gain-scaled
and repaired on the device first (``UDFRunner._apply_corrections``).
Then one of two paths:

* **fused**: when every UDF of the set declares a
  ``fused_moments_spec`` (ApplyMasks, CoM, Sum, SumSig, StdDev, NoOp),
  the whole pass is one fused moments op per block
  (:func:`libertem_tpu_torch.ops.moments.fused_moments`), and its
  three outputs are distributed into each UDF's state;
* **generic**: otherwise every UDF runs its own ``process_*`` method
  on the block, eagerly: ``process_tile`` and ``process_partition``
  once per sig tile of the scheme, ``process_frame`` under
  ``torch.func.vmap`` when the UDF writes only nav buffers, else as a
  loop over the block's valid frames.

State lives on the device:

* ``kind='nav'`` buffers: one tensor each, roi-compressed, with
  ``depth`` pad rows so every block has a full-depth view.  A UDF gets
  a clone of its block's rows; only the rows ``< valid`` are written
  back, so writes to padding never reach the next block's frames.
* ``kind='sig'|'single'`` buffers accumulate per partition, starting
  from zeros; at the end of the partition ``UDF.merge`` folds them
  into the run's state.

Results come back to the host once, at the end, where
``UDF.get_results`` post-processes them with numpy; nav results are
expanded from the roi to the full nav shape there.

Not ported yet: aux buffers, the host engine (numpy UDFs and UDFs that
``vmap`` cannot take), pre/postprocess hooks, partial results and the
sharded loop.
"""
from __future__ import annotations

import contextlib
import enum
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.buffers import ArrayWithMask, BufferWrapper
from ..common.shape import Shape
from ..common.slice import Slice
from ..io.corrections import CorrectionSet
from ..io.dataset.base import DataSet, Partition
from ..io.tiling import (
    TILE_DEPTH_DEFAULT,
    TILE_DEPTH_MAX,
    TILE_SIZE_BEST_FIT,
    TILE_SIZE_MAX,
    Negotiator,
    TilingScheme,
)
from ..ops.moments import fused_moments


class UDFData:
    """Attribute-style accessor over a dict of arrays; records writes."""

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

    def _get(self, k):
        return self._data[k]


class UDFParams:
    """Attribute access to a UDF's constructor arguments."""

    def __init__(self, kwargs: dict):
        object.__setattr__(self, "_kwargs", kwargs)

    def __getattr__(self, k):
        try:
            return object.__getattribute__(self, "_kwargs")[k]
        except KeyError:
            raise AttributeError(k) from None


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
    tile, a :class:`Slice`) and ``tiling_scheme_idx``.  During
    ``get_task_data``, ``coordinates`` holds the numpy coordinates of
    every frame of the run.
    """

    def __init__(self, dataset_shape: Shape, dataset_dtype, input_dtype,
                 roi: Optional[np.ndarray] = None,
                 tiling_scheme: Optional[TilingScheme] = None,
                 device: Optional[torch.device] = None):
        self.dataset_shape = dataset_shape
        self.dataset_dtype = np.dtype(dataset_dtype)
        self.input_dtype = np.dtype(input_dtype)
        self._roi = roi
        self.tiling_scheme = tiling_scheme
        self.device = torch.device("cpu") if device is None else device
        self.coordinates = None
        self.tile_valid = None
        self.valid_frames = None
        self.global_offset = None
        self.sig_slice: Optional[Slice] = None
        self.tiling_scheme_idx = 0

    @property
    def roi(self) -> Optional[np.ndarray]:
        """The run's roi in nav shape, or None."""
        if self._roi is None:
            return None
        return np.asarray(self._roi, dtype=bool).reshape(
            tuple(self.dataset_shape.nav)
        )

    @property
    def sig_shape(self) -> tuple:
        return tuple(self.dataset_shape.sig)


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
    """

    USE_NATIVE_DTYPE = np.bool_  # result_type(bool, x) == x
    TILE_SIZE_BEST_FIT = TILE_SIZE_BEST_FIT
    TILE_SIZE_MAX = TILE_SIZE_MAX
    TILE_DEPTH_DEFAULT = TILE_DEPTH_DEFAULT
    TILE_DEPTH_MAX = TILE_DEPTH_MAX

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self.params = UDFParams(kwargs)
        self.results: Optional[UDFData] = None
        self.meta: Optional[UDFMeta] = None
        self.task_data: Optional[UDFData] = None

    def get_result_buffers(self) -> dict:
        raise NotImplementedError()

    @staticmethod
    def buffer(kind, extra_shape=(), dtype="float32", use=None):
        return BufferWrapper(kind, extra_shape, dtype, use)

    @staticmethod
    def with_mask(data, mask):
        """Mark the valid region of a ``get_results`` value."""
        return ArrayWithMask(data, mask)

    def merge(self, dest: UDFData, src: UDFData):
        raise NotImplementedError(
            f"{type(self).__name__} declares non-nav buffers and must "
            f"implement merge(dest, src)"
        )

    def get_results(self) -> dict:
        return {}

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
    """Device state dtype of a declared buffer: 64-bit floats run in
    32 bits on the device, as in the JAX package; the result is cast
    back to the declared dtype on the host."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        dtype = np.dtype(np.float32)
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


class _UDFPlanEntry:
    """Per-UDF static plan: declarations split by residency, and the
    ``process_*`` method the UDF runs through."""

    def __init__(self, udf: UDF, decls: dict):
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
            raise ValueError(
                f"{type(udf).__name__}.get_method() returned "
                f"unrecognized method {method!r}"
            )
        self.method = UDFMethod(method).value
        if not hasattr(udf, f"process_{self.method}"):
            raise TypeError(
                f"{type(udf).__name__}.get_method() chose "
                f"{self.method!r} but process_{self.method} is not "
                f"implemented"
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
    """

    masks_t: np.ndarray
    specs: list
    need_var: bool
    need_colsum: bool


class HostFeed:
    """Streams a dataset's blocks to the device, overlapped with
    compute (counterpart of ``UDFRunner._prefetch``).

    A background thread reads each block straight into one of
    ``SLOTS`` page-locked host buffers and, on the CUDA path, copies it
    to the matching device buffer with ``non_blocking=True`` on a side
    stream.  The ordering rules:

    * the step that reads a device buffer waits (on the device) for the
      event recorded after its copy;
    * a copy into a device buffer waits (on the device) for the event
      recorded after the previous step that read it;
    * the thread refills a host buffer only after the copy out of it
      has finished (a host wait on the copy event), and only after the
      consumer has released the slot.

    On the CPU the host buffers are the blocks themselves.  Each item
    is usable until the consumer asks for the next one.
    """

    SLOTS = 3

    def __init__(self, block_shape: tuple, dtype, device: torch.device):
        self._device = device
        self._cuda = device.type == "cuda"
        tdtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        self._host = [
            torch.empty(block_shape, dtype=tdtype, pin_memory=self._cuda)
            for _ in range(self.SLOTS)
        ]
        if self._cuda:
            self._dev = [
                torch.empty(block_shape, dtype=tdtype, device=device)
                for _ in range(self.SLOTS)
            ]
            self._copied = [torch.cuda.Event() for _ in range(self.SLOTS)]
            self._consumed = [
                torch.cuda.Event() for _ in range(self.SLOTS)
            ]
            self._stream = torch.cuda.Stream(device)
        else:
            self._dev = self._host
        # read_s: the reader filling host buffers; slot_wait_s: the
        # reader waiting for a free slot (the consumer is behind);
        # wait_s: the consumer waiting for a block (the feed is behind)
        self.stats = {
            "read_s": 0.0, "slot_wait_s": 0.0, "wait_s": 0.0, "blocks": 0,
        }

    def run(self, partitions: Sequence[Partition], scheme: TilingScheme,
            roi: Optional[np.ndarray] = None):
        """Yield ``(partition index, device block, Block)`` for every
        block of every partition (of the roi's frames), in order."""
        free = threading.Semaphore(self.SLOTS)
        stop = threading.Event()
        q: queue.Queue = queue.Queue()
        slot_of_next = [0]
        sig = tuple(scheme.dataset_shape.sig)

        def acquire() -> np.ndarray:
            t0 = time.perf_counter()
            while not free.acquire(timeout=0.1):
                if stop.is_set():
                    raise _FeedStopped()
            slot = slot_of_next[0] % self.SLOTS
            if self._cuda:
                self._copied[slot].synchronize()
            self.stats["slot_wait_s"] += time.perf_counter() - t0
            return self._host[slot].numpy().reshape(
                (scheme.depth,) + sig
            )

        def worker():
            try:
                if self._cuda:
                    torch.cuda.set_device(self._device)
                for pi, part in enumerate(partitions):
                    blocks = part.gen_blocks(scheme, roi, out=acquire)
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
                        if self._cuda:
                            with torch.cuda.stream(self._stream):
                                self._stream.wait_event(
                                    self._consumed[slot]
                                )
                                self._dev[slot].copy_(
                                    self._host[slot], non_blocking=True
                                )
                                self._copied[slot].record(self._stream)
                        q.put(("item", (pi, slot, block)))
                q.put(("done", None))
            except _FeedStopped:
                pass
            except BaseException as e:  # handed to the consumer
                q.put(("error", e))

        thread = threading.Thread(target=worker, daemon=True)
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
                self.stats["blocks"] += 1
                yield pi, self._dev[slot], block
                if self._cuda:
                    self._consumed[slot].record(
                        torch.cuda.current_stream(self._device)
                    )
                free.release()
        finally:
            stop.set()
            thread.join(timeout=60)


class _FeedStopped(Exception):
    """The consumer went away while the reader waited for a slot."""


class UDFRunner:
    """Runs a set of UDFs over a dataset in one pass: fused when every
    UDF can join the fused moments op, else generic."""

    def __init__(self, udfs: Sequence[UDF]):
        self._udfs = list(udfs)
        self.feed_stats: Optional[dict] = None

    def run_for_dataset(self, dataset: DataSet, device: torch.device,
                        roi: Optional[np.ndarray] = None,
                        corrections: Optional[CorrectionSet] = None,
                        ) -> UDFResults:
        prep = self._prepare(dataset, device, roi, corrections)
        with _full_fp32_matmul():
            state = self._run_loop(prep, dataset)
        return self._wrap_results(prep, state)

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
        input_dtype = _get_input_dtype(udfs, meta0.native_dtype)
        if input_dtype.kind == "c":
            raise NotImplementedError("complex data is not ported yet")
        # the device computes in float32, as the JAX package does
        if input_dtype == np.float64:
            input_dtype = np.dtype(np.float32)
        if corrections is not None and not corrections.have_corrections():
            corrections = None
        if corrections is not None and input_dtype.kind != "f":
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
        )
        for udf in udfs:
            udf.meta = meta
        scheme = Negotiator().get_scheme(
            udfs, meta0.shape, input_dtype,
            max_partition_frames=max(1, max_part_frames),
            corrections=corrections,
        )
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
        plan = []
        try:
            for udf in udfs:
                decls = dict(udf.get_result_buffers())
                for b in decls.values():
                    b.set_shape_ds(meta0.shape, roi)
                entry = _UDFPlanEntry(udf, decls)
                if (udf.requires_custom_merge(decls)
                        and type(udf).merge is UDF.merge):
                    raise NotImplementedError(
                        f"{type(udf).__name__} declares non-nav buffers "
                        f"and must implement merge()"
                    )
                udf.task_data = UDFData(udf.get_task_data() or {})
                plan.append(entry)
        finally:
            meta.coordinates = None
        fused = self._build_fused_plan(plan, meta)
        return {
            "fused": fused,
            "masks_t": (
                None if fused is None
                else torch.from_numpy(fused.masks_t).to(device)
            ),
            "corr_plan": self._device_corr_plan(
                corrections, meta0.shape.sig, device
            ),
            "input_tdtype": _torch_dtype(input_dtype),
            "meta": meta,
            "plan": plan,
            "scheme": scheme,
            "partitions": partitions,
            "roi": roi,
            "n_nav": n_nav,
            "device": device,
        }

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
        """Collapse the UDF set into one fused moments pass, or None
        when some UDF cannot join it."""
        if np.dtype(meta.input_dtype).kind not in "fiu":
            return None
        pixels = int(np.prod(meta.sig_shape))
        mask_rows = []
        specs = []
        need_var = False
        need_colsum = False
        col_off = 0
        for ui, entry in enumerate(plan):
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
        if any(s["mode"] == "sumsig" for s in specs):
            mask_rows.append(np.ones((1, pixels), dtype=np.float32))
            for s in specs:
                if s["mode"] == "sumsig":
                    s["off"] = col_off
            col_off += 1
        if col_off == 0:
            # one zero row, so the op always has a mask operand
            mask_rows.append(np.zeros((1, pixels), dtype=np.float32))
        return FusedPlan(
            masks_t=np.concatenate(mask_rows, axis=0),
            specs=specs, need_var=need_var, need_colsum=need_colsum,
        )

    # -- state -----------------------------------------------------------

    def _zeros(self, prep, decl, shape):
        return torch.zeros(
            shape, dtype=_state_dtype(decl.dtype), device=prep["device"]
        )

    def _init_state(self, prep) -> list:
        """Per UDF a dict name -> tensor.  Nav buffers get ``depth``
        pad rows past the roi-compressed nav, so the last block has a
        full-depth view too."""
        depth = prep["scheme"].depth
        state = []
        for e in prep["plan"]:
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
        return {
            n: self._zeros(prep, entry.decls[n], entry.decls[n].shape)
            for n in entry.part_names
        }

    def _init_part_state(self, prep) -> list:
        return [self._init_part_state_one(prep, e) for e in prep["plan"]]

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
        """One fused op on a block, then each UDF's share of its
        outputs into the state.  Updates the state tensors in place:
        nav rows of different blocks never overlap, and the per-
        partition sums are private to this run."""
        from .stddev import _combine

        fused: FusedPlan = prep["fused"]
        sig_shape = tuple(prep["meta"].dataset_shape.sig)
        if prep["corr_plan"] is not None:
            block = self._apply_corrections(block, prep, valid)
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
        """Every UDF's own ``process_*`` on a (corrected) block, one sig
        tile of the scheme after another."""
        meta = prep["meta"]
        scheme = prep["scheme"]
        depth = scheme.depth
        sig_shape = tuple(meta.dataset_shape.sig)
        block = self._apply_corrections(
            block.reshape((depth,) + sig_shape), prep, valid
        )
        valid_mask = torch.arange(depth, device=block.device) < valid
        for k, sig_slice in scheme.slices:
            tile = (
                block if len(scheme) == 1
                else block[(slice(None),) + sig_slice.get()]
            )
            for ui, entry in enumerate(prep["plan"]):
                self._run_udf_on_tile(
                    entry, tile, k, sig_slice, meta, state[ui],
                    part_state[ui], goff, coords, valid_mask, valid,
                    depth,
                )

    def _run_udf_on_tile(self, entry, tile, scheme_idx, sig_slice, meta,
                         state_u, part_u, goff, coords, valid_mask, valid,
                         depth) -> None:
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
            def per_frame(frame, coord, olds):
                udf.results = UDFData(dict(olds, **ro_views))
                meta.coordinates = coord
                udf.process_frame(frame)
                return {
                    n: _as_state(udf.results._get(n), olds[n])
                    for n in entry.nav_names
                }

            try:
                out = torch.func.vmap(per_frame)(tile, coords, nav_old)
            except RuntimeError as e:
                raise NotImplementedError(
                    f"{type(udf).__name__}.process_frame cannot run "
                    f"under torch.func.vmap ({e}); the host engine that "
                    f"runs such UDFs frame by frame is not ported yet"
                ) from e
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

    def _merge(self, prep, state, part_state) -> None:
        """Fold a partition's sig/single state into the run's state
        with each UDF's ``merge``."""
        for ui, entry in enumerate(prep["plan"]):
            if not entry.part_names:
                continue
            dest = UDFData({n: state[ui][n] for n in entry.part_names})
            src = UDFData({n: part_state[ui][n] for n in entry.part_names})
            entry.udf.merge(dest, src)
            for n in entry.part_names:
                if n in dest._touched:
                    state[ui][n] = _as_state(dest._get(n), state[ui][n])

    # -- main loop -------------------------------------------------------

    def _run_loop(self, prep, dataset) -> list:
        scheme = prep["scheme"]
        device = prep["device"]
        pixels = int(np.prod(prep["meta"].sig_shape))
        feed = HostFeed(
            (scheme.depth, pixels), dataset.meta.native_dtype, device,
        )
        state = self._init_state(prep)
        part_state = None
        current = None
        fused = prep["fused"] is not None
        with contextlib.closing(
            feed.run(prep["partitions"], scheme, prep["roi"])
        ) as blocks:
            for pi, block_t, block in blocks:
                if pi != current:
                    if part_state is not None:
                        self._merge(prep, state, part_state)
                    part_state = self._init_part_state(prep)
                    current = pi
                if fused:
                    self._fused_step(
                        prep, state, part_state, block_t,
                        block.global_offset, block.valid,
                    )
                else:
                    coords = torch.from_numpy(block.coords).to(device)
                    self._generic_step(
                        prep, state, part_state, block_t,
                        block.global_offset, coords, block.valid,
                    )
        if part_state is not None:
            self._merge(prep, state, part_state)
        self.feed_stats = feed.stats
        return state

    # -- results -----------------------------------------------------------

    def _wrap_results(self, prep, state) -> UDFResults:
        """Device state -> host numpy -> ``get_results`` -> one dict of
        BufferWrappers per UDF."""
        meta = prep["meta"]
        n_nav = prep["n_nav"]
        damage_host = np.ones(n_nav, dtype=bool)
        buffers = []
        for ui, entry in enumerate(prep["plan"]):
            raw = {
                n: state[ui][n][:n_nav].cpu().numpy()
                for n in entry.nav_names
            }
            raw.update({
                n: state[ui][n].cpu().numpy() for n in entry.part_names
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
        derived = udf.get_results() or {}
        for name in derived:
            if name not in entry.decls:
                raise KeyError(
                    f"get_results returned {name!r} which is not "
                    f"declared in get_result_buffers"
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
            elif decl.use == "result_only":
                continue
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
