"""UDF contract and the runner of the fused path (counterpart of
``libertem_tpu/udf/base.py``).

A run streams the dataset as fixed-depth, zero-padded ``(depth,
pixels)`` blocks of raw-dtype frames.  When every UDF of the set
declares a ``fused_moments_spec`` (ApplyMasks, CoM, Sum, SumSig,
StdDev), the whole pass is one fused moments op per block
(:func:`libertem_tpu_torch.ops.moments.fused_moments`), and its three
outputs are distributed into each UDF's state:

* ``kind='nav'`` buffers live in one state tensor each on the device;
  a block adds its projections to its own rows, in place.
* ``kind='sig'|'single'`` buffers accumulate per partition, starting
  from zeros; at the end of the partition ``UDF.merge`` folds them
  into the run's state.

Results come back to the host once, at the end, where
``UDF.get_results`` post-processes them with numpy.

Not ported yet: UDF sets with no fused spec (the generic
``process_tile``/``process_frame`` path), rois, corrections, partial
results and the sharded loop.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..common.buffers import ArrayWithMask, BufferWrapper
from ..common.shape import Shape
from ..io.dataset.base import DataSet, Partition
from ..io.tiling import Negotiator, TilingScheme
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


class UDFMeta:
    """What a UDF sees of the run as ``self.meta``."""

    def __init__(self, dataset_shape: Shape, dataset_dtype, input_dtype):
        self.dataset_shape = dataset_shape
        self.dataset_dtype = np.dtype(dataset_dtype)
        self.input_dtype = np.dtype(input_dtype)

    @property
    def sig_shape(self) -> tuple:
        return tuple(self.dataset_shape.sig)


class UDF:
    """Base class of user-defined functions: declare result buffers in
    ``get_result_buffers`` and, to run on the fused path, the part of
    the fused pass the UDF consumes in ``fused_moments_spec``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self.params = UDFParams(kwargs)
        self.results: Optional[UDFData] = None
        self.meta: Optional[UDFMeta] = None

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

    def requires_custom_merge(self, decls: dict) -> bool:
        return any(
            b.kind != "nav" for b in decls.values()
            if b.use != "result_only"
        )


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


def _state_dtype(dtype) -> torch.dtype:
    """Device state dtype of a declared buffer: 64-bit floats run in
    32 bits on the device, as in the JAX package; the result is cast
    back to the declared dtype on the host."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        dtype = np.dtype(np.float32)
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _UDFPlanEntry:
    """Per-UDF static plan: declarations split by residency."""

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


@dataclass
class FusedPlan:
    """The cross-UDF fused pass: one mask stack for all projections and
    where each UDF's share of the outputs goes.

    masks_t: (M, pixels) float32; rows of each ``masks`` spec at its
             ``off``, and a ones row for ``sumsig``
    specs:   one dict per UDF: ``ui`` (index in the UDF list),
             ``mode`` (masks | sumsig | colsum | stats) and, by mode,
             ``name``, ``off``, ``n``
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

    def run(self, partitions: Sequence[Partition], scheme: TilingScheme):
        """Yield ``(partition index, device block, Block)`` for every
        block of every partition, in order."""
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
                    blocks = part.gen_blocks(scheme, out=acquire)
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
    """Runs a set of UDFs over a dataset in one fused pass."""

    def __init__(self, udfs: Sequence[UDF]):
        self._udfs = list(udfs)
        self.feed_stats: Optional[dict] = None

    def run_for_dataset(self, dataset: DataSet,
                        device: torch.device) -> UDFResults:
        prep = self._prepare(dataset, device)
        state = self._run_loop(prep, dataset)
        return self._wrap_results(prep, state)

    # -- preparation ---------------------------------------------------

    def _prepare(self, dataset: DataSet, device: torch.device) -> dict:
        udfs = self._udfs
        meta0 = dataset.meta
        input_dtype = _get_input_dtype(udfs, meta0.native_dtype)
        if input_dtype.kind == "c":
            raise NotImplementedError("complex data is not ported yet")
        # the device computes in float32, as the JAX package does
        if input_dtype == np.float64:
            input_dtype = np.dtype(np.float32)
        partitions = list(dataset.get_partitions())
        meta = UDFMeta(
            dataset_shape=meta0.shape,
            dataset_dtype=meta0.native_dtype,
            input_dtype=input_dtype,
        )
        scheme = Negotiator().get_scheme(
            meta0.shape, input_dtype,
            max_partition_frames=max(
                (p.num_frames for p in partitions), default=1
            ),
        )
        plan = []
        for udf in udfs:
            udf.meta = meta
            decls = dict(udf.get_result_buffers())
            for b in decls.values():
                b.set_shape_ds(meta0.shape)
            if (udf.requires_custom_merge(decls)
                    and type(udf).merge is UDF.merge):
                raise NotImplementedError(
                    f"{type(udf).__name__} declares non-nav buffers "
                    f"and must implement merge()"
                )
            plan.append(_UDFPlanEntry(udf, decls))
        fused = self._build_fused_plan(plan, meta)
        if fused is None:
            raise NotImplementedError(
                "generic path not yet ported: every UDF of the set "
                "must join the fused pass (ApplyMasksUDF, CoMUDF, "
                "SumUDF, SumSigUDF, StdDevUDF with float32 results)"
            )
        return {
            "fused": fused,
            "masks_t": torch.from_numpy(fused.masks_t).to(device),
            "meta": meta,
            "plan": plan,
            "scheme": scheme,
            "partitions": partitions,
            "n_nav": meta0.shape.nav.size,
            "device": device,
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
        return [
            {
                n: self._zeros(prep, e.decls[n], e.decls[n].shape)
                for n in e.nav_names + e.part_names
            }
            for e in prep["plan"]
        ]

    def _init_part_state(self, prep) -> list:
        return [
            {
                n: self._zeros(prep, e.decls[n], e.decls[n].shape)
                for n in e.part_names
            }
            for e in prep["plan"]
        ]

    # -- the step ----------------------------------------------------------

    def _fused_step(self, prep, state, part_state, block, goff: int,
                    valid: int) -> None:
        """One fused op on a block, then each UDF's share of its
        outputs into the state.  Updates the state tensors in place:
        nav rows of different blocks never overlap, and the per-
        partition sums are private to this run."""
        from .stddev import _combine

        fused: FusedPlan = prep["fused"]
        sig_shape = tuple(prep["meta"].dataset_shape.sig)
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
                    state[ui][n] = dest._get(n).to(state[ui][n].dtype)

    # -- main loop -------------------------------------------------------

    def _run_loop(self, prep, dataset) -> list:
        scheme = prep["scheme"]
        pixels = int(np.prod(prep["meta"].sig_shape))
        feed = HostFeed(
            (scheme.depth, pixels), dataset.meta.native_dtype,
            prep["device"],
        )
        state = self._init_state(prep)
        part_state = None
        current = None
        with contextlib.closing(
            feed.run(prep["partitions"], scheme)
        ) as blocks:
            for pi, block_t, block in blocks:
                if pi != current:
                    if part_state is not None:
                        self._merge(prep, state, part_state)
                    part_state = self._init_part_state(prep)
                    current = pi
                self._fused_step(
                    prep, state, part_state, block_t,
                    block.global_offset, block.valid,
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
        damage_host = np.ones(prep["n_nav"], dtype=bool)
        buffers = []
        for ui, entry in enumerate(prep["plan"]):
            raw = {n: t.cpu().numpy() for n, t in state[ui].items()}
            buffers.append(self._wrap_one(entry, raw, damage_host, meta))
        damage = BufferWrapper("nav", (), bool)
        damage.set_shape_ds(meta.dataset_shape)
        damage.set_result(damage_host, valid_nav_mask=damage_host)
        return UDFResults(buffers=buffers, damage=damage)

    @staticmethod
    def _wrap_one(entry, raw, damage_host, meta) -> dict:
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
        buffers = {}
        for name, decl in entry.decls.items():
            if decl.use == "private":
                continue
            custom_mask = None
            if name in derived:
                data = derived[name]
                if isinstance(data, ArrayWithMask):
                    custom_mask = data.mask
                    data = data.arr
            elif decl.use == "result_only":
                continue
            else:
                data = raw[name].astype(decl.dtype, copy=False)
            out = BufferWrapper(decl.kind, decl.extra_shape, decl.dtype)
            out.set_shape_ds(meta.dataset_shape)
            out.set_result(
                np.asarray(data), valid_nav_mask=damage_host,
                custom_mask=custom_mask,
            )
            buffers[name] = out
        return buffers
