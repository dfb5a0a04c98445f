"""Result-buffer declarations and containers (counterpart of
``libertem_tpu/common/buffers.py``).

``BufferWrapper`` is two things:

1. a *declaration* (kind / extra_shape / dtype / use) from which the
   runner allocates the run's state tensors on the device, and
2. after a run, a *container* for the final host-side result:
   ``.data`` (nav buffers in the full nav shape; with a roi, the
   positions outside it hold nan for floats, 0 for integers),
   ``.raw_data`` (the storage layout: flat nav, roi-compressed),
   ``.valid_mask`` and ``.masked_data``.

Kinds: ``'nav'`` one entry per scan position, ``'sig'`` one per
detector pixel, ``'single'`` one entry (plus ``extra_shape``).
Uses: ``None`` regular, ``'private'`` not part of the final results,
``'result_only'`` produced only by ``UDF.get_results``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np

from .math import prod
from .shape import Shape

KINDS = ("nav", "sig", "single")
USES = (None, "private", "result_only")


class BufferWrapper:
    def __init__(
        self,
        kind: str,
        extra_shape: Sequence[int] = (),
        dtype="float32",
        where: Optional[str] = None,
        use: Optional[str] = None,
    ):
        if kind not in KINDS:
            raise ValueError(f"unknown buffer kind {kind!r}")
        if use not in USES:
            raise ValueError(f"unknown buffer use {use!r}")
        self._kind = kind
        self._extra_shape = tuple(int(s) for s in extra_shape)
        self._dtype = np.dtype(dtype)
        self._where = where
        self._use = use
        self._ds_shape: Optional[Shape] = None
        self._roi: Optional[np.ndarray] = None
        self._roi_count: Optional[int] = None
        self._data: Optional[np.ndarray] = None
        self._full_data: Optional[np.ndarray] = None
        self._valid_nav_mask: Optional[np.ndarray] = None
        self._custom_mask: Optional[np.ndarray] = None

    @property
    def kind(self) -> str:
        return self._kind

    @property
    def extra_shape(self) -> tuple[int, ...]:
        return self._extra_shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def where(self) -> Optional[str]:
        return self._where

    @property
    def use(self) -> Optional[str]:
        return self._use

    def replace_dtype(self, dtype) -> None:
        self._dtype = np.dtype(dtype)

    def set_shape_ds(self, ds_shape: Shape,
                     roi: Optional[np.ndarray] = None) -> None:
        """Bind to a dataset shape and the run's roi (flat bool over
        nav, or None for every position)."""
        self._ds_shape = ds_shape
        if roi is not None:
            roi = np.asarray(roi).reshape(-1).astype(bool)
            self._roi_count = int(np.count_nonzero(roi))
        self._roi = roi

    @property
    def roi(self) -> Optional[np.ndarray]:
        """The bound roi, flat, or None."""
        return self._roi

    @property
    def shape(self) -> tuple[int, ...]:
        """The storage shape (roi-compressed flat nav for 'nav')."""
        if self._ds_shape is None:
            raise RuntimeError("buffer not bound to a dataset shape yet")
        if self._kind == "nav":
            n = (
                self._roi_count if self._roi is not None
                else self._ds_shape.nav.size
            )
            return (n,) + self._extra_shape
        if self._kind == "sig":
            return tuple(self._ds_shape.sig) + self._extra_shape
        # a 'single' buffer with no extra_shape is (1,), never 0-d
        return self._extra_shape if self._extra_shape else (1,)

    @property
    def size(self) -> int:
        return prod(self.shape)

    def set_result(
        self,
        data: np.ndarray,
        valid_nav_mask: Optional[np.ndarray] = None,
        custom_mask: Optional[np.ndarray] = None,
        full_data: Optional[np.ndarray] = None,
    ) -> None:
        """Install the final host result; ``valid_nav_mask`` is the
        roi-compressed flat-nav damage mask, ``custom_mask`` (from
        ``UDF.with_mask``) overrides the default validity of this
        buffer, and ``full_data`` (nav buffers only) is a full-nav
        array that ``get_results`` produced itself, kept verbatim as
        ``.data``."""
        self._data = np.asarray(data)
        self._valid_nav_mask = valid_nav_mask
        self._custom_mask = custom_mask
        self._full_data = (
            None if full_data is None else np.asarray(full_data)
        )

    @property
    def raw_data(self) -> Optional[np.ndarray]:
        return self._data

    @property
    def data(self) -> Optional[np.ndarray]:
        if self._full_data is not None:
            return self._full_data
        if self._data is None or self._kind != "nav":
            return self._data
        nav_shape = tuple(self._ds_shape.nav)
        if self._roi is None:
            return self._data.reshape(nav_shape + self._extra_shape)
        # keep the stored dtype where get_results widened it
        out_dtype = np.result_type(self._data.dtype, self._dtype)
        full = np.full(
            (self._ds_shape.nav.size,) + self._extra_shape,
            _fill_value(out_dtype), dtype=out_dtype,
        )
        full[self._roi] = self._data
        return full.reshape(nav_shape + self._extra_shape)

    @property
    def valid_mask(self) -> Optional[np.ndarray]:
        if self._data is None:
            return None
        if self._custom_mask is not None:
            return np.broadcast_to(
                np.asarray(self._custom_mask, dtype=bool),
                self.data.shape,
            )
        if self._kind == "nav":
            nav_shape = tuple(self._ds_shape.nav)
            vm = (
                np.ones(self.shape[0], dtype=bool)
                if self._valid_nav_mask is None
                else np.asarray(self._valid_nav_mask, dtype=bool)
            )
            full = np.zeros(self._ds_shape.nav.size, dtype=bool)
            if self._roi is None:
                full[:] = vm
            else:
                full[self._roi] = vm
            return np.broadcast_to(
                full.reshape(nav_shape + (1,) * len(self._extra_shape)),
                nav_shape + self._extra_shape,
            )
        any_valid = (
            True if self._valid_nav_mask is None
            else bool(np.any(self._valid_nav_mask))
        )
        return np.full(self.data.shape, any_valid, dtype=bool)

    @property
    def masked_data(self) -> Optional[np.ma.MaskedArray]:
        if self._data is None:
            return None
        return np.ma.MaskedArray(self.data, mask=~self.valid_mask)

    @property
    def _valid_mask(self) -> Optional[np.ndarray]:
        """The validity of ``raw_data``, in its storage shape."""
        m = self.raw_masked_data
        return None if m is None else ~np.asarray(m.mask)

    @property
    def raw_masked_data(self) -> Optional[np.ma.MaskedArray]:
        """``raw_data`` masked to its valid entries (the roi-compressed
        flat-nav mask, not the nav-shaped one)."""
        if self._data is None:
            return None
        if self._custom_mask is not None:
            full = np.broadcast_to(
                np.asarray(self._custom_mask, dtype=bool), self.data.shape
            )
            if self._kind == "nav":
                flat = full.reshape(
                    (self._ds_shape.nav.size,) + self._extra_shape
                )
                mask = flat[self._roi] if self._roi is not None else flat
            else:
                mask = full
        elif self._kind == "nav":
            vm = (
                np.ones(self.shape[0], dtype=bool)
                if self._valid_nav_mask is None
                else np.asarray(self._valid_nav_mask, dtype=bool)
            )
            mask = np.broadcast_to(
                vm.reshape((-1,) + (1,) * len(self._extra_shape)),
                self._data.shape,
            )
        else:
            any_valid = (
                True if self._valid_nav_mask is None
                else bool(np.any(self._valid_nav_mask))
            )
            mask = np.full(self._data.shape, any_valid, dtype=bool)
        return np.ma.MaskedArray(self._data, mask=~mask)

    def make_default_mask(self, valid_nav_mask: np.ndarray,
                          dataset_shape: Shape,
                          roi: Optional[np.ndarray] = None) -> np.ndarray:
        """The storage-shaped validity of this kind of buffer for a
        flat-nav ``valid_nav_mask`` (roi-compressed with a roi): nav
        buffers broadcast it over ``extra_shape``, sig and single
        buffers are valid everywhere."""
        valid_nav_mask = np.asarray(valid_nav_mask, dtype=bool)
        if self._kind == "nav":
            n = (int(np.count_nonzero(roi)) if roi is not None
                 else dataset_shape.nav.size)
            mask = np.zeros((n,) + self._extra_shape, dtype=bool)
            mask[:] = valid_nav_mask.reshape(
                valid_nav_mask.shape + (1,) * len(self._extra_shape)
            )
            return mask
        if self._kind == "sig":
            return np.ones(tuple(dataset_shape.sig) + self._extra_shape,
                           dtype=bool)
        return np.ones(self._extra_shape, dtype=bool)

    @property
    def valid_slice_bounding(self) -> tuple:
        """The smallest slice tuple of ``data`` that holds every valid
        entry (it may hold invalid ones too)."""
        return get_bbox_slice(self.valid_mask)

    def get_valid_slice_inner(self, axis: int = 0) -> tuple:
        """The first run along ``axis`` over which every entry of the
        other axes is valid, as a slice tuple of ``data``."""
        return get_inner_slice(self.valid_mask, axis=axis)

    def __array__(self, dtype=None, copy=None):
        arr = self.data
        if dtype is not None:
            arr = np.asarray(arr, dtype=dtype)
        return np.array(arr, copy=True) if copy else np.asarray(arr)

    def __repr__(self) -> str:
        return (
            f"<BufferWrapper kind={self._kind} extra_shape="
            f"{self._extra_shape} dtype={self._dtype} use={self._use}>"
        )


def _fill_value(dtype: np.dtype):
    """What ``.data`` holds outside the roi: nan for floats, False
    for bools, 0 otherwise."""
    if dtype.kind in "fc":
        return np.nan
    if dtype.kind == "b":
        return False
    return 0


class InvalidMaskError(Exception):
    """A mask that does not fit its array (not bool, or of a shape
    that does not broadcast to the array's)."""


def get_bbox_slice(arr: np.ndarray) -> tuple:
    """The smallest slice tuple that holds every truthy entry of
    ``arr`` (``slice(0, 0)`` on an axis without one)."""
    arr = np.asarray(arr)
    out = []
    for ax in range(arr.ndim):
        other = tuple(i for i in range(arr.ndim) if i != ax)
        nz = np.flatnonzero(arr.any(axis=other))
        out.append(slice(int(nz[0]), int(nz[-1]) + 1) if len(nz)
                   else slice(0, 0))
    return tuple(out)


def get_bbox(arr: np.ndarray) -> tuple:
    """``(min0, max0, min1, max1, ...)``: the inclusive bounds of the
    truthy entries of ``arr``."""
    out = []
    for sl in get_bbox_slice(arr):
        out.extend((sl.start, max(sl.start, sl.stop - 1)))
    return tuple(out)


def get_inner_slice(arr: np.ndarray, axis: int = 0) -> tuple:
    """The first run along ``axis`` over which every entry of the
    other axes is truthy, as a slice tuple of ``arr``."""
    arr = np.asarray(arr)
    other = tuple(i for i in range(arr.ndim) if i != axis)
    nz = np.flatnonzero((arr != 0).all(axis=other))
    if len(nz) == 0:
        lo = hi = 0
    else:
        lo = int(nz[0])
        breaks = np.flatnonzero(np.diff(nz) != 1)
        hi = int(nz[breaks[0]] if len(breaks) else nz[-1]) + 1
    return tuple(slice(lo, hi) if d == axis else slice(None)
                 for d in range(arr.ndim))


class ArrayWithMask:
    """A result array bundled with an explicit validity mask, returned
    from ``UDF.get_results`` via ``UDF.with_mask``.  The mask is bool
    (a Python bool stands for every entry) and broadcasts to the
    array's shape, else :class:`InvalidMaskError`."""

    def __init__(self, arr, mask):
        if isinstance(mask, bool):
            mask = np.array([mask])
        mask = np.asarray(mask)
        arr = np.asarray(arr)
        if mask.dtype != np.dtype(bool):
            raise InvalidMaskError(
                f"mask should have dtype=bool (have {mask.dtype})")
        try:
            self.mask = np.broadcast_to(mask, arr.shape)
        except ValueError:
            raise InvalidMaskError(
                "arr and mask must have compatible shapes "
                f"(arr.shape={arr.shape} vs mask.shape={mask.shape})"
            ) from None
        self.arr = arr

    def __array__(self, dtype=None, copy=None):
        return self.arr.astype(dtype) if dtype is not None else self.arr


class AuxBufferWrapper(BufferWrapper):
    """Per-frame auxiliary *input* data of a UDF, declared with
    :meth:`UDF.aux_data` and passed as a constructor argument: the
    runner hands out the rows of the frames being processed as
    ``self.params.<name>`` (a tensor on the device engine, a numpy
    array on the host engine).  ``data`` holds one row per nav
    position of the whole dataset (flat nav, plus ``extra_shape``)."""

    def __init__(self, kind, extra_shape=(), dtype="float32", data=None):
        super().__init__(kind, extra_shape, dtype)
        self._aux_data: Optional[np.ndarray] = None
        if data is not None:
            self.set_buffer(data)

    def set_buffer(self, data) -> None:
        data = np.ascontiguousarray(data, dtype=self._dtype)
        self._aux_data = data.reshape((-1,) + self._extra_shape)
        self._data = self._aux_data

    @property
    def aux_data(self) -> Optional[np.ndarray]:
        return self._aux_data

    @property
    def raw_data(self) -> Optional[np.ndarray]:
        """The rows of the bound roi's frames (all rows without one)."""
        if self._aux_data is None or self._roi is None:
            return self._aux_data
        return self._aux_data[self._roi]

    @property
    def data(self) -> Optional[np.ndarray]:
        if self._aux_data is None or self._ds_shape is None:
            return self._aux_data
        prev = self._data
        self._data = self.raw_data
        try:
            return super().data
        finally:
            self._data = prev

    def new_for_partition(self, partition, roi=None) -> "AuxBufferWrapper":
        """The rows of ``partition``'s nav window, roi-compressed with
        ``roi`` (a bool array over the dataset's nav)."""
        new = AuxBufferWrapper(self._kind, self._extra_shape, self._dtype)
        ps = partition.slice.get(nav_only=True)
        data = self._aux_data[ps]
        if roi is not None:
            data = data[np.asarray(roi).reshape(-1)[ps]]
        new._aux_data = new._data = data
        return new


class PlaceholderBufferWrapper(BufferWrapper):
    """A buffer that only exists as a ``get_results`` output
    (``use='result_only'``); the run allocates no state for it."""

    def __init__(self, kind, extra_shape=(), dtype="float32"):
        super().__init__(kind, extra_shape, dtype, use="result_only")

    def __array__(self, dtype=None, copy=None):
        if self._data is None:
            raise ValueError(
                "this BufferWrapper has no array associated with it "
                "(use='result_only' placeholders are filled by "
                "get_results)"
            )
        return super().__array__(dtype, copy)


class PreallocBufferWrapper(BufferWrapper):
    """A BufferWrapper over data that its caller allocated."""

    def __init__(self, data, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._data = data


def reshaped_view(a: np.ndarray, shape) -> np.ndarray:
    """A reshaped view of ``a``; raises AttributeError where
    ``np.reshape`` would copy."""
    v = a.view()
    v.shape = shape
    return v


# Page-aligned host buffers, for O_DIRECT reads of user IO code (the
# engine's own reads go through ``io.dataset.base.RangeReader``).

def _alloc_aligned(size: int, blocksize: int = 4096):
    import mmap

    blocks = -(-max(1, int(size)) // blocksize)
    return mmap.mmap(-1, blocksize * blocks)


def bytes_aligned(size: int) -> memoryview:
    """A page-aligned writable buffer of exactly ``size`` bytes."""
    return memoryview(_alloc_aligned(size))[:size]


def empty_aligned(size, dtype) -> np.ndarray:
    """``np.empty``, page-aligned."""
    dtype = np.dtype(dtype)
    n = prod(size)
    return np.frombuffer(_alloc_aligned(dtype.itemsize * n),
                         dtype=dtype)[:n].reshape(size)


def zeros_aligned(size, dtype) -> np.ndarray:
    """``np.zeros``, page-aligned."""
    if np.dtype(dtype) == object or prod(size) == 0:
        return np.zeros(size, dtype=dtype)
    res = empty_aligned(size, dtype)
    res[:] = 0
    return res


def to_numpy(a) -> np.ndarray:
    """``a`` as a host ndarray: numpy passes through, a torch tensor is
    copied to the host; anything else is a TypeError."""
    if isinstance(a, np.ndarray):
        return a
    import torch
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    raise TypeError(f"I don't know how to convert {type(a)} here.")


def disjoint(sl, slices) -> bool:
    """True when the Slice ``sl`` intersects none of ``slices``."""
    return all(sl.intersection_with(s2).is_null() for s2 in slices)


def get_bbox_2d(arr, eps: float = 1e-8) -> tuple:
    """``(ymin, ymax, xmin, xmax)`` of the entries with
    ``|value| >= eps``; ``(rows, 0, cols, 0)`` when there is none."""
    arr = np.asarray(arr)
    ys, xs = np.nonzero(np.abs(arr) >= eps)
    if ys.size == 0:
        return arr.shape[0], 0, arr.shape[1], 0
    return int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max())


class BufferPool:
    """A free list of aligned allocations, by (size, alignment)."""

    def __init__(self):
        import collections

        self._buffers = collections.defaultdict(list)

    def checkout_bytes(self, size, alignment):
        free = self._buffers[(size, alignment)]
        return free.pop() if free else _alloc_aligned(size, alignment)

    def checkin_bytes(self, size, alignment, buf):
        self._buffers[(size, alignment)].append(buf)

    @contextlib.contextmanager
    def bytes(self, size, alignment=4096):
        buf = self.checkout_bytes(size, alignment)
        try:
            yield buf
        finally:
            self.checkin_bytes(size, alignment, buf)

    @contextlib.contextmanager
    def empty(self, size, dtype, alignment=4096):
        dtype = np.dtype(dtype)
        n = prod(size)
        with self.bytes(dtype.itemsize * n, alignment) as buf:
            yield np.frombuffer(buf, dtype=dtype)[:n].reshape(size)

    @contextlib.contextmanager
    def zeros(self, size, dtype, alignment=4096):
        if np.dtype(dtype) == object or prod(size) == 0:
            yield np.zeros(size, dtype=dtype)
            return
        with self.empty(size, dtype, alignment) as res:
            res[:] = 0
            yield res


class ManagedBuffer:
    """``size`` bytes checked out of ``pool``, checked back in when the
    object is collected."""

    def __init__(self, pool, size, alignment):
        self.pool = pool
        self.buf = pool.checkout_bytes(size, alignment)
        self.size = size
        self.alignment = alignment

    def __del__(self):
        self.pool.checkin_bytes(self.size, self.alignment, self.buf)
