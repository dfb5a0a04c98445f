"""ApplyMasksUDF: virtual detectors as projections on a mask stack
(counterpart of ``libertem_tpu/udf/masks.py``).

The mask factories are evaluated once into a dense ``(n_masks, *sig)``
stack (scipy.sparse and other ``.todense()`` output is densified).  On
the fused path its flattened rows join the fused pass's mask operand;
on the generic path each tile is projected on it with a float32 matmul
(``torch.matmul``, full fp32: the runner keeps TF32 off), on the
stack's support blocks when its union support is small enough for
compaction to pay on the run's device (``ops/sparse_masks.py``).
Complex masks project real tiles with one real matmul on the stacked
[Re | Im] operand, complex tiles with a complex64 matmul.  Per-frame
``shifts`` (aux data or a constant ``(dy, dx)``) move each frame by
(-dy, -dx) before the projection, the pixels shifted in from outside
the frame being zero.  Explicit 64-bit
requests run on the host engine in numpy, in 64 bits.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..common.sparse import is_sparse, to_dense
from ..ops.sparse_masks import (
    compaction_pays,
    gather_blocks,
    plan_compaction,
)
from .base import UDF


class TileOperand:
    """The columns of a (n, *sig) mask stack under the current sig
    tile, as a (pixels of the tile, n) tensor of the given dtype on the
    run's device: the generic path's matmul operand, made once per
    tile, dtype and device."""

    def __init__(self):
        self._key = None
        self._op = None

    def get(self, make_stack, meta, dtype=np.float32) -> torch.Tensor:
        sl = meta.sig_slice
        key = (meta.sig_shape, sl.origin, tuple(sl.shape), str(meta.device),
               np.dtype(dtype))
        if key != self._key:
            sub = make_stack()[(slice(None),) + sl.get()]
            self._op = torch.from_numpy(np.ascontiguousarray(
                sub.reshape(sub.shape[0], -1).T, dtype=dtype
            )).to(meta.device)
            self._key = key
        return self._op


class MaskContainer:
    """Evaluates mask factories once into a dense stack.

    ``use_sparse`` (True, False, ``"scipy.sparse..."``,
    ``"sparse.pydata..."`` or None: sparse when every factory returns a
    sparse mask) is the declared sparse policy; the computation is
    dense or block-compacted either way (:meth:`get_compaction`)."""

    def __init__(
        self,
        mask_factories: Union[Callable, Sequence[Callable]],
        dtype=None,
        use_sparse=None,
        count: Optional[int] = None,
    ):
        self._factories = mask_factories
        self._dtype = dtype
        self._count = count
        self._stack: Optional[np.ndarray] = None  # (n_masks, *sig)
        self._all_sparse_factories = False
        self._compactions: dict = {}
        if use_sparse is True:
            self._use_sparse = "scipy.sparse"
        elif use_sparse is False or use_sparse is None:
            self._use_sparse = use_sparse
        elif isinstance(use_sparse, str) and use_sparse.lower().startswith(
                ("scipy.sparse", "sparse.pydata")):
            self._use_sparse = use_sparse
        else:
            raise ValueError(f"use_sparse not an allowed value: {use_sparse}")

    @property
    def use_sparse(self):
        if self._use_sparse is None:
            self.compute_stack(None)
            self._use_sparse = (
                "scipy.sparse" if self._all_sparse_factories else False
            )
        return self._use_sparse

    def compute_stack(self, sig_shape) -> np.ndarray:
        if self._stack is not None:
            return self._stack
        if callable(self._factories):
            raw = self._factories()
            if isinstance(raw, (list, tuple)):
                self._all_sparse_factories = all(is_sparse(m) for m in raw)
                masks = [to_dense(m) for m in raw]
            else:
                self._all_sparse_factories = is_sparse(raw)
                raw = to_dense(raw)
                if sig_shape is not None and raw.ndim == len(sig_shape):
                    masks = [raw]
                elif sig_shape is None and raw.ndim <= 2:
                    masks = [raw]
                else:
                    masks = list(raw)
        else:
            raws = [f() for f in self._factories]
            self._all_sparse_factories = all(is_sparse(m) for m in raws)
            masks = [to_dense(m) for m in raws]
        stack = np.stack(masks, axis=0)
        if sig_shape is not None and stack.shape[1:] != tuple(sig_shape):
            raise ValueError(
                f"mask shape {stack.shape[1:]} != sig {tuple(sig_shape)}"
            )
        if self._dtype is not None:
            stack = stack.astype(self._dtype)
        if self._count is not None and stack.shape[0] != self._count:
            raise ValueError(
                f"mask_count={self._count} but the factories "
                f"produced {stack.shape[0]} masks"
            )
        self._stack = stack
        return stack

    @property
    def n_masks(self) -> int:
        if self._count is not None:
            return self._count
        if self._stack is not None:
            return self._stack.shape[0]
        if not callable(self._factories):
            return len(self._factories)
        raise ValueError(
            "mask_count must be given for a single bulk factory"
        )

    def dtype_for(self, input_dtype, sig_shape=None) -> np.dtype:
        """Result dtype of projecting ``input_dtype`` data on the
        stack: complex masks give complex results, float64 factory
        output gives float64."""
        if self._stack is None and self._dtype is None \
                and sig_shape is not None:
            self.compute_stack(sig_shape)
        if self._stack is not None:
            mdt = self._stack.dtype
        elif self._dtype is not None:
            mdt = np.dtype(self._dtype)
        else:
            mdt = np.dtype(np.float32)
        return np.result_type(mdt, input_dtype)

    def get_compaction(self, sig_shape, dtype) -> Optional[dict]:
        """The block-compaction plan of the whole-sig stack in
        ``dtype`` (complex stacks in complex64), or None when its union
        support is too dense to pay off."""
        key = np.dtype(dtype)
        if key not in self._compactions:
            stack = self.compute_stack(sig_shape)
            flat = stack.reshape(stack.shape[0], -1)
            if np.iscomplexobj(flat):
                plan = plan_compaction(flat.astype(np.complex64))
            else:
                plan = plan_compaction(flat.astype(dtype))
            self._compactions[key] = plan
        return self._compactions[key]


class ApplyMasksUDF(UDF):
    """Apply a stack of masks to each frame: the virtual-detector UDF.

    ``mask_factories`` is a callable or a list of callables, each
    returning a (*sig) mask (dense, scipy.sparse, or anything with
    ``.todense()``); ``mask_count`` and ``mask_dtype`` fix the stack's
    length and dtype; ``dtype`` (or ``preferred_dtype``) is the
    preferred input dtype; ``use_sparse`` the declared sparse policy
    (see :class:`MaskContainer`); ``backends`` restricts the engines;
    ``shifts`` per-frame integer ``(dy, dx)`` mask shifts, as aux data
    (``UDF.aux_data(..., kind="nav", extra_shape=(2,))``) or one
    constant vector.  ``use_torch`` is accepted and ignored.
    """

    def __init__(
        self,
        mask_factories=None,
        use_torch=None,
        use_sparse=None,
        mask_count=None,
        mask_dtype=None,
        preferred_dtype=None,
        backends=None,
        dtype=None,
        shifts=None,
        **kwargs,
    ):
        if mask_factories is None:
            raise ValueError("mask_factories is required")
        if preferred_dtype is not None and dtype is None:
            dtype = preferred_dtype
        if shifts is not None and isinstance(use_sparse, str) and \
                use_sparse.lower().startswith("scipy.sparse"):
            raise ValueError(
                "use_sparse='scipy.sparse' is not supported together "
                "with shifts; use 'sparse.pydata' or dense masks"
            )
        if backends is not None:
            if isinstance(backends, str):
                backends = (backends,)
            bad = set(backends) - set(UDF.BACKEND_ALL)
            if bad:
                raise ValueError(
                    f"unknown backends {sorted(bad)}; valid: "
                    f"{sorted(UDF.BACKEND_ALL)}"
                )
        super().__init__(
            mask_factories=mask_factories, use_sparse=use_sparse,
            mask_count=mask_count, mask_dtype=mask_dtype, dtype=dtype,
            shifts=shifts, **kwargs,
        )
        if backends is not None:
            self._backend_restriction = tuple(backends)
        self.on_params_updated()

    @property
    def masks(self) -> MaskContainer:
        return self._container

    def on_params_updated(self):
        self._container = MaskContainer(
            self._kwargs["mask_factories"],
            dtype=self._kwargs.get("mask_dtype"),
            count=self._kwargs.get("mask_count"),
            use_sparse=self._kwargs.get("use_sparse"),
        )
        self._operand = TileOperand()
        self._compact_op = None

    def get_preferred_input_dtype(self):
        if self._kwargs.get("dtype") is not None:
            return np.dtype(self._kwargs["dtype"])
        return np.float32

    def get_tiling_preferences(self):
        prefs = super().get_tiling_preferences()
        if self._kwargs.get("shifts") is not None:
            # a shift moves pixels across the whole frame
            prefs = dict(prefs, whole_frames=True)
        return prefs

    def _declared_input(self) -> np.dtype:
        """The result_type of the preference and the dataset dtype: the
        result follows it, not the device's narrower compute dtype."""
        return np.result_type(
            self.get_preferred_input_dtype(), self.meta.dataset_dtype
        )

    def get_result_buffers(self):
        return {
            "intensity": self.buffer(
                kind="nav",
                extra_shape=(self._container.n_masks,),
                dtype=self._container.dtype_for(
                    self._declared_input(), self.meta.sig_shape
                ),
            ),
        }

    def _wants_64bit(self) -> bool:
        """An explicit 64-bit request: a ``mask_dtype`` or ``dtype`` of
        float64/complex128, or 64-bit data.  Implicit float64 factory
        output (numpy's default) is no such request: it runs on the
        device in 32 bits."""
        dtypes = [self._kwargs.get(k) for k in ("mask_dtype", "dtype")]
        meta = getattr(self, "meta", None)
        if meta is not None and meta.dataset_dtype is not None:
            dtypes.append(meta.dataset_dtype)
        return any(
            d is not None and np.dtype(d).kind in "fc"
            and np.dtype(d).itemsize >= (8 if np.dtype(d).kind == "f"
                                         else 16)
            for d in dtypes
        )

    def get_backends(self):
        if getattr(self, "_backend_restriction", None) is not None:
            # an explicit choice overrides the 64-bit routing
            return tuple(self._backend_restriction)
        if self._wants_64bit():
            return (self.BACKEND_NUMPY,)
        return (self.BACKEND_TORCH,)

    def _operand_dtype(self) -> np.dtype:
        """The device operand's dtype: 64-bit clamped to 32."""
        mdt = self._container.dtype_for(self.meta.input_dtype)
        if mdt == np.complex128:
            return np.dtype(np.complex64)
        if mdt == np.float64:
            return np.dtype(np.float32)
        return mdt

    def _process_tile_host(self, tile):
        """Host engine (numpy): 64-bit accumulation for explicit
        64-bit requests."""
        shifts = self.params.get("shifts")
        if shifts is not None:
            tile = self._shift_tile(
                torch.from_numpy(np.ascontiguousarray(tile)), shifts
            ).numpy()
        flat = np.asarray(tile).reshape(tile.shape[0], -1)
        dtype = self._container.dtype_for(self._declared_input(),
                                          self.meta.sig_shape)
        stack = self._container.compute_stack(self.meta.sig_shape)
        sub = stack[(slice(None),) + self.meta.sig_slice.get()]
        op = np.ascontiguousarray(sub.reshape(sub.shape[0], -1).T).astype(
            dtype
        )
        self.results.intensity[:] += flat.astype(
            np.result_type(dtype, flat.dtype)
        ) @ op

    def process_tile(self, tile):
        if self._host_mode:
            return self._process_tile_host(tile)
        shifts = self.params.get("shifts")
        if shifts is not None:
            tile = self._shift_tile(tile, shifts)
        flat = tile.reshape(tile.shape[0], -1)
        mdt = self._operand_dtype()
        whole_sig = tuple(self.meta.sig_slice.shape) == tuple(
            self.meta.sig_shape
        )
        comp = None
        if whole_sig and shifts is None:
            comp = self._container.get_compaction(self.meta.sig_shape, mdt)
        if compaction_pays(comp, self.meta.device, "matmul"):
            # the stack's support blocks only
            key = (str(self.meta.device), np.dtype(mdt))
            if self._compact_op is None or self._compact_op[0] != key:
                self._compact_op = (key, *(
                    torch.from_numpy(comp[k]).to(self.meta.device)
                    for k in ("support", "operand_c")
                ))
            _, support, masks = self._compact_op
            flat = gather_blocks(flat, support, comp["block"])
        else:
            masks = self._operand.get(
                lambda: self._container.compute_stack(self.meta.sig_shape),
                self.meta, mdt,
            )
        out_dtype = self.results.intensity.dtype
        if masks.is_complex() and not flat.is_complex():
            # x @ (A + iB) = x @ A + i (x @ B): one real matmul on the
            # stacked [Re | Im] operand
            m = masks.shape[1]
            y = flat.to(torch.float32) @ torch.cat(
                [masks.real, masks.imag], dim=1
            )
            self.results.intensity += torch.complex(
                y[:, :m], y[:, m:]
            ).to(out_dtype)
            return
        dt = torch.promote_types(masks.dtype, torch.float32)
        if flat.is_complex():
            dt = torch.promote_types(dt, flat.dtype)
        self.results.intensity += (
            flat.to(dt) @ masks.to(dt)
        ).to(out_dtype)

    @staticmethod
    def _shift_tile(tile: torch.Tensor, shifts) -> torch.Tensor:
        """Each frame moved by (-dy, -dx): ``out[i, r, c] = tile[i, r +
        dy, c + dx]``, zero where that lies outside the frame (a roll
        with the wrapped border zeroed).  One gather over the block;
        ``shifts`` is (2,) for all frames or (frames, 2)."""
        d, h, w = tile.shape[0], tile.shape[-2], tile.shape[-1]
        sh = torch.as_tensor(shifts, device=tile.device).to(torch.int64)
        sh = sh.reshape(-1, 2).expand(d, 2)
        rows = torch.arange(h, device=tile.device)[None, :] + sh[:, :1]
        cols = torch.arange(w, device=tile.device)[None, :] + sh[:, 1:]
        keep = (((rows >= 0) & (rows < h))[:, :, None]
                & ((cols >= 0) & (cols < w))[:, None, :])
        frames = torch.arange(d, device=tile.device)[:, None, None]
        out = tile[frames, rows.clamp(0, h - 1)[:, :, None],
                   cols.clamp(0, w - 1)[:, None, :]]
        return out * keep.to(out.dtype)

    def fused_moments_spec(self):
        """Contribute the mask stack as rows of the fused mask operand
        (real-valued, unshifted masks with float32/float64 results
        only)."""
        if self.params.get("shifts") is not None:
            return None
        stack = self._container.compute_stack(self.meta.sig_shape)
        if np.iscomplexobj(stack):
            return None
        out_dtype = self._container.dtype_for(self.meta.input_dtype)
        if self._kwargs.get("dtype") is not None:
            out_dtype = np.dtype(self._kwargs["dtype"])
        if np.dtype(out_dtype) not in (np.dtype(np.float32),
                                       np.dtype(np.float64)):
            return None
        operand = stack.reshape(stack.shape[0], -1).astype(np.float32)
        return {"mode": "masks", "operand": operand, "name": "intensity"}
