"""ApplyMasksUDF: virtual detectors as projections on a mask stack
(counterpart of ``libertem_tpu/udf/masks.py``).

The mask factories are evaluated once into a dense ``(n_masks, *sig)``
stack; on the fused path its flattened rows join the fused pass's
mask operand, on the generic path each tile is projected on it with a
float32 matmul (``torch.matmul``, full fp32: the runner keeps TF32
off).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .base import UDF


class TileOperand:
    """The columns of a (n, *sig) mask stack under the current sig
    tile, as a (pixels of the tile, n) float32 tensor on the run's
    device: the generic path's matmul operand, made once per tile and
    device."""

    def __init__(self):
        self._key = None
        self._op = None

    def get(self, make_stack, meta) -> torch.Tensor:
        sl = meta.sig_slice
        key = (meta.sig_shape, sl.origin, tuple(sl.shape), str(meta.device))
        if key != self._key:
            sub = make_stack()[(slice(None),) + sl.get()]
            self._op = torch.from_numpy(np.ascontiguousarray(
                sub.reshape(sub.shape[0], -1).T, dtype=np.float32
            )).to(meta.device)
            self._key = key
        return self._op


class MaskContainer:
    """Evaluates mask factories once into a dense stack."""

    def __init__(
        self,
        mask_factories: Union[Callable, Sequence[Callable]],
        dtype=None,
        count: Optional[int] = None,
    ):
        self._factories = mask_factories
        self._dtype = dtype
        self._count = count
        self._stack: Optional[np.ndarray] = None  # (n_masks, *sig)

    def compute_stack(self, sig_shape) -> np.ndarray:
        if self._stack is not None:
            return self._stack
        if callable(self._factories):
            raw = np.asarray(self._factories())
            masks = [raw] if raw.ndim == len(sig_shape) else list(raw)
        else:
            masks = [np.asarray(f()) for f in self._factories]
        stack = np.stack(masks, axis=0)
        if stack.shape[1:] != tuple(sig_shape):
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

    def dtype_for(self, input_dtype, sig_shape) -> np.dtype:
        """Result dtype of projecting ``input_dtype`` data on the
        stack: complex masks give complex results, float64 factory
        output gives float64."""
        if self._dtype is not None:
            mdt = np.dtype(self._dtype)
        else:
            mdt = self.compute_stack(sig_shape).dtype
        return np.result_type(mdt, input_dtype)


class ApplyMasksUDF(UDF):
    """Apply a stack of masks to each frame: the virtual-detector UDF.

    ``mask_factories`` is a callable or a list of callables, each
    returning a (*sig) mask; ``mask_count`` and ``mask_dtype`` fix the
    stack's length and dtype; ``dtype`` is the preferred input dtype.
    """

    def __init__(self, mask_factories, mask_count=None, mask_dtype=None,
                 dtype=None):
        super().__init__(
            mask_factories=mask_factories, mask_count=mask_count,
            mask_dtype=mask_dtype, dtype=dtype,
        )
        self._container = MaskContainer(
            mask_factories, dtype=mask_dtype, count=mask_count,
        )
        self._operand = TileOperand()

    def get_preferred_input_dtype(self):
        if self._kwargs.get("dtype") is not None:
            return np.dtype(self._kwargs["dtype"])
        return np.float32

    def get_result_buffers(self):
        # the result dtype follows the declared input dtype
        # result_type(preference, dataset), not the device's
        # narrower compute dtype
        declared_input = np.result_type(
            self.get_preferred_input_dtype(), self.meta.dataset_dtype
        )
        return {
            "intensity": self.buffer(
                kind="nav",
                extra_shape=(self._container.n_masks,),
                dtype=self._container.dtype_for(
                    declared_input, self.meta.sig_shape
                ),
            ),
        }

    def _wants_64bit(self) -> bool:
        """An explicit 64-bit mask/input dtype, or 64-bit data, asks for
        64-bit accumulation, which the JAX package runs on its host
        engine; that engine is not ported."""
        dtypes = [self._kwargs.get(k) for k in ("mask_dtype", "dtype")]
        dtypes.append(self.meta.dataset_dtype)
        return any(
            d is not None and np.dtype(d).kind in "fc"
            and np.dtype(d).itemsize >= (8 if np.dtype(d).kind == "f"
                                         else 16)
            for d in dtypes
        )

    def _real_stack(self) -> np.ndarray:
        stack = self._container.compute_stack(self.meta.sig_shape)
        if np.iscomplexobj(stack):
            raise NotImplementedError("complex masks are not ported yet")
        return stack

    def process_tile(self, tile):
        if self._wants_64bit():
            raise NotImplementedError(
                "64-bit mask or input dtypes accumulate in 64 bits on "
                "the JAX package's host engine, which is not ported yet"
            )
        flat = tile.reshape(tile.shape[0], -1).to(torch.float32)
        self.results.intensity += flat @ self._operand.get(
            self._real_stack, self.meta
        )

    def fused_moments_spec(self):
        """Contribute the mask stack as rows of the fused mask operand
        (real-valued float32/float64 results only)."""
        if self._wants_64bit():
            return None
        stack = self._container.compute_stack(self.meta.sig_shape)
        if np.iscomplexobj(stack):
            return None
        out_dtype = self._container.dtype_for(
            self.meta.input_dtype, self.meta.sig_shape
        )
        if self._kwargs.get("dtype") is not None:
            out_dtype = np.dtype(self._kwargs["dtype"])
        if np.dtype(out_dtype) not in (np.dtype(np.float32),
                                       np.dtype(np.float64)):
            return None
        operand = stack.reshape(stack.shape[0], -1).astype(np.float32)
        return {"mode": "masks", "operand": operand, "name": "intensity"}
