"""AutoUDF: ``f(frame) -> result`` on every frame, behind
``Context.map`` (counterpart of ``libertem_tpu/udf/auto.py``).

``f`` is probed once on a frame of meta tensors (no data, no device),
vmapped as the device engine calls ``process_frame``: where that
passes, ``f`` runs on the device engine (mode ``"torch"``), its result
shape taken from the probe.  Otherwise ``f`` runs once on a zero frame
in numpy and goes to the host engine: mode ``"host"`` for an
array-like result, ``"object"`` for any other value, kept in an
object-dtype nav buffer.

The result dtype follows the JAX package's, whose ``jnp`` computes
without 64-bit types: a 64-bit torch result is declared in 32 bits
(``_jax_dtype``).  Frames come as float32 in both packages (the
default input dtype of a UDF).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import UDF, _torch_dtype


def _jax_dtype(result: torch.dtype) -> np.dtype:
    """The JAX package's dtype of a result that torch computes as
    ``result``: 64-bit types in 32 bits."""
    dtype = torch.empty(0, dtype=result).numpy().dtype
    return {np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.complex128): np.dtype(np.complex64),
            np.dtype(np.int64): np.dtype(np.int32),
            np.dtype(np.uint64): np.dtype(np.uint32)}.get(dtype, dtype)


class AutoUDF(UDF):
    def __init__(self, f=None, monitor=False):
        super().__init__(f=f, monitor=monitor)
        self._probe = None  # (mode, shape, dtype)

    def _probe_f(self) -> tuple:
        if self._probe is not None:
            return self._probe
        sig = tuple(self.meta.dataset_shape.sig)
        in_dtype = self.meta.input_dtype
        try:
            frames = torch.zeros((1,) + sig, dtype=_torch_dtype(in_dtype),
                                 device="meta")
            out = torch.func.vmap(self.params.f)(frames)
            if not isinstance(out, torch.Tensor):
                raise TypeError(f"f returned {type(out).__name__}")
            self._probe = ("torch", tuple(out.shape[1:]),
                           _jax_dtype(out.dtype))
        except Exception:
            # f for real, on a zero frame, with numpy
            res = self.params.f(np.zeros(sig, dtype=in_dtype))
            arr = None
            try:
                arr = np.asarray(res)
            except Exception:
                pass
            if arr is not None and arr.dtype != object:
                self._probe = ("host", tuple(arr.shape), arr.dtype)
            else:
                self._probe = ("object", (), np.dtype(object))
        return self._probe

    def on_params_updated(self):
        self._probe = None

    def get_backends(self):
        mode, _, _ = self._probe_f()
        if mode == "torch":
            return (self.BACKEND_TORCH,)
        return (self.BACKEND_NUMPY,)

    def get_result_buffers(self):
        mode, shape, dtype = self._probe_f()
        bufs = {"result": self.buffer(kind="nav", extra_shape=shape,
                                      dtype=dtype)}
        if self.params.monitor:
            if mode == "object":
                raise ValueError("monitor= requires an array-valued f")
            # the result of some recently processed frame, for live
            # monitoring
            bufs["monitor"] = self.buffer(kind="single", extra_shape=shape,
                                          dtype=dtype)
        return bufs

    def process_frame(self, frame):
        mode, shape, _ = self._probe_f()
        res = self.params.f(frame)
        if mode == "object":
            # one Python value a nav position of the object array
            self.results.result = res
            return
        if self._host_mode:
            arr = np.asarray(res).reshape(shape)
            self.results.result = arr
            if self.params.monitor:
                self.results.monitor[...] = arr
            return
        self.results.result = res.reshape(self.results.result.shape)
        if self.params.monitor:
            self.results.monitor = res.reshape(self.results.monitor.shape)

    def merge(self, dest, src):
        # a custom merge writes every buffer it gets: the nav rows as
        # they are, the monitor from the latest partition
        if hasattr(src, "result"):
            dest.result[...] = src.result
        if hasattr(src, "monitor"):
            dest.monitor = src.monitor
