"""Host thread-count control (counterpart of
``libertem_tpu/common/threading.py``): caps the BLAS/OpenMP pools, and
torch's own intra-op pool, for the duration of a block."""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def set_num_threads(n: int):
    """At most ``n`` threads in torch's intra-op pool and, where
    threadpoolctl imports, in the BLAS/OpenMP pools."""
    # only the import belongs in the try: an except around the yield
    # would swallow ImportErrors raised by the caller's body
    try:
        import threadpoolctl
    except ImportError:  # pragma: no cover
        threadpoolctl = None
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, int(n)))
    try:
        if threadpoolctl is None:
            yield
        else:
            with threadpoolctl.threadpool_limits(limits=n):
                yield
    finally:
        torch.set_num_threads(old)


@contextlib.contextmanager
def set_num_threads_env(n: int, set_numba: bool = False):
    """The OpenMP/MKL/OpenBLAS thread variables set to ``n`` for the
    block (for processes started inside it).  ``set_numba`` is
    accepted as in the JAX package; there is no numba here."""
    keys = ["OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"]
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ[k] = str(n)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mitigations():
    """Thread-pool mitigations for threaded executors: nothing to do
    with one controller process, so a null context."""
    return contextlib.nullcontext()
