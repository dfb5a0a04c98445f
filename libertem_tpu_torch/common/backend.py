"""The device rule (counterpart of ``libertem_tpu/common/backend.py``).

Entry points run on the CUDA card unless the caller asks for the CPU
explicitly.  There is no silent fallback: without a card, the default
device raises.

The caller may also pin the default device through the environment,
with the port's own variable names (the JAX package's
``LIBERTEM_TPU_USE_*`` pins never steer the port):

* ``LIBERTEM_TPU_TORCH_USE_DEVICE=<index>`` (:func:`set_use_device`,
  :func:`set_use_cuda`): ``cuda:<index>``;
* ``LIBERTEM_TPU_TORCH_USE_CPU=<id>`` (:func:`set_use_cpu`): the CPU,
  an explicit request, so it wins over a device pin.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

_ENV_DEVICE = "LIBERTEM_TPU_TORCH_USE_DEVICE"
_ENV_CPU = "LIBERTEM_TPU_TORCH_USE_CPU"


def set_use_device(idx: int) -> None:
    """Pin the default device to CUDA card ``idx``."""
    os.environ[_ENV_DEVICE] = str(int(idx))


def get_use_device() -> Optional[int]:
    v = os.environ.get(_ENV_DEVICE)
    return int(v) if v is not None else None


def set_use_cpu(cpu_id: int = 0) -> None:
    """Pin the default device to the CPU (there is one CPU device; the
    id is kept as given) and clear a card pin."""
    os.environ[_ENV_CPU] = str(int(cpu_id))
    os.environ.pop(_ENV_DEVICE, None)


def set_use_cuda(gpu_id: int) -> None:
    """Pin the default device to CUDA card ``gpu_id`` and clear a CPU
    pin."""
    set_use_device(gpu_id)
    os.environ.pop(_ENV_CPU, None)


def get_use_cpu() -> bool:
    return _ENV_CPU in os.environ


def get_use_cuda() -> Optional[int]:
    """The pinned card's index, or None (no pin, or a CPU pin)."""
    if get_use_cpu():
        return None
    return get_use_device()


def get_device_class() -> str:
    """``"cpu"`` or ``"cuda"``: the type of the default device, that
    is the pinned one, else the card where there is one."""
    if get_use_cpu():
        return "cpu"
    if get_use_device() is not None or torch.cuda.is_available():
        return "cuda"
    return "cpu"


def set_file_limit() -> None:
    """Raise RLIMIT_NOFILE to the hard limit: many-file datasets (K2IS
    sectors, MIB and TVIPS series) keep a descriptor per file open."""
    import resource

    _, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``None`` means the pinned device, else the CUDA card, and
    raises when that is a card and there is none; anything else
    (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is taken as given,
    and a CUDA device is checked for too."""
    if device is None:
        if get_use_cpu():
            return torch.device("cpu")
        idx = get_use_device()
        device = "cuda" if idx is None else f"cuda:{idx}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
