"""The device rule (counterpart of ``libertem_tpu/common/backend.py``).

Entry points run on the CUDA card unless the caller asks for the CPU
explicitly.  There is no silent fallback: without a card, the default
device raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``None`` means the CUDA card and raises when there is none;
    anything else (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is
    taken as given, and a CUDA device is checked for too."""
    dev = torch.device("cuda" if device is None else device)
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
