"""A cell's inputs, made from ``--seed`` on the card.

One ``torch.Generator`` on the device draws, in this order: the dark
frame, the gain map and the excluded pixels where the configuration has
them, then the frames, a fixed number at a time.  The frames are copied
once into one host numpy array, which the program reads (through its
source) and the reference reads again after the window: both sides get
the same bytes.  The same seed on the same kind of device gives the
same inputs; every seed gives inputs of the same sizes and statistics,
so the work does not depend on the seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# frames drawn per call of the generator (a fixed count: the draws, and
# so the inputs, follow from the seed and this number alone)
CHUNK_FRAMES = 2048


@dataclass
class Inputs:
    frames: np.ndarray          # nav + sig, the configuration's dtype
    dark: Optional[np.ndarray]  # sig, float32: the dark level in the frames
    gain: Optional[np.ndarray]  # sig, float32
    excluded: Optional[np.ndarray]  # sig, bool

    @property
    def nbytes(self) -> int:
        return int(self.frames.nbytes)


def make_inputs(config: dict, seed: int, device) -> Inputs:
    import torch

    nav = tuple(int(n) for n in config["nav"])
    sig = tuple(int(n) for n in config["sig"])
    n = int(np.prod(nav))
    p = int(np.prod(sig))
    spec = config["frames"]
    dtype = np.dtype(spec["dtype"])
    if dtype not in (np.uint16, np.float32):
        raise ValueError(f"frames of {dtype} are not made here")
    lam = float(spec["poisson"])
    if dtype == np.uint16 and lam > 1000:
        # counts of Poisson(1000) stay far below 2**15: the int16 view
        # below holds them exactly
        raise ValueError("u16 counts above Poisson(1000) are not made here")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    dark = gain = excluded = None
    if "dark" in spec:
        mean, std = (float(v) for v in spec["dark"])
        dark_t = torch.normal(mean, std, (p,), generator=g, device=device)
        dark = dark_t.cpu().numpy().reshape(sig)
    corr = config.get("corrections") or {}
    if "gain" in corr:
        low, spread = (float(v) for v in corr["gain"])
        gain = (low + spread * torch.rand(
            p, generator=g, device=device)).cpu().numpy().reshape(sig)
    if corr.get("excluded_pixels"):
        k = int(corr["excluded_pixels"])
        idx = torch.randperm(p, generator=g, device=device)[:k].cpu()
        excluded = np.zeros(p, dtype=bool)
        excluded[idx.numpy()] = True
        excluded = excluded.reshape(sig)

    host = np.empty((n, p), dtype=dtype)
    # uint16 counts cross as int16, the same bits for counts < 2**15
    host_t = torch.from_numpy(host.view(np.int16) if dtype == np.uint16
                              else host)
    rate = torch.full((min(CHUNK_FRAMES, n), p), lam, device=device)
    for lo in range(0, n, CHUNK_FRAMES):
        k = min(CHUNK_FRAMES, n - lo)
        x = torch.poisson(rate[:k], generator=g)
        if dtype == np.uint16:
            x = x.to(torch.int16)
        elif dark is not None:
            x += dark_t
        host_t[lo:lo + k].copy_(x)
    return Inputs(frames=host.reshape(nav + sig), dark=dark, gain=gain,
                  excluded=excluded)
