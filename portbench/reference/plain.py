"""The plain reference of the fused pass: ApplyMasks over a mask stack,
CoM in a disk, Sum, SumSig and StdDev.  Plain PyTorch, in blocks of
frames, on the card or the CPU; it imports nothing of the program and
takes nothing the program made: the masks and the CoM grids are built
here from the configuration's parameters, and the frames are the
inputs both sides were given.

``precision``: ``"float64"`` is the reference.  The controls compute
the same in a lower precision: ``"tf32"`` rounds both operands of the
product to TF32 (10 bits of mantissa) and keeps everything else, and
the results, in float32; ``"bf16"`` computes and keeps every value in
bfloat16 (products accumulated as torch does, in float32).
"""
from __future__ import annotations

import numpy as np

BLOCK_FRAMES = 2048
PRECISIONS = ("float64", "tf32", "bf16")
# the buffer whose magnitude scales a group's errors, where it is not
# each buffer's own (yardstick/compare.py)
SCALES = {"com": "raw_com"}


def com_stack(sig, cy, cx, r) -> np.ndarray:
    """(3, h, w): the disk of radius ``r`` around (cy, cx), and the
    disk weighted by the row and by the column index."""
    h, w = sig
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    disk = (((y - cy) ** 2 + (x - cx) ** 2) <= r * r).astype(np.float64)
    return np.stack([disk, y * disk, x * disk])


def _tf32(t):
    """float32 rounded to TF32, to nearest (ties away from zero)."""
    import torch

    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _narrow(a: np.ndarray, precision: str) -> np.ndarray:
    """``a`` as the precision keeps it, widened to float64."""
    import torch

    if precision == "float64":
        return a
    if precision == "tf32":
        return a.astype(np.float32).astype(np.float64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).to(torch.float64).numpy()


def expected(frames: np.ndarray, sig, stack: np.ndarray, com: dict,
             precision: str = "float64", device="cpu") -> dict:
    """``{group: {buffer: float64 array}}`` of the five UDFs over
    ``frames`` (nav + sig); ``stack`` (k, h, w) the ApplyMasks masks,
    ``com`` its ``cy``, ``cx`` and ``r``."""
    import torch

    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    sig = tuple(int(s) for s in sig)
    nav = frames.shape[:frames.ndim - len(sig)]
    flat = frames.reshape(-1, int(np.prod(sig)))
    n, p = flat.shape
    k = stack.shape[0]
    cy, cx = float(com["cy"]), float(com["cx"])
    operand_np = np.concatenate([
        stack.reshape(k, p).astype(np.float64),
        com_stack(sig, cy, cx, float(com["r"])).reshape(3, p),
        np.ones((1, p)),
    ]).T
    work = {"float64": torch.float64, "tf32": torch.float32,
            "bf16": torch.bfloat16}[precision]

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    operand = on(operand_np).to(work)
    if precision == "tf32":
        operand = _tf32(operand)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        proj = torch.empty((n, operand.shape[1]), dtype=work, device=device)
        count, s1, mean, m2 = 0, 0, 0, 0
        for lo in range(0, n, BLOCK_FRAMES):
            hi = min(n, lo + BLOCK_FRAMES)
            raw = flat[lo:hi]
            if raw.dtype == np.uint16:
                x = on(raw.view(np.int16)).to(torch.int32) & 0xFFFF
            else:
                x = on(raw)
            x = x.to(work)
            proj[lo:hi] = (_tf32(x) if precision == "tf32" else x) @ operand
            nb_ = hi - lo
            sb = x.sum(dim=0)
            mb = sb / nb_
            m2b = ((x - mb) ** 2).sum(dim=0)
            # Chan's update of (count, mean, M2) by a block's
            if count == 0:
                mean, m2 = mb, m2b
            else:
                tot = count + nb_
                delta = mb - mean
                mean = mean + delta * (nb_ / tot)
                m2 = m2 + m2b + delta * delta * (count * nb_ / tot)
            count += nb_
            s1 = sb if isinstance(s1, int) else s1 + sb
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    def host(t):
        return t.to(torch.float64).cpu().numpy()

    proj_h = host(proj)
    s1_h = host(s1).reshape(sig)
    m2_h = host(m2).reshape(sig)
    moments = proj_h[:, k:k + 3]
    com_y = np.full(n, cy)
    com_x = np.full(n, cx)
    mass = moments[:, 0] != 0
    np.divide(moments[:, 1], moments[:, 0], out=com_y, where=mass)
    np.divide(moments[:, 2], moments[:, 0], out=com_x, where=mass)
    sy = (com_y - cy).reshape(nav)
    sx = (com_x - cx).reshape(nav)
    dy_dy, dy_dx = np.gradient(sy)
    dx_dy, dx_dx = np.gradient(sx)
    var = m2_h / n
    out = {
        "masks": {"intensity": proj_h[:, :k].reshape(nav + (k,))},
        "com": {
            "raw_com": np.stack([com_y, com_x], -1).reshape(nav + (2,)),
            "raw_shifts": np.stack([sy, sx], -1),
            "field": np.stack([sy, sx], -1),
            "field_y": sy,
            "field_x": sx,
            "magnitude": np.hypot(sy, sx),
            "divergence": dy_dy + dx_dx,
            "curl": dy_dx - dx_dy,
            "regression": np.zeros((3, 2)),
        },
        "sum": {"intensity": s1_h},
        "sumsig": {"intensity": proj_h[:, k + 3].reshape(nav)},
        "stddev": {
            "num_frames": np.array([float(n)]),
            "sum": s1_h,
            "varsum": m2_h,
            "var": var,
            "std": np.sqrt(var),
            "mean": s1_h / n,
        },
    }
    return {g: {name: _narrow(a, precision) for name, a in bufs.items()}
            for g, bufs in out.items()}
