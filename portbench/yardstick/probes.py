"""Calibration read beside a traced run: the card's link and memory
rates, and its clocks and power over the window.  They are printed and
kept in the run's output file, never in the result line."""
from __future__ import annotations

import shutil
import subprocess

H2D_BYTES = 256 << 20
D2D_BYTES = 1 << 30
SMI_FIELDS = "index,name,clocks.sm,clocks.mem,power.draw,power.limit," \
             "temperature.gpu"


def _timed_gbps(fn, nbytes: int, device, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    end.synchronize()
    return nbytes * reps / (start.elapsed_time(end) / 1e3) / 1e9


def link_and_hbm(device) -> dict:
    """GB/s of a pinned 256 MiB host-to-device copy and of a 1 GiB
    device-to-device copy (bytes copied a second; the copy reads and
    writes each byte), CUDA events around 8 copies after one more."""
    import torch

    host = torch.empty(H2D_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(H2D_BYTES, dtype=torch.uint8, device=device)
    h2d = _timed_gbps(lambda: dev.copy_(host, non_blocking=True),
                      H2D_BYTES, device, 8)
    del dev, host
    a = torch.empty(D2D_BYTES, dtype=torch.uint8, device=device)
    b = torch.empty_like(a)
    d2d = _timed_gbps(lambda: b.copy_(a), D2D_BYTES, device, 8)
    del a, b
    torch.cuda.empty_cache()
    return {"h2d_pinned_256MiB_GBps": h2d, "d2d_1GiB_GBps": d2d}


class SmiSampler:
    """``nvidia-smi`` sampling its fields every ``period_ms`` while the
    ``with`` block runs; ``rows`` holds the CSV lines after it (none
    where the tool is missing)."""

    def __init__(self, period_ms: int = 1000):
        self.period_ms = period_ms
        self.rows: list = []
        self._proc = None

    def __enter__(self) -> "SmiSampler":
        tool = shutil.which("nvidia-smi")
        if tool:
            self._proc = subprocess.Popen(
                [tool, f"--query-gpu={SMI_FIELDS}",
                 "--format=csv,noheader", f"-lms={self.period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)
        return self

    def __exit__(self, *exc) -> bool:
        if self._proc is not None:
            self._proc.terminate()
            try:
                out, _ = self._proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                out, _ = self._proc.communicate()
            self.rows = [r for r in out.splitlines() if r.strip()]
        return False


def power_limit_w(index: int):
    """The card's power limit in W from ``nvidia-smi``, or None."""
    tool = shutil.which("nvidia-smi")
    if not tool:
        return None
    out = subprocess.run(
        [tool, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
         f"--id={index}"], capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        return None
