"""The plain reference of the ``strain`` UDF set: correlation peak
finding around the expected reflections of a lattice, as
LiberTEM-blobfinder's ``SparseCorrelationUDF`` does it for strain
mapping.  Plain PyTorch, float64 (complex128 FFTs), in blocks of
frames, on the card or the CPU.  It imports nothing of the program and
takes nothing the program made: the template, the expected peaks and
the windows are built here from the configuration, and the frames are
the inputs both sides were given, with the specimen's disks rendered
into them (``specimens/lattice.py``, before the program's set-up or
here, whichever comes first).

For each frame and expected peak ``p`` (``y, x``):

* the correlation map is the circular cross-correlation of the frame
  with the template, ``ifft2(fft2(frame) * conj(fft2(template)))``,
  the template centred on pixel ``(0, 0)``: its maximum lies on a disk
  shaped like the template;
* ``centers``: ``p`` plus the offset of the first maximum (row-major)
  of the map in the ``(2 steps + 1)^2`` window of offsets around ``p``,
  which wraps around the frame's border as the map does;
* ``refineds``: ``p`` plus the centre of mass of the window's values
  less their minimum, over the window's offsets (``p`` where they sum
  to 0);
* ``peak_values``: the window's maximum.

The template is LiberTEM's radial gradient of radius ``R``: ``r / R``
times a disk of radius ``R`` about the frame's centre ``(h // 2, w //
2)``, where a pixel counts by the share of its 4 x 4 points inside the
disk.

Where this departs from LiberTEM-blobfinder (and the program with it):
blobfinder cuts a patch around each expected peak and correlates the
patches; here, as in the program, the whole frame is correlated by FFT
and the windows are read from that map, so a template that reaches
across the frame's border wraps.  blobfinder refines the maximum by a
centre of mass in a small neighbourhood of it; here the whole window,
less its minimum, about the expected peak, as the program does.  No
peak elevation is computed.

``precision``: ``"float64"`` is the reference.  ``"float32"`` computes
the same with float32 frames, a complex64 spectrum and complex64 FFTs
(as the program states it: it reads as the program).  ``"bf16"`` is
the lower control: the frames and the template's spectrum (its real
and imaginary parts) rounded to bfloat16, then the FFTs in float32.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

BLOCK_FRAMES = 512
PRECISIONS = ("float64", "float32", "bf16")
SCALES: dict = {}
SPECIMEN = (Path(__file__).resolve().parent.parent / "specimens"
            / "lattice.py")


def _specimen():
    spec = importlib.util.spec_from_file_location(
        "portbench_specimen_lattice", SPECIMEN)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def radial_gradient(sig, radius: float) -> np.ndarray:
    """(h, w) float64: ``r / radius`` inside the disk of ``radius``
    about ``(h // 2, w // 2)``, each pixel weighted by the share of its
    4 x 4 points that lie in the disk."""
    h, w = (int(s) for s in sig)
    cy, cx = h // 2, w // 2
    sub = (np.arange(4) + 0.5) / 4 - 0.5
    y = np.arange(h, dtype=np.float64)[:, None, None, None] + sub[:, None]
    x = np.arange(w, dtype=np.float64)[None, :, None, None] + sub[None, :]
    inside = ((y - cy) ** 2 + (x - cx) ** 2) <= radius ** 2
    share = inside.mean(axis=(2, 3))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    return r * share / radius


def expected_peaks(config) -> np.ndarray:
    """(n, 2) int: the unstrained lattice's reflections ``zero + h a +
    k b`` for ``|h|, |k| <= orders``, ``h`` outer, ``y, x``."""
    s = config["specimen"]
    orders = int(s["orders"])
    zero, a, b = (np.asarray(s[k], dtype=np.float64)
                  for k in ("zero", "a", "b"))
    out = [zero + h * a + k * b
           for h in range(-orders, orders + 1)
           for k in range(-orders, orders + 1)]
    return np.rint(np.array(out)).astype(np.int64)


def windows(sig, peaks: np.ndarray, steps: int) -> np.ndarray:
    """(n, (2 steps + 1)^2) flat pixel indices of each peak's window,
    row-major over the offsets, wrapping around the border."""
    h, w = (int(s) for s in sig)
    out = []
    for py, px in peaks:
        out.append([((py + dy) % h) * w + (px + dx) % w
                    for dy in range(-steps, steps + 1)
                    for dx in range(-steps, steps + 1)])
    return np.array(out, dtype=np.int64)


def _bf16(t):
    import torch

    return t.to(torch.bfloat16).to(torch.float32)


def expected(config, inputs, precision="float64", device="cpu") -> dict:
    """``{"correlation": {"centers", "refineds", "peak_values"}}`` over
    ``inputs.frames`` (the specimen rendered first, where it is not
    yet), each float64 and of the program's shapes."""
    _specimen().render(config, inputs, device)
    return {"correlation": correlation(
        inputs.frames, config["sig"], float(config["template_radius"]),
        expected_peaks(config), int(config["steps"]), precision, device)}


def correlation(frames: np.ndarray, sig, radius: float, peaks: np.ndarray,
                steps: int, precision: str = "float64",
                device="cpu") -> dict:
    """``{"centers", "refineds", "peak_values"}`` (float64, nav + (n,
    2) and nav + (n,)) of ``frames`` (nav + sig) correlated with the
    radial gradient of ``radius``, in the windows of ``steps`` around
    ``peaks`` ((n, 2) int, ``y, x``)."""
    import torch

    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    sig = tuple(int(s) for s in sig)
    nav = frames.shape[:frames.ndim - len(sig)]
    size = 2 * steps + 1
    template = radial_gradient(sig, radius)
    spectrum = np.conj(np.fft.fft2(np.fft.ifftshift(template)))
    real = torch.float64 if precision == "float64" else torch.float32
    cplx = torch.complex128 if precision == "float64" else torch.complex64
    spec_t = torch.from_numpy(spectrum).to(device)
    if precision == "bf16":
        spec_t = torch.complex(_bf16(spec_t.real), _bf16(spec_t.imag))
    spec_t = spec_t.to(cplx)
    win = torch.from_numpy(windows(sig, peaks, steps)).to(device)
    offs = torch.arange(-steps, steps + 1, dtype=torch.float64,
                        device=device)
    off_y = offs.repeat_interleave(size)
    off_x = offs.repeat(size)
    peaks_t = torch.from_numpy(peaks.astype(np.float64)).to(device)
    flat = frames.reshape(-1, sig[0] * sig[1])
    n = flat.shape[0]
    centers = torch.empty((n, len(peaks), 2), dtype=torch.float64)
    refineds = torch.empty_like(centers)
    values = torch.empty((n, len(peaks)), dtype=torch.float64)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for lo in range(0, n, BLOCK_FRAMES):
            hi = min(n, lo + BLOCK_FRAMES)
            raw = flat[lo:hi]
            if raw.dtype == np.uint16:
                x = torch.from_numpy(raw.view(np.int16)).to(device).to(
                    torch.int32) & 0xFFFF
            else:
                x = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
            x = x.to(real)
            if precision == "bf16":
                x = _bf16(x)
            x = x.reshape((hi - lo,) + sig)
            corr = torch.fft.ifft2(torch.fft.fft2(x) * spec_t).real
            wins = corr.reshape(hi - lo, -1)[:, win].to(torch.float64)
            # the first maximum of each window, row-major
            top = wins.amax(dim=-1, keepdim=True)
            first = (wins == top).to(torch.int8).argmax(dim=-1)
            c = torch.stack([off_y[first], off_x[first]], -1)
            w0 = wins - wins.amin(dim=-1, keepdim=True)
            mass = w0.sum(dim=-1)
            safe = torch.where(mass > 0, mass, torch.ones_like(mass))
            com = torch.stack([(w0 * off_y).sum(-1), (w0 * off_x).sum(-1)],
                              -1) / safe[..., None]
            com = torch.where((mass > 0)[..., None], com,
                              torch.zeros_like(com))
            centers[lo:hi] = (peaks_t + c).cpu()
            refineds[lo:hi] = (peaks_t + com).cpu()
            values[lo:hi] = top[..., 0].cpu()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    k = len(peaks)
    return {
        "centers": centers.numpy().reshape(nav + (k, 2)),
        "refineds": refineds.numpy().reshape(nav + (k, 2)),
        "peak_values": values.numpy().reshape(nav + (k,)),
    }
