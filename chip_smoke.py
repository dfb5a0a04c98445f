#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

from the root of the repository.  Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``libertem_tpu_torch/csrc`` with nvcc;
2. write the full-size dataset: a raw u16 file, nav (256, 256),
   sig (128, 128), Poisson(8) counts from a numpy seed (2 GiB), to a
   temporary directory;
3. hold every kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, and on the contract cases
   (tails, constant data, variance off);
4. run the main path through the public API -- ``Context().load("raw",
   ...)`` and ``run_udf`` with ApplyMasksUDF (BF disk + ADF ring),
   CoMUDF, SumUDF, SumSigUDF and StdDevUDF -- with the kernels' launch
   counts set to 0 just before and read just after, and check every
   result against a float64 numpy oracle;
5. time the kernel, its plain version and a PyTorch expression of the
   same outputs on the main path's blocks, and the end-to-end run, and
   trace one more run with torch.profiler for device time by kernel
   and copy.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NAV = (256, 256)
SIG = (128, 128)
SEED = 0
# H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float32 against float32 with another summation order, or against a
# float64 oracle: relative 1e-5, with an absolute floor of 1e-5 of the
# largest magnitude for entries near zero
RTOL = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> tuple[float, bool]:
    """(max abs error, within tolerance) of two arrays or tensors."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf"), False
    scale = max(float(np.nanmax(np.abs(want), initial=0.0)), 1.0)
    err = np.abs(got - want)
    ok = bool(np.all(
        (err <= RTOL * np.abs(want) + RTOL * scale)
        | (np.isnan(got) & np.isnan(want))
    ))
    return float(np.nanmax(err, initial=0.0)), ok


def make_udfs(lt):
    h, w = SIG
    return [
        lt.ApplyMasksUDF(mask_factories=[
            lambda: lt.masks.circular(64, 64, w, h, 16),
            lambda: lt.masks.ring(64, 64, w, h, 60, 40),
        ]),
        lt.CoMUDF.with_params(cy=64, cx=64, r=32),
        lt.SumUDF(),
        lt.SumSigUDF(),
        lt.StdDevUDF(),
    ]


def write_dataset(path: str) -> np.ndarray:
    """Poisson(8) u16 frames, one seeded stream per chunk of frames,
    drawn by 8 threads (numpy's generators release the GIL)."""
    n = int(np.prod(NAV))
    data = np.empty((n,) + SIG, np.uint16)
    chunks = 64
    seeds = np.random.SeedSequence(SEED).spawn(chunks)
    step = n // chunks

    def fill(i):
        rng = np.random.default_rng(seeds[i])
        data[i * step:(i + 1) * step] = rng.poisson(
            8.0, (step,) + SIG
        )

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, range(chunks)))
    data.tofile(path)
    return data.reshape(NAV + SIG)


def oracle(data: np.ndarray, masks_bf_adf: np.ndarray) -> dict:
    """float64 answers of the five UDFs, in chunks of frames."""
    h, w = SIG
    flat = data.reshape(-1, h * w)
    n = flat.shape[0]
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    disk = (((y - 64) ** 2 + (x - 64) ** 2) <= 32 ** 2).astype(np.float64)
    operand = np.concatenate([
        masks_bf_adf.reshape(2, -1).astype(np.float64),
        np.stack([disk, y * disk, x * disk]).reshape(3, -1),
    ]).T
    proj = np.empty((n, 5))
    sumsig = np.empty(n)
    s1 = np.zeros(h * w)
    s2 = np.zeros(h * w)
    for off in range(0, n, 4096):
        f = flat[off:off + 4096].astype(np.float64)
        proj[off:off + 4096] = f @ operand
        sumsig[off:off + 4096] = f.sum(axis=1)
        s1 += f.sum(axis=0)
        s2 += (f * f).sum(axis=0)
    # integer counts: these float64 sums are exact, so the raw second
    # moment is too
    mean = s1 / n
    var = s2 / n - mean * mean
    com = proj[:, 3:5] / proj[:, 2:3]
    shifts = com - 64.0
    sy = shifts[:, 0].reshape(NAV)
    sx = shifts[:, 1].reshape(NAV)
    dy_dy, dy_dx = np.gradient(sy)
    dx_dy, dx_dx = np.gradient(sx)
    return {
        (0, "intensity"): proj[:, :2].reshape(NAV + (2,)),
        (1, "raw_com"): com.reshape(NAV + (2,)),
        (1, "raw_shifts"): shifts.reshape(NAV + (2,)),
        (1, "field"): shifts.reshape(NAV + (2,)),
        (1, "magnitude"): np.hypot(sy, sx),
        (1, "divergence"): dy_dy + dx_dx,
        (1, "curl"): dy_dx - dx_dy,
        (2, "intensity"): s1.reshape(SIG),
        (3, "intensity"): sumsig.reshape(NAV),
        (4, "num_frames"): np.array([float(n)]),
        (4, "sum"): s1.reshape(SIG),
        (4, "mean"): mean.reshape(SIG),
        (4, "var"): var.reshape(SIG),
        (4, "std"): np.sqrt(var).reshape(SIG),
    }


def time_ms(fn, inputs, calls=32, replays=8) -> tuple[float, float]:
    """(device ms, host-launched ms) per call of ``fn``, cycling over
    ``inputs`` (more bytes in all than the 50 MB L2, so every call
    reads from HBM).  Device time: ``calls`` calls captured in a CUDA
    graph and replayed, so no launch overhead of Python enters it.
    Host-launched time: the same calls issued eagerly, CUDA events
    around them; the larger of the wrapper's Python time and the
    device time."""
    import torch

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    eager_ms = start.elapsed_time(end) / calls
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / (calls * replays)
    del graph
    torch.cuda.synchronize()
    return device_ms, eager_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.ops import build
    from libertem_tpu_torch.ops.moments import (
        fused_moments,
        fused_moments_reference,
    )
    from libertem_tpu_torch.udf.base import UDFRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    at = f"[{card}]"
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    failures = []

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(["fused_moments"])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    log = build.BUILD_DIR / "fused_moments.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    with tempfile.TemporaryDirectory() as tmp:
        # -- 2. data -----------------------------------------------------------
        path = os.path.join(tmp, "scan.raw")
        t0 = time.perf_counter()
        data = write_dataset(path)
        print(f"data: {os.path.getsize(path)} bytes written in "
              f"{time.perf_counter() - t0:.1f} s")

        ctx = lt.Context()
        ds = ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                      sig_shape=SIG)
        prep = UDFRunner(make_udfs(lt))._prepare(ds, dev)
        depth = prep["scheme"].depth
        masks_t = prep["masks_t"]
        pixels = masks_t.shape[1]
        n_blocks = sum(-(-p.num_frames // depth) for p in prep["partitions"])
        print(f"main path: block depth {depth}, {pixels} pixels, "
              f"{masks_t.shape[0]} mask rows, {n_blocks} blocks")

        # -- 3. kernel against its plain version --------------------------
        rng = np.random.default_rng(SEED + 1)

        def case(name, x_np, valid, compute_var=True, masks=masks_t):
            x = torch.from_numpy(x_np).to(dev)
            got = fused_moments(x, masks, valid, compute_var=compute_var)
            want = fused_moments_reference(x, masks, valid,
                                           compute_var=compute_var)
            torch.cuda.synchronize()
            errs = []
            for label, g, w in zip(("y", "colsum", "colvar"), got, want):
                e, ok = max_err(g.cpu(), w.cpu())
                errs.append(e)
                if not ok:
                    failures.append(f"kernel {name} {label}: max err {e}")
            return got, max(errs)

        poisson = rng.poisson(8.0, (depth, pixels)).astype(np.uint16)
        tail = poisson.copy()
        tail[depth - 37:] = 0
        ragged = rng.poisson(8.0, (100, 1000)).astype(np.uint16)
        ragged[77:] = 0
        checks = {
            "u16 Poisson(8)": case("u16", poisson, depth),
            "u8": case("u8", rng.integers(
                0, 256, (depth, pixels)).astype(np.uint8), depth),
            "f32 mean 1000 std 0.5": case("f32", rng.normal(
                1000.0, 0.5, (depth, pixels)).astype(np.float32), depth),
            "u16 tail valid=D-37": case("tail", tail, depth - 37),
            "compute_var=False": case("novar", poisson, depth,
                                      compute_var=False),
            "ragged D=100 P=1000 M=7 valid=77": case(
                "ragged", ragged, 77,
                masks=torch.from_numpy(rng.normal(size=(7, 1000)).astype(
                    np.float32)).to(dev),
            ),
        }
        const_out = case("const", np.full((depth, pixels), 1000.123,
                                          np.float32), depth)
        checks["f32 constant 1000.123"] = const_out
        if not bool(torch.all(const_out[0][2] == 0)):
            failures.append("kernel const: colvar is not exactly 0")
        if not bool(torch.all(checks["compute_var=False"][0][2] == 0)):
            failures.append("kernel novar: colvar is not 0")
        kernel_max_err = max(e for _, e in checks.values())
        for name, (_, e) in checks.items():
            print(f"  kernel fused_moments vs plain, {name}: max abs err "
                  f"{e:.3g}")
        print("kernels: fused_moments "
              + ("ok" if not failures else "FAILED")
              + f" max_abs_err {kernel_max_err:.3g} (rtol {RTOL}, atol "
              f"{RTOL} x max|plain|)")

        # -- 4. the main path -----------------------------------------------
        udfs = make_udfs(lt)
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, udfs)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = fused_moments.launches
        feed = dict(ctx.feed_stats)
        if launches != n_blocks or launches == 0:
            failures.append(
                f"main path launched fused_moments {launches} times, "
                f"expected {n_blocks} (one per block)"
            )
        bf_adf = np.stack([
            lt.masks.circular(64, 64, SIG[1], SIG[0], 16),
            lt.masks.ring(64, 64, SIG[1], SIG[0], 60, 40),
        ])
        t0 = time.perf_counter()
        want = oracle(data, bf_adf)
        print(f"oracle: {time.perf_counter() - t0:.1f} s (float64 numpy)")
        for (ui, name), ref in want.items():
            got = res[ui][name].data
            e, ok = max_err(got, ref)
            if name in ("divergence", "curl"):
                # differences of neighbouring shifts: the floor follows
                # the field's magnitude
                scale = float(np.abs(want[(1, "field")]).max())
                ok = bool(np.all(
                    np.abs(np.asarray(got, np.float64) - ref)
                    <= RTOL * max(scale, 1.0)
                ))
            print(f"  result {ui}/{name}: max abs err {e:.3g} vs float64")
            if not ok or not np.all(np.isfinite(got)):
                failures.append(f"result {ui}/{name}: max err {e}")

        # steady-state rerun, for timing only
        t0 = time.perf_counter()
        ctx.run_udf(ds, make_udfs(lt))
        torch.cuda.synchronize()
        e2e2_s = time.perf_counter() - t0
        feed2 = dict(ctx.feed_stats)

        # a traced rerun: device time by kernel and copy
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ctx.run_udf(ds, make_udfs(lt))
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        # device-side events only (kernels and copies): the CPU ops
        # that launched them carry the same time again
        device_us = {
            evt.key: evt.self_device_time_total
            for evt in prof.key_averages()
            if str(evt.device_type).endswith("CUDA")
            and evt.self_device_time_total > 0
        }
        busy_s = sum(device_us.values()) / 1e6
        print(f"trace: {traced_s:.3f} s wall, device activity "
              f"{busy_s:.4f} s = {busy_s / traced_s:.2%} of it (copies "
              f"and kernels summed; they may overlap), idle share "
              f"{1 - busy_s / traced_s:.2%} {at}")
        for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  device {us / 1e3:9.3f} ms  {key[:90]}")

    # -- 5. timings --------------------------------------------------------------
    blocks = [
        (torch.from_numpy(np.random.default_rng(SEED + 2 + i).poisson(
            8.0, (depth, pixels)).astype(np.uint16)).to(dev), masks_t,
         depth)
        for i in range(4)
    ]

    def library(x, m, valid):
        xf = x.float()
        return xf @ m.T, torch.var_mean(xf, dim=0, correction=0)

    kernel_ms, kernel_eager_ms = time_ms(fused_moments, blocks)
    plain_ms, plain_eager_ms = time_ms(fused_moments_reference, blocks)
    library_ms, _ = time_ms(library, blocks)
    x_bytes = depth * pixels * 2
    n_masks = masks_t.shape[0]
    moved = x_bytes + masks_t.numel() * 4 + depth * n_masks * 4 + 2 * pixels * 4
    flops = depth * pixels * (2 * n_masks + 5)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    total_bytes = data.nbytes
    print(f"kernel fused_moments: {kernel_ms:.4f} ms per block "
          f"({x_bytes / kernel_ms / 1e6:.1f} GB/s of u16 input), bound "
          f"{bound_ms:.4f} ms by "
          f"{'bytes' if bytes_ms >= flops_ms else 'operations'} "
          f"({bound_ms / kernel_ms:.1%} of it); launched from Python "
          f"one by one {kernel_eager_ms:.4f} ms per block {at}")
    print(f"plain version: {plain_ms:.4f} ms per block (one by one "
          f"{plain_eager_ms:.4f} ms) {at}")
    print(f"library expression (matmul + var_mean, yardstick only): "
          f"{library_ms:.4f} ms per block {at}")
    for label, secs, stats in (("first", e2e_s, feed),
                               ("second", e2e2_s, feed2)):
        print(f"end to end ({label} run): {secs:.3f} s for "
              f"{total_bytes} bytes = {total_bytes / secs / 1e9:.2f} GB/s; "
              f"host feed: reader {stats['read_s']:.3f} s, consumer "
              f"waited {stats['wait_s']:.3f} s = "
              f"{stats['wait_s'] / secs:.1%} of the wall time; kernel "
              f"{kernel_ms * launches / 1e3:.4f} s of device time "
              f"= {kernel_ms * launches / 1e3 / secs:.2%} of it {at}")

    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "fused_moments",
        "route": "cuda",
        "source": "libertem_tpu_torch/csrc/fused_moments.cu",
        "replaces": "libertem_tpu/ops/moments.py:135",
        "launches": launches,
        "max_abs_err": kernel_max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
