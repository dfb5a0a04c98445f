#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one CUDA card.

    python3 chip_smoke.py

from the root of the repository.  Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``libertem_tpu_torch/csrc`` with nvcc;
2. write the full-size dataset: a raw u16 file, nav (256, 256),
   sig (128, 128), Poisson(8) counts from a numpy seed (2 GiB), to a
   temporary directory;
3. hold every kernel against its plain PyTorch version on the card at
   the shapes the paths give it, and on the contract cases (tails,
   constant data, variance off, more than 8 mask rows, a corrected
   float32 block, f64 / i64 / f16 input);
4. run the main path through the public API -- ``Context().load("raw",
   ...)`` and ``run_udf`` with ApplyMasksUDF (BF disk + ADF ring),
   CoMUDF, SumUDF, SumSigUDF and StdDevUDF -- with the kernels' launch
   counts set to 0 just before and read just after, and check every
   result against a float64 numpy oracle; trace one more run with
   torch.profiler for device time by kernel and copy;
5. time the kernel, its plain version and a PyTorch expression of the
   same outputs on the paths' blocks (u16 with 6, 12 and 40 mask rows;
   the corrected float32 block), and the end-to-end run;
6. the second slice's paths on the same scan, each with the launch
   counts set to 0 just before and read just after, checked against
   float64 numpy oracles and traced once more:
   (a) the fused path with detector corrections (dark, gain, 20
       excluded pixels) and 12 mask rows: ApplyMasksUDF with 8 rings,
       CoMUDF, SumUDF, SumSigUDF, StdDevUDF; the kernel runs twice
       per block (two groups of mask rows);
   (b) the generic path with a roi: LogsumUDF, FEMUDF and SumUDF over
       half the scan, then PickUDF over 5 frames (bit for bit); no
       fused kernel launches.

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
# results derived from centres of mass (differences com - c): their
# absolute floor follows the centres' magnitude, not their own
FROM_COM = ("raw_shifts", "field", "magnitude", "divergence", "curl")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(got, want, scale=None) -> tuple[float, bool]:
    """(max abs error, within tolerance) of two arrays or tensors;
    ``scale`` sets the absolute floor (default: want's magnitude)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf"), False
    if scale is None:
        scale = float(np.nanmax(np.abs(want), initial=0.0))
    scale = max(scale, 1.0)
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


def ring_stack(lt) -> np.ndarray:
    """8 concentric rings of width 8 around the frame's centre."""
    h, w = SIG
    return np.stack([
        lt.masks.ring(64, 64, w, h, r + 8, r) for r in range(0, 64, 8)
    ])


def make_ring_udfs(lt):
    rings = ring_stack(lt)
    return [lt.ApplyMasksUDF(mask_factories=lambda: rings,
                             mask_count=len(rings))] + make_udfs(lt)[1:]


def make_corrections(lt):
    """Dark frame, gain map and 20 excluded pixels, from the seed."""
    rng = np.random.default_rng(SEED + 3)
    h, w = SIG
    excluded = np.zeros(SIG, dtype=bool)
    excluded.flat[rng.choice(h * w, 20, replace=False)] = True
    return lt.CorrectionSet(
        dark=rng.normal(1.5, 0.3, SIG).astype(np.float32),
        gain=(1.0 + 0.1 * rng.random(SIG)).astype(np.float32),
        excluded_pixels=excluded,
    )


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


def in_chunks(ids: np.ndarray, fn, chunk: int = 1024) -> list:
    """``fn(position, ids[position:position + chunk])`` for every chunk
    of frame ids, on 8 threads (numpy releases the GIL), results in
    order.  Host memory stays bounded by 8 chunks of float64 frames."""
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(
            lambda lo: fn(lo, ids[lo:lo + chunk]),
            range(0, len(ids), chunk),
        ))


def frames64(raw: np.ndarray, plan) -> np.ndarray:
    """(n, pixels) frames in float64, corrected with ``plan`` (the
    correction set's numpy plan) when there is one."""
    f = raw.astype(np.float64)
    if plan is None:
        return f
    f -= plan["dark"].reshape(-1)
    f *= plan["gain"].reshape(-1)
    f[:, plan["repair_idx"]] = (
        f[:, plan["nbr_idx"]] * plan["nbr_w"].astype(np.float64)
    ).sum(axis=-1)
    return f


def oracle(data: np.ndarray, mask_stack: np.ndarray, plan=None) -> dict:
    """float64 answers of ApplyMasks (``mask_stack``), CoM (r=32),
    Sum, SumSig and StdDev, in chunks of frames; the per-pixel
    moments fold chunk by chunk with the Chan update."""
    h, w = SIG
    flat = data.reshape(-1, h * w)
    n = flat.shape[0]
    k = mask_stack.shape[0]
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    disk = (((y - 64) ** 2 + (x - 64) ** 2) <= 32 ** 2).astype(np.float64)
    operand = np.concatenate([
        mask_stack.reshape(k, -1).astype(np.float64),
        np.stack([disk, y * disk, x * disk]).reshape(3, -1),
        np.ones((1, h * w)),
    ]).T
    proj = np.empty((n, k + 4))

    def part(lo, ids):
        f = frames64(flat[ids], plan)
        proj[lo:lo + len(ids)] = f @ operand
        s1 = f.sum(axis=0)
        mean = s1 / len(ids)
        return len(ids), s1, mean, ((f - mean) ** 2).sum(axis=0)

    # integer counts keep these float64 sums exact
    count, s1, mean, m2 = 0, 0.0, 0.0, 0.0
    for nb, sb, mb, m2b in in_chunks(np.arange(n), part):
        delta = mb - mean
        tot = count + nb
        mean = mean + delta * (nb / tot)
        m2 = m2 + m2b + delta * delta * (count * nb / tot)
        count = tot
        s1 = s1 + sb
    var = m2 / n
    com = proj[:, k + 1:k + 3] / proj[:, k:k + 1]
    shifts = com - 64.0
    sy = shifts[:, 0].reshape(NAV)
    sx = shifts[:, 1].reshape(NAV)
    dy_dy, dy_dx = np.gradient(sy)
    dx_dy, dx_dx = np.gradient(sx)
    return {
        (0, "intensity"): proj[:, :k].reshape(NAV + (k,)),
        (1, "raw_com"): com.reshape(NAV + (2,)),
        (1, "raw_shifts"): shifts.reshape(NAV + (2,)),
        (1, "field"): shifts.reshape(NAV + (2,)),
        (1, "magnitude"): np.hypot(sy, sx),
        (1, "divergence"): dy_dy + dx_dx,
        (1, "curl"): dy_dx - dx_dy,
        (2, "intensity"): s1.reshape(SIG),
        (3, "intensity"): proj[:, k + 3].reshape(NAV),
        (4, "num_frames"): np.array([float(n)]),
        (4, "sum"): s1.reshape(SIG),
        (4, "mean"): mean.reshape(SIG),
        (4, "var"): var.reshape(SIG),
        (4, "std"): np.sqrt(var).reshape(SIG),
    }


def generic_udfs(lt):
    return [lt.LogsumUDF(),
            lt.FEMUDF(center=(64, 64), rad_in=20, rad_out=50),
            lt.SumUDF()]


def oracle_generic(data: np.ndarray, roi: np.ndarray) -> dict:
    """float64 answers of ``generic_udfs`` over the roi's frames, in
    chunks of frames."""
    flat = data.reshape(-1, SIG[0] * SIG[1])
    yy, xx = np.ogrid[0:SIG[0], 0:SIG[1]]
    d = np.sqrt((yy - 64) ** 2 + (xx - 64) ** 2)
    ring_idx = np.flatnonzero(((d > 20) & (d <= 50)).reshape(-1))
    sel = np.flatnonzero(roi.reshape(-1))
    fem = np.full(flat.shape[0], np.nan)

    def part(lo, ids):
        f = flat[ids].astype(np.float64)
        fem[ids] = f[:, ring_idx].std(axis=1)
        logs = np.log1p(f - f.min(axis=1, keepdims=True)).sum(axis=0)
        return logs, f.sum(axis=0)

    sums = in_chunks(sel, part)
    return {
        (0, "logsum"): sum(s[0] for s in sums).reshape(SIG),
        (1, "intensity"): fem.reshape(NAV),
        (2, "intensity"): sum(s[1] for s in sums).reshape(SIG),
    }


def check_results(label, res, want, failures, shift_floor=False) -> None:
    """Every result against its float64 answer.  Divergence and curl
    are differences of neighbouring shifts: their floor follows the
    field's magnitude.  With ``shift_floor`` (non-integer data, whose
    float32 sums round), everything derived from the centres of mass
    takes the centres' magnitude as its floor."""
    for (ui, name), ref in want.items():
        got = res[ui][name].data
        scale = None
        if shift_floor and ui == 1 and name in FROM_COM:
            scale = float(np.abs(want[(1, "raw_com")]).max())
        e, ok = max_err(got, ref, scale)
        if name in ("divergence", "curl") and not shift_floor:
            field_scale = float(np.abs(want[(1, "field")]).max())
            ok = bool(np.all(
                np.abs(np.asarray(got, np.float64) - ref)
                <= RTOL * max(field_scale, 1.0)
            ))
        print(f"  {label} result {ui}/{name}: max abs err {e:.3g} vs "
              f"float64")
        # finite where the answer is (nan outside a roi)
        finite = np.array_equal(np.isfinite(got), np.isfinite(ref))
        if not ok or not finite:
            failures.append(f"{label} result {ui}/{name}: max err {e}")


def device_busy(prof) -> dict:
    """Device time in µs by key: kernels and copies only (the CPU ops
    that launched them carry the same time again)."""
    return {
        evt.key: evt.self_device_time_total
        for evt in prof.key_averages()
        if str(evt.device_type).endswith("CUDA")
        and evt.self_device_time_total > 0
    }


def traced_run(ctx, ds, udfs, at, **kw) -> None:
    """One more run under torch.profiler: its wall, device activity and
    idle share, and the eight largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.run_udf(ds, udfs, **kw)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    device_us = device_busy(prof)
    busy_s = sum(device_us.values()) / 1e6
    print(f"trace: {traced_s:.3f} s wall, device activity "
          f"{busy_s:.4f} s = {busy_s / traced_s:.2%} of it (copies "
          f"and kernels summed; they may overlap), idle share "
          f"{1 - busy_s / traced_s:.2%} {at}")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {us / 1e3:9.3f} ms  {key[:90]}")


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


def bound(depth, pixels, n_masks, itemsize) -> tuple[float, str]:
    """Least ms of a fused_moments call: x, the masks and the outputs
    moved once over the HBM rate, or its FLOPs over the fp32 rate,
    whichever is larger."""
    moved = (depth * pixels * itemsize + n_masks * pixels * 4
             + depth * n_masks * 4 + 2 * pixels * 4)
    flops = depth * pixels * (2 * n_masks + 5)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOP_PER_S * 1e3
    if bytes_ms >= flops_ms:
        return bytes_ms, "bytes"
    return flops_ms, "operations"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.ops import build
    from libertem_tpu_torch.ops.moments import (
        MASK_GROUP,
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
        corrections = make_corrections(lt)
        corr_prep = UDFRunner(make_ring_udfs(lt))._prepare(
            ds, dev, corrections=corrections,
        )
        ring_masks_t = corr_prep["masks_t"]
        n_ring_masks = ring_masks_t.shape[0]
        groups = -(-n_ring_masks // MASK_GROUP)
        if corr_prep["fused"] is None or corr_prep["scheme"].depth != depth:
            failures.append("phase 6a does not take the fused path at the "
                            "main path's block depth")

        # -- 3. kernel against its plain version --------------------------
        rng = np.random.default_rng(SEED + 1)

        def case(name, x, valid, compute_var=True, masks=masks_t):
            x = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                 else x).to(dev)
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

        def random_masks(m):
            return torch.from_numpy(rng.normal(size=(m, pixels)).astype(
                np.float32)).to(dev)

        def corrected_block(seed):
            """What phase 6a gives the kernel: a u16 Poisson block with
            a padded tail, corrected on the card (the tail zeroed
            again)."""
            raw = np.random.default_rng(seed).poisson(
                8.0, (depth, pixels)).astype(np.uint16)
            raw[depth - 24:] = 0
            return UDFRunner([])._apply_corrections(
                torch.from_numpy(raw).to(dev), corr_prep, depth - 24
            )

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
        for m in (9, 12, 17, 40):
            checks[f"u16 M={m}"] = case(f"M={m}", poisson, depth,
                                        masks=random_masks(m))
        checks[f"f32 corrected M={n_ring_masks} valid=D-24"] = case(
            "corrected", corrected_block(SEED + 4), depth - 24,
            masks=ring_masks_t,
        )
        checks["f64"] = case("f64", poisson.astype(np.float64), depth)
        checks["i64 tail"] = case("i64", tail.astype(np.int64), depth - 37)
        checks["f16"] = case(
            "f16", torch.from_numpy(poisson).to(torch.float16), depth,
        )
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
        check_results("main", res, want, failures)

        # steady-state rerun, for timing only
        t0 = time.perf_counter()
        ctx.run_udf(ds, make_udfs(lt))
        torch.cuda.synchronize()
        e2e2_s = time.perf_counter() - t0
        feed2 = dict(ctx.feed_stats)
        traced_run(ctx, ds, make_udfs(lt), at)

        # -- 5. timings --------------------------------------------------------
        u16_blocks = [
            torch.from_numpy(np.random.default_rng(SEED + 2 + i).poisson(
                8.0, (depth, pixels)).astype(np.uint16)).to(dev)
            for i in range(4)
        ]
        f32_blocks = [corrected_block(SEED + 10 + i) for i in range(4)]

        def library(x, m, valid):
            xf = x.float()
            return xf @ m.T, torch.var_mean(xf, dim=0, correction=0)

        def timed(label, blocks, m, valid):
            inputs = [(b, m, valid) for b in blocks]
            k_ms, k_eager_ms = time_ms(fused_moments, inputs)
            p_ms, p_eager_ms = time_ms(fused_moments_reference, inputs)
            l_ms, _ = time_ms(library, inputs)
            itemsize = blocks[0].element_size()
            b_ms, b_by = bound(depth, pixels, m.shape[0], itemsize)
            x_bytes = depth * pixels * itemsize
            print(f"kernel fused_moments, {label}: {k_ms:.4f} ms per block "
                  f"({x_bytes / k_ms / 1e6:.1f} GB/s of input), bound "
                  f"{b_ms:.4f} ms by {b_by} ({b_ms / k_ms:.1%} of it); "
                  f"launched from Python one by one {k_eager_ms:.4f} ms "
                  f"{at}")
            print(f"  plain version: {p_ms:.4f} ms (one by one "
                  f"{p_eager_ms:.4f} ms); library expression (matmul + "
                  f"var_mean, yardstick only): {l_ms:.4f} ms {at}")
            return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": l_ms}

        main_t = timed("u16 M=6 (main path)", u16_blocks, masks_t, depth)
        cases = [
            dict(case="u16 M=12", launches_per_2GiB_run=n_blocks * 2,
                 **timed("u16 M=12", u16_blocks, random_masks(12), depth)),
            dict(case="u16 M=40", launches_per_2GiB_run=n_blocks * 5,
                 **timed("u16 M=40", u16_blocks, random_masks(40), depth)),
        ]
        corr_t = timed(f"f32 corrected M={n_ring_masks}", f32_blocks,
                       ring_masks_t, depth)
        total_bytes = data.nbytes
        for label, secs, stats in (("first", e2e_s, feed),
                                   ("second", e2e2_s, feed2)):
            print(f"end to end ({label} run): {secs:.3f} s for "
                  f"{total_bytes} bytes = {total_bytes / secs / 1e9:.2f} "
                  f"GB/s; host feed: reader {stats['read_s']:.3f} s, "
                  f"consumer waited {stats['wait_s']:.3f} s = "
                  f"{stats['wait_s'] / secs:.1%} of the wall time; kernel "
                  f"{main_t['ms'] * launches / 1e3:.4f} s of device time "
                  f"= {main_t['ms'] * launches / 1e3 / secs:.2%} of it "
                  f"{at}")

        # -- 6. the second slice's paths ------------------------------------
        def report(label, secs, nbytes, stats):
            print(f"{label}: {secs:.3f} s wall for {nbytes} bytes read = "
                  f"{nbytes / secs / 1e9:.2f} GB/s; feed_stats "
                  f"{json.dumps(stats)} {at}")

        # (a) fused, corrected, 12 mask rows
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, make_ring_udfs(lt), corrections=corrections)
        torch.cuda.synchronize()
        corr_s = time.perf_counter() - t0
        corr_launches = fused_moments.launches
        report("6a fused + corrections, M=12", corr_s, total_bytes,
               ctx.feed_stats)
        if corr_launches != n_blocks * groups:
            failures.append(
                f"6a launched fused_moments {corr_launches} times, "
                f"expected {n_blocks} blocks x {groups} mask groups"
            )
        t0 = time.perf_counter()
        want = oracle(data, ring_stack(lt),
                      corrections.make_plan(SIG))
        print(f"oracle 6a: {time.perf_counter() - t0:.1f} s (float64 "
              f"numpy, corrected in float64)")
        check_results("6a", res, want, failures, shift_floor=True)
        traced_run(ctx, ds, make_ring_udfs(lt), at,
                   corrections=corrections)

        # (b) generic, half the scan, then Pick over 5 frames
        roi = np.zeros(NAV, dtype=bool)
        roi[:, :NAV[1] // 2] = True
        pick_ids = np.sort(np.random.default_rng(SEED + 5).choice(
            int(np.prod(NAV)), 5, replace=False))
        pick_roi = np.zeros(int(np.prod(NAV)), dtype=bool)
        pick_roi[pick_ids] = True

        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, generic_udfs(lt), roi=roi)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        n_sel = int(roi.sum())
        report("6b generic, roi of half the scan", gen_s,
               n_sel * pixels * 2, ctx.feed_stats)
        t0 = time.perf_counter()
        pick = ctx.run_udf(ds, lt.PickUDF(), roi=pick_roi.reshape(NAV))
        torch.cuda.synchronize()
        pick_s = time.perf_counter() - t0
        report("6b PickUDF, roi of 5 frames", pick_s, 5 * pixels * 2,
               ctx.feed_stats)
        if fused_moments.launches != 0:
            failures.append(f"6b launched fused_moments "
                            f"{fused_moments.launches} times, expected 0")
        gen_launches = fused_moments.launches

        t0 = time.perf_counter()
        want = oracle_generic(data, roi)
        print(f"oracle 6b: {time.perf_counter() - t0:.1f} s (float64 numpy)")
        check_results("6b", res, want, failures)
        picked = pick["intensity"].data
        if picked.dtype != np.uint16 or not np.array_equal(
            picked, data.reshape(-1, *SIG)[pick_ids]
        ):
            failures.append("6b PickUDF is not bit for bit the frames")
        else:
            print("  6b result pick: 5 frames bit for bit, uint16")
        traced_run(ctx, ds, generic_udfs(lt), at, roi=roi)

    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    cases.append(dict(
        case=f"f32 corrected M={n_ring_masks} (path 6a)",
        launches_per_2GiB_run=corr_launches, **corr_t,
    ))
    print(json.dumps({"kernels": [dict(
        name="fused_moments",
        route="cuda",
        source="libertem_tpu_torch/csrc/fused_moments.cu",
        replaces="libertem_tpu/ops/moments.py:135",
        launches=launches,
        max_abs_err=kernel_max_err,
        **main_t,
        checks={name: err for name, (_, err) in checks.items()},
        launches_by_path={
            "main (phase 4)": launches,
            "fused + corrections, M=12 (phase 6a)": corr_launches,
            "generic + roi (phase 6b)": gen_launches,
        },
        cases=cases,
    )]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
