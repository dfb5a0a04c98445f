#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one CUDA card.

    python3 chip_smoke.py

from the root of the repository.  Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``libertem_tpu_torch/csrc`` with nvcc and the host
   decoders with g++;
2. write the full-size dataset: a raw u16 file, nav (256, 256),
   sig (128, 128), Poisson(8) counts from a numpy seed (2 GiB), to a
   temporary directory;
3. hold every kernel against its plain PyTorch version on the card at
   the shapes the paths give it, and on the contract cases (tails,
   constant data, variance off, more than 8 mask rows, a corrected
   float32 block, f64 / i64 / f16 input), and check that three calls
   and a CUDA-graph replay of captured calls give identical bits;
4. run the main path through the public API -- ``Context().load("raw",
   ...)`` and ``run_udf`` with ApplyMasksUDF (BF disk + ADF ring),
   CoMUDF, SumUDF, SumSigUDF and StdDevUDF -- with the kernels' launch
   counts set to 0 just before and read just after, and check every
   result against a float64 numpy oracle; trace one more run with
   torch.profiler for device time by kernel and copy, and check that
   the trace holds one partials and one combine kernel a block;
5. time the kernel, its plain version and a PyTorch expression of the
   same outputs on the paths' blocks (u16 with 6, 12 and 40 mask rows;
   the corrected float32 block), beside the earlier design's times and
   the predicted ones; the kernel at other CTA tiles than the grid
   plan's (a grid sweep); and the end-to-end run;
6. the second slice's paths on the same scan, each with the launch
   counts set to 0 just before and read just after, checked against
   float64 numpy oracles and traced once more:
   (a) the fused path with detector corrections (dark, gain, 20
       excluded pixels) and 12 mask rows: ApplyMasksUDF with 8 rings,
       CoMUDF, SumUDF, SumSigUDF, StdDevUDF; the kernel runs once
       per block (one partials launch for any mask count);
   (b) the generic path with a roi: LogsumUDF, FEMUDF and SumUDF over
       half the scan, then PickUDF over 5 frames (bit for bit); no
       fused kernel launches;
7. the fifth slice's paths on the same scan, each with the launch
   counts set to 0 just before and read just after, checked against
   float64 / complex128 numpy oracles and traced once more:
   (a) sparse virtual detectors, fused: the BF disk and 16 small disks
       (``sparse_circular_multi_stack``), M = 17, whose compaction plan
       keeps 45 of 128 pixel blocks; the run compacts where that pays
       on the card.  The kernel is held against its plain version on a
       gathered block; the gather, the kernel there and on the whole
       frame are timed apart, and a fill sweep times compaction against
       the whole frame for the kernel and for the generic path's
       matmul;
   (b) both engines in one read pass: Sum + StdDev + ApplyMasks (BF),
       fused, beside a numpy UDF (per-frame and per-pixel maxima, numpy
       in-place merge) on the host engine, exact;
   (c) the generic path with a roi of half the scan: ApplyMasks (BF)
       with per-frame shifts as aux data, 16 complex ring-harmonic
       masks, and a device UDF with preprocess and postprocess.
   No library UDF may run on the host engine in any phase;
8. live partial results on the same scan: the main path's five UDFs
   through ``Context.run_udf_iter`` with a counting progress reporter,
   the launch count set to 0 just before and read just after; every
   partial's merged nav rows against the float64 oracle; after the
   second partial ApplyMasks is patched to another ring, and the final
   result is held against the old masks' oracle before the patch and
   the new masks' after it; then a second iterator is abandoned after
   its first partial, and its reader thread must have ended;
9. the stage ablation of the fused-moments kernel
   (``ops/ablation.py``): every stage held against its plain version on
   the card and the full stage bit for bit against ``fused_moments`` at
   three shapes (the main path's block, M = 40, and the compacted
   P = 5760, M = 17), each stage timed there with the launch count set
   to 0 just before and read just after; then the entry point
   ``python -m libertem_tpu_torch.ops.ablation`` once;
10. the analyses on the same scan, each through the API a user calls
    with the launch count set to 0 just before and read just after,
    printing its wall time, GB/s, whether it ran fused and its launches:
    the 15 analysis ids through ``Context.run`` (MASKS with a BF disk,
    an ADF ring and a gradient; RADIAL_FOURIER with 2 bins and 8
    orders, 18 complex masks; CLUST's two device passes, the std map
    and 42 templates, without the clustering); a GUI roi over a quarter
    of the scan; CoMUDF with the regressions SUBTRACT_MEAN and
    SUBTRACT_LINEAR; ``Context.map`` with a torch and a numpy function
    over a quarter; RecordUDF writing a quarter to a ``.npy`` file.
    Every result channel against float64 (complex128) numpy answers,
    the regression's coefficients against ``np.linalg.lstsq``, the
    recorded file bit for bit; CLUST's feature pass and APPLY_FFT_MASK
    traced once more;
11. the FFT UDFs and the dataset core: a 2 GiB CBED scan through
    ``run_blobfinder`` and the correlation UDFs, 256 holograms through
    HoloReconstructUDF, and phase 4's scan under a sync offset, an
    inferred nav, each io backend, as a big-endian quarter (swapped in
    place by the C++ byteswap) and through the tile stream;
12. the detector formats, each written from phase 2's counts by the
    format's own layout, loaded with ``Context().load`` and run with the
    main path's five UDFs at its sig with the launch count set to 0
    just before and read just after: MIB r12, r1, r6 (256 x 256, nav
    128 x 128), r24 (nav 64 x 64) and a 2x2 quad at r12 (512 x 512),
    K2IS (8 sectors, 1860 x 2048, nav 16 x 16), FRMS6 with its dark
    file (264 x 264), EMPAD, SEQ, TVIPS, BLO, NPY, MRC, SER and DM4
    (256-512 MiB each).  Each against float64 numpy answers of the
    frames written, 5 frames bit for bit (PickUDF), detected by
    ``load("auto")``, with its wall time, GB/s, the reader's share, the
    consumer's wait and the C++ decode time a block; MIB r12 traced
    once more;
13. the last formats and the repaired API, each pass through
    ``Context`` with the launch count set to 0 just before and read
    just after, against float64 answers, with its wall time, GB/s, the
    reader's share and the consumer's wait: (a) raw CSR at
    event-counting scale (nav 256 x 256, sig 256 x 256, Poisson(400)
    single electrons a frame, about 160 MB on disk for 8 GiB of dense
    u16 frames), the blocks' entries densified on the card, against
    scipy.sparse answers, plain, under a sync offset and over half the
    scan, with the H2D bytes a block and the densify's device time;
    (b) phase 2's scan pushed by a producer thread into a live ring
    while ``run_udf_iter`` runs, then a producer that stops early, then
    an iterator abandoned while the producer stalls (its reader must
    end within 5 s); (c) the scan as an array-like (``np.memmap``);
    (d) the scan as chunked HDF5, where h5py imports; (e) a user tile
    UDF on the repaired API (``sig_slice.get(w, sig_only=True)``,
    ``results["..."]``, ``params.items()``) and SumUDF's
    ``raw_masked_data`` over half the scan under ``with Context()``;
14. the executors and what surrounds a run, on phase 2's scan with
    phase 4's UDFs against phase 4's float64 answers, each pass with the
    launch count set to 0 just before and read just after, printing its
    wall time, GB/s and launches: (a) ``Context.make_with("inline")``,
    ``make_with("sharded")`` (one card) and
    ``Context(executor=InlineJobExecutor())``, each with its
    ``run_udf:start``/``run_udf:end`` events, and the debug executor;
    (b) ``run_udf(sync=False)`` under ``asyncio.run``, ``run_udf_iter
    (sync=False)`` with two live plots (the BF image and CoM's field
    magnitude, recording every update), ``plots=True`` with
    ``Dummy2DPlot``, and an async iterator closed after two partials
    (its reader must end within 1 s); (c) the delayed executor: no
    launch and no read at return, one pass at the first access, none
    at the second; (d) ``export_dataset`` of the scan to ``.npy``
    (equal to the scan, then loaded and run again); (e)
    ``convert_transposed_to_npy`` of a 256 MiB (sig, nav)-ordered cut;
    (f) snooze: an idle check releases the caching allocator's blocks,
    the next run wakes it; (g) the four example scripts with
    ``libertem_tpu`` replaced by ``libertem_tpu_torch``;
15. the multi-device loop on card 0, on phase 2's scan with phase 4's
    UDFs against its float64 answers, each pass with the launch count
    set to 0 just before and read just after, printing its wall time,
    GB/s, each worker's reader share and its launches: (a) one device,
    ``ShardedJobExecutor(devices=[cuda:0, cuda:0])`` and
    ``make_with("sharded", tpus=[0, 0, 0, 0])``, twice in turns, 64
    launches each, the two- and four-worker passes traced once more,
    and one more pass printing ``last_sharded_stats``;
    (b) 6a's corrections (M = 12) over a roi of every third frame on 2
    workers; (c) ``run_udf_iter`` on 2 workers with phase 8's patch
    after the second partial (one partial a super-step), then an
    iterator abandoned after two partials (its readers must end within
    1 s); (d) 7b's numpy UDF beside the fused pass on 2 workers; (e)
    13b's live ring on 2 workers (block-cyclic shards), whole and with
    an early ``finish()``; (f) one pass over every card, where there
    are several;
16. the multi-process run: two processes (``chip_smoke.py --rank``) on
    card 0 in one ``torch.distributed`` group over gloo (NCCL refuses
    two processes on one card), each reading and stepping only its own
    workers' shards of phase 2's scan, the states gathered through
    pinned host copies: (a) phase 4's UDFs with one and with two workers
    a process, (b) 15(b)'s corrections over every third frame, (c)
    15(c)'s ``run_udf_iter`` with the patch, one worker a process, (d)
    7b's numpy UDF, refused on both.  Each process's results against
    the float64 answers and bit for bit against phase 15's pass at the
    same global worker count; the two processes' launches add up to
    that pass's (64, 64, 44, 64); wall time, each process's
    ``collective_s`` and the transport are printed;
17. the web GUI's path on phase 2's scan with phase 10's parameters and
    float64 answers, each job with the launch count set to 0 just
    before and read just after: (a) the port's ``SharedState`` and
    ``JobEngine`` with a registry that records every broadcast, the
    ``"local"`` connection (the card), the scan opened as RAW through
    the GUI's converter; one job each of SUM_FRAMES, SUM_SIG,
    SD_FRAMES, APPLY_DISK_MASK, APPLY_RING_MASK and CENTER_OF_MASS
    (phase 10's launches), CoM again with only ``flip_y`` changed (no
    pass: 0 launches), a DISK job cancelled at its first partial
    (fewer launches, CANCEL_JOB_DONE, its readers ended within 5 s),
    CLUST through its controller (phase 10's feature passes; its
    clustering where scikit-learn imports); (b) where tornado imports,
    ``make_app`` served on 127.0.0.1 and driven over REST and the
    websocket, the NPZ downloads bit for bit (a)'s; (c) the notebook
    the GUI generates for (a)'s DISK and CoM, its cells run here, its
    results bit for bit (a)'s.  Wall time, GB/s, launches, TASK_RESULT
    headers and image frames a job are printed;
18. the drop-in ``libertem`` namespace, in processes started through
    ``python -m libertem_tpu_torch.dropin``: (a) ``import libertem.api
    as lt``, phase 4's UDFs by their reference spellings and
    ``lt.Context()`` (the card) over phase 2's scan, the launch count
    set to 0 just before the pass and read just after, its results bit
    for bit phase 4's with phase 4's launches, the import time and the
    pass's wall printed; (b) the four example scripts with
    ``libertem_tpu`` rewritten to ``libertem``, each with its own
    asserts; (c) the reference spellings of ``tests/test_dropin.py``
    each the port's object, ``set_use_cuda(0)`` pinning card 0, and
    neither jax nor the JAX package imported in any of them;
19. the reduced-precision modes (``precision_phase``): (a) phase 4's
    pass under ``LIBERTEM_TPU_TORCH_MATMUL_PRECISION=default`` (one
    TF32 pass), its launches and every result bit for bit phase 4's;
    (b) one-pass kernel calls at u16 M = 6, 12, 40 with random normal
    masks, the corrected f32 block at M = 12 and M = 17 on the whole
    frame, against the plain version on TF32-rounded operands and a
    float64 product, colsum and colvar the three-pass call's bits,
    graph replays bit for bit; (c) those cases timed in both modes
    beside the one-pass bound; (d) 6a's pass with the variable flipped
    between two runs: one pass, then three (6a's bits); (e)
    ``ApplyMasksUDF(use_bf16=True)`` over the scan with random float
    masks: no fused launch, float32, against the float32 generic run
    and a float64 product of the bf16-rounded operands, its wall beside
    the float32 run's, the bf16 product's routes timed on a block; (f)
    the malloc tune: phase 2's scan and 12a's MIB r12 file read in a
    child process with it and in one without it
    (``LIBERTEM_TPU_TORCH_NO_MALLOC_TUNE=1``), reader GB/s side by side.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card the script exits non-zero and prints no result.

Two other entry points: ``python3 chip_smoke.py --every-card`` drives
the multi-device loop over every card of a host with several, and
phase 16 over NCCL with a process a card (:func:`every_card_main`),
and ``python3 chip_smoke.py --time-paths DIR
SCAN`` times the end-to-end passes of the checkout at DIR, for
comparing two checkouts in turns on one card (:func:`time_paths_main`).
``--rank SPEC`` is the mode of phase 16's processes
(:func:`rank_main`), ``--dropin-child SPEC`` that of phase 18's
(:func:`dropin_child_main`, run through the drop-in's runner) and
``--reader-child SPEC`` that of 19(f) (:func:`reader_child_main`).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NAV = (256, 256)
SIG = (128, 128)
SEED = 0
# H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores
# and the dense TF32 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# float32 against float32 with another summation order, or against a
# float64 oracle: relative 1e-5, with an absolute floor of 1e-5 of the
# largest magnitude for entries near zero
RTOL = 1e-5
CRTOL = 1e-4
# results derived from centres of mass (differences com - c): their
# absolute floor follows the centres' magnitude, not their own
FROM_COM = ("raw_shifts", "field", "magnitude", "divergence", "curl")
# ms a block of the earlier design of fused_moments (fp32 FMA on the
# CUDA cores, a launch per 8 mask rows; H100 80GB HBM3 at 700 W, PERF.md
# section 6), and what the tensor-core design was predicted to take
# (PERF.md section 6), printed beside this run's times
EARLIER_MS = {
    "u16 M=6 (main path)": 0.0270, "u16 M=12": 0.0492, "u16 M=40": 0.1209,
    "f32 corrected M=12": 0.0622, "u16 M=17 whole frame (7a)": 0.0630,
    "u16 compacted M=17 P=45x128": 0.0337,
}
PREDICTED_MS = {
    "u16 M=6 (main path)": 0.0245, "u16 M=12": 0.0285, "u16 M=40": 0.0375,
    "f32 corrected M=12": 0.0425, "u16 M=17 whole frame (7a)": 0.0290,
    "u16 compacted M=17 P=45x128": 0.0200,
}
# the same for the stages load_min .. full of phase 9 (predicted at the
# main path's block only)
EARLIER_STAGE_MS = {
    "u16 M=6 P=16384 (main path)":
        (0.0141, 0.0149, 0.0153, 0.0196, 0.0224, 0.0280),
    "u16 M=40 P=16384": (0.0395, 0.0403, 0.0490, 0.1068, 0.1127, 0.1219),
    "u16 M=17 P=5760 (compacted)":
        (0.0195, 0.0189, 0.0217, 0.0274, 0.0341, 0.0417),
}
PREDICTED_STAGE_MS = {
    "u16 M=6 P=16384 (main path)":
        (0.0140, 0.0150, 0.0155, 0.0175, 0.0203, 0.0259),
}


def beside(ms, earlier, predicted) -> str:
    """A time with the earlier design's and the predicted one."""
    if earlier is None:
        return ""
    return (f" (earlier design {earlier:.4f} ms, {ms / earlier:.2f}x; "
            + ("not predicted)" if predicted is None
               else f"predicted {predicted:.4f} ms)"))


def tensor_core_kernels() -> tuple[int, int, bool]:
    """From the built libraries' SASS (``cuobjdump -sass``): how many of
    the partials kernels that take the product (the production and the
    dot stage instantiations) hold HMMA instructions, how many there
    are, and whether the combine holds any."""
    from libertem_tpu_torch.ops import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = "".join(subprocess.run(
        [tool, "-sass", str(build.library_path(name))],
        capture_output=True, text=True, check=True, timeout=600).stdout
        for name in ("fused_moments", "fused_moments_wide",
                     "fused_moments_ablation"))
    product = with_hmma = 0
    combine = False
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        if "moments_combine" in name:
            combine = combine or "HMMA" in body
        # STAGE 3 (dot) and 5 (full): the third template argument, the
        # one-pass mode the fourth
        elif re.search(r"moments_partials.*Li[35]ELb[01]EEEv", name):
            product += 1
            with_hmma += "HMMA" in body
    return with_hmma, product, combine


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(got, want, scale=None, rtol=RTOL) -> tuple[float, bool]:
    """(max abs error, within tolerance) of two arrays or tensors;
    ``scale`` sets the absolute floor (default: want's magnitude).
    Complex arrays compare their real and imaginary parts."""
    got, want = np.asarray(got), np.asarray(want)
    if np.iscomplexobj(got) or np.iscomplexobj(want):
        got = np.stack([got.real, got.imag])
        want = np.stack([want.real, want.imag])
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    if got.shape != want.shape:
        return float("inf"), False
    if scale is None:
        scale = float(np.nanmax(np.abs(want), initial=0.0))
    scale = max(scale, 1.0)
    err = np.abs(got - want)
    ok = bool(np.all(
        (err <= rtol * np.abs(want) + rtol * scale)
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
    if plan["dark"] is not None:
        f -= plan["dark"].reshape(-1)
    if plan["gain"] is not None:
        f *= plan["gain"].reshape(-1)
    if plan["repair_idx"] is not None:
        f[:, plan["repair_idx"]] = (
            f[:, plan["nbr_idx"]] * plan["nbr_w"].astype(np.float64)
        ).sum(axis=-1)
    return f


def com_oracle(com: np.ndarray, nav=NAV, centre=(64.0, 64.0)) -> dict:
    """CoMUDF's float64 answers from the centres of mass ``com`` ((n, 2);
    the centre itself for a frame of no mass) around ``centre``."""
    shifts = com - np.asarray(centre, np.float64)
    sy = shifts[:, 0].reshape(nav)
    sx = shifts[:, 1].reshape(nav)
    dy_dy, dy_dx = np.gradient(sy)
    dx_dy, dx_dx = np.gradient(sx)
    return {
        (1, "raw_com"): com.reshape(nav + (2,)),
        (1, "raw_shifts"): shifts.reshape(nav + (2,)),
        (1, "field"): shifts.reshape(nav + (2,)),
        (1, "magnitude"): np.hypot(sy, sx),
        (1, "divergence"): dy_dy + dx_dx,
        (1, "curl"): dy_dx - dx_dy,
    }


def centres_of_mass(moments: np.ndarray, centre) -> np.ndarray:
    """(n, 2) centres from (n, 3) moments (mass, y mass, x mass): the
    centre itself for a frame of no mass, as CoMUDF reports it."""
    com = np.empty((len(moments), 2))
    com[:] = centre
    np.divide(moments[:, 1:], moments[:, :1], out=com,
              where=moments[:, :1] != 0)
    return com


def oracle(data: np.ndarray, mask_stack: np.ndarray, plan=None,
           nav=NAV) -> dict:
    """float64 answers of ApplyMasks (``mask_stack``), CoM (r=32),
    Sum, SumSig and StdDev over a scan of ``nav`` (sig ``SIG``)."""
    flat = data.reshape(-1, SIG[0] * SIG[1])
    return oracle_at(lambda lo, hi: flat[lo:hi], flat.shape[0], SIG, nav,
                     mask_stack, (64, 64), 32, plan)


def oracle_at(frames, n, sig, nav, mask_stack, centre, r, plan=None) -> dict:
    """float64 answers of ApplyMasks (``mask_stack``), CoM (radius ``r``
    around ``centre``), Sum, SumSig and StdDev over ``n`` frames of
    ``sig`` (``frames(lo, hi)``: frames lo..hi as (k, pixels), any
    dtype), corrected with the numpy ``plan`` when given; in chunks of
    frames on 8 threads, the per-pixel moments folded chunk by chunk
    with the Chan update."""
    h, w = sig
    k = mask_stack.shape[0]
    cy, cx = centre
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    disk = (((y - cy) ** 2 + (x - cx) ** 2) <= r ** 2).astype(np.float64)
    operand = np.concatenate([
        mask_stack.reshape(k, -1).astype(np.float64),
        np.stack([disk, y * disk, x * disk]).reshape(3, -1),
        np.ones((1, h * w)),
    ]).T
    proj = np.empty((n, k + 4))

    def part(lo, ids):
        f = frames64(frames(lo, lo + len(ids)).reshape(len(ids), -1), plan)
        proj[lo:lo + len(ids)] = f @ operand
        s1 = f.sum(axis=0)
        mean = s1 / len(ids)
        return len(ids), s1, mean, ((f - mean) ** 2).sum(axis=0)

    # integer counts keep these float64 sums exact
    count, s1, mean, m2 = 0, 0.0, 0.0, 0.0
    chunk = max(1, min(1024, (16 << 20) // (h * w)))
    for nb, sb, mb, m2b in in_chunks(np.arange(n), part, chunk):
        delta = mb - mean
        tot = count + nb
        mean = mean + delta * (nb / tot)
        m2 = m2 + m2b + delta * delta * (count * nb / tot)
        count = tot
        s1 = s1 + sb
    var = m2 / n
    return {
        (0, "intensity"): proj[:, :k].reshape(nav + (k,)),
        **com_oracle(centres_of_mass(proj[:, k:k + 3], (cy, cx)), nav,
                     (cy, cx)),
        (2, "intensity"): s1.reshape(sig),
        (3, "intensity"): proj[:, k + 3].reshape(nav),
        (4, "num_frames"): np.array([float(n)]),
        (4, "sum"): s1.reshape(sig),
        (4, "mean"): mean.reshape(sig),
        (4, "var"): var.reshape(sig),
        (4, "std"): np.sqrt(var).reshape(sig),
    }


DISK_CENTRES = [46, 58, 70, 82]


def sparse_stack(lt) -> np.ndarray:
    """The BF disk and 16 disks of radius 4 on a grid: (17, h, w)."""
    h, w = SIG
    disks = lt.masks.sparse_circular_multi_stack(
        np.arange(16), np.repeat(DISK_CENTRES, 4), np.tile(DISK_CENTRES, 4),
        w, h, 4,
    )
    return np.concatenate([lt.masks.circular(64, 64, w, h, 16)[None],
                           np.asarray(disks)]).astype(np.float64)


def sparse_udfs(lt):
    h, w = SIG
    return [
        lt.ApplyMasksUDF(mask_factories=[
            lambda: lt.masks.circular(64, 64, w, h, 16)]),
        lt.ApplyMasksUDF(mask_factories=lambda: sparse_stack(lt)[1:],
                         mask_count=16),
    ]


def mixed_udfs(lt):
    """Sum, StdDev and BF (fused, on the device) beside a numpy UDF."""
    h, w = SIG

    class FrameAndPixelMaxUDF(lt.udf.UDF):
        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def get_result_buffers(self):
            return {"frame_max": self.buffer(kind="nav", dtype="float32"),
                    "pixel_max": self.buffer(kind="sig", dtype="float32")}

        def process_tile(self, tile):
            self.results.frame_max[:] = tile.max(axis=(1, 2))
            np.maximum(self.results.pixel_max, tile.max(axis=0),
                       out=self.results.pixel_max)

        def merge(self, dest, src):
            # a custom merge writes the nav buffers too
            dest.frame_max[:] = src.frame_max
            np.maximum(dest.pixel_max, src.pixel_max, out=dest.pixel_max)

    return [lt.SumUDF(), lt.StdDevUDF(),
            lt.ApplyMasksUDF(mask_factories=[
                lambda: lt.masks.circular(64, 64, w, h, 16)]),
            FrameAndPixelMaxUDF()]


def ring_harmonics(lt) -> np.ndarray:
    """4 rings of width 16 around the centre x orders 0..3 of
    exp(i phi): (16, h, w) complex64."""
    h, w = SIG
    r, phi = lt.masks.polar_map(64, 64, w, h)
    rings = np.stack([(r >= lo) & (r < lo + 16) for lo in (0, 16, 32, 48)])
    orders = np.arange(4)[:, None, None]
    return (rings[:, None] * np.exp(1j * orders * phi)).reshape(
        16, h, w).astype(np.complex64)


def frame_shifts() -> np.ndarray:
    """Per-frame integer (dy, dx) in [-3, 3], from the seed."""
    return np.random.default_rng(SEED + 6).integers(
        -3, 4, (int(np.prod(NAV)), 2))


def spot_stack(lt) -> np.ndarray:
    """4 disks of radius 3 around the centre: rows 58-70, a fill of 13
    of 128 blocks, where compaction pays for the generic path's matmul
    on the card: (4, h, w)."""
    h, w = SIG
    return np.asarray(lt.masks.sparse_circular_multi_stack(
        np.arange(4), [61, 61, 67, 67], [61, 67, 61, 67], w, h, 3))


def generic_aux_udfs(lt):
    h, w = SIG
    harmonics = ring_harmonics(lt)

    class ScaledSumSigUDF(lt.udf.UDF):
        """preprocess sets the scale process_tile uses; postprocess
        doubles the partition's rows back."""

        def get_backends(self):
            return (self.BACKEND_TORCH,)

        def get_result_buffers(self):
            return {"intensity": self.buffer(kind="nav", dtype="float32")}

        def preprocess(self):
            self._scale = 0.5

        def process_tile(self, tile):
            self.results.intensity += tile.sum(dim=(1, 2)) * self._scale

        def postprocess(self):
            self.results.intensity[:] *= 2

    return [
        lt.ApplyMasksUDF(
            mask_factories=[lambda: lt.masks.circular(64, 64, w, h, 16)],
            shifts=lt.udf.UDF.aux_data(frame_shifts(), kind="nav",
                                       extra_shape=(2,), dtype=np.int64)),
        lt.ApplyMasksUDF(mask_factories=lambda: harmonics, mask_count=16),
        ScaledSumSigUDF(),
        lt.ApplyMasksUDF(mask_factories=lambda: spot_stack(lt),
                         mask_count=4),
    ]


def projections64(data, operand, ids) -> np.ndarray:
    """float64 ``frames @ operand.T`` over the frames ``ids``, in
    chunks; ``operand`` (k, pixels)."""
    flat = data.reshape(-1, SIG[0] * SIG[1])
    out = np.empty((len(ids), operand.shape[0]))

    def part(lo, chunk):
        out[lo:lo + len(chunk)] = flat[chunk].astype(np.float64) @ operand.T

    in_chunks(ids, part)
    return out


def shifted_masks(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 49 shifts (dy, dx) in [-3, 3]^2 and ``mask`` moved by each,
    zero-filled: projecting a frame moved by (-dy, -dx) on ``mask`` is
    projecting the frame on ``mask`` moved by (dy, dx)."""
    h, w = mask.shape
    shifts = np.array([(dy, dx) for dy in range(-3, 4)
                       for dx in range(-3, 4)])
    out = np.zeros((len(shifts), h, w))
    for k, (dy, dx) in enumerate(shifts):
        out[k, max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)] = \
            mask[max(0, -dy):min(h, h - dy), max(0, -dx):min(w, w - dx)]
    return shifts, out


def oracle_generic_aux(lt, data, roi) -> dict:
    """float64 / complex128 answers of ``generic_aux_udfs`` over the
    roi's frames: one projection per frame on 49 shifted BF disks, the
    16 harmonics (real and imaginary rows), a ones row and the 4
    spots."""
    h, w = SIG
    shifts, moved = shifted_masks(
        lt.masks.circular(64, 64, w, h, 16).astype(np.float64))
    harm = ring_harmonics(lt).astype(np.complex128).reshape(16, -1)
    operand = np.concatenate([moved.reshape(49, -1), harm.real, harm.imag,
                              np.ones((1, h * w)),
                              spot_stack(lt).reshape(4, -1)])
    sel = np.flatnonzero(roi.reshape(-1))
    proj = projections64(data, operand, sel)
    fs = frame_shifts()[sel]
    which = (fs[:, 0] + 3) * 7 + (fs[:, 1] + 3)
    nan = np.full(int(np.prod(NAV)), np.nan)

    def full(rows):
        out = np.full((int(np.prod(NAV)),) + rows.shape[1:], np.nan,
                      dtype=rows.dtype)
        out[sel] = rows
        return out.reshape(NAV + rows.shape[1:])

    nan[sel] = proj[np.arange(len(sel)), which]
    return {
        (0, "intensity"): nan.reshape(NAV + (1,)),
        (1, "intensity"): full(proj[:, 49:65] + 1j * proj[:, 65:81]),
        (2, "intensity"): full(proj[:, 81]),
        (3, "intensity"): full(proj[:, 82:86]),
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
        # complex64 sums against complex128: relative 1e-4 of the
        # largest magnitude
        e, ok = max_err(got, ref, scale,
                        CRTOL if np.iscomplexobj(ref) else RTOL)
        if name in ("divergence", "curl") and not shift_floor:
            # (nan outside a roi, in both)
            field_scale = float(np.nanmax(np.abs(want[(1, "field")])))
            diff = np.abs(np.asarray(got, np.float64) - ref)
            ok = bool(np.all(
                (diff <= RTOL * max(field_scale, 1.0))
                | (np.isnan(got) & np.isnan(ref))
            ))
        print(f"  {label} result {ui}/{name}: max abs err {e:.3g} vs "
              f"float64")
        # finite where the answer is (nan outside a roi)
        finite = np.array_equal(np.isfinite(got), np.isfinite(ref))
        if not ok or not finite:
            failures.append(f"{label} result {ui}/{name}: max err {e}")


def check_engines(label, ctx, host, failures) -> None:
    """The engine each UDF of the last run ran on: the host engine for
    the UDFs flagged in ``host`` (numpy UDFs) and for no other."""
    engines = ctx.run_info["engines"]
    want = ["host" if h else "device" for h in host]
    print(f"  {label} engines: {engines}")
    if engines != want:
        failures.append(f"{label} engines {engines}, expected {want}")


def device_busy(prof) -> dict:
    """Device time in µs by key: kernels and copies only (the CPU ops
    that launched them carry the same time again)."""
    return {
        evt.key: evt.self_device_time_total
        for evt in prof.key_averages()
        if str(evt.device_type).endswith("CUDA")
        and evt.self_device_time_total > 0
    }


def traced_run(ctx, ds, udfs, at, **kw) -> dict:
    """One more run under torch.profiler: its wall, device activity and
    idle share, and the eight largest device items.  Returns the count
    of each device item."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.run_udf(ds, udfs, **kw)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    device_us = device_busy(prof)
    counts = {evt.key: evt.count for evt in prof.key_averages()
              if evt.key in device_us}
    busy_s = sum(device_us.values()) / 1e6
    print(f"trace: {traced_s:.3f} s wall, device activity "
          f"{busy_s:.4f} s = {busy_s / traced_s:.2%} of it (copies "
          f"and kernels summed; they may overlap), idle share "
          f"{1 - busy_s / traced_s:.2%} {at}")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {us / 1e3:9.3f} ms  {key[:90]}")
    return counts


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


def bound(depth, pixels, n_masks, itemsize, passes=3) -> tuple[float, str]:
    """Least ms of a fused_moments call: x, the masks and the outputs
    moved once over the HBM rate, or its arithmetic: the product's
    TF32 passes that these inputs need (``tf32_passes``, three at
    most) over the tensor cores' rate, or the moments' ~5 FLOPs a
    pixel over the fp32 rate, whichever takes longer; whichever of
    bytes and arithmetic is larger."""
    moved = (depth * pixels * itemsize + n_masks * pixels * 4
             + depth * n_masks * 4 + 2 * pixels * 4)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(passes * 2 * depth * pixels * n_masks / TF32_FLOP_PER_S,
                 5 * depth * pixels / FP32_FLOP_PER_S) * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


SWEEP_FILLS = (4, 16, 45)  # support blocks (of 128) in the fill sweep
SWEEP_MASKS = (1, 17)


def fill_sweep(u16_blocks, f32_blocks, depth, at) -> None:
    """Compaction against the whole frame on the card.  For contiguous
    supports of ``SWEEP_FILLS`` of the frame's 128-pixel blocks and
    ``SWEEP_MASKS`` masks (random on the support, zero elsewhere): the
    gather plus the product on the gathered block against the product
    on the whole frame, for the fused kernel (u16 blocks, the fused
    path) and for the float32 matmul of ApplyMasks' generic path.
    Prints each pair and, per product, the largest fill up to which the
    compacted side won at every mask count, beside the limit the port
    uses on the card (``CUDA_MAX_FILL``)."""
    import torch
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.ops.sparse_masks import (
        CUDA_MAX_FILL,
        gather_blocks,
    )

    dev = u16_blocks[0].device
    pixels = u16_blocks[0].shape[1]
    nb = pixels // 128
    rng = np.random.default_rng(SEED + 7)
    wins = {"fused_moments": {}, "matmul": {}}
    for s in SWEEP_FILLS:
        lo, hi = (nb - s) // 2 * 128, ((nb - s) // 2 + s) * 128
        support = torch.arange(lo // 128, hi // 128, device=dev)
        for m in SWEEP_MASKS:
            masks = np.zeros((m, pixels), np.float32)
            masks[:, lo:hi] = rng.normal(size=(m, hi - lo))
            whole = torch.from_numpy(masks).to(dev)
            comp = whole[:, lo:hi].contiguous()
            op_whole, op_comp = whole.T.contiguous(), comp.T.contiguous()
            routes = {
                "fused_moments": (
                    u16_blocks,
                    lambda x: fused_moments(x, whole, depth,
                                            compute_var=False),
                    lambda x: fused_moments(gather_blocks(x, support), comp,
                                            depth, compute_var=False),
                ),
                "matmul": (
                    f32_blocks,
                    lambda x: x @ op_whole,
                    lambda x: gather_blocks(x, support) @ op_comp,
                ),
            }
            for route, (blocks, on_whole, on_comp) in routes.items():
                w_ms, _ = time_ms(on_whole, [(b,) for b in blocks])
                c_ms, _ = time_ms(on_comp, [(b,) for b in blocks])
                wins[route].setdefault(s, []).append(c_ms < w_ms)
                print(f"fill sweep, {route}: {s} of {nb} blocks, M={m}: "
                      f"whole frame {w_ms:.4f} ms, gather + compacted "
                      f"{c_ms:.4f} ms ({c_ms / w_ms:.2f}x) {at}")
    for route, by_fill in wins.items():
        pays = 0.0
        for s in SWEEP_FILLS:
            if not all(by_fill[s]):
                break
            pays = s / nb
        print(f"fill sweep, {route}: compaction won at every mask count "
              f"up to a fill of {pays:.4f}; the port compacts on the card "
              f"up to {CUDA_MAX_FILL[route]:.4f} {at}")


def grid_sweep(cases, depth, at, failures) -> None:
    """fused_moments at every CTA tile (pixels x rows) the kernel takes
    for the case, the grid plan's among them, per case ``(label,
    blocks, masks, compute_var)``: each tile held against the plain
    version once, then timed."""
    import torch
    from libertem_tpu_torch.ops.moments import (
        CHUNK_CHOICES,
        ROW_CHOICES,
        SMEM_LIMIT,
        Grid,
        _fused_moments_cuda,
        fused_moments_reference,
        grid_for,
        max_rows,
        smem_bytes,
    )

    for label, blocks, masks, cv in cases:
        n_masks = masks.shape[0]
        plan = grid_for(blocks[0], n_masks)
        pixels = blocks[0].shape[1]
        parts = []
        for chunk, rows in [(c, r) for c in CHUNK_CHOICES
                            for r in ROW_CHOICES]:
            if rows > max_rows(n_masks) or smem_bytes(
                    blocks[0].element_size(), n_masks, rows) > SMEM_LIMIT:
                continue
            grid = Grid(rows, -(-pixels // chunk), -(-depth // rows), chunk)

            def call(x, _g=grid):
                return _fused_moments_cuda(x, masks, depth, cv, _g)

            want = fused_moments_reference(blocks[0], masks, depth, cv)
            for part, g, w in zip(("y", "colsum", "colvar"),
                                  call(blocks[0]), want):
                e, ok = max_err(g.cpu(), w.cpu())
                if not ok:
                    failures.append(f"grid sweep {label} {rows} rows "
                                    f"{part}: max err {e}")
            ms, _ = time_ms(call, [(b,) for b in blocks])
            parts.append(f"{chunk}x{rows} ({grid.ctas} CTAs) {ms:.4f} ms"
                         + (" [plan]" if grid == plan else ""))
        print(f"grid sweep, {label}: " + ", ".join(parts) + f" {at}")
    torch.cuda.synchronize()


def readers_alive() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("block-reader") and t.is_alive()]


def partial_results(ctx, ds, lt, data, want4, failures) -> dict:
    """Phase 8: ``run_udf_iter`` over the scan with a parameter patch
    after the second partial, checked partial by partial; then an
    abandoned iterator.  Returns its launch count and times."""
    import torch
    from libertem_tpu_torch.common.progress import ProgressReporter
    from libertem_tpu_torch.ops.moments import fused_moments

    h, w = SIG
    n = int(np.prod(NAV))
    new_masks = np.stack([lt.masks.circular(64, 64, w, h, 16),
                          lt.masks.ring(64, 64, w, h, 30, 10)])

    class Frames(ProgressReporter):
        def __init__(self):
            self.updates = 0
            self.last = None

        def update(self, state):
            self.updates += 1

        def end(self, state):
            self.last = state

    reporter = Frames()
    partials = []
    fused_moments.launches = 0
    t0 = time.perf_counter()
    gen = ctx.run_udf_iter(ds, make_udfs(lt), progress=reporter)
    for i, res in enumerate(gen):
        # the merged rows' nav results, copied before the run goes on
        partials.append((np.array(res.damage.data).reshape(-1), {
            (ui, name): np.array(res.buffers[ui][name].data)
            for ui, name in ((0, "intensity"), (1, "raw_com"),
                             (1, "raw_shifts"), (1, "field"),
                             (1, "magnitude"), (3, "intensity"))
        }))
        if i == 1:
            gen.update_parameters_experimental([
                {"mask_factories": [lambda m=m: m for m in new_masks]},
                {}, {}, {}, {},
            ])
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - t0
    launches = fused_moments.launches
    final = res
    print(f"8 run_udf_iter: {len(partials)} partials, {launches} launches, "
          f"{reporter.updates} progress updates, end state "
          f"{tuple(reporter.last) if reporter.last else None}; fused "
          f"{ctx.run_info['fused']}")
    if len(partials) != 4:
        failures.append(f"8: {len(partials)} partials, expected 4")
    if reporter.last is None or reporter.last.num_frames_complete != n:
        failures.append(f"8: the reporter counted {reporter.last}, "
                        f"expected {n} frames")
    # the patched oracle: old masks before the patch (2 partitions of
    # n / 4 frames), the new masks after it
    cut = n // 2
    t0 = time.perf_counter()
    patched = want4[(0, "intensity")].reshape(n, 2).copy()
    patched[cut:] = projections64(data, new_masks.reshape(2, -1),
                                  np.arange(cut, n))
    print(f"oracle 8: {time.perf_counter() - t0:.1f} s (float64 numpy)")
    wants = {
        (0, "intensity"): patched,
        **{(1, k): want4[(1, k)].reshape(n, -1)
           for k in ("raw_com", "raw_shifts", "field")},
        (1, "magnitude"): want4[(1, "magnitude")].reshape(n, 1),
        (3, "intensity"): want4[(3, "intensity")].reshape(n, 1),
    }
    for k, (damage, bufs) in enumerate(partials):
        expect = np.arange(n) < (k + 1) * n // 4
        if not np.array_equal(damage, expect):
            failures.append(f"8 partial {k}: damage covers "
                            f"{int(damage.sum())} frames, expected "
                            f"{int(expect.sum())}")
            continue
        errs = []
        for key, ref in wants.items():
            got = bufs[key].reshape(n, -1)[damage]
            scale = (float(np.abs(wants[(1, "raw_com")]).max())
                     if key[0] == 1 else None)
            e, ok = max_err(got, ref[damage], scale)
            errs.append(e)
            if not ok:
                failures.append(f"8 partial {k} {key}: max err {e}")
        print(f"  8 partial {k}: {int(damage.sum())} merged frames, nav "
              f"results max abs err {max(errs):.3g} vs float64")
    want = {
        (0, "intensity"): patched.reshape(NAV + (2,)),
        **{key: ref for key, ref in want4.items() if key[0] != 0},
    }
    check_results("8 final", [final.buffers[ui] for ui in range(5)], want,
                  failures)
    # abandon a second iterator after its first partial
    gen = ctx.run_udf_iter(ds, make_udfs(lt))
    next(gen)
    alive_before = len(readers_alive())
    gen.close()
    del gen
    alive = readers_alive()
    print(f"  8 abandoned iterator: {alive_before} reader thread(s) alive "
          f"before close, {len(alive)} after")
    if alive:
        failures.append(f"8: reader threads alive after close: {alive}")
    return {"launches": launches, "iter_s": iter_s}


def stage_ablation(u16_blocks, masks_t, depth, dev, at, failures) -> dict:
    """Phase 9: every stage against its plain version and the full stage
    against fused_moments at three shapes, then every stage timed."""
    import torch
    from libertem_tpu_torch.ops.ablation import (
        STAGES,
        fused_moments_stage,
        fused_moments_stage_reference,
        measure,
    )
    from libertem_tpu_torch.ops.moments import fused_moments

    rng = np.random.default_rng(SEED + 9)

    def rand_masks(m, p):
        return torch.from_numpy(rng.normal(size=(m, p)).astype(
            np.float32)).to(dev)

    # 8 blocks of 11.25 MiB: more than the 50 MB L2 in all
    compacted = [torch.from_numpy(np.random.default_rng(SEED + 20 + i)
                                  .poisson(8.0, (depth, 45 * 128))
                                  .astype(np.uint16)).to(dev)
                 for i in range(8)]
    shapes = {
        "u16 M=6 P=16384 (main path)": (u16_blocks, masks_t),
        "u16 M=40 P=16384": (u16_blocks,
                             rand_masks(40, u16_blocks[0].shape[1])),
        "u16 M=17 P=5760 (compacted)": (compacted, rand_masks(17, 45 * 128)),
    }
    max_abs = 0.0
    for label, (blocks, masks) in shapes.items():
        x = blocks[0]
        tail = x.cpu().numpy()
        tail[depth - 37:] = 0
        tail = torch.from_numpy(tail).to(dev)
        for stage in STAGES:
            for name, block, valid in (("", x, depth),
                                       (" tail", tail, depth - 37)):
                got = fused_moments_stage(block, masks, valid, stage)
                want = fused_moments_stage_reference(block, masks, valid,
                                                     stage)
                for part, g, w in zip(("y", "colsum", "colvar"), got, want):
                    e, ok = max_err(g.cpu(), w.cpu())
                    max_abs = max(max_abs, e)
                    if not ok:
                        failures.append(f"9 {label} {stage}{name} {part}: "
                                        f"max err {e}")
        for a, b in zip(fused_moments_stage(x, masks, depth, "full"),
                        fused_moments(x, masks, depth)):
            if not torch.equal(a, b):
                failures.append(f"9 {label}: full stage is not "
                                f"fused_moments bit for bit")
    torch.cuda.synchronize()
    print(f"9 stages vs plain: max abs err {max_abs:.3g} (rtol {RTOL}); "
          f"full stage bit for bit against fused_moments")
    cases = []
    fused_moments_stage.launches = 0
    for label, (blocks, masks) in shapes.items():
        rows = measure(blocks, masks, depth,
                       timer=lambda fn, inputs: time_ms(fn, inputs)[0])
        prev = None
        for k, row in enumerate(rows):
            step = "" if prev is None else (
                f", +{row['ms'] - prev:.4f} ms over the stage before")
            lib = ("none" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
            print(f"stage {row['stage']:8s} {label}: {row['ms']:.4f} ms"
                  f"{step}; bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']}; plain {row['plain_ms']:.4f} ms; "
                  f"library {lib}"
                  + beside(row["ms"], EARLIER_STAGE_MS[label][k],
                           PREDICTED_STAGE_MS.get(label, [None] * 6)[k])
                  + f" {at}")
            prev = row["ms"]
            cases.append(dict(case=f"{label}, stage {row['stage']}", **row))
    launches = fused_moments_stage.launches
    if launches == 0:
        failures.append("9: the stage ablation launched no kernel")
    # the entry point a user calls, once
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "libertem_tpu_torch.ops.ablation"],
        capture_output=True, text=True, timeout=600,
    )
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    print(f"9 entry point: exit {out.returncode}, {len(lines)} stage lines "
          f"in {time.perf_counter() - t0:.1f} s")
    for ln in lines:
        print("  " + json.dumps(ln))
    if out.returncode != 0 or [next(iter(ln)) for ln in lines] != list(
            STAGES):
        failures.append(f"9 entry point: exit {out.returncode}, "
                        f"{out.stderr[-2000:]}")
    return {"launches": launches, "max_abs_err": max_abs, "cases": cases}


# -- phase 10: the analyses ---------------------------------------------------

# the ids whose run is fused in the JAX package's plan (held against the
# JAX runner, per id, by tests/test_torch_analyses.py)
FUSED_IDS = {"MASKS", "APPLY_DISK_MASK", "APPLY_RING_MASK",
             "APPLY_POINT_SELECTOR", "SUM_FRAMES", "SUM_SIG", "SD_FRAMES",
             "CENTER_OF_MASS", "FFTSUM_FRAMES", "CLUST"}


def analysis_params(lt) -> dict:
    """Parameters of each analysis id, scaled to the frame (at 128x128:
    BF disk r=16 and ADF ring 40..60 around the centre, CoM r=32, FEM
    ring 20..50, Fourier ring 4..40 behind a real-space disk of 16)."""
    h, w = SIG
    c = h // 2
    aperture = {"real_rad": h // 8, "real_centery": c, "real_centerx": c}
    return {
        "MASKS": {"factories": [
            lambda: lt.masks.circular(c, c, w, h, h // 8),
            lambda: lt.masks.ring(c, c, w, h, h * 15 // 32, h * 5 // 16),
            lambda: lt.masks.gradient_x(w, h),
        ]},
        "APPLY_DISK_MASK": {"cx": c, "cy": c, "r": h // 8},
        "APPLY_RING_MASK": {"cx": c, "cy": c, "ri": h * 5 // 16,
                            "ro": h * 15 // 32},
        "APPLY_POINT_SELECTOR": {"cx": c + h // 16, "cy": c - h // 8},
        "SUM_FRAMES": {},
        "SUM_SIG": {},
        "SD_FRAMES": {},
        "PICK_FRAME": {"x": NAV[1] * 3 // 10, "y": NAV[0] * 5 // 9},
        # phase 4's CoM disk, whose centres the oracle reuses
        "CENTER_OF_MASS": {"cx": c, "cy": c, "r": h // 4,
                           "scan_rotation": 15.0, "flip_y": True},
        "RADIAL_FOURIER": {"cx": c, "cy": c, "ri": h // 16,
                           "ro": h * 7 // 16, "n_bins": 2, "max_order": 8},
        "FEM": {"cx": c, "cy": c, "ri": h * 5 // 32, "ro": h * 25 // 64},
        "APPLY_FFT_MASK": {"rad_in": h // 32, "rad_out": h * 5 // 16,
                           **aperture},
        "PICK_FFT_FRAME": {"x": NAV[1] // 7, "y": NAV[0] * 7 // 9,
                           **aperture},
        "FFTSUM_FRAMES": dict(aperture),
        "CLUST": {},
    }


# the CoM regression runs: the whole frame's centre of mass (the frame's
# middle, for this scan) against a reference centre off it, so that the
# mean shift is far from 0
REG_CENTRE = (SIG[0] * 0.47, SIG[1] * 0.55)


def analysis_oracle(lt, data, analyses, want4) -> dict:
    """float64 (complex128) answers of phase 10 over every frame: the
    projections on every real mask row of the analyses (the complex
    radial Fourier stack as real and imaginary rows) and of the
    regression runs' CoM rows; FEM's per-frame ring std and
    APPLY_FFT_MASK's Fourier-ring intensity (scipy.fft); the moments
    and phase 4's CoM centres from ``want4``."""
    from scipy import fft as sfft

    from libertem_tpu_torch.analysis.fft import _fft_ring_mask, _real_aperture
    from libertem_tpu_torch.analysis.radialfourier import radial_fourier_masks
    from libertem_tpu_torch.udf.com import com_masks

    h, w = SIG
    n = int(np.prod(NAV))
    blocks, rows = [], {}

    def add(name, stack):
        stack = np.asarray(stack, dtype=np.float64).reshape(-1, h * w)
        start = sum(len(b) for b in blocks)
        rows[name] = slice(start, start + len(stack))
        blocks.append(stack)

    for id_ in ("MASKS", "APPLY_DISK_MASK", "APPLY_RING_MASK",
                "APPLY_POINT_SELECTOR"):
        add(id_, np.stack([f() for f in analyses[id_].get_mask_factories()]))
    add("SUM_SIG", np.ones((1, h * w)))
    add("REGRESSION", com_masks(SIG, *REG_CENTRE))
    p = analyses["RADIAL_FOURIER"].parameters
    rf = radial_fourier_masks(SIG, p["cx"], p["cy"], p["ri"], p["ro"],
                              p["n_bins"], p["max_order"]).astype(
        np.complex128)
    add("RF_REAL", rf.real)
    add("RF_IMAG", rf.imag)
    proj = projections64(data, np.concatenate(blocks), np.arange(n))
    p = analyses["FEM"].parameters
    yy, xx = np.ogrid[0:h, 0:w]
    d = np.sqrt((yy - p["cy"]) ** 2 + (xx - p["cx"]) ** 2)
    ring_idx = np.flatnonzero(((d > p["ri"]) & (d <= p["ro"])).reshape(-1))
    p = analyses["APPLY_FFT_MASK"].parameters
    fring = _fft_ring_mask(SIG, p["rad_in"], p["rad_out"]).astype(np.float64)
    ap = _real_aperture(SIG, p["real_rad"], p["real_centery"],
                        p["real_centerx"]).astype(np.float64)
    flat = data.reshape(n, h * w)

    def part(lo, ids):
        f = flat[ids].astype(np.float64)
        spec = np.abs(sfft.fft2(f.reshape(-1, h, w) * ap))
        return f[:, ring_idx].std(axis=1), (spec * fring).sum(axis=(1, 2))

    per_frame = in_chunks(np.arange(n), part)
    return {"proj": {k: proj[:, s] for k, s in rows.items()},
            "fem": np.concatenate([f for f, _ in per_frame]),
            "fftm": np.concatenate([m for _, m in per_frame]),
            "sum": want4[(2, "intensity")], "mean": want4[(4, "mean")],
            "var": want4[(4, "var")], "centres": want4[(1, "raw_com")]}


def com_channels(centres, centre, scan_rotation, flip_y) -> tuple:
    """float64 CoM shift fields of the (*nav, 2) ``centres`` relative
    to ``centre``, corrected as CoMAnalysis does (flip y, then
    rotate)."""
    sy = centres[..., 0] - centre[0]
    sx = centres[..., 1] - centre[1]
    theta = np.deg2rad(scan_rotation)
    if flip_y:
        sy = -sy
    return (sy * np.cos(theta) + sx * np.sin(theta),
            -sy * np.sin(theta) + sx * np.cos(theta))


def spectrum64(frame, p) -> np.ndarray:
    from libertem_tpu_torch.analysis.fft import _real_aperture
    ap = _real_aperture(SIG, p["real_rad"], p["real_centery"],
                        p["real_centerx"])
    return np.fft.fftshift(np.abs(np.fft.fft2(
        frame.astype(np.float64) * ap)))


def dominant64(coeffs, n_bins, max_order) -> tuple[np.ndarray, np.ndarray]:
    """RadialFourierAnalysis's dominant order in float64, and where it
    is decided by less than 1e-4 relative (two orders' magnitudes, or
    one and the threshold, that close): there float32 may decide the
    other way."""
    absolute = np.abs(coeffs.reshape(NAV + (n_bins, max_order + 1)))[..., 1:]
    threshold = absolute.reshape(-1, n_bins, max_order).max(axis=(0, 2)) * 0.2
    top2 = np.sort(absolute, axis=-1)[..., -2:]
    dominant = np.argmax(absolute, axis=-1) + 1.0
    dominant[np.all(absolute < threshold[:, None], axis=-1)] = 0.0
    near = ((top2[..., 1] - top2[..., 0]) <= 1e-4 * top2[..., 1]) | (
        np.abs(top2[..., 1] - threshold) <= 1e-4 * threshold)
    return dominant, near


def expected_channels(id_, analysis, o, data) -> dict:
    """key -> (float64 / complex128 answer, how it is held: "real",
    "complex", "phase", "exact", "dominant" or "field") of every result
    channel of ``id_``."""
    proj = o["proj"]
    p = analysis.parameters
    if id_ == "MASKS":
        return {f"mask_{i}": (proj[id_][:, i].reshape(NAV), "real")
                for i in range(proj[id_].shape[1])}
    if id_ in ("APPLY_DISK_MASK", "APPLY_RING_MASK",
               "APPLY_POINT_SELECTOR"):
        v = proj[id_][:, 0].reshape(NAV)
        return {"intensity": (v, "real"), "intensity_log": (v, "real")}
    if id_ == "SUM_FRAMES":
        return {"intensity": (o["sum"], "real"),
                "intensity_lin": (o["sum"], "real")}
    if id_ == "CLUST":
        return {"intensity": (np.sqrt(o["var"]), "real")}
    if id_ == "SUM_SIG":
        return {"intensity": (proj[id_][:, 0].reshape(NAV), "real")}
    if id_ == "SD_FRAMES":
        std = np.sqrt(o["var"])
        return {"intensity": (std, "real"), "intensity_lin": (std, "real"),
                "variance": (o["var"], "real"), "std": (std, "real"),
                "mean": (o["mean"], "real")}
    if id_ == "PICK_FRAME":
        frame = data[p["y"], p["x"]]
        return {"intensity": (frame, "exact"),
                "intensity_lin": (frame, "exact")}
    if id_ == "PICK_FFT_FRAME":
        return {"intensity": (spectrum64(data[p["y"], p["x"]], p), "real")}
    if id_ == "FFTSUM_FRAMES":
        return {"intensity": (spectrum64(o["sum"], p), "real")}
    if id_ == "FEM":
        return {"intensity": (o["fem"].reshape(NAV), "real")}
    if id_ == "APPLY_FFT_MASK":
        return {"intensity": (o["fftm"].reshape(NAV), "real")}
    if id_ == "CENTER_OF_MASS":
        fy, fx = com_channels(o["centres"], (p["cy"], p["cx"]),
                              p["scan_rotation"], p["flip_y"])
        return {
            "field": (np.stack([fx, fy]), "real"),
            "magnitude": (np.hypot(fy, fx), "real"),
            "divergence": (np.gradient(fy, axis=0) + np.gradient(fx, axis=1),
                           "field"),
            "curl": (np.gradient(fy, axis=1) - np.gradient(fx, axis=0),
                     "field"),
            "x": (fx, "real"), "y": (fy, "real"),
        }
    # RADIAL_FOURIER
    n_bins, max_order = p["n_bins"], p["max_order"]
    coeffs = proj["RF_REAL"] + 1j * proj["RF_IMAG"]
    dominant, near = dominant64(coeffs, n_bins, max_order)
    c = coeffs.reshape(NAV + (n_bins, max_order + 1))
    out = {}
    for b in range(n_bins):
        out[f"dominant_{b}"] = ((dominant[..., b], near[..., b]), "dominant")
        for k in range(max_order + 1):
            # the magnitude of a complex64 result: held as complex
            # results are (the orders above 0 are sums that cancel to
            # about 1/200 of their terms' magnitude)
            out[f"absolute_{b}_{k}"] = (np.abs(c[..., b, k]), "complex")
            if k > 0:
                out[f"phase_{b}_{k}"] = (c[..., b, k], "phase")
            out[f"complex_{b}_{k}"] = (c[..., b, k], "complex")
    return out


def check_channels(label, res, want, failures) -> float:
    """Every channel of an AnalysisResultSet against its answer (and no
    channel without one); returns the largest relative error seen."""
    worst = 0.0
    if list(res.keys()) != list(want):
        failures.append(f"{label}: channels {res.keys()}, expected "
                        f"{list(want)}")
        return float("inf")
    field_scale = None
    for r in res:
        ref, how = want[r.key]
        got = np.asarray(r.raw_data)
        if how == "exact":
            ok = got.dtype == ref.dtype and np.array_equal(got, ref)
            e = 0.0 if ok else float("inf")
        elif how == "dominant":
            ref, near = ref
            ok = got.shape == ref.shape and np.array_equal(
                got[~near], ref[~near])
            e = float(np.count_nonzero(got[~near] != ref[~near]))
            print(f"  {label} {r.key}: {int(near.sum())} positions "
                  f"decided within 1e-4 left out, {int(e)} others differ")
        elif how == "phase":
            # |c| times the angle error, against CRTOL of |c| and of the
            # largest |c|
            mag = np.abs(ref)
            d = np.angle(np.exp(1j * (got - np.angle(ref))))
            err = mag * np.abs(d)
            ok = bool(np.all(err <= CRTOL * (mag + mag.max())))
            e = float(err.max() / mag.max())
        else:
            scale = None
            if how == "field":
                scale = field_scale
            e, ok = max_err(got, ref, scale,
                            CRTOL if how == "complex" else RTOL)
            e = e / max(float(np.nanmax(np.abs(ref), initial=0.0)), 1.0)
            if r.key == "magnitude":
                field_scale = float(np.nanmax(np.abs(ref)))
        worst = max(worst, e)
        if not ok:
            failures.append(f"{label} {r.key}: error {e} ({how})")
    return worst


def analyses_phase(ctx, ds, lt, data, want4, tmp, at, failures,
                   keep=None) -> dict:
    """Phase 10: the 15 analysis ids through ``Context.run`` on the
    scan, a GUI roi, the CoM regression, ``Context.map`` and RecordUDF,
    each with the launch count set to 0 just before and read just
    after, held against float64 (complex128) numpy answers.  Returns
    the launch count of each path; ``keep`` gets the results, the
    analyses and the float64 answers (for phase 17)."""
    import torch

    from libertem_tpu_torch.analysis.base import Analysis
    from libertem_tpu_torch.analysis.clust import peak_local_max
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.udf.com import RegressionOptions

    n = int(np.prod(NAV))
    frame_bytes = int(np.prod(SIG)) * data.itemsize
    params = analysis_params(lt)
    analyses = {id_: Analysis.get_analysis_by_type(id_)(ds, p)
                for id_, p in params.items()}
    launches = {}

    def run(label, fn, frames, fused_expected):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = fused_moments.launches
        fused = ctx.run_info["fused"]
        print(f"10 {label}: {secs:.3f} s wall, {frames} frames = "
              f"{frames * frame_bytes / secs / 1e9:.2f} GB/s, fused "
              f"{fused}, fused_moments partials launches {count} {at}")
        launches[f"{label} (phase 10)"] = count
        if fused != fused_expected or (count > 0) != fused:
            failures.append(f"10 {label}: fused {fused} (expected "
                            f"{fused_expected}), {count} launches")
        return out

    results = {}
    for id_, analysis in analyses.items():
        if id_ == "CLUST":
            continue
        frames = 1 if id_ in ("PICK_FRAME", "PICK_FFT_FRAME") else n
        results[id_] = run(f"Context.run {id_}",
                           lambda a=analysis: ctx.run(a), frames,
                           id_ in FUSED_IDS)
    clust = analyses["CLUST"]
    std_map, feats = run("CLUST feature passes (std, then M=42)",
                         lambda: clust.run_feature_passes(ctx), 2 * n, True)
    results["CLUST"] = run("Context.run CLUST", lambda: ctx.run(clust), n,
                           True)
    quarter = np.zeros(NAV, dtype=bool)
    quarter[:NAV[0] // 2, :NAV[1] // 2] = True
    gui = Analysis.get_analysis_by_type("APPLY_DISK_MASK")(ds, {
        **params["APPLY_DISK_MASK"],
        "roi": {"shape": "rect", "x": 0, "y": 0, "width": NAV[1] // 2,
                "height": NAV[0] // 2},
    })
    roi_res = run("APPLY_DISK_MASK with a GUI roi (a quarter)",
                  lambda: ctx.run(gui), n // 4, True)
    reg = {}
    for mode in (RegressionOptions.SUBTRACT_MEAN,
                 RegressionOptions.SUBTRACT_LINEAR):
        udf = lt.CoMUDF.with_params(cy=REG_CENTRE[0], cx=REG_CENTRE[1],
                                    regression=mode)
        reg[mode] = run(f"CoMUDF regression={mode}",
                        lambda u=udf: ctx.run_udf(ds, u), n, True)
    br = np.zeros(NAV, dtype=bool)
    br[NAV[0] // 2:, NAV[1] // 2:] = True
    map_t = run("Context.map, torch f (a quarter)",
                lambda: ctx.map(ds, lambda fr: fr.sum(0), roi=br), n // 4,
                False)
    engines_t = ctx.run_info["engines"]
    map_n = run("Context.map, numpy f (a quarter)",
                lambda: ctx.map(ds, lambda fr: np.asarray(fr).max(axis=1),
                                roi=br), n // 4, False)
    engines_n = ctx.run_info["engines"]
    tr = np.zeros(NAV, dtype=bool)
    tr[:NAV[0] // 2, NAV[1] // 2:] = True
    rec_path = os.path.join(tmp, "record.npy")
    run("RecordUDF (a quarter)",
        lambda: ctx.run_udf(ds, lt.RecordUDF(rec_path), roi=tr), n // 4,
        False)
    engines_r = ctx.run_info["engines"]
    # the two slowest whole-scan passes, once more under the profiler
    print("10 trace of CLUST's feature pass (M=42), run again:")
    traced_run(ctx, ds, [clust.feature_udf(std_map)], at)
    print("10 trace of APPLY_FFT_MASK, run again:")
    traced_run(ctx, ds, [analyses["APPLY_FFT_MASK"].get_udf()], at)

    t0 = time.perf_counter()
    o = analysis_oracle(lt, data, analyses, want4)
    print(f"oracle 10: {time.perf_counter() - t0:.1f} s (float64 / "
          f"complex128 numpy, scipy.fft)")
    for id_, res in results.items():
        want = expected_channels(id_, analyses[id_], o, data)
        e = check_channels(f"10 {id_}", res, want, failures)
        print(f"  10 {id_}: {len(want)} channels, largest relative error "
              f"{e:.3g} vs float64")
    # CLUST's passes: the std map, and the features at its peaks
    e_std, ok = max_err(std_map, np.sqrt(o["var"]))
    if not ok:
        failures.append(f"10 CLUST std map: max err {e_std}")
    udf = clust.feature_udf(std_map)
    stack = np.asarray(udf.params.mask_factories(), dtype=np.float64)
    want_f = projections64(data, stack.reshape(len(stack), -1),
                           np.arange(n)).reshape(NAV + (len(stack),))
    e, ok = max_err(feats, want_f)
    peaks = peak_local_max(std_map, 1, 42)
    print(f"  10 CLUST: std map max abs err {e_std:.3g}, {len(peaks)} "
          f"peaks, features {feats.shape} max abs err {e:.3g} vs float64")
    if not ok or feats.shape != NAV + (42,):
        failures.append(f"10 CLUST features: max err {e}, {feats.shape}")
    # the GUI roi: the quarter's frames, nan elsewhere
    disk = np.full(NAV, np.nan)
    disk[quarter] = o["proj"]["APPLY_DISK_MASK"][:, 0].reshape(NAV)[quarter]
    e = check_channels("10 GUI roi", roi_res, {
        "intensity": (disk, "real"), "intensity_log": (disk, "real")},
        failures)
    print(f"  10 GUI roi: {int(np.isfinite(roi_res.intensity.raw_data).sum())}"
          f" frames, largest relative error {e:.3g} vs float64")
    # the regression: np.linalg.lstsq in float64 on the oracle's centres
    proj = o["proj"]["REGRESSION"]
    centres = (proj[:, 1:] / proj[:, :1]).reshape(NAV + (2,))
    shifts = com_channels(centres, REG_CENTRE, 0.0, False)
    rows, cols = np.mgrid[0:NAV[0], 0:NAV[1]]
    a = np.stack([np.ones(n), rows.reshape(-1), cols.reshape(-1)], axis=-1)
    centre_scale = float(np.abs(centres).max())
    for mode, res in reg.items():
        coef = np.zeros((3, 2))
        fields = []
        for ci, comp in enumerate(shifts):
            if mode == RegressionOptions.SUBTRACT_MEAN:
                coef[0, ci] = comp.mean()
                fields.append(comp - coef[0, ci])
            else:
                coef[:, ci] = np.linalg.lstsq(a, comp.reshape(-1),
                                              rcond=None)[0]
                fields.append(comp - (a @ coef[:, ci]).reshape(NAV))
        fy, fx = fields
        e_c, ok_c = max_err(res["regression"].data, coef, rtol=1e-4)
        if not ok_c or not res["regression"].valid_mask.all():
            failures.append(f"10 regression={mode}: coefficients max err "
                            f"{e_c}")
        errs = [e_c]
        for name, ref in (("field", np.stack([fy, fx], axis=-1)),
                          ("magnitude", np.hypot(fy, fx))):
            e, ok = max_err(res[name].data, ref, centre_scale)
            errs.append(e)
            if not ok:
                failures.append(f"10 regression={mode} {name}: max err {e}")
        print(f"  10 CoMUDF regression={mode}: coefficients "
              f"{np.round(res['regression'].data, 6).tolist()} (lstsq "
              f"{np.round(coef, 6).tolist()}), max abs err {max(errs):.3g}")
    # Context.map: column sums on the card, row maxima on the host
    sel = br.reshape(-1)
    want_t = np.full((n, SIG[1]), np.nan)
    want_t[sel] = data.reshape(n, *SIG)[sel].astype(np.float64).sum(axis=1)
    e, ok = max_err(map_t.data, want_t.reshape(NAV + (SIG[1],)))
    want_n = np.full((n, SIG[0]), np.nan)
    want_n[sel] = data.reshape(n, *SIG)[sel].max(axis=2)
    exact_n = map_n.data.dtype == np.float32 and np.array_equal(
        map_n.data, want_n.reshape(NAV + (SIG[0],)), equal_nan=True)
    print(f"  10 Context.map: torch f on {engines_t}, {map_t.data.dtype}, "
          f"max abs err {e:.3g}; numpy f on {engines_n}, "
          f"{map_n.data.dtype}, exact {exact_n}")
    if not ok or engines_t != ["device"]:
        failures.append(f"10 map torch f: max err {e}, {engines_t}")
    if not exact_n or engines_n != ["host"]:
        failures.append(f"10 map numpy f: exact {exact_n}, {engines_n}")
    # RecordUDF: the quarter's frames, bit for bit
    back = np.load(rec_path, mmap_mode="r")
    same = (back.dtype == data.dtype and back.shape == (n // 4,) + SIG
            and np.array_equal(back, data.reshape(n, *SIG)[tr.reshape(-1)]))
    print(f"  10 RecordUDF: {back.shape} {back.dtype} on {engines_r}, bit "
          f"for bit: {same}")
    del back
    os.remove(rec_path)
    if not same or engines_r != ["host"]:
        failures.append(f"10 RecordUDF: bit for bit {same}, {engines_r}")
    if keep is not None:
        keep.update(results=results, analyses=analyses, oracle=o)
    return launches


# -- phase 11: the FFT UDFs and the dataset core ------------------------------

LATTICE = dict(a=(16, 0), b=(0, 16), radius=4)
CBED_SCALE = 4.0  # Poisson mean per unit of cbed_frame's intensity
HOLO_FRAMES, HOLO_SIG, HOLO_OUT = 256, (1024, 1024), (256, 256)
SYNC = 1000  # the sync offset of phase 11(c), both signs


def write_cbed_scan(path: str) -> np.ndarray:
    """A CBED scan of nav NAV and sig SIG, u16, written to ``path``:
    ``cbed_frame``'s lattice (a = (16, 0), b = (0, 16), radius 4) with
    the zero order's disk raised by the brightest disk's intensity, so
    each frame's brightest disk is the zero order; the pattern wobbles by
    up to 2 px in steps of 2/3 px with the scan position (49 distinct
    clean frames); Poisson noise from the seed, drawn by 8 threads.  Returns
    the (n, *SIG) array."""
    from libertem_tpu_torch.utils.generate import cbed_frame

    n = int(np.prod(NAV))
    y, x = np.unravel_index(np.arange(n), NAV)
    offs = np.stack([np.round(3 * np.sin(2 * np.pi * y / 64)) * 2 / 3,
                     np.round(3 * np.cos(2 * np.pi * x / 48)) * 2 / 3],
                    axis=-1)
    keys, index = np.unique(offs, axis=0, return_inverse=True)
    index = index.reshape(-1)
    clean = np.empty((len(keys),) + SIG, np.float32)
    for i, (dy, dx) in enumerate(keys):
        zero = (SIG[0] // 2 + dy, SIG[1] // 2 + dx)
        frame = cbed_frame(*SIG, zero=zero, **LATTICE)[0][0]
        disk = cbed_frame(*SIG, zero=zero, indices=[(0, 0)],
                          all_equal=True, **LATTICE)[0][0]
        clean[i] = frame + frame.max() * disk
    data = np.empty((n,) + SIG, np.uint16)
    seeds = np.random.SeedSequence(SEED + 20).spawn(64)
    step = n // 64

    def fill(i):
        sl = slice(i * step, (i + 1) * step)
        data[sl] = np.random.default_rng(seeds[i]).poisson(
            CBED_SCALE * clean[index[sl]] + 1.0)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, range(64)))
    data.tofile(path)
    return data


def lattice_peaks(count: int) -> np.ndarray:
    """The ``count`` nominal lattice peaks nearest the frame's centre,
    (count, 2) int (y, x)."""
    from libertem_tpu_torch.utils import frame_peaks

    centre = np.array(SIG) // 2
    _, peaks = frame_peaks(*SIG, centre, np.array(LATTICE["a"]),
                           np.array(LATTICE["b"]), LATTICE["radius"],
                           np.mgrid[-4:5, -4:5])
    order = np.argsort(np.linalg.norm(peaks - centre, axis=1), kind="stable")
    return peaks[order[:count]].astype(np.int64)


def correlation_answers(corr, windows, steps):
    """From float64 correlation maps ``corr`` (d, h, w) (torch, any
    device): the full-frame centre, 3x3 refinement (clipped) and peak
    value, the map's maximum and the gap between its two largest values;
    per window (``windows``: (n_peaks, size^2) flat pixel indices) the
    centre offset, the refinement over the window and the peak value
    and gap.  A float64 implementation apart from the port's."""
    import torch

    d, h, w = corr.shape
    flat = corr.reshape(d, -1)
    top = flat.topk(2, dim=-1).values
    idx = flat.argmax(dim=-1)
    iy, ix = idx // w, idx % w
    o = torch.arange(-1, 2, device=corr.device)
    yy = (iy[:, None] + o).clamp(0, h - 1)
    xx = (ix[:, None] + o).clamp(0, w - 1)
    rows = torch.arange(d, device=corr.device)[:, None, None]
    win = corr[rows, yy[:, :, None], xx[:, None, :]]
    win = win - win.amin(dim=(1, 2), keepdim=True)
    total = win.sum(dim=(1, 2)).clamp_min(1e-12)
    of = o.double()
    refined = torch.stack([iy + (win * of[:, None]).sum((1, 2)) / total,
                           ix + (win * of[None, :]).sum((1, 2)) / total],
                          dim=-1)
    size = 2 * steps + 1
    wins = flat[:, windows]  # (d, n_peaks, size^2)
    wtop = wins.topk(2, dim=-1).values
    widx = wins.argmax(dim=-1)
    g = torch.arange(size, device=corr.device).double() - steps
    w0 = wins - wins.amin(dim=-1, keepdim=True)
    wtot = w0.sum(dim=-1).clamp_min(1e-12)
    return {
        "centers": torch.stack([iy, ix], dim=-1).double(),
        "refineds": refined,
        "peak_values": top[:, 0],
        "map_max": top[:, 0],
        "gap": top[:, 0] - top[:, 1],
        "s_offsets": torch.stack([widx // size - steps,
                                  widx % size - steps], dim=-1).double(),
        "s_refineds": torch.stack(
            [(w0 * g.repeat_interleave(size)).sum(-1) / wtot,
             (w0 * g.repeat(size)).sum(-1) / wtot], dim=-1),
        "s_peak_values": wtop[..., 0],
        "s_gap": wtop[..., 0] - wtop[..., 1],
    }


def correlation_oracle(data, peaks, steps, dev, at, failures) -> dict:
    """Phase 11(a)'s answers over every frame of ``data``: each frame
    correlated with the RadialGradient(4) template in complex128 with
    torch.fft on the card, and the per-pixel sum and sum of squares in
    float64.  The card's float64 maps are checked against numpy's FFT
    on 256 frames (two partition boundaries and the last block)."""
    import torch

    from libertem_tpu_torch.udf.blobfinder import RadialGradient

    mask = RadialGradient(LATTICE["radius"]).get_mask(SIG)
    spec = torch.from_numpy(
        np.conj(np.fft.fft2(np.fft.ifftshift(mask)))).to(dev)
    h, w = SIG
    size = 2 * steps + 1
    offs = np.arange(-steps, steps + 1)
    win_y = (peaks[:, 0:1, None] + offs[None, :, None]) % h
    win_x = (peaks[:, 1:2, None] + offs[None, None, :]) % w
    windows = torch.from_numpy((win_y * w + win_x).reshape(len(peaks), -1)
                               ).to(dev)
    n = len(data)
    out, s1, s2 = [], 0.0, 0.0
    for lo in range(0, n, 1024):
        x = torch.from_numpy(data[lo:lo + 1024]).to(dev).double()
        s1 = s1 + x.sum(0)
        s2 = s2 + (x * x).sum(0)
        corr = torch.fft.ifft2(torch.fft.fft2(x) * spec).real
        out.append({k: v.cpu().numpy() for k, v in correlation_answers(
            corr, windows, steps).items()})
    ans = {k: np.concatenate([o[k] for o in out]) for k in out[0]}
    ans["sum"] = s1.cpu().numpy()
    ans["sumsq"] = s2.cpu().numpy()
    # the oracle against numpy's float64 FFT
    ids = np.concatenate([np.arange(n // 4 - 32, n // 4 + 32),
                          np.arange(n // 2 - 32, n // 2 + 32),
                          np.arange(n - 128, n)])
    maps = np.fft.ifft2(np.fft.fft2(data[ids].astype(np.float64))
                        * np.conj(np.fft.fft2(np.fft.ifftshift(mask)))).real
    ref = {k: v.numpy() for k, v in correlation_answers(
        torch.from_numpy(maps), windows.cpu(), steps).items()}
    worst = 0.0
    for k, v in ref.items():
        e = float(np.abs(ans[k][ids] - v).max() / max(np.abs(v).max(), 1.0))
        worst = max(worst, e)
    print(f"11a oracle: complex128 torch.fft on the card against numpy "
          f"float64 on {len(ids)} frames (partition boundaries, last "
          f"block): largest relative difference {worst:.3g} {at}")
    if worst > 1e-9:
        failures.append(f"11a oracle disagrees with numpy: {worst}")
    return ans


def check_correlation(label, res, ans, peaks, failures, sparse) -> None:
    """Centres exact where the oracle's two largest values in the search
    region differ by more than 1e-4 of the map's maximum (the frames or
    windows left out counted and printed); refined positions within
    1e-3 px (full frame: where the centres agree); peak values within
    1e-4 of the map's maximum."""
    n = int(np.prod(NAV))
    scale = ans["map_max"]
    if sparse:
        cen = res["centers"].data.reshape(n, -1, 2).astype(np.float64)
        want_c = peaks[None] + ans["s_offsets"]
        ok = ans["s_gap"] > 1e-4 * scale[:, None]
        same = np.all(cen == want_c, axis=-1)
        ref_err = np.abs(res["refineds"].data.reshape(n, -1, 2)
                         - (peaks[None] + ans["s_refineds"]))
        ref_ok = np.all(ref_err <= 1e-3)
        pv_err = np.abs(res["peak_values"].data.reshape(n, -1)
                        - ans["s_peak_values"]) / scale[:, None]
    else:
        cen = res["centers"].data.reshape(n, 2).astype(np.float64)
        ok = ans["gap"] > 1e-4 * scale
        same = np.all(cen == ans["centers"], axis=-1)
        ref_err = np.abs(res["refineds"].data.reshape(n, 2)
                         - ans["refineds"])[same]
        ref_ok = np.all(ref_err <= 1e-3)
        pv_err = np.abs(res["peak_values"].data.reshape(n)
                        - ans["peak_values"]) / scale
    wrong = int(np.count_nonzero(ok & ~same))
    left_out = ok.size - int(np.count_nonzero(ok))
    frames_out = int(np.count_nonzero(~ok.reshape(n, -1).all(axis=-1)))
    what = "windows" if sparse else "frames"
    print(f"  {label}: centres exact in {int(np.count_nonzero(same & ok))} "
          f"of {ok.size} {what}; {left_out} {what} ({frames_out} frames) "
          f"left out, their two largest values within 1e-4 of the map's "
          f"maximum; {int(np.count_nonzero(~same))} {what} differ in all; "
          f"refined max abs err {float(ref_err.max(initial=0.0)):.3g} px; "
          f"peak values max err {float(pv_err.max()):.3g} of the map's "
          f"maximum")
    if wrong or not ref_ok or float(pv_err.max()) > 1e-4:
        failures.append(f"{label}: {wrong} centres wrong, refined ok "
                        f"{ref_ok}, peak values {float(pv_err.max())}")


def stage_ms(fn, args, calls=8) -> tuple[float, float]:
    """(device ms, host-launched ms) a call of ``fn(*args)``, after a
    warm-up call: the device time of the kernels and copies of
    ``calls`` calls under torch.profiler, and CUDA events around the
    same calls issued eagerly."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    device_ms = sum(device_busy(prof).values()) / 1e3 / calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    end.synchronize()
    return device_ms, start.elapsed_time(end) / calls


def fft_stage_times(block, at) -> dict:
    """Device ms of the full-frame correlation's steps on one block of
    the path (1024 frames of 128 x 128 u16, on the card): the cast and
    rfft2, the product with the template's scaled half spectrum, the
    unscaled irfft2 (with torch's copy of its input), and the argmax
    with the refinement."""
    import torch

    from libertem_tpu_torch.udf import blobfinder

    spec = blobfinder._half_spectrum(
        blobfinder.RadialGradient(LATTICE["radius"]), SIG, block.device)
    f = torch.fft.rfft2(block.float())
    prod_ = f * spec
    corr = blobfinder._correlate(block, spec)

    def peak(c):
        flat = c.reshape(c.shape[0], -1)
        i = flat.argmax(dim=-1)
        return blobfinder._subpixel_refine(c, i // SIG[1], i % SIG[1])

    times = {
        "cast + rfft2": stage_ms(lambda b: torch.fft.rfft2(b.float()),
                                 (block,)),
        "product": stage_ms(lambda p: torch.mul(p, spec, out=prod_), (f,)),
        "irfft2": stage_ms(lambda p: torch.fft.irfft2(p, s=SIG,
                                                      norm="forward"),
                           (prod_,)),
        "argmax + refine": stage_ms(peak, (corr,)),
    }
    print("11a ms a block (1024 frames) by step, device (traced) / "
          "host-launched: " + ", ".join(
              f"{k} {d:.4f} / {e:.4f}" for k, (d, e) in times.items())
          + f"; device in all {sum(d for d, _ in times.values()):.4f} "
          f"{at}")
    return times


def holo_scan(path: str) -> np.ndarray:
    """HOLO_FRAMES off-axis holograms of HOLO_SIG, float32, written to
    ``path``: frame 0 a flat reference, frame i a Gaussian phase object
    (sigma an eighth of the frame: 128 px) of strength
    0.5 + i / HOLO_FRAMES rad whose centre circles with i; sampling 4 px,
    8 threads.  Returns (the holograms, the phases)."""
    from libertem_tpu_torch.utils.generate import hologram_frame

    h, w = HOLO_SIG
    y, x = np.mgrid[0:h, 0:w]
    amp = np.ones(HOLO_SIG)
    holos = np.empty((HOLO_FRAMES,) + HOLO_SIG, np.float32)
    phases = np.empty((HOLO_FRAMES,) + HOLO_SIG, np.float32)

    def one(i):
        cy = h / 2 + h / 10 * np.sin(2 * np.pi * i / HOLO_FRAMES)
        cx = w / 2 + w / 10 * np.cos(2 * np.pi * i / HOLO_FRAMES)
        phase = (0.0 if i == 0 else (0.5 + i / HOLO_FRAMES) * np.exp(
            -((y - cy) ** 2 + (x - cx) ** 2) / (2 * (h / 8) ** 2)))
        phases[i] = phase
        holos[i] = hologram_frame(amp, amp * phase, sampling=4.0)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(HOLO_FRAMES)))
    holos.tofile(path)
    return holos, phases


def holo_oracle(holos, sb_pos, sb_size, dev) -> np.ndarray:
    """The waves of HoloReconstructUDF(out_shape=HOLO_OUT) in complex128
    on the card: fft2, a roll of the sideband to the origin, the crop of
    the low frequencies at the corners, a float64 aperture, ifft2."""
    import torch

    oh, ow = HOLO_OUT
    fy = np.fft.fftfreq(oh) * oh
    fx = np.fft.fftfreq(ow) * ow
    r = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    edge = max(1.0, 0.05 * sb_size)
    ap = torch.from_numpy(np.clip((sb_size - r) / edge + 0.5, 0.0, 1.0)
                          ).to(dev)
    out = []
    for lo in range(0, len(holos), 16):
        x = torch.from_numpy(holos[lo:lo + 16]).to(dev).double()
        spec = torch.roll(torch.fft.fft2(x), (-sb_pos[0], -sb_pos[1]),
                          dims=(-2, -1))
        spec = torch.cat([spec[..., :oh - oh // 2, :],
                          spec[..., spec.shape[-2] - oh // 2:, :]], dim=-2)
        spec = torch.cat([spec[..., :ow - ow // 2],
                          spec[..., spec.shape[-1] - ow // 2:]], dim=-1)
        out.append(torch.fft.ifft2(spec * ap).cpu().numpy())
    return np.concatenate(out)


def shifted_oracle(want4, data, so, nav=NAV) -> dict:
    """Phase 4's answers for the scan read with sync offset ``so``:
    frame i is data frame i + so, a blank frame (no mass: CoM at the
    centre) where that lies outside the data.  Per-frame results are
    phase 4's, moved; per-pixel sums drop the data frames that are not
    read (float64 sums of squares, exact for these counts)."""
    n = int(np.prod(NAV))
    ids = np.arange(n) + so
    ok = (ids >= 0) & (ids < n)
    k = want4[(0, "intensity")].shape[-1]

    def move(a, fill=0.0):
        a = a.reshape(n, -1)
        out = np.full_like(a, fill)
        out[ok] = a[ids[ok]]
        return out

    gone = np.setdiff1d(np.arange(n), ids[ok])
    f = data.reshape(n, -1)[gone].astype(np.float64)
    mean4 = want4[(4, "mean")].reshape(-1)
    sumsq = n * (want4[(4, "var")].reshape(-1) + mean4 ** 2) - (f * f).sum(0)
    s1 = want4[(4, "sum")].reshape(-1) - f.sum(0)
    mean = s1 / n
    var = sumsq / n - mean ** 2
    return {
        (0, "intensity"): move(want4[(0, "intensity")]).reshape(nav + (k,)),
        **com_oracle(move(want4[(1, "raw_com")], 64.0), nav),
        (2, "intensity"): s1.reshape(SIG),
        (3, "intensity"): move(want4[(3, "intensity")]).reshape(nav),
        (4, "num_frames"): np.array([float(n)]),
        (4, "sum"): s1.reshape(SIG),
        (4, "mean"): mean.reshape(SIG),
        (4, "var"): var.reshape(SIG),
        (4, "std"): np.sqrt(var).reshape(SIG),
    }


def slice9_phase(ctx, ds, lt, path, data, want4, res6a, corrections, tmp,
                 report, at, failures) -> dict:
    """Phase 11: (a) the blobfinder on a 2 GiB CBED scan, (b) holography
    on 256 holograms of 1024 x 1024, (c) the dataset core (sync offset,
    inferred nav, io backends, big-endian data, the tile stream, the
    standalone corrections) through phase 4's scan and UDFs.  Each pass
    with the launch count set to 0 just before and read just after.
    Returns the launch count of each pass."""
    import torch

    from libertem_tpu_torch.io.corrections import (
        correct,
        correct_dot_masks,
    )
    from libertem_tpu_torch.io.dataset.base import IOBackend
    from libertem_tpu_torch.io.tiling import TilingScheme
    from libertem_tpu_torch.common.shape import Shape
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.udf import blobfinder, holography
    from libertem_tpu_torch.udf.base import UDFRunner

    dev = ctx.device
    n = int(np.prod(NAV))
    launches = {}

    def blocks_of(dset, udfs) -> int:
        """The blocks a run of ``udfs`` on ``dset`` reads: one fused
        launch each, for M <= 8."""
        prep = UDFRunner(udfs)._prepare(dset, dev)
        return sum(-(-p.num_frames // prep["scheme"].depth)
                   for p in prep["partitions"])

    def timed(label, fn, nbytes, fused_expected, launches_expected):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = fused_moments.launches
        fused = ctx.run_info["fused"]
        report(f"11{label}", secs, nbytes, ctx.feed_stats)
        print(f"  11{label}: fused {fused}, fused_moments partials "
              f"launches {count}")
        launches[f"{label} (phase 11)"] = count
        if fused != fused_expected or count != launches_expected:
            failures.append(f"11{label}: fused {fused} (expected "
                            f"{fused_expected}), {count} launches "
                            f"(expected {launches_expected})")
        return out

    # -- (a) the blobfinder ------------------------------------------------
    cbed_path = os.path.join(tmp, "cbed.raw")
    t0 = time.perf_counter()
    cbed = write_cbed_scan(cbed_path)
    print(f"11a data: CBED scan of {cbed.nbytes} bytes written in "
          f"{time.perf_counter() - t0:.1f} s")
    cds = ctx.load("raw", path=cbed_path, dtype="uint16", nav_shape=NAV,
                   sig_shape=SIG)
    peaks = lattice_peaks(25)
    steps = 5
    t0 = time.perf_counter()
    ans = correlation_oracle(cbed, peaks, steps, dev, at, failures)
    print(f"oracle 11a: {time.perf_counter() - t0:.1f} s")
    pattern = blobfinder.RadialGradient(LATTICE["radius"])
    full = timed("a run_blobfinder, full frame, RadialGradient(4)",
                 lambda: blobfinder.run_blobfinder(ctx, cds, pattern),
                 cbed.nbytes, False, 0)
    check_correlation("11a full frame", full, ans, peaks, failures, False)
    sparse = timed(
        "a SparseCorrelationUDF, 25 peaks, steps 5",
        lambda: ctx.run_udf(cds, blobfinder.SparseCorrelationUDF(
            pattern, peaks=peaks, steps=steps)), cbed.nbytes, False, 0)
    check_correlation("11a sparse", sparse, ans, peaks, failures, True)
    beside = timed(
        "a FullFrameCorrelationUDF beside SumUDF and StdDevUDF",
        lambda: ctx.run_udf(cds, [blobfinder.FullFrameCorrelationUDF(
            pattern), lt.SumUDF(), lt.StdDevUDF()]), cbed.nbytes, False, 0)
    check_correlation("11a beside Sum, StdDev", beside[0], ans, peaks,
                      failures, False)
    mean = ans["sum"] / n
    var = ans["sumsq"] / n - mean ** 2
    check_results("11a beside", beside, {
        (1, "intensity"): ans["sum"], (2, "num_frames"): np.array([n]),
        (2, "sum"): ans["sum"],
        (2, "mean"): mean, (2, "var"): var, (2, "std"): np.sqrt(var),
    }, failures)
    print("11a trace of the full-frame pass, run again:")
    traced_run(ctx, cds, [blobfinder.FullFrameCorrelationUDF(pattern)], at)
    block = torch.from_numpy(cbed[:1024]).to(dev)
    fft_stage_times(block, at)
    del cds, cbed, block
    os.remove(cbed_path)

    # -- (b) holography -----------------------------------------------------
    holo_path = os.path.join(tmp, "holo.raw")
    t0 = time.perf_counter()
    holos, phases = holo_scan(holo_path)
    print(f"11b data: {HOLO_FRAMES} holograms of {HOLO_SIG}, "
          f"{holos.nbytes} bytes written in {time.perf_counter() - t0:.1f} s")
    sb_pos = holography.estimate_sideband_position(holos[0])
    sb_size = holography.estimate_sideband_size(sb_pos, HOLO_SIG)
    print(f"11b sideband at {sb_pos}, aperture radius {sb_size:.2f} px")
    hds = ctx.load("raw", path=holo_path, dtype="float32",
                   nav_shape=(HOLO_FRAMES,), sig_shape=HOLO_SIG)
    wave = timed(f"b HoloReconstructUDF, out_shape {HOLO_OUT}",
                 lambda: ctx.run_udf(hds, holography.HoloReconstructUDF(
                     out_shape=HOLO_OUT, sb_position=sb_pos,
                     sb_size=sb_size)), holos.nbytes, False, 0)["wave"].data
    t0 = time.perf_counter()
    want = holo_oracle(holos, sb_pos, sb_size, dev)
    print(f"oracle 11b: {time.perf_counter() - t0:.1f} s (complex128 "
          f"torch.fft on the card)")
    err = float(np.abs(wave - want).max() / np.abs(want).max())
    # the phase of each object against the reference, downsampled to
    # the wave's shape, inside its inner half
    oh, ow = HOLO_OUT
    step = HOLO_SIG[0] // oh
    inner = np.s_[oh // 4:3 * oh // 4, ow // 4:3 * ow // 4]
    worst_max = worst_mean = 0.0
    for i in range(1, HOLO_FRAMES, 15):
        dphi = -np.angle(wave[i] / wave[0])
        delta = dphi[inner] - phases[i][::step, ::step][inner]
        delta -= delta.mean()
        worst_max = max(worst_max, float(np.abs(delta).max()))
        worst_mean = max(worst_mean, float(np.abs(delta).mean()))
    print(f"  11b wave: {wave.shape} {wave.dtype}, max abs err {err:.3g} of "
          f"max|wave| vs complex128; recovered phase vs the object (every "
          f"15th frame, inner half): max {worst_max:.3f} rad, mean "
          f"{worst_mean:.3f} rad")
    if err > 1e-4 or worst_max > 0.35 or worst_mean > 0.1:
        failures.append(f"11b: wave err {err}, phase {worst_max} / "
                        f"{worst_mean}")
    print("11b trace of the holography pass, run again:")
    traced_run(ctx, hds, [holography.HoloReconstructUDF(
        out_shape=HOLO_OUT, sb_position=sb_pos, sb_size=sb_size)], at)
    del hds, holos, phases, want, wave
    os.remove(holo_path)

    # -- (c) the dataset core -------------------------------------------------
    nbytes = data.nbytes
    launches_expected = blocks_of(ds, make_udfs(lt))
    for so in (SYNC, -SYNC):
        sds = ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                       sig_shape=SIG, sync_offset=so)
        info = sds.get_sync_offset_info()
        expect = {"frames_skipped_start": max(0, so),
                  "frames_ignored_end": max(0, -so),
                  "frames_inserted_start": max(0, -so),
                  "frames_inserted_end": max(0, so)}
        print(f"  11c sync_offset {so:+d}: {info}")
        if info != expect:
            failures.append(f"11c get_sync_offset_info {info} != {expect}")
        res = timed(f"c sync_offset {so:+d}",
                    lambda: ctx.run_udf(sds, make_udfs(lt)), nbytes, True,
                    launches_expected)
        check_results(f"11c sync_offset {so:+d}", res,
                      shifted_oracle(want4, data, so), failures)
    # one partition's tile stream (sig split in two) against the file
    sds = ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                   sig_shape=SIG, sync_offset=-SYNC)
    part = next(sds.get_partitions())
    scheme = TilingScheme.make_for_shape(Shape((512, 64, 128), sig_dims=2),
                                         sds.shape)
    raw = np.memmap(path, dtype=np.uint16, mode="r").reshape(-1, *SIG)
    first, covered, count, same = None, 0, 0, True
    for t in part.get_tiles(scheme):
        f0, y0, x0 = t.tile_slice.origin
        first = f0 if first is None else first
        d, th, tw = t.shape
        # dataset frame f is data frame f - SYNC
        same &= np.array_equal(
            t.data, raw[f0 - SYNC:f0 - SYNC + d, y0:y0 + th, x0:x0 + tw])
        covered += d if t.scheme_idx == 0 else 0
        count += 1
    print(f"  11c get_tiles, partition 0 under sync_offset {-SYNC}: "
          f"{count} tiles from frame {first}, {covered} frames, equal to "
          f"the file's bytes: {same}")
    if not same or first != SYNC or covered != part.num_frames - SYNC:
        failures.append(f"11c get_tiles: equal {same}, from {first}, "
                        f"{covered} frames")
    del raw
    # nav omitted: inferred as (n,); CoMUDF needs a 2-D nav, so the
    # other four UDFs
    ids = ctx.load("raw", path=path, dtype="uint16", sig_shape=SIG)
    print(f"  11c nav inferred: {tuple(ids.shape)}")
    udfs4 = [u for i, u in enumerate(make_udfs(lt)) if i != 1]
    res = timed(f"c nav inferred ({n},)", lambda: ctx.run_udf(ids, udfs4),
                nbytes, True, launches_expected)
    want_flat = {(0, "intensity"): want4[(0, "intensity")].reshape(n, -1),
                 (1, "intensity"): want4[(2, "intensity")],
                 (2, "intensity"): want4[(3, "intensity")].reshape(n)}
    want_flat.update({(3, k): want4[(4, k)] for k in
                      ("num_frames", "sum", "mean", "var", "std")})
    if tuple(ids.shape) != (n,) + SIG:
        failures.append(f"11c inferred nav {tuple(ids.shape)}")
    check_results("11c nav inferred", res, want_flat, failures)
    # the io backends
    for backend in ("mmap", "buffered", "direct"):
        bds = ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                       sig_shape=SIG,
                       io_backend=IOBackend.from_json({"id": backend}))
        res = timed(f"c io_backend {backend}",
                    lambda: ctx.run_udf(bds, make_udfs(lt)), nbytes, True,
                    launches_expected)
        check_results(f"11c io_backend {backend}", res, want4, failures)
        if backend == "direct":
            probe = next(bds.get_partitions())
            probe.read_dataset_frames(0, 1)
            print(f"  11c direct: O_DIRECT opened: "
                  f"{probe._reader.direct_opened} (else read as buffered)")
    # big-endian: a copy of the first quarter of the scan
    be_path = os.path.join(tmp, "scan_be.raw")
    quarter = data[:NAV[0] // 4]
    quarter.astype(">u2").tofile(be_path)
    qnav = (NAV[0] // 4, NAV[1])
    qds = ctx.load("raw", path=be_path, dtype=">u2", nav_shape=qnav,
                   sig_shape=SIG)
    q_blocks = blocks_of(qds, make_udfs(lt))
    t0 = time.perf_counter()
    res = timed("c big-endian >u2, a quarter of the scan",
                lambda: ctx.run_udf(qds, make_udfs(lt)), quarter.nbytes, True,
                q_blocks)
    be_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_q = oracle(quarter, np.stack([lt.masks.circular(64, 64, SIG[1], SIG[0],
                                                         16),
                                       lt.masks.ring(64, 64, SIG[1], SIG[0],
                                                     60, 40)]), nav=qnav)
    print(f"oracle 11c quarter: {time.perf_counter() - t0:.1f} s")
    check_results("11c big-endian", res, want_q, failures)
    # the swap as the reader runs it: C++, in place in a 32 MiB block
    from libertem_tpu_torch.ops.decode import byteswap_inplace
    slot = np.array(quarter.reshape(-1, *SIG)[:1024])
    byteswap_inplace(slot)
    t0 = time.perf_counter()
    for _ in range(8):
        byteswap_inplace(slot)
    swap_ms = (time.perf_counter() - t0) / 8 * 1e3
    print(f"  11c byteswap in place on the host (C++ byteswap16, the "
          f"reader's thread): {swap_ms:.2f} ms a 32 MiB block (numpy's "
          f"in-place swap: 14.59 ms, PERF.md section 5), "
          f"{swap_ms * q_blocks / 1e3:.3f} s a quarter-scan pass; the "
          f"quarter read at {quarter.nbytes / be_s / 1e9:.2f} GB/s (with "
          f"numpy's swap: 1.26 GB/s) {at}")
    del qds
    os.remove(be_path)
    # the standalone corrections against phase 6a's corrected run
    rows = np.arange(n // 4 - 512, n // 4 + 512)
    frames = data.reshape(n, *SIG)[rows]
    rings = ring_stack(lt).reshape(8, -1).astype(np.float64)
    excluded = corrections.excluded_coords.T
    fixed = correct(frames, corrections.dark, corrections.gain, excluded)
    folded = correct_dot_masks(ring_stack(lt).astype(np.float32),
                               corrections.gain, excluded)
    got6a = res6a[0]["intensity"].data.reshape(n, -1)[rows]
    for label, proj in (
        ("correct", fixed.reshape(len(rows), -1).astype(np.float64)
         @ rings.T),
        ("correct_dot_masks", (frames - corrections.dark).reshape(
            len(rows), -1).astype(np.float64)
         @ folded.reshape(8, -1).astype(np.float64).T),
    ):
        e, ok = max_err(proj, got6a)
        print(f"  11c {label} on 1024 frames (a partition boundary) vs "
              f"phase 6a's corrected run: max abs err {e:.3g}")
        if not ok:
            failures.append(f"11c {label}: max err {e}")
    return launches


# -- phase 12: the detector formats -------------------------------------------

# Merlin's header bytes of a single chip and of a quad
MIB_HEAD, MIB_QUAD_HEAD = 384, 768
# the first nav axis of every phase-12 scan is divided by this (1 on the
# card; a CPU rehearsal may raise it)
FMT_NAV_DIV = 1
K2_BLOCK, K2_HEAD, K2_SECTORS = 0x5758, 40, 8
FRMS6_DARK_FRAMES = 32


def write_records(path, n, pbytes, payload, head=0, head_fn=None, tail=0,
                  prefix=b"") -> int:
    """Write ``prefix``, then ``n`` records of ``head`` bytes (from
    ``head_fn(lo, hi)``, else zeros), ``pbytes`` of payload (from
    ``payload(lo, hi)``, (k, pbytes) uint8) and ``tail`` zero bytes;
    built in chunks of about 64 MiB on 8 threads, written in order.
    Returns the bytes written."""
    rec = head + pbytes + tail
    per = max(1, (64 << 20) // rec)
    starts = list(range(0, n, per))

    def build(lo):
        hi = min(n, lo + per)
        out = np.zeros((hi - lo, rec), np.uint8)
        if head_fn is not None:
            out[:, :head] = head_fn(lo, hi)
        out[:, head:head + pbytes] = payload(lo, hi).reshape(hi - lo, -1)
        return out

    with open(path, "wb") as f, ThreadPoolExecutor(8) as pool:
        f.write(prefix)
        for w in range(0, len(starts), 8):
            for block in pool.map(build, starts[w:w + 8]):
                f.write(memoryview(block).cast("B"))
    return len(prefix) + n * rec


def u8(x) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint8).reshape(len(x), -1)


def enc_r12(x: np.ndarray) -> np.ndarray:
    """Merlin RAW 12-bit: values reversed in groups of 4, big-endian."""
    k = len(x)
    return u8(x.reshape(k, -1, 4)[:, :, ::-1].astype(">u2"))


def enc_r6(x: np.ndarray) -> np.ndarray:
    k = len(x)
    return np.ascontiguousarray(x.reshape(k, -1, 8)[:, :, ::-1]).reshape(
        k, -1)


def enc_r1(x: np.ndarray) -> np.ndarray:
    """Merlin RAW 1-bit: 64-pixel stripes, bits little-endian in a byte,
    bytes reversed in the stripe."""
    k = len(x)
    bits = x.reshape(k, -1, 8, 8)
    packed = np.packbits(bits, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed[:, :, ::-1, 0]).reshape(k, -1)


def enc_r24(x: np.ndarray) -> np.ndarray:
    return np.concatenate([enc_r12((x >> 12) & 0xFFF),
                           enc_r12(x & 0xFFF)], axis=1)


def quad_store(frames: np.ndarray) -> np.ndarray:
    """(k, 2h, 2h) assembled quad frames -> (k, h, 4h) stored rows
    [Q4 | Q3 | Q2 | Q1], the bottom quadrants rotated 180 degrees."""
    k, h2, _ = frames.shape
    h = h2 // 2
    out = np.empty((k, h, 4 * h), frames.dtype)
    out[:, :, 3 * h:] = frames[:, :h, :h]
    out[:, :, 2 * h:3 * h] = frames[:, :h, h:]
    out[:, :, h:2 * h] = frames[:, h:, :h][:, ::-1, ::-1]
    out[:, :, :h] = frames[:, h:, h:][:, ::-1, ::-1]
    return out


def mib_heads(hb, chips, width, height, dtype, layout, bit_depth):
    """``head_fn`` of MIB frame headers: the sequence number (1-based,
    6 digits) in each."""
    base = np.frombuffer(
        f"MQ1,000000,{hb:05d},{chips:02d},{width:04d},{height:04d},{dtype},"
        f"{layout},{bit_depth},".encode().ljust(hb, b"\x00"), np.uint8)

    def heads(lo, hi):
        out = np.tile(base, (hi - lo, 1))
        seq = np.arange(lo + 1, hi + 1)
        for j in range(6):
            out[:, 4 + j] = 48 + (seq // 10 ** (5 - j)) % 10
        return out
    return heads


def write_k2is(dirpath: str, frames: np.ndarray) -> tuple[str, int]:
    """8 sector files of K2 IS blocks (40-byte big-endian header, 930 x
    16 pixels 12-bit little-endian), each frame's 32 blocks a sector
    with x descending in each half, as the detector streams them.
    Returns the path of sector 0 and the bytes written."""
    n = len(frames)

    def sector(s):
        blocks = frames[:, :, s * 256:(s + 1) * 256].reshape(
            n, 2, 930, 16, 16).transpose(0, 1, 3, 2, 4)[:, :, ::-1]
        vals = blocks.reshape(n, 32, 930 * 16)
        a = vals[..., 0::2].astype(np.uint16)
        b = vals[..., 1::2].astype(np.uint16)
        rec = np.zeros((n, 32, K2_BLOCK), np.uint8)
        pay = rec[:, :, K2_HEAD:]
        pay[..., 0::3] = a & 0xFF
        pay[..., 1::3] = ((a >> 8) & 0x0F) | ((b & 0x0F) << 4)
        pay[..., 2::3] = (b >> 4) & 0xFF
        head = rec[:, :, :K2_HEAD]
        xs = np.tile(np.arange(15, -1, -1) * 16, 2)
        ys = np.repeat([0, 930], 16)
        fid = 100 + np.arange(n)
        fields = ((0, 4, np.uint32(0xFFFF0055)), (20, 2, 256), (22, 2, 1860),
                  (24, 4, fid[:, None]), (28, 2, xs), (30, 2, ys),
                  (32, 2, xs + 15), (34, 2, ys + 929), (36, 4, K2_BLOCK))
        head[:, :, 8] = 1
        head[:, :, 9] = 1  # shutter active
        for off, size, val in fields:
            v = np.broadcast_to(np.asarray(val, np.int64), (n, 32))
            for j in range(size):
                head[:, :, off + j] = (v >> (8 * (size - 1 - j))) & 0xFF
        path = os.path.join(dirpath, f"k2is{s}.bin")
        rec.tofile(path)
        return path

    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(sector, range(K2_SECTORS)))
    return paths[0], K2_SECTORS * n * 32 * K2_BLOCK


def dm4_tag_stream(data_bytes: int, count: int, shape: tuple) -> tuple:
    """A DM4 file around one u16 image array of ``count`` items: the
    bytes before the array's data and after it.  (DM4: big-endian tag
    headers, a little-endian data flag, ImageList.0.ImageData.Data and
    its Dimensions, x fastest.)"""
    import struct

    def data_tag(name, payload_defs, payload):
        body = b"%%%%" + struct.pack(">q", len(payload_defs)) + b"".join(
            struct.pack(">q", d) for d in payload_defs) + payload
        return (bytes([0x15]) + struct.pack(">h", len(name)) + name.encode()
                + struct.pack(">q", len(body)) + body)

    def group(name, children):
        inner = bytes([1, 0]) + struct.pack(">q", len(children)) + b"".join(
            children)
        return (bytes([0x14]) + struct.pack(">h", len(name)) + name.encode()
                + struct.pack(">q", len(inner)) + inner)

    dims = group("Dimensions", [data_tag(str(i), [3], struct.pack("<i", d))
                                for i, d in enumerate(reversed(shape))])
    array_head = data_tag("Data", [20, 4, count], b"")
    # the Data tag's byte count covers its payload, which follows
    name_len = 1 + 2 + 4
    total = struct.unpack(">q", array_head[name_len:name_len + 8])[0]
    array_head = (array_head[:name_len] + struct.pack(">q", total + data_bytes)
                  + array_head[name_len + 8:])
    image_data = (bytes([0x14]) + struct.pack(">h", 9) + b"ImageData")
    inner_head = bytes([1, 0]) + struct.pack(">q", 2)
    img_len = len(inner_head) + len(array_head) + data_bytes + len(dims)
    entry_inner_head = bytes([1, 0]) + struct.pack(">q", 1)
    entry_len = len(entry_inner_head) + len(image_data) + 8 + img_len
    list_head = bytes([1, 0]) + struct.pack(">q", 1)
    list_len = len(list_head) + 1 + 2 + 1 + 8 + entry_len
    root_head = bytes([1, 0]) + struct.pack(">q", 1)
    root_len = len(root_head) + 1 + 2 + 9 + 8 + list_len
    before = (struct.pack(">i", 4) + struct.pack(">q", root_len)
              + struct.pack(">i", 1) + root_head
              + bytes([0x14]) + struct.pack(">h", 9) + b"ImageList"
              + struct.pack(">q", list_len) + list_head
              + bytes([0x14]) + struct.pack(">h", 1) + b"0"
              + struct.pack(">q", entry_len) + entry_inner_head
              + image_data + struct.pack(">q", img_len) + inner_head
              + array_head)
    return before, dims


def ser_prefix(n: int, h: int, w: int, dtype_code: int, itemsize: int):
    """The TIA series header, its dimension record and offset tables for
    ``n`` 2-D elements that follow back to back, each a 50-byte element
    header and h x w items.  Returns (prefix, element header)."""
    import struct
    head = struct.pack("<hhhiiii", 0x4949, 0x0197, 0x0220, 0x4122, 0x4152,
                       n, n)
    dim_record = (struct.pack("<i", n) + struct.pack("<ddi", 0.0, 1.0, 0)
                  + struct.pack("<i", 0) + struct.pack("<i", 0))
    data_start = 34 + len(dim_record)
    first = data_start + 16 * n
    elem = 50 + h * w * itemsize
    offsets = first + np.arange(n, dtype="<i8") * elem
    prefix = (head + struct.pack("<qi", data_start, 1) + dim_record
              + offsets.tobytes() + np.zeros(n, "<i8").tobytes())
    element = (struct.pack("<ddi", 0.0, 1.0, 0) * 2
               + struct.pack("<hii", dtype_code, w, h))
    return prefix, np.frombuffer(element, np.uint8)


def format_udfs(lt, sig):
    """The main path's five UDFs at a format's sig: ApplyMasks (a disk
    and a ring around the centre), CoM, Sum, SumSig, StdDev."""
    h, w = sig
    cy, cx, r = h // 2, w // 2, min(h, w) // 4
    masks = np.stack([lt.masks.circular(cx, cy, w, h, r // 2),
                      lt.masks.ring(cx, cy, w, h, 2 * r - 2, r)])
    return [
        lt.ApplyMasksUDF(mask_factories=lambda: masks, mask_count=2),
        lt.CoMUDF.with_params(cy=cy, cx=cx, r=r),
        lt.SumUDF(), lt.SumSigUDF(), lt.StdDevUDF(),
    ], masks, (cy, cx), r


def formats_phase(ctx, lt, data, tmp, at, failures) -> dict:
    """Phase 12: every ported format through ``Context.load`` and
    ``run_udf`` with the main path's UDFs at the format's sig, each pass
    with the launch count set to 0 just before and read just after,
    against float64 numpy answers of the frames the writer was given,
    5 frames bit for bit, detection by ``load("auto")``; MIB r12 traced
    once more.  The frames come from phase 2's Poisson(8) scan.
    Returns the launch count of each pass."""
    import struct

    import torch

    from libertem_tpu_torch.io.dataset import detect
    from libertem_tpu_torch.ops import decode
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.udf.base import UDFRunner

    flat = data.reshape(-1)
    launches = {}
    rows = []

    def nav_of(nav):
        return (max(1, nav[0] // FMT_NAV_DIV),) + tuple(nav[1:])

    def frames_of(px):
        return flat[:flat.size // px * px].reshape(-1, px)

    def run(label, kind, load_kw, frames, n, sig, nav, disk_bytes, files,
            dtype, auto_path, auto_kw=None, plan=None, trace=False):
        ds = ctx.load(kind, **load_kw)
        if tuple(ds.shape) != nav + sig or ds.meta.native_dtype != dtype:
            failures.append(f"12{label}: shape {tuple(ds.shape)} "
                            f"{ds.meta.native_dtype}, expected "
                            f"{nav + sig} {dtype}")
            return
        udfs, masks, centre, r = format_udfs(lt, sig)
        prep = UDFRunner(udfs)._prepare(ds, ctx.device)
        blocks = sum(-(-p.num_frames // prep["scheme"].depth)
                     for p in prep["partitions"])
        expected = blocks  # one launch a block, for any mask count
        dec0 = dict(decode.stats)
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, udfs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = fused_moments.launches
        stats = dict(ctx.feed_stats)
        dec_s = decode.stats["decode_s"] - dec0["decode_s"]
        calls = decode.stats["calls"] - dec0["calls"]
        decoded = n * int(np.prod(sig)) * dtype.itemsize
        row = dict(path=f"12{label}", wall_s=secs, disk_bytes=disk_bytes,
                   decoded_bytes=decoded, disk_gbps=disk_bytes / secs / 1e9,
                   decoded_gbps=decoded / secs / 1e9,
                   reader_share=stats["read_s"] / secs,
                   consumer_wait_share=stats["wait_s"] / secs,
                   blocks=stats["blocks"], depth=prep["scheme"].depth,
                   decode_calls=calls,
                   decode_ms_per_block=dec_s * 1e3 / max(stats["blocks"], 1),
                   launches=count, fused=ctx.run_info["fused"])
        rows.append(row)
        launches[f"{label} (phase 12)"] = count
        print(f"12{label}: {secs:.3f} s wall; {disk_bytes} bytes on disk "
              f"({row['disk_gbps']:.2f} GB/s), {decoded} decoded "
              f"({row['decoded_gbps']:.2f} GB/s); reader "
              f"{row['reader_share']:.1%} of the wall, consumer waited "
              f"{row['consumer_wait_share']:.1%}; {stats['blocks']} blocks "
              f"of {prep['scheme'].depth} frames, C++ decode "
              f"{row['decode_ms_per_block']:.2f} ms a block ({calls} "
              f"calls); fused {row['fused']}, fused_moments launches "
              f"{count} {at}")
        if count != expected or count == 0 or not row["fused"]:
            failures.append(f"12{label}: {count} launches (expected "
                            f"{expected}), fused {row['fused']}")
        t0 = time.perf_counter()
        want = oracle_at(frames, n, sig, nav, masks, centre, r, plan)
        print(f"  oracle 12{label}: {time.perf_counter() - t0:.1f} s "
              f"(float64 numpy)")
        # float32 sums over frames of 65536 to 3.8 million pixels round:
        # what derives from the centres of mass takes the centres'
        # magnitude as its floor (as phase 6a's corrected data)
        check_results(f"12{label}", res, want, failures, shift_floor=True)
        # 5 frames bit for bit, as stored (no correction)
        ids = np.sort(np.random.default_rng(SEED + 12).choice(
            n, 5, replace=False))
        roi = np.zeros(n, bool)
        roi[ids] = True
        pick = ctx.run_udf(ds, lt.PickUDF(), roi=roi.reshape(nav),
                           corrections=lt.CorrectionSet())
        got = pick["intensity"].data
        want_px = np.stack([frames(i, i + 1)[0] for i in ids]).astype(dtype)
        if got.dtype != dtype or not np.array_equal(
                got.reshape(5, -1), want_px.reshape(5, -1)):
            failures.append(f"12{label}: picked frames are not bit for bit")
        found = detect(auto_path)
        auto = ctx.load("auto", path=auto_path, **(auto_kw or {}))
        ok = (found is not None and found["type"] == kind
              and tuple(auto.shape) == nav + sig)
        print(f"  12{label}: 5 picked frames bit for bit, {dtype}; "
              f"load('auto') of {os.path.basename(auto_path)} detects "
              f"{found and found['type']}, shape {tuple(auto.shape)}")
        if not ok:
            failures.append(f"12{label}: load('auto') found {found}, "
                            f"shape {tuple(auto.shape)}")
        if trace:
            print(f"12{label} trace of the pass, run again:")
            traced_run(ctx, ds, format_udfs(lt, sig)[0], at)
        del ds, auto, res, pick
        for f in files:
            os.remove(f)

    def written(label, t0, nbytes):
        print(f"12{label} data: {nbytes} bytes written in "
              f"{time.perf_counter() - t0:.1f} s")

    # -- (a-d) MIB ------------------------------------------------------------
    sig, px = (256, 256), 65536
    f16 = frames_of(px)                      # the scan as 16384 frames
    half = len(f16) // 2
    mibs = [
        # label, frames, nav, dtype, bit depth, encoder, bytes a pixel
        ("a MIB r12 256x256", lambda lo, hi: f16[lo:hi], (128, 128),
         np.dtype(np.uint16), 12, enc_r12, 2),
        ("b MIB r1 256x256", lambda lo, hi: (f16[lo:hi] & 1).astype(
            np.uint8), (128, 128), np.dtype(np.uint8), 1, enc_r1, 1 / 8),
        ("b MIB r6 256x256", lambda lo, hi: (f16[lo:hi] & 63).astype(
            np.uint8), (128, 128), np.dtype(np.uint8), 6, enc_r6, 1),
        ("c MIB r24 256x256", lambda lo, hi: (
            f16[lo:hi].astype(np.uint32) << 12) | f16[half + lo:half + hi],
         (64, 64), np.dtype(np.uint32), 24, enc_r24, 4),
    ]
    for label, frames, nav, dtype, bd, enc, per_px in mibs:
        nav = nav_of(nav)
        n = int(np.prod(nav))
        path = os.path.join(tmp, "scan1.mib")
        t0 = time.perf_counter()
        width = 2 * sig[1] if bd == 24 else sig[1]
        nbytes = write_records(
            path, n, int(px * per_px), lambda lo, hi: enc(frames(lo, hi)),
            head=MIB_HEAD, head_fn=mib_heads(MIB_HEAD, 1, width, sig[0],
                                             "R64", "1x1", bd))
        written(label, t0, nbytes)
        run(label, "mib", dict(path=path, nav_shape=nav), frames, n, sig,
            nav, nbytes, [path], dtype, path, dict(nav_shape=nav),
            trace=bd == 12)
    # the quad: 2048 frames of 512 x 512
    qsig, qpx = (512, 512), 512 * 512
    f512 = frames_of(qpx)
    path = os.path.join(tmp, "quad1.mib")
    nav = nav_of((32, 64))
    n = int(np.prod(nav))
    t0 = time.perf_counter()
    nbytes = write_records(
        path, n, 2 * qpx,
        lambda lo, hi: enc_r12(quad_store(f512[lo:hi].reshape(-1, *qsig))),
        head=MIB_QUAD_HEAD, head_fn=mib_heads(MIB_QUAD_HEAD, 4, 1024, 256,
                                              "R64", "2x2", 12))
    written("d MIB quad r12 512x512", t0, nbytes)
    run("d MIB quad r12 512x512", "mib", dict(path=path, nav_shape=nav),
        lambda lo, hi: f512[lo:hi], n, qsig, nav, nbytes, [path],
        np.dtype(np.uint16), path, dict(nav_shape=nav))

    # -- (e) K2IS -------------------------------------------------------------
    ksig = (1860, 2048)
    fk = frames_of(ksig[0] * ksig[1])
    k2dir = os.path.join(tmp, "k2is")
    os.makedirs(k2dir)
    nav = nav_of((16, 16))
    n = int(np.prod(nav))
    t0 = time.perf_counter()
    p0, nbytes = write_k2is(k2dir, fk[:n].reshape(n, *ksig))
    written("e K2IS 8 sectors", t0, nbytes)
    run("e K2IS 8 sectors", "k2is", dict(path=p0, nav_shape=nav),
        lambda lo, hi: fk[lo:hi], n, ksig, nav, nbytes,
        [os.path.join(k2dir, f) for f in os.listdir(k2dir)],
        np.dtype(np.uint16), p0, dict(nav_shape=nav))

    # -- (f) the other formats, 256-512 MiB each --------------------------
    # FRMS6: pnCCD frames of 264 x 264, stored folded (132, 528), a dark
    # file of 32 frames applied as the dataset's own correction
    fsig, stored = (264, 264), (132, 528)
    ff = frames_of(fsig[0] * fsig[1])
    fnav = nav_of((32, 60))
    n = int(np.prod(fnav))
    dark_frames = ff[n:n + FRMS6_DARK_FRAMES].reshape(-1, *fsig)

    def fold(x):
        x = x.reshape(-1, *fsig)
        out = np.empty((len(x),) + stored, np.uint16)
        out[:, :, :264] = x[:, :132]
        out[:, :, 264:] = x[:, 132:][:, ::-1, ::-1]
        return u8(out)

    def frms6_header(k):
        head = bytearray(1024)
        head[0:4] = struct.pack("<HH", 1024, 64)
        head[7] = 6
        head[88:92] = struct.pack("<HH", stored[1], stored[0])
        head[1020:1024] = struct.pack("<I", k)
        return bytes(head)

    t0 = time.perf_counter()
    dark_path = os.path.join(tmp, "pn_000.frms6")
    path = os.path.join(tmp, "pn_001.frms6")
    nbytes = write_records(dark_path, FRMS6_DARK_FRAMES, 2 * 132 * 528,
                           lambda lo, hi: fold(dark_frames[lo:hi]), head=64,
                           prefix=frms6_header(FRMS6_DARK_FRAMES))
    nbytes += write_records(path, n, 2 * 132 * 528,
                            lambda lo, hi: fold(ff[lo:hi]), head=64,
                            prefix=frms6_header(n))
    written("f FRMS6 264x264 + dark", t0, nbytes)
    dark = dark_frames.astype(np.float64).mean(axis=0).astype(np.float32)
    plan = lt.CorrectionSet(dark=dark).make_plan(fsig)
    run("f FRMS6 264x264, dark-corrected", "frms6",
        dict(path=path, nav_shape=fnav), lambda lo, hi: ff[lo:hi], n,
        fsig, fnav, nbytes, [path, dark_path], np.dtype(np.uint16), path,
        dict(nav_shape=fnav), plan=plan)

    others = []
    # EMPAD: 128 x 128 float32 frames stored as 130 x 128
    f128 = frames_of(128 * 128)

    def empad_frames(lo, hi):
        return f128[lo:hi].astype(np.float32) * np.float32(0.5)

    raw = os.path.join(tmp, "empad.raw")
    xml = os.path.join(tmp, "empad.xml")
    with open(xml, "w") as f:
        f.write('<root><raw_file filename="empad.raw"/><type>scan</type>'
                '<scan_parameters mode="acquire"><scan_resolution_x>64'
                '</scan_resolution_x><scan_resolution_y>'
                f'{nav_of((64, 64))[0]}</scan_resolution_y>'
                '</scan_parameters></root>')
    others.append(("f EMPAD 128x128 f32", "empad", dict(path=xml),
                   empad_frames, (128, 128), (64, 64), raw,
                   dict(pbytes=128 * 128 * 4, tail=2 * 128 * 4,
                        payload=lambda lo, hi: u8(empad_frames(lo, hi))),
                   [raw, xml], np.dtype(np.float32), xml, {}))
    # SEQ: 512 x 512 u16, version 5, frames padded to true_image_size
    fs = frames_of(512 * 512)
    seq_head = bytearray(8192)
    seq_head[0:4] = struct.pack("<L", 0xFEED)
    seq_head[28:32] = struct.pack("<l", 5)
    seq_head[32:36] = struct.pack("<l", 8192)
    seq_head[548:580] = struct.pack("<LLLLLLLL", 512, 512, 16, 12,
                                    512 * 512 * 2, 0, 0, 0)
    seq_head[580:584] = struct.pack("<L", 512 * 512 * 2 + 512)
    seq = os.path.join(tmp, "scan.seq")
    others.append(("f SEQ 512x512 u16", "seq",
                   dict(path=seq, nav_shape=(16, 32)),
                   lambda lo, hi: fs[lo:hi], (512, 512), (16, 32), seq,
                   dict(pbytes=512 * 512 * 2, tail=512,
                        payload=lambda lo, hi: u8(fs[lo:hi]),
                        prefix=bytes(seq_head)),
                   [seq], np.dtype(np.uint16), seq, dict(nav_shape=(16, 32))))
    # TVIPS: 512 x 512 u16, version 2, 12-byte frame headers
    tv = os.path.join(tmp, "tv_000.tvips")
    tv_head = struct.pack("<13i", 256, 2, 512, 512, 16, 0, 0, 1, 1, 10, 200,
                          1, 12).ljust(256, b"\x00")
    others.append(("f TVIPS 512x512 u16", "tvips",
                   dict(path=tv, nav_shape=(16, 32)),
                   lambda lo, hi: fs[lo:hi], (512, 512), (16, 32), tv,
                   dict(pbytes=512 * 512 * 2, head=12,
                        payload=lambda lo, hi: u8(fs[lo:hi]),
                        prefix=tv_head),
                   [tv], np.dtype(np.uint16), tv, dict(nav_shape=(16, 32))))
    # BLO: 256 x 256 u8, nav (64, 64) from its header
    blo = os.path.join(tmp, "scan.blo")
    blo_head = bytearray(2048)
    blo_head[0:6] = b"IMGBLO"
    struct.pack_into("<HIIIHHHH", blo_head, 6, 258, 1024, 2048, 0, 256, 0,
                     64, nav_of((64, 64))[0])

    def blo_frames(lo, hi):
        return (f16[lo:hi] & 0xFF).astype(np.uint8)

    others.append(("f BLO 256x256 u8", "blo", dict(path=blo), blo_frames,
                   (256, 256), (64, 64), blo,
                   dict(pbytes=px, head=6, payload=blo_frames,
                        prefix=bytes(blo_head)),
                   [blo], np.dtype(np.uint8), blo, {}))
    # NPY: (32, 64, 256, 256) u16
    npy = os.path.join(tmp, "scan.npy")
    npy_head = npy_header(nav_of((32, 64)) + (256, 256), "<u2")
    others.append(("f NPY 256x256 u16", "npy", dict(path=npy),
                   lambda lo, hi: f16[lo:hi], (256, 256), (32, 64),
                   npy, dict(pbytes=2 * px,
                             payload=lambda lo, hi: u8(f16[lo:hi]),
                             prefix=npy_head),
                   [npy], np.dtype(np.uint16), npy, {}))
    # MRC: 256 x 256 float32 (mode 2), 1024 frames
    mrc = os.path.join(tmp, "scan.mrc")
    mrc_head = bytearray(1024)
    mrc_head[0:16] = struct.pack("<4i", 256, 256,
                                 int(np.prod(nav_of((32, 32)))), 2)

    def mrc_frames(lo, hi):
        return f16[lo:hi].astype(np.float32) * np.float32(0.25)

    others.append(("f MRC 256x256 f32", "mrc",
                   dict(path=mrc, nav_shape=(32, 32)), mrc_frames,
                   (256, 256), (32, 32), mrc,
                   dict(pbytes=4 * px, payload=lambda lo, hi: u8(
                       mrc_frames(lo, hi)), prefix=bytes(mrc_head)),
                   [mrc], np.dtype(np.float32), mrc,
                   dict(nav_shape=(32, 32))))
    # SER: 2048 elements of 256 x 256 u16
    ser = os.path.join(tmp, "scan.ser")
    ser_pre, ser_elem = ser_prefix(int(np.prod(nav_of((32, 64)))), 256, 256,
                                   2, 2)
    others.append(("f SER 256x256 u16", "ser",
                   dict(path=ser, nav_shape=(32, 64)),
                   lambda lo, hi: f16[lo:hi], (256, 256), (32, 64), ser,
                   dict(pbytes=2 * px, head=50,
                        head_fn=lambda lo, hi: np.tile(ser_elem,
                                                       (hi - lo, 1)),
                        payload=lambda lo, hi: u8(f16[lo:hi]),
                        prefix=ser_pre),
                   [ser], np.dtype(np.uint16), ser, dict(nav_shape=(32, 64))))
    # DM4: a (2048, 256, 256) u16 stack
    dm = os.path.join(tmp, "scan.dm4")
    n_dm = int(np.prod(nav_of((32, 64))))
    dm_before, dm_after = dm4_tag_stream(n_dm * 2 * px, n_dm * px,
                                         (n_dm, 256, 256))
    others.append(("f DM4 256x256 u16", "dm",
                   dict(path=dm, nav_shape=(32, 64)),
                   lambda lo, hi: f16[lo:hi], (256, 256), (32, 64), dm,
                   dict(pbytes=2 * px, payload=lambda lo, hi: u8(f16[lo:hi]),
                        prefix=dm_before, suffix=dm_after),
                   [dm], np.dtype(np.uint16), dm, dict(nav_shape=(32, 64))))
    for (label, kind, load_kw, frames, fsig, nav, path, wkw, files,
         dtype, auto_path, auto_kw) in others:
        nav = nav_of(nav)
        n = int(np.prod(nav))
        for kw in (load_kw, auto_kw):
            if "nav_shape" in kw:
                kw["nav_shape"] = nav
        t0 = time.perf_counter()
        suffix = wkw.pop("suffix", b"")
        nbytes = write_records(path, n, **wkw)
        if suffix:
            with open(path, "ab") as f:
                f.write(suffix)
            nbytes += len(suffix)
        written(label, t0, nbytes)
        run(label, kind, load_kw, frames, n, fsig, nav, nbytes, files,
            dtype, auto_path, auto_kw)
    print("phase 12 summary: " + json.dumps(rows))
    return launches


# -- phase 13: raw CSR, live, array-like, HDF5 and the repaired API ----------

EVT_NAV = (256, 256)
EVT_SIG = (256, 256)
EVT_RATE = 400       # single-electron events a frame (Poisson mean)
EVT_SIGMA = 20.0     # px, the disk that half of them fall in
CSR_SYNC = 100       # phase 13(a)'s sync offset
LIVE_RING = 2048     # frames of 13(b)'s ring: blocks of up to 1024
LIVE_EARLY = 40000   # frames pushed before 13(b)'s early finish()


def write_events(dirpath: str, nav: tuple, sig: tuple):
    """An event-counting scan as raw CSR: per frame Poisson(EVT_RATE)
    single electrons, half in a Gaussian disk (sigma EVT_SIGMA) whose
    centre wobbles with the scan position, half uniform; each frame's
    hits counted per pixel (``<u2``), ``<i4`` pixel indices, ``<i8``
    row pointers, and every 97th frame's first pixel listed twice.
    Returns the TOML path, the scipy CSR matrix and the bytes on disk."""
    import scipy.sparse as sp

    n = int(np.prod(nav))
    h, w = sig
    chunk = 4096
    seeds = np.random.SeedSequence(SEED + 13).spawn(-(-n // chunk))

    def part(i):
        rng = np.random.default_rng(seeds[i])
        lo, hi = i * chunk, min(n, (i + 1) * chunk)
        counts = rng.poisson(EVT_RATE, hi - lo)
        frame = np.repeat(np.arange(hi - lo), counts)
        first = np.repeat(np.cumsum(counts) - counts, counts)
        disk = np.arange(len(frame)) - first < np.repeat(counts // 2, counts)
        sy, sx = np.divmod(np.arange(lo, hi), nav[-1])
        cy = h / 2 + 6 * np.sin(2 * np.pi * sy / nav[0])
        cx = w / 2 + 6 * np.cos(2 * np.pi * sx / nav[-1])
        ey = np.where(disk, rng.normal(cy[frame], EVT_SIGMA),
                      rng.uniform(0, h, len(frame)))
        ex = np.where(disk, rng.normal(cx[frame], EVT_SIGMA),
                      rng.uniform(0, w, len(frame)))
        py = np.clip(ey.astype(np.int64), 0, h - 1)
        px = np.clip(ex.astype(np.int64), 0, w - 1)
        keys, hits = np.unique(frame * (h * w) + py * w + px,
                               return_counts=True)
        return (np.bincount(keys // (h * w), minlength=hi - lo),
                keys % (h * w), hits)

    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(part, range(len(seeds))))
    per = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] for p in parts]).astype("<i4")
    vals = np.concatenate([p[2] for p in parts]).astype("<u2")
    starts = np.concatenate(([0], np.cumsum(per)[:-1]))
    dup = np.flatnonzero((np.arange(n) % 97 == 0) & (per > 0))
    cols = np.insert(cols, starts[dup] + 1, cols[starts[dup]])
    vals = np.insert(vals, starts[dup] + 1, 1).astype("<u2")
    per[dup] += 1
    indptr = np.concatenate(([0], np.cumsum(per))).astype("<i8")
    files = {"indptr": indptr, "indices": cols, "data": vals}
    for key, arr in files.items():
        arr.tofile(os.path.join(dirpath, f"{key}.bin"))
    toml = os.path.join(dirpath, "events.toml")
    with open(toml, "w") as f:
        f.write('[params]\nfiletype = "raw_csr"\n'
                f"nav_shape = {list(nav)}\nsig_shape = {list(sig)}\n\n"
                "[raw_csr]\n" + "".join(
                    f'{key}_file = "{key}.bin"\n'
                    f'{key}_dtype = "{arr.dtype.str}"\n'
                    for key, arr in files.items()))
    mat = sp.csr_matrix((vals, cols, indptr), shape=(n, h * w))
    return toml, mat, sum(a.nbytes for a in files.values())


def csr_oracle(mat, rows, roi, nav, sig, masks, centre, r) -> dict:
    """float64 answers of ``format_udfs`` over a raw CSR scan from the
    scipy matrix: dataset frame i is stored row ``rows[i]`` (a blank
    frame where that is -1), the run over the ``roi``'s frames (nan
    outside it in the nav results).  Products, column sums and sums of
    squares of the matrix after ``sum_duplicates``, never the dense
    frames."""
    import scipy.sparse as sp

    n = int(np.prod(nav))
    sel = np.ones(n, bool) if roi is None else roi.reshape(-1)
    keep = rows[sel]
    d = mat[np.where(keep >= 0, keep, 0)]
    d = sp.diags((keep >= 0).astype(np.float64)) @ d.astype(np.float64)
    d = sp.csr_matrix(d)
    d.sum_duplicates()
    h, w = sig
    k = masks.shape[0]
    cy, cx = centre
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    disk = (((y - cy) ** 2 + (x - cx) ** 2) <= r ** 2).astype(np.float64)
    operand = np.concatenate([
        masks.reshape(k, -1).astype(np.float64),
        np.stack([disk, y * disk, x * disk]).reshape(3, -1),
        np.ones((1, h * w)),
    ]).T
    proj = np.asarray(d @ operand)
    m = d.shape[0]
    s1 = np.asarray(d.sum(axis=0)).reshape(-1)
    sq = np.asarray(d.multiply(d).sum(axis=0)).reshape(-1)
    mean = s1 / m
    var = sq / m - mean ** 2

    def full(a):
        out = np.full((n,) + a.shape[1:], np.nan)
        out[sel] = a
        return out.reshape(nav + a.shape[1:])

    com = np.full((n, 2), np.nan)
    com[sel] = centres_of_mass(proj[:, k:k + 3], centre)
    return {
        (0, "intensity"): full(proj[:, :k]),
        **com_oracle(com, nav, centre),
        (2, "intensity"): s1.reshape(sig),
        (3, "intensity"): full(proj[:, k + 3]),
        (4, "num_frames"): np.array([float(m)]),
        (4, "sum"): s1.reshape(sig),
        (4, "mean"): mean.reshape(sig),
        (4, "var"): var.reshape(sig),
        (4, "std"): np.sqrt(var).reshape(sig),
    }


def truncated_oracle(want4, data, keep: int) -> dict:
    """Phase 4's answers for the scan of which only the first ``keep``
    frames arrived, the rest blank (no mass: CoM at the centre); the
    per-pixel sums drop the frames that did not come (float64 sums of
    squares in chunks, exact for these counts)."""
    n = int(np.prod(NAV))
    flat = data.reshape(n, -1)
    k = want4[(0, "intensity")].shape[-1]

    def cut(a, fill=0.0):
        a = a.reshape(n, -1).copy()
        a[keep:] = fill
        return a

    parts = in_chunks(np.arange(keep, n), lambda lo, ids: (
        flat[ids].astype(np.float64).sum(0),
        (flat[ids].astype(np.float64) ** 2).sum(0)))
    gone1 = sum(p[0] for p in parts)
    gone2 = sum(p[1] for p in parts)
    mean4 = want4[(4, "mean")].reshape(-1)
    sumsq = n * (want4[(4, "var")].reshape(-1) + mean4 ** 2) - gone2
    s1 = want4[(4, "sum")].reshape(-1) - gone1
    mean = s1 / n
    var = sumsq / n - mean ** 2
    return {
        (0, "intensity"): cut(want4[(0, "intensity")]).reshape(NAV + (k,)),
        **com_oracle(cut(want4[(1, "raw_com")], 64.0), NAV),
        (2, "intensity"): s1.reshape(SIG),
        (3, "intensity"): cut(want4[(3, "intensity")]).reshape(NAV),
        (4, "num_frames"): np.array([float(n)]),
        (4, "sum"): s1.reshape(SIG),
        (4, "mean"): mean.reshape(SIG),
        (4, "var"): var.reshape(SIG),
        (4, "std"): np.sqrt(var).reshape(SIG),
    }


def run_row(label, ctx, secs, nbytes, launches) -> dict:
    """Phase 13's line of a pass: wall, GB/s, the reader's share, the
    consumer's wait, blocks and launches."""
    st = dict(ctx.feed_stats)
    row = dict(path=label, wall_s=secs, bytes=nbytes,
               gbps=nbytes / secs / 1e9, reader_share=st["read_s"] / secs,
               consumer_wait_share=st["wait_s"] / secs,
               blocks=st["blocks"], h2d_bytes=st["h2d_bytes"],
               launches=launches, fused=ctx.run_info["fused"])
    print(f"{label}: {secs:.3f} s wall, {nbytes} bytes ({row['gbps']:.2f} "
          f"GB/s); reader {row['reader_share']:.1%} of the wall, consumer "
          f"waited {row['consumer_wait_share']:.1%}; {st['blocks']} blocks, "
          f"fused {row['fused']}, fused_moments launches {launches}")
    return row


def slice11_phase(ctx, lt, path, data, want4, tmp, at, failures) -> dict:
    """Phase 13: raw CSR at event-counting scale (densified on the
    card), a live acquisition, an array-like, HDF5 where h5py imports,
    and the repaired public API; each pass through ``Context`` with the
    launch count set to 0 just before and read just after, against
    float64 answers.  Returns the launch count of each pass."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from libertem_tpu_torch.io.dataset.base import densify_into
    from libertem_tpu_torch.io.dataset.live import LiveDataSet
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.udf.base import UDFRunner

    launches, rows = {}, []
    n4 = int(np.prod(NAV))
    main_bytes = data.nbytes

    def counted(fn):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, fused_moments.launches

    def expect(label, ctx_, count):
        blocks = ctx_.feed_stats["blocks"]
        if count == 0 or count != blocks or not ctx_.run_info["fused"]:
            failures.append(f"{label}: {count} launches for {blocks} "
                            f"blocks, fused {ctx_.run_info['fused']}")

    # -- (a) raw CSR ---------------------------------------------------------
    t0 = time.perf_counter()
    toml, mat, disk_bytes = write_events(tmp, EVT_NAV, EVT_SIG)
    n = mat.shape[0]
    px = int(np.prod(EVT_SIG))
    dense_bytes = n * px * 2
    print(f"13a data: {mat.nnz} entries of {n} frames ({mat.nnz / n:.0f} a "
          f"frame), {disk_bytes} bytes on disk, {dense_bytes} dense as u16; "
          f"written in {time.perf_counter() - t0:.1f} s")
    ds = ctx.load("raw_csr", path=toml)
    udfs, masks, centre, r = format_udfs(lt, EVT_SIG)
    prep = UDFRunner(udfs)._prepare(ds, ctx.device)
    depth = prep["scheme"].depth
    half = np.zeros(EVT_NAV, bool)
    half[:EVT_NAV[0] // 2] = True
    ident = np.arange(n)
    shifted = ident + CSR_SYNC
    shifted[shifted >= n] = -1
    for label, kw, rows_of, roi in (
            ("13a raw CSR", {}, ident, None),
            (f"13a raw CSR, sync_offset {CSR_SYNC}",
             {"sync_offset": CSR_SYNC}, shifted, None),
            ("13a raw CSR, roi of half the scan", {}, ident, half)):
        ds = ctx.load("raw_csr", path=toml, **kw)
        res, secs, count = counted(lambda: ctx.run_udf(
            ds, format_udfs(lt, EVT_SIG)[0], roi=roi))
        row = run_row(label, ctx, secs, disk_bytes, count)
        frames = n if roi is None else int(roi.sum())
        row.update(dense_bytes=frames * px * 2,
                   dense_gbps=frames * px * 2 / secs / 1e9,
                   h2d_per_block=row["h2d_bytes"] / max(row["blocks"], 1),
                   dense_per_block=depth * px * 2)
        rows.append(row)
        launches[f"{label} (phase 13)"] = count
        print(f"  {frames * px * 2} bytes dense ({row['dense_gbps']:.2f} GB/s "
              f"of dense frames); H2D {row['h2d_per_block']:.0f} bytes a "
              f"block of {depth} frames, dense {row['dense_per_block']} "
              f"({row['h2d_per_block'] / row['dense_per_block']:.2%}) {at}")
        if count != row["blocks"] or not row["fused"]:
            failures.append(f"{label}: {count} launches for {row['blocks']} "
                            f"blocks")
        if row["h2d_per_block"] > 0.1 * row["dense_per_block"]:
            failures.append(f"{label}: H2D bytes do not follow the entries")
        t0 = time.perf_counter()
        want = csr_oracle(mat, rows_of, roi, EVT_NAV, EVT_SIG, masks, centre,
                          r)
        print(f"  oracle: {time.perf_counter() - t0:.1f} s (scipy.sparse, "
              f"float64)")
        check_results(label, res, want, failures)
    # the densify's device time: one traced run, and CUDA events on a
    # block of the run
    ds = ctx.load("raw_csr", path=toml)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.run_udf(ds, format_udfs(lt, EVT_SIG)[0])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    device_us = device_busy(prof)
    # the densify's kernels: index_put_'s bounds checks (reductions of
    # the long indices, an assert), the sort, the indexed add, the zero
    dens_us = {k: v for k, v in device_us.items() if re.search(
        r"index|[Ss]ort|[Ff]ill|_assert_async|ReduceOp<long", k)}
    busy = sum(device_us.values()) / 1e6
    print(f"13a trace: {traced_s:.3f} s wall, device activity {busy:.4f} s, "
          f"idle share {1 - busy / traced_s:.2%}; densify items "
          f"{sum(dens_us.values()) / 1e3:.3f} ms in all {at}")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {us / 1e3:9.3f} ms  {key[:90]}")
    part = next(iter(ds.get_partitions()))
    block = next(part.gen_blocks(prep["scheme"]))
    triple = [torch.from_numpy(a[:block.nnz]).to(ctx.device)
              for a in block.sparse]
    dense = torch.empty((depth, px), dtype=torch.uint16, device=ctx.device)
    densify_into(dense, *triple)
    want_block = torch.from_numpy(block.data.reshape(depth, px)).to(
        ctx.device)
    if not torch.equal(dense, want_block):
        failures.append("13a: the densify on the card differs from the "
                        "host's np.add.at")
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(50):
        densify_into(dense, *triple)
    end.record()
    torch.cuda.synchronize()
    print(f"13a densify: {start.elapsed_time(end) / 50:.4f} ms a block of "
          f"{block.nnz} entries ({depth} x {px}, CUDA events, "
          f"50 calls); equal to the host's np.add.at {at}")
    del mat, ds

    # -- (b) live --------------------------------------------------------------
    raw = np.memmap(path, dtype=np.uint16, mode="r", shape=(n4,) + SIG)

    def producer(ds, upto, gate=None):
        def push():
            for lo in range(0, upto, 1024):
                ds.push_frames(raw[lo:min(lo + 1024, upto)])
            if gate is not None:
                gate.wait()
            else:
                ds.finish()

        t = threading.Thread(target=push, daemon=True)
        t.start()
        return t

    live = LiveDataSet(nav_shape=NAV, sig_shape=SIG, dtype=np.uint16,
                       ring_capacity=LIVE_RING, num_partitions=4).initialize()
    feeder = producer(live, n4)
    partials = []

    def iterate():
        for p in ctx.run_udf_iter(live, make_udfs(lt)):
            partials.append(p)
        return partials[-1]

    final, secs, count = counted(iterate)
    feeder.join(60)
    rows.append(run_row("13b live, 5 UDFs through run_udf_iter", ctx, secs,
                        main_bytes, count))
    print(f"  {len(partials)} partials; block depth "
          f"{ctx.feed_stats['blocks'] and n4 // ctx.feed_stats['blocks']} "
          f"with a ring of {LIVE_RING} frames {at}")
    launches["live (phase 13)"] = count
    expect("13b live", ctx, count)
    check_results("13b live", final.buffers, want4, failures)
    del partials[:]
    live = LiveDataSet(nav_shape=NAV, sig_shape=SIG, dtype=np.uint16,
                       ring_capacity=LIVE_RING, num_partitions=4).initialize()
    feeder = producer(live, LIVE_EARLY)
    res, secs, count = counted(lambda: ctx.run_udf(live, make_udfs(lt)))
    feeder.join(60)
    rows.append(run_row(f"13b live, finish() after {LIVE_EARLY} frames", ctx,
                        secs, main_bytes, count))
    launches["live, early finish (phase 13)"] = count
    expect("13b early finish", ctx, count)
    valid = res[3]["intensity"].valid_mask.reshape(-1)
    if not (valid[:LIVE_EARLY].all() and not valid[LIVE_EARLY:].any()):
        failures.append("13b early finish: damage is not the frames pushed")
    t0 = time.perf_counter()
    want = truncated_oracle(want4, data, LIVE_EARLY)
    print(f"  oracle: {time.perf_counter() - t0:.1f} s (float64 numpy)")
    check_results("13b early finish", res, want, failures)
    live = LiveDataSet(nav_shape=NAV, sig_shape=SIG, dtype=np.uint16,
                       ring_capacity=LIVE_RING, num_partitions=4).initialize()
    # the producer stalls inside the second partition's second block:
    # the first partial comes (with the second partition's first
    # block), and the reader waits in the ring for frames that do not
    depth = UDFRunner(make_udfs(lt))._prepare(live, ctx.device)[
        "scheme"].depth
    stall = next(iter(live.get_partitions())).num_frames + depth + depth // 2
    gate = threading.Event()
    feeder = producer(live, stall, gate)
    gen = ctx.run_udf_iter(live, make_udfs(lt))
    next(gen)
    t0 = time.perf_counter()
    gen.close()
    closed_s = time.perf_counter() - t0
    while readers_alive() and time.perf_counter() - t0 < 5.0:
        time.sleep(0.01)
    ended_s = time.perf_counter() - t0
    gate.set()
    feeder.join(10)
    print(f"13b abandoned after the first partial, the producer stalled at "
          f"{stall} frames ({live.ring.frames_received} pushed): close() "
          f"returned in {closed_s:.3f} s, the reader ended in "
          f"{ended_s:.3f} s")
    if readers_alive() or ended_s >= 5.0:
        failures.append(f"13b abandoned iterator: reader alive "
                        f"{bool(readers_alive())} after {ended_s:.3f} s")
    if feeder.is_alive():
        failures.append("13b abandoned iterator: the producer is stuck")
    del live, gen

    # -- (c) array-like --------------------------------------------------------
    arr = np.memmap(path, dtype=np.uint16, mode="r", shape=NAV + SIG)
    ds = ctx.load("dask", array=arr)
    res, secs, count = counted(lambda: ctx.run_udf(ds, make_udfs(lt)))
    rows.append(run_row("13c array-like (np.memmap)", ctx, secs, main_bytes,
                        count))
    launches["array-like (phase 13)"] = count
    expect("13c array-like", ctx, count)
    check_results("13c array-like", res, want4, failures)
    del ds, arr

    # -- (d) HDF5 --------------------------------------------------------------
    try:
        import h5py
    except ImportError:
        h5py = None
        print("phase 13(d) was not run: h5py is not installed on this "
              "machine")
    if h5py is not None:
        h5 = os.path.join(tmp, "scan.h5")
        t0 = time.perf_counter()
        with h5py.File(h5, "w") as f:
            dset = f.create_dataset("scan/data", shape=NAV + SIG,
                                    dtype=np.uint16, chunks=(1, 16) + SIG)
            for y in range(0, NAV[0], 16):
                dset[y:y + 16] = data[y:y + 16]
        print(f"13d data: {os.path.getsize(h5)} bytes written in "
              f"{time.perf_counter() - t0:.1f} s")
        ds = ctx.load("hdf5", path=h5, ds_path="scan/data")
        res, secs, count = counted(lambda: ctx.run_udf(ds, make_udfs(lt)))
        rows.append(run_row("13d HDF5, chunks (1, 16, 128, 128)", ctx, secs,
                            main_bytes, count))
        launches["HDF5 (phase 13)"] = count
        expect("13d HDF5", ctx, count)
        check_results("13d HDF5", res, want4, failures)
        ids = np.sort(np.random.default_rng(SEED + 13).choice(n4, 5, False))
        roi = np.zeros(n4, bool)
        roi[ids] = True
        pick = ctx.run_udf(ds, lt.PickUDF(), roi=roi.reshape(NAV))
        if not np.array_equal(pick["intensity"].raw_data,
                              data.reshape((n4,) + SIG)[ids]):
            failures.append("13d: picked frames are not bit for bit")
        print("  13d: 5 picked frames bit for bit")
        del ds
        os.remove(h5)

    # -- (e) the repaired API ---------------------------------------------
    half = np.zeros(NAV, bool)
    half[:NAV[0] // 2] = True
    sel = np.flatnonzero(half)
    wmap = np.linspace(0.5, 2.0, SIG[0] * SIG[1]).reshape(SIG).astype(
        np.float32)

    class Weighted(lt.UDF):
        """Each tile weighted with its part of a frame-shaped map."""

        def get_result_buffers(self):
            return {"total": self.buffer("nav", dtype="float32")}

        def get_tiling_preferences(self):
            return {"depth": lt.UDF.TILE_DEPTH_DEFAULT,
                    "total_size": SIG[1] * 32 * 4}

        def process_tile(self, tile):
            if self.meta.dataset_shape.sig_dims != 2:
                raise ValueError("expected 2 sig dims")
            w = dict(self.params.items())["w"]
            cut = self.forbuf(self.meta.sig_slice.get(w, sig_only=True), tile)
            self.results["total"] = self.results["total"] + (
                tile * cut).sum(axis=(1, 2))

    with lt.Context(device=ctx.device) as api_ctx:
        ds = api_ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                          sig_shape=SIG)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            res, secs, count = counted(lambda: api_ctx.run_udf(
                ds, [Weighted(w=wmap), lt.SumUDF()], roi=half))
        rows.append(run_row("13e user tile UDF + SumUDF, roi of half",
                            api_ctx, secs, main_bytes // 2, count))
        tiles = len(UDFRunner([Weighted(w=wmap)])._prepare(
            ds, api_ctx.device)["scheme"])
        check_engines("13e", api_ctx, [False, False], failures)
        flat = data.reshape(n4, -1)
        wflat = wmap.reshape(-1).astype(np.float64)
        parts = in_chunks(sel, lambda lo, ids: (
            flat[ids].astype(np.float64) @ wflat,
            flat[ids].astype(np.float64).sum(0)))
        total = np.full(n4, np.nan)
        total[sel] = np.concatenate([p[0] for p in parts])
        s1 = sum(p[1] for p in parts).reshape(SIG)
        check_results("13e", res, {(0, "total"): total.reshape(NAV)},
                      failures)
        masked = res[1]["intensity"].raw_masked_data
        e, ok = max_err(masked.data, s1)
        print(f"  13e: {tiles} sig tiles a frame; SumUDF raw_masked_data max "
              f"abs err {e:.3g} vs float64, {int(masked.mask.sum())} masked")
        if not ok or masked.mask.any():
            failures.append(f"13e raw_masked_data: max err {e}")
    print("phase 13 summary: " + json.dumps(rows))
    return launches


# -- phase 14: executors, async, delayed, export, snooze, examples -----------

# phase 14(e): frames of the scan written in (sig, nav) order, 256 MiB
TRANSPOSED_FRAMES = 8192
EXAMPLES = ("custom_udf", "holography", "strain_mapping",
            "virtual_detector")


def picklable_udfs(lt):
    """Phase 4's five UDFs with mask factories that pickle (the debug
    executor round-trips the UDFs' arguments through pickle)."""
    import functools
    h, w = SIG
    return [
        lt.ApplyMasksUDF(mask_factories=[
            functools.partial(lt.masks.circular, 64, 64, w, h, 16),
            functools.partial(lt.masks.ring, 64, 64, w, h, 60, 40),
        ]),
        *make_udfs(lt)[1:],
    ]


def slice12_phase(lt, path, data, want4, n_blocks, tmp, at,
                  failures) -> dict:
    """Phase 14: the executors (``make_with``), the async run and
    iterator with live plots, the delayed executor, ``export_dataset``
    and its re-load, ``convert_transposed_to_npy``, snooze and the four
    example scripts, on phase 2's scan with phase 4's UDFs against
    ``want4``; each pass with the launch count set to 0 just before and
    read just after.  Returns the launch count of each pass."""
    import asyncio
    import contextlib
    import io
    import warnings

    import torch

    from libertem_tpu_torch.contrib.convert_transposed import (
        convert_transposed_to_npy,
    )
    from libertem_tpu_torch.executor import InlineJobExecutor
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.viz.base import Dummy2DPlot, Live2DPlot

    launches, rows = {}, []
    nbytes = data.nbytes

    def load(ctx):
        return ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                        sig_shape=SIG)

    def counted(fn):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, fused_moments.launches

    def row(label, secs, count, res=None, want_launches=n_blocks):
        launches[f"{label} (phase 14)"] = count
        rows.append(dict(path=label, wall_s=secs, gbps=nbytes / secs / 1e9,
                         launches=count))
        print(f"{label}: {secs:.3f} s wall, {nbytes / secs / 1e9:.2f} GB/s "
              f"of the scan; fused_moments launches {count} {at}")
        if count != want_launches:
            failures.append(f"{label}: {count} launches, expected "
                            f"{want_launches}")
        if res is not None:
            check_results(label, res, want4, failures)

    # -- (a) the executors -------------------------------------------------
    print(f"14a: {torch.cuda.device_count()} CUDA device(s)")
    for label, make in (
            ("14a make_with('inline')", lambda: lt.Context.make_with("inline")),
            ("14a make_with('sharded')",
             lambda: lt.Context.make_with("sharded")),
            ("14a Context(executor=InlineJobExecutor())",
             lambda: lt.Context(executor=InlineJobExecutor()))):
        ctx = make()
        events = []
        for topic in ("run_udf:start", "run_udf:end"):
            ctx.executor.subscribe(topic, lambda t, m: events.append(t))
        ds = load(ctx)
        res, secs, count = counted(lambda: ctx.run_udf(ds, make_udfs(lt)))
        row(label, secs, count, res)
        print(f"  devices {[str(d) for d in ctx.executor.devices]}, "
              f"events {events}")
        if events != ["run_udf:start", "run_udf:end"]:
            failures.append(f"{label}: events {events}")
        ctx.close()
    ctx = lt.Context(executor=InlineJobExecutor(debug=True))
    ds = load(ctx)
    res, secs, count = counted(lambda: ctx.run_udf(ds, picklable_udfs(lt)))
    row("14a InlineJobExecutor(debug=True)", secs, count, res)

    # -- (b) async ---------------------------------------------------------
    ctx = lt.Context.make_with("inline")
    ds = load(ctx)
    res, secs, count = counted(
        lambda: asyncio.run(ctx.run_udf(ds, make_udfs(lt), sync=False)))
    row("14b run_udf(sync=False)", secs, count, res)

    class Recording(Live2DPlot):
        """Keeps each update's damage count and data."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.updates = []

        def update(self, damage, force=False):
            self.updates.append((int(np.count_nonzero(damage)),
                                 np.array(self.data)))

        def display(self):
            pass

    def bf(intensity):
        return intensity[..., 0]

    def magnitude(field):
        return np.hypot(field[..., 0], field[..., 1])

    udfs = make_udfs(lt)
    plots = [Recording(ds, udfs[0], channel=("intensity", bf)),
             Recording(ds, udfs[1], channel=("field", magnitude))]

    async def drain():
        damages, last = [], None
        async for part in ctx.run_udf_iter(ds, udfs, sync=False,
                                           plots=plots):
            damages.append(int(np.count_nonzero(part.damage.data)))
            last = part
        return damages, last

    (damages, last), secs, count = counted(lambda: asyncio.run(drain()))
    row("14b run_udf_iter(sync=False, plots=[BF, |field|])", secs, count,
        last.buffers)
    print(f"  partials' merged frames {damages}; plot updates "
          f"{[len(p.updates) for p in plots]}")
    if not damages or any(b <= a for a, b in zip(damages, damages[1:])) \
            or damages[-1] != int(np.prod(NAV)):
        failures.append(f"14b: partials' damage {damages}")
    for p, want in ((plots[0], want4[(0, "intensity")][..., 0]),
                    (plots[1], magnitude(last.buffers[1]["field"].data))):
        e, ok = max_err(p.updates[-1][1], want)
        print(f"  14b plot {p.title}: final data max abs err {e:.3g}")
        if not ok or len(p.updates) != len(damages) + 1:
            failures.append(f"14b plot {p.title}: err {e}, "
                            f"{len(p.updates)} updates")
    ctx.plot_class = Dummy2DPlot
    res, secs, count = counted(
        lambda: ctx.run_udf(ds, make_udfs(lt), plots=True))
    row("14b run_udf(plots=True), Dummy2DPlot", secs, count, res)

    async def abandon():
        agen = ctx.run_udf_iter(ds, make_udfs(lt), sync=False)
        n = 0
        async for _ in agen:
            n += 1
            if n == 2:
                break
        await agen.aclose()

    asyncio.run(abandon())
    t0 = time.perf_counter()
    while readers_alive() and time.perf_counter() - t0 < 1.0:
        time.sleep(0.01)
    ended_s = time.perf_counter() - t0
    print(f"  14b async iterator closed after two partials: readers alive "
          f"{len(readers_alive())} after {ended_s:.3f} s")
    if readers_alive():
        failures.append("14b: block reader alive 1 s after aclose()")

    # -- (c) delayed -------------------------------------------------------
    dctx = lt.Context.make_with("delayed")
    dds = load(dctx)
    res, secs, count = counted(lambda: dctx.run_udf(dds, make_udfs(lt)))
    print(f"14c delayed run_udf returned in {secs:.3f} s: {count} launches, "
          f"feed_stats {dctx.feed_stats}")
    if count != 0 or dctx.feed_stats is not None:
        failures.append(f"14c: {count} launches and feed_stats "
                        f"{dctx.feed_stats} at return")
    _, secs, count = counted(lambda: res[0]["intensity"].data)
    row("14c delayed, first access", secs, count, res)
    _, secs, count = counted(lambda: [r[k].data for r in res for k in r])
    print(f"  14c second access: {count} launches, {secs:.3f} s")
    if count != 0:
        failures.append(f"14c: the second access launched {count}")

    # -- (d) export --------------------------------------------------------
    out = os.path.join(tmp, "export.npy")
    _, secs, count = counted(lambda: ctx.export_dataset(ds, path=out))
    print(f"14d export_dataset: {secs:.3f} s, {nbytes / secs / 1e9:.2f} GB/s "
          f"written; fused_moments launches {count}; engines "
          f"{ctx.run_info['engines']} {at}")
    rows.append(dict(path="14d export_dataset", wall_s=secs,
                     gbps=nbytes / secs / 1e9, launches=count))
    written = np.load(out, mmap_mode="r")
    flat, wflat = data.reshape(-1, *SIG), written.reshape(-1, *SIG)
    same = written.shape == data.shape and all(in_chunks(
        np.arange(len(flat)),
        lambda lo, ids: np.array_equal(wflat[lo:lo + len(ids)],
                                       flat[lo:lo + len(ids)]), chunk=4096))
    print(f"  14d file {written.shape} {written.dtype}: equal to the scan "
          f"{same}")
    if not same or count != 0:
        failures.append(f"14d: file equal {same}, {count} launches")
    del written, wflat
    eds = ctx.load("npy", path=out)
    res, secs, count = counted(lambda: ctx.run_udf(eds, make_udfs(lt)))
    row("14d the exported .npy re-loaded", secs, count, res)
    os.remove(out)

    # -- (e) convert_transposed_to_npy -------------------------------------
    k = min(TRANSPOSED_FRAMES, len(flat))
    cut = flat[:k].reshape(k, -1)
    src = os.path.join(tmp, "transposed.raw")
    dst = os.path.join(tmp, "converted.npy")
    np.ascontiguousarray(cut.T).tofile(src)
    nav_e = (k // NAV[1], NAV[1])
    t0 = time.perf_counter()
    convert_transposed_to_npy(src, dst, nav_shape=nav_e, sig_shape=SIG,
                              dtype=np.uint16)
    secs = time.perf_counter() - t0
    same = np.array_equal(np.load(dst, mmap_mode="r").reshape(k, -1), cut)
    print(f"14e convert_transposed_to_npy: {cut.nbytes} bytes in {secs:.3f} "
          f"s ({cut.nbytes / secs / 1e9:.2f} GB/s); equal to the transpose "
          f"{same} {at}")
    rows.append(dict(path="14e convert_transposed_to_npy", wall_s=secs,
                     gbps=cut.nbytes / secs / 1e9, launches=0))
    if not same:
        failures.append("14e: the converted file is not the transpose")
    os.remove(src)
    os.remove(dst)

    # -- (f) snooze --------------------------------------------------------
    sctx = lt.Context.make_with("inline", snooze_timeout=3600)
    sds = load(sctx)
    manager = sctx.snooze_manager
    sctx.run_udf(sds, make_udfs(lt))
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(sctx.device)
    # an hour idle, then the manager's own check
    manager._last_activity -= 7200
    manager._check()
    after = torch.cuda.memory_reserved(sctx.device)
    print(f"14f snooze: snoozing {manager.is_snoozing}; memory_reserved "
          f"{before} -> {after} bytes")
    if not manager.is_snoozing or not after < before:
        failures.append(f"14f: snoozing {manager.is_snoozing}, reserved "
                        f"{before} -> {after}")
    res, secs, count = counted(lambda: sctx.run_udf(sds, make_udfs(lt)))
    row("14f the run after the snooze", secs, count, res)
    if manager.is_snoozing:
        failures.append("14f: the run did not wake the manager")
    sctx.close()
    ctx.close()

    # -- (g) the example scripts -------------------------------------------
    for name in EXAMPLES:
        src_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "examples", f"{name}.py")
        with open(src_path) as f:
            code = f.read().replace("libertem_tpu", "libertem_tpu_torch")
        out = io.StringIO()
        fused_moments.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    warnings.catch_warnings():
                # custom_udf's MaxFrameUDF warns that it goes to the
                # host engine
                warnings.simplefilter("ignore", UserWarning)
                exec(compile(code, src_path, "exec"),  # noqa: S102
                     {"__name__": "__main__", "__file__": src_path})
            torch.cuda.synchronize()
        except Exception as e:  # each one's own asserts included
            failures.append(f"14g example {name}: {type(e).__name__}: {e}")
            print(f"14g example {name}: FAILED {type(e).__name__}: {e}")
            continue
        secs = time.perf_counter() - t0
        lines = out.getvalue().strip().splitlines()
        print(f"14g example {name}: ok in {secs:.3f} s, fused_moments "
              f"launches {fused_moments.launches}; last line "
              f"{lines[-1] if lines else ''!r}")
    print("phase 14 summary: " + json.dumps(rows))
    return launches


# -- phase 15: the multi-device loop, several workers on the card ------------


def shard_steps(n: int, n_dev: int, depth: int) -> list:
    """Per worker of a contiguous split of ``n`` frames, its super-steps'
    ``(first, end)`` frame ranges (the multi-device loop's split)."""
    bounds = np.linspace(0, n, n_dev + 1).astype(np.int64)
    return [[(int(lo), int(min(lo + depth, b1)))
             for lo in range(int(b0), int(b1), depth)]
            for b0, b1 in zip(bounds[:-1], bounds[1:])]


def check_roi(label, res, want, failures) -> None:
    """Phase 15(b)'s results over the roi's frames (nav rows
    roi-compressed) against the float64 answers of those frames; the
    centres of mass of corrected frames take their own magnitude as
    the floor."""
    for (ui, name), ref in want.items():
        if name in FROM_COM:
            continue
        buf = res[ui][name]
        got = buf.raw_data if buf.kind == "nav" else buf.data
        got = np.asarray(got).reshape(np.asarray(ref).shape)
        scale = (float(np.abs(want[(1, "raw_com")]).max())
                 if name == "raw_com" else None)
        e, ok = max_err(got, ref, scale)
        print(f"  {label} result {ui}/{name}: max abs err {e:.3g} vs "
              f"float64")
        if not ok:
            failures.append(f"{label} result {ui}/{name}: max err {e}")


def slice13_phase(lt, path, data, want4, depth, n_blocks, at,
                  failures, keep=None) -> dict:
    """Phase 15: the multi-device loop with two and four workers on
    card 0 (one card suffices: each worker has its own shard, reader,
    pinned slots, copy stream and state), on phase 2's scan with phase
    4's UDFs against ``want4``; each pass with the launch count set to 0
    just before and read just after, printing its wall time, GB/s,
    each worker's reader share and its launches.  Returns the launch
    count of each pass; ``keep`` (a dict) receives what phase 16 holds
    its processes against: by phase 16's pass, the results' arrays,
    launches and float64 answers of the pass at the same worker
    count."""
    import torch

    from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
    from libertem_tpu_torch.io.dataset.live import LiveDataSet
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.udf.base import UDFRunner

    launches, rows = {}, []
    n = int(np.prod(NAV))
    nbytes = data.nbytes
    card0 = torch.device("cuda", 0)
    h, w = SIG

    def load(ctx):
        return ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                        sig_shape=SIG)

    def sharded(n_dev):
        return lt.Context(executor=ShardedJobExecutor(
            devices=[card0] * n_dev))

    def counted(fn):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, fused_moments.launches

    def row(label, ctx, secs, count, want_launches, size=nbytes):
        st = ctx.feed_stats
        workers = st.get("workers", [st])
        shares = [wk["read_s"] / secs for wk in workers]
        launches[f"{label} (phase 15)"] = count
        rows.append(dict(path=label, wall_s=secs, gbps=size / secs / 1e9,
                         workers=len(workers), reader_shares=shares,
                         consumer_wait_share=st["wait_s"] / secs,
                         blocks=[wk["blocks"] for wk in workers],
                         launches=count))
        print(f"{label}: {secs:.3f} s wall, {size / secs / 1e9:.2f} GB/s; "
              f"readers {', '.join(f'{s:.1%}' for s in shares)} of the "
              f"wall, consumer waited {st['wait_s'] / secs:.1%}; blocks "
              f"{[wk['blocks'] for wk in workers]}; fused_moments "
              f"launches {count} {at}")
        if count != want_launches:
            failures.append(f"{label}: {count} launches, expected "
                            f"{want_launches}")

    def expected(n_frames, n_dev, d=depth):
        return sum(len(s) for s in shard_steps(n_frames, n_dev, d))

    # -- (a) one card, one, two and four workers, twice in turns ----------
    passes = (
        ("15a single device", lambda: lt.Context()),
        ("15a 2 workers on cuda:0, ShardedJobExecutor", lambda: sharded(2)),
        ("15a 4 workers, make_with('sharded', tpus=[0, 0, 0, 0])",
         lambda: lt.Context.make_with("sharded", tpus=[0, 0, 0, 0])),
    )
    keep = {} if keep is None else keep
    for label, make in passes + passes[::-1]:
        ctx = make()
        ds = load(ctx)
        n_dev = len(ctx.executor.devices)
        res, secs, count = counted(lambda: ctx.run_udf(ds, make_udfs(lt)))
        row(label, ctx, secs, count, expected(n, n_dev))
        if count != n_blocks:
            failures.append(f"{label}: {count} launches, not {n_blocks}")
        check_results(label, res, want4, failures)
        if n_dev > 1:
            keep.setdefault(f"16a {n_dev // 2} a process", dict(
                arrays=result_arrays(res), launches=count, want=want4))
        ctx.close()
    for n_dev in (2, 4):
        print(f"15a {n_dev} workers traced:")
        ctx = sharded(n_dev)
        traced_run(ctx, load(ctx), make_udfs(lt), at)
        ctx.close()
    ctx2 = sharded(2)
    ds2 = load(ctx2)
    os.environ["LIBERTEM_TPU_SHARDED_STATS"] = "1"
    try:
        runner = UDFRunner(make_udfs(lt))
        fused_moments.launches = 0
        t0 = time.perf_counter()
        runner.run_for_dataset(ds2, devices=[card0] * 2)
        secs = time.perf_counter() - t0
    finally:
        del os.environ["LIBERTEM_TPU_SHARDED_STATS"]
    print(f"15a 2 workers with LIBERTEM_TPU_SHARDED_STATS (each stage "
          f"synchronised): {secs:.3f} s, {fused_moments.launches} "
          f"launches; last_sharded_stats "
          f"{json.dumps(runner.last_sharded_stats)} {at}")

    # -- (b) corrections and a sparse roi on 2 workers ---------------------
    corrections = make_corrections(lt)
    roi = np.zeros(n, dtype=bool)
    roi[::3] = True
    ids = np.flatnonzero(roi)
    n_ring = len(ring_stack(lt)) + 4
    res, secs, count = counted(lambda: ctx2.run_udf(
        ds2, make_ring_udfs(lt), roi=roi.reshape(NAV),
        corrections=corrections))
    row("15b 2 workers, corrections, M=12, roi of every third frame", ctx2,
        secs, count, expected(len(ids), 2),
        size=len(ids) * h * w * 2)
    flat = data.reshape(n, -1)
    t0 = time.perf_counter()
    want = oracle_at(lambda lo, hi: flat[ids[lo:hi]], len(ids), SIG,
                     (len(ids) // 2, 2), ring_stack(lt), (64, 64), 32,
                     corrections.make_plan(SIG))
    print(f"  oracle 15b: {time.perf_counter() - t0:.1f} s (float64 numpy)")
    check_roi("15b", res, want, failures)
    keep["16b"] = dict(arrays=result_arrays(res), launches=count, want=want)

    # -- (c) run_udf_iter on 2 workers, phase 8's patch, then abandoned ----
    new_masks = np.stack([lt.masks.circular(64, 64, w, h, 16),
                          lt.masks.ring(64, 64, w, h, 30, 10)])
    damages = []

    def iterate():
        gen = ctx2.run_udf_iter(ds2, make_udfs(lt))
        last = None
        for i, last in enumerate(gen):
            damages.append(int(np.count_nonzero(last.damage.data)))
            if i == 1:
                gen.update_parameters_experimental([
                    {"mask_factories": [lambda m=m: m for m in new_masks]},
                    {}, {}, {}, {}])
        return last

    final, secs, count = counted(iterate)
    row("15c 2 workers, run_udf_iter, patch after the second partial",
        ctx2, secs, count, expected(n, 2))
    steps = shard_steps(n, 2, depth)
    print(f"  15c {len(damages)} partials (a super-step each, then the "
          f"final), merged frames {damages[:3]} ... {damages[-2:]}")
    if (len(damages) != max(len(s) for s in steps) + 1
            or any(b < a for a, b in zip(damages, damages[1:]))
            or damages[-1] != n):
        failures.append(f"15c: partials' damage {damages}")
    old = np.zeros(n, dtype=bool)
    for s in steps:
        for lo, hi in s[:2]:
            old[lo:hi] = True
    t0 = time.perf_counter()
    patched = want4[(0, "intensity")].reshape(n, 2).copy()
    patched[~old] = projections64(data, new_masks.reshape(2, -1),
                                  np.flatnonzero(~old))
    print(f"  oracle 15c: {time.perf_counter() - t0:.1f} s (float64 numpy)")
    want15c = {(0, "intensity"): patched.reshape(NAV + (2,)),
               **{k: v for k, v in want4.items() if k[0] != 0}}
    check_results("15c final", [final.buffers[ui] for ui in range(5)],
                  want15c, failures)
    keep["16c"] = dict(arrays=result_arrays(final.buffers), launches=count,
                       want=want15c, damages=damages)
    gen = ctx2.run_udf_iter(ds2, make_udfs(lt))
    next(gen)
    next(gen)
    t0 = time.perf_counter()
    gen.close()
    while readers_alive() and time.perf_counter() - t0 < 1.0:
        time.sleep(0.01)
    ended = time.perf_counter() - t0
    print(f"  15c iterator abandoned after two partials: reader threads "
          f"alive {len(readers_alive())} after {ended:.3f} s")
    if readers_alive():
        failures.append("15c: reader threads alive 1 s after close()")

    # -- (d) a numpy UDF beside the fused pass on 2 workers ----------------
    res, secs, count = counted(lambda: ctx2.run_udf(ds2, mixed_udfs(lt)))
    row("15d 2 workers, fused + host engine", ctx2, secs, count,
        expected(n, 2))
    check_engines("15d", ctx2, [False, False, False, True], failures)
    print(f"  15d host engine {ctx2.feed_stats['host_s']:.3f} s of the "
          f"wall")
    check_results("15d", res, {
        (0, "intensity"): want4[(2, "intensity")],
        **{(1, k): want4[(4, k)]
           for k in ("num_frames", "sum", "mean", "var", "std")},
        (2, "intensity"): want4[(0, "intensity")][..., :1],
    }, failures)
    if not (np.array_equal(res[3]["frame_max"].data,
                           data.max(axis=(2, 3)).astype(np.float32))
            and np.array_equal(res[3]["pixel_max"].data,
                               data.max(axis=(0, 1)).astype(np.float32))):
        failures.append("15d numpy UDF maxima are not exact")
    else:
        print("  15d result 3/frame_max, 3/pixel_max: exact")

    # -- (e) the live ring on 2 workers, block-cyclic ----------------------
    raw = np.memmap(path, dtype=np.uint16, mode="r", shape=(n,) + SIG)

    def live_run(upto):
        live = LiveDataSet(nav_shape=NAV, sig_shape=SIG, dtype=np.uint16,
                           ring_capacity=LIVE_RING,
                           num_partitions=4).initialize()

        def push():
            for lo in range(0, upto, 1024):
                live.push_frames(raw[lo:min(lo + 1024, upto)])
            live.finish()

        t = threading.Thread(target=push, daemon=True)
        t.start()
        out = counted(lambda: ctx2.run_udf(live, make_udfs(lt)))
        t.join(60)
        if t.is_alive():
            failures.append("15e: the producer is stuck")
        return out

    for label, upto in (("15e live, 2 workers, block-cyclic", n),
                        (f"15e live, 2 workers, finish() after {LIVE_EARLY} "
                         "frames", LIVE_EARLY)):
        res, secs, count = live_run(upto)
        blocks = sum(wk["blocks"] for wk in ctx2.feed_stats["workers"])
        row(label, ctx2, secs, count, blocks)
        print(f"  block depth {n // max(blocks, 1)} with a ring of "
              f"{LIVE_RING} frames")
        if upto == n:
            check_results(label, res, want4, failures)
            continue
        valid = res[3]["intensity"].valid_mask.reshape(-1)
        if not (valid[:upto].all() and not valid[upto:].any()):
            failures.append("15e early finish: damage is not the frames "
                            "pushed")
        check_results(label, res, truncated_oracle(want4, data, upto),
                      failures)

    # -- (f) every card ----------------------------------------------------
    if torch.cuda.device_count() > 1:
        ctx = lt.Context(executor=ShardedJobExecutor())
        ds = load(ctx)
        n_dev = len(ctx.executor.devices)
        res, secs, count = counted(lambda: ctx.run_udf(ds, make_udfs(lt)))
        row(f"15f every card ({n_dev})", ctx, secs, count,
            expected(n, n_dev))
        check_results("15f", res, want4, failures)
    else:
        print("15f was not run: this machine has one CUDA device")
    ctx2.close()
    print("phase 15 summary: " + json.dumps(rows))
    return launches


# -- phase 16: several processes, the multi-process run ----------------------

RANK_TIMEOUT_S = 400
NUMPY_REFUSAL = "numpy-backend UDFs process the host block feed"


def result_arrays(res) -> dict:
    """A run's result buffers (per UDF a dict of buffers) as arrays:
    ``ui/name`` the buffer's data and, for a nav buffer, ``ui/name/raw``
    its roi-compressed rows."""
    out = {}
    for ui, bufs in enumerate(res):
        for name, buf in bufs.items():
            out[f"{ui}/{name}"] = np.asarray(buf.data)
            if buf.kind == "nav":
                out[f"{ui}/{name}/raw"] = np.asarray(buf.raw_data)
    return out


class LoadedBuffer:
    """A result buffer read back from :func:`result_arrays`' arrays."""

    def __init__(self, arrays: dict, key: str):
        self.data = arrays[key]
        self.raw_data = arrays.get(f"{key}/raw")
        self.kind = "nav" if self.raw_data is not None else "sig"


def loaded_results(arrays: dict) -> list:
    out = {}
    for key in arrays:
        ui, name = key.split("/", 1)
        if not name.endswith("/raw"):
            out.setdefault(int(ui), {})[name] = LoadedBuffer(arrays, key)
    return [out[ui] for ui in sorted(out)]


def same_bits(a: dict, b: dict) -> list:
    """The keys whose arrays differ in shape, dtype or any bit."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b
                  or a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                  or a[k].tobytes() != b[k].tobytes())


def rank_main(spec_json: str) -> int:
    """``python3 chip_smoke.py --rank SPEC``: one process of phase 16
    (:func:`slice14_phase` starts them).  ``SPEC`` is a JSON object:
    ``rank``, ``world``, ``backend`` (``gloo`` or ``nccl``), ``init``
    (the group's ``file://`` rendezvous), ``device`` (this process's
    card), ``scan`` (phase 2's raw file), ``nav``, ``workers`` (the
    local worker counts of the 16a passes) and ``out`` (a directory).
    Each pass starts at a barrier, with the launch count set to 0 just
    before and read just after; the results go to ``out/rankR.npz``
    under each pass's index,
    and the passes' wall time, launches, ``collective_s`` and transport
    to the last line of the output, as JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    spec = json.loads(spec_json)
    rank = spec["rank"]
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the host's cores shared between the processes, as torchrun does
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["world"]))
    dist.init_process_group(
        spec["backend"], init_method=spec["init"], rank=rank,
        world_size=spec["world"], timeout=datetime.timedelta(seconds=180))
    try:
        import libertem_tpu_torch as lt
        from libertem_tpu_torch.common.exceptions import UDFException
        from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
        from libertem_tpu_torch.ops.moments import fused_moments

        nav = tuple(spec["nav"])
        n = int(np.prod(nav))
        passes, arrays = [], {}

        def context(n_local):
            ctx = lt.Context(executor=ShardedJobExecutor(
                devices=[dev] * n_local))
            return ctx, ctx.load("raw", path=spec["scan"], dtype="uint16",
                                 nav_shape=nav, sig_shape=SIG)

        def counted(label, ctx, fn):
            dist.barrier()
            fused_moments.launches = 0
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            st = ctx.feed_stats
            passes.append(dict(
                path=label, wall_s=secs, launches=fused_moments.launches,
                collective_s=st["collective_s"], transport=st["transport"],
                run_transport=ctx.run_info["transport"],
                workers=len(ctx.executor.global_workers),
                reader_shares=[w["read_s"] / secs for w in st["workers"]]))
            return out

        def keep_arrays(res):
            """The last pass's results, under its index."""
            arrays.update({f"{len(passes) - 1}/{k}": v
                           for k, v in result_arrays(res).items()})

        for n_local in spec["workers"]:
            label = f"16a {n_local} a process"
            ctx, ds = context(n_local)
            res = counted(label, ctx, lambda: ctx.run_udf(ds, make_udfs(lt)))
            keep_arrays(res)
            ctx.close()
        ctx, ds = context(1)
        roi = np.zeros(n, dtype=bool)
        roi[::3] = True
        res = counted("16b", ctx, lambda: ctx.run_udf(
            ds, make_ring_udfs(lt), roi=roi.reshape(nav),
            corrections=make_corrections(lt)))
        keep_arrays(res)
        h, w = SIG
        new_masks = np.stack([lt.masks.circular(64, 64, w, h, 16),
                              lt.masks.ring(64, 64, w, h, 30, 10)])
        damages = []

        def iterate():
            gen = ctx.run_udf_iter(ds, make_udfs(lt))
            last = None
            for i, last in enumerate(gen):
                damages.append(int(np.count_nonzero(last.damage.data)))
                if i == 1:
                    gen.update_parameters_experimental([
                        {"mask_factories": [lambda m=m: m
                                            for m in new_masks]},
                        {}, {}, {}, {}])
            return last

        final = counted("16c", ctx, iterate)
        keep_arrays(final.buffers)
        try:
            ctx.run_udf(ds, mixed_udfs(lt))
            refused = "no exception"
        except UDFException as e:
            refused = str(e)
        ctx.close()
        np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **arrays)
        print(json.dumps(dict(rank=rank, device=str(dev), passes=passes,
                              damages=damages, refused=refused)),
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def slice14_phase(keep, scan, at, failures, backend="gloo",
                  devices=("cuda:0", "cuda:0"), workers=(1, 2, 1),
                  nav=NAV) -> dict:
    """Phase 16: the multi-process run.  Starts one process a device of
    ``devices`` (``chip_smoke.py --rank``, :func:`rank_main`), joined
    in a ``torch.distributed`` group over ``backend``: two on card 0
    over gloo here (NCCL refuses two processes on one card; gloo
    gathers host copies), one a card over NCCL under ``--every-card``.
    Each runs on phase 2's scan, with its own workers' shards only:
    (a) phase 4's UDFs with ``workers`` local workers a process (the
    first pass carries each process's CUDA start-up), (b)
    phase 6a's corrections over every third frame, (c) ``run_udf_iter``
    with phase 8's patch after the second partial (one worker a
    process), (d) phase 7b's numpy UDF, refused.  Every process's
    results are held against the float64 answers of ``keep`` (phase 15
    or the one-process passes of ``--every-card``) and bit for bit
    against the one-process pass at the same global worker count, and
    the processes' launches must add up to that pass's.  A process
    that fails or outlasts its time fails the phase.  Returns the
    launch count of each pass (all processes)."""
    t_phase = time.perf_counter()
    world = len(devices)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(world=world, backend=backend, init=f"file://{tmp}/pg",
                    scan=scan, nav=list(nav), workers=list(workers),
                    out=tmp)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank",
             json.dumps(dict(spec, rank=r, device=str(devices[r])))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            failures.append(f"16: a process outlasted {RANK_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        reports = []
        for r, p in enumerate(procs):
            log = logs[r] if r < len(logs) else ""
            last = [ln for ln in log.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not last:
                failures.append(f"16: process {r} exited {p.returncode}")
                print(f"16 process {r} output:\n{log[-3000:]}")
                return launches
            reports.append(json.loads(last[-1]))
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(world)]
    print(f"phase 16: {world} processes over {backend} on "
          f"{', '.join(map(str, devices))}, {time.perf_counter() - t_phase:.1f}"
          f" s with their start-up {at}")
    rows = []
    for i, pass_ in enumerate(reports[0]["passes"]):
        label = pass_["path"]
        first = "" if i else " (with each process's start-up)"
        each = [rep["passes"][i] for rep in reports]
        wall = max(x["wall_s"] for x in each)
        count = sum(x["launches"] for x in each)
        launches[f"{label} ({world} processes, {backend}, phase 16)"] = count
        rows.append(dict(path=label + first, wall_s=wall, launches=count,
                         launches_by_rank=[x["launches"] for x in each],
                         collective_s=[x["collective_s"] for x in each],
                         transport=each[0]["transport"],
                         workers=each[0]["workers"],
                         reader_shares=[x["reader_shares"] for x in each]))
        by_rank = "+".join(str(x["launches"]) for x in each)
        coll = ", ".join("%.1f" % (x["collective_s"] * 1e3) for x in each)
        print(f"{label}{first}: {wall:.3f} s wall, {each[0]['workers']} "
              f"workers in "
              f"{world} processes, launches {count} ({by_rank}), "
              f"collectives {coll} ms, transport {each[0]['transport']} "
              f"{at}")
        if any(x["transport"] != backend or x["run_transport"] != backend
               for x in each):
            failures.append(f"{label}: transport is not {backend}")
        ref = keep.get(label)
        if ref is None:
            failures.append(f"{label}: no one-process pass to hold it to")
            continue
        if count != ref["launches"]:
            failures.append(f"{label}: {count} launches in all, the "
                            f"one-process pass {ref['launches']}")
        for r, arrays in enumerate(ranks):
            mine = {k[len(f"{i}/"):]: v for k, v in arrays.items()
                    if k.startswith(f"{i}/")}
            res = loaded_results(mine)
            found = len(failures)
            # one line a process: the checks' own lines only on a failure
            with contextlib.redirect_stdout(io.StringIO()) as lines:
                (check_roi if label == "16b" else check_results)(
                    f"{label} process {r}", res, ref["want"], failures)
            if len(failures) > found:
                print(lines.getvalue(), end="")
            differ = same_bits(mine, ref["arrays"])
            print(f"  {label} process {r}: "
                  + ("float64 answers held, " if len(failures) == found
                     else "float64 answers NOT held, ")
                  + ("bit for bit the one-process pass's results"
                     if not differ else f"differs from the one-process "
                     f"pass in {differ[:6]}"))
            if differ:
                failures.append(f"{label} process {r}: not bit-equal to "
                                f"the one-process pass ({differ[:6]})")
    for rep in reports:
        ref = keep.get("16c", {}).get("damages")
        if ref is not None and rep["damages"] != ref:
            failures.append(f"16c process {rep['rank']}: partials' damage "
                            f"{rep['damages'][:4]}..., one process "
                            f"{ref[:4]}...")
        if NUMPY_REFUSAL not in rep["refused"]:
            failures.append(f"16d process {rep['rank']}: numpy UDF not "
                            f"refused ({rep['refused'][:200]})")
    print(f"  16c {len(reports[0]['damages'])} partials on each process; "
          f"16d refused on each: "
          f"{all(NUMPY_REFUSAL in rep['refused'] for rep in reports)}")
    print("phase 16 summary: " + json.dumps(rows))
    return launches


# -- phase 17: the web GUI's path ---------------------------------------------

# the fused analysis jobs of 17(a), with phase 10's parameters
GUI_JOBS = ("SUM_FRAMES", "SUM_SIG", "SD_FRAMES", "APPLY_DISK_MASK",
            "APPLY_RING_MASK", "CENTER_OF_MASS")
READERS_END_S = 5.0  # a cancelled job's readers end within this


class RecordingRegistry:
    """The web server's event registry without clients: every broadcast
    (JSON messages as dicts, PNG frames as bytes) kept in order, each
    handed to ``on_event`` too."""

    def __init__(self):
        self.events = []
        self.on_event = None

    def broadcast_event(self, message, binary=False):
        import asyncio
        self.events.append(message)
        if self.on_event is not None:
            self.on_event(message)
        done = asyncio.get_running_loop().create_future()
        done.set_result(None)
        return done


def job_frames(events, job_id) -> tuple:
    """(TASK_RESULT headers, PNG frames, whether every header's image
    count matched the frames right after it, the job's last message
    type) of one job's broadcasts."""
    heads = frames = 0
    matched, pending, last = True, None, None
    for ev in events:
        if isinstance(ev, bytes):
            frames += 1
            pending = None if pending is None else pending - 1
            continue
        if pending:
            matched = False
        pending = None
        if ev.get("job") != job_id:
            continue
        kind = ev["messageType"]
        if kind in ("TASK_RESULT", "FINISH_JOB"):
            pending = ev["followup"]["numMessages"]
            heads += kind == "TASK_RESULT"
        if kind in ("FINISH_JOB", "JOB_ERROR", "CANCEL_JOB_DONE"):
            last = kind
    return heads, frames, matched and not pending, last


def raw_arrays(result_set) -> dict:
    """key -> raw result array of an AnalysisResultSet."""
    return {r.key: np.asarray(r.raw_data) for r in result_set}


def same_arrays(a: dict, b: dict, keys=None) -> list:
    """The keys whose arrays differ in dtype, shape or any bit (nan
    equal to nan)."""
    return [k for k in (keys if keys is not None else a)
            if k not in b or a[k].dtype != b[k].dtype
            or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k], equal_nan=True)]


class PlotStub:
    """``plt`` of a generated notebook where matplotlib does not
    import: every attribute, call and item is the stub again."""

    def __getattr__(self, name):
        return self

    def __call__(self, *args, **kwargs):
        return self

    def __getitem__(self, key):
        return self

    def __iter__(self):
        return iter((self, self))


def gui_phase(lt, path, data, keep10, p10, at, failures) -> dict:
    """Phase 17: the web GUI's path on phase 2's scan, each job with the
    launch count set to 0 just before and read just after.

    (a) the port's ``SharedState`` and ``JobEngine`` with a registry that
    records every broadcast: the ``"local"`` connection
    (``helpers.create_executor``, the card), the scan opened as RAW
    through ``get_converter("RAW")`` and ``ctx.load``, one job each of
    GUI_JOBS held against phase 10's float64 answers (and beside phase
    10's ``Context.run`` results), CoM again with only ``flip_y``
    changed (``need_rerun`` says no pass), a DISK job cancelled at its
    first partial (fewer launches, CANCEL_JOB_DONE, its readers ended),
    and CLUST through its controller (phase 10's two feature passes;
    the clustering needs scikit-learn);
    (b) where tornado imports, ``make_app`` served on 127.0.0.1 in a
    thread and driven with tornado's HTTP and websocket clients, the
    NPZ downloads bit for bit (a)'s results;
    (c) the notebook the GUI generates for (a)'s DISK and CoM analyses,
    its code cells run here (a stub ``plt`` where matplotlib does not
    import), its results bit for bit (a)'s.
    Returns the launch count of each job."""
    import asyncio
    import logging

    import torch

    from libertem_tpu_torch.analysis.base import Analysis
    from libertem_tpu_torch.executor.async_adapter import AsyncAdapter
    from libertem_tpu_torch.io.dataset.converters import get_converter
    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.web.engine import JobEngine
    from libertem_tpu_torch.web.helpers import create_executor
    from libertem_tpu_torch.web.state import SharedState

    params = analysis_params(lt)
    o = keep10["oracle"]
    nbytes = data.nbytes
    launches, rows, res_a = {}, [], {}
    clust_launches = p10["CLUST feature passes (std, then M=42) (phase 10)"]

    # the engine logs each channel it cannot render and each failed job;
    # counted here instead of a traceback apiece on stderr
    class Records(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record)

    web_log = logging.getLogger("libertem_tpu_torch.web")
    records = Records()
    web_log.addHandler(records)
    web_log.propagate = False
    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    print(f"17: PIL {'imports' if has_pil else 'is not installed'}, "
          f"matplotlib {'imports' if has_mpl else 'is not installed'} "
          f"(the channels' images need both)")

    def row(label, secs, count, heads, frames, frames_ok, last,
            frames_total=None):
        launches[f"{label} (phase 17)"] = count
        gbps = nbytes / secs / 1e9
        rows.append(dict(path=label, wall_s=secs, gbps=gbps,
                         launches=count, task_results=heads,
                         images=frames, last=last))
        print(f"{label}: {secs:.3f} s wall, {gbps:.2f} GB/s of the scan; "
              f"fused_moments launches {count}; {heads} TASK_RESULT "
              f"headers, {frames} image frames (each header's count "
              f"matched: {frames_ok}), ended with {last} {at}")
        if not frames_ok:
            failures.append(f"{label}: a header's image count does not "
                            f"match the frames after it")

    async def drive():
        state = SharedState()
        registry = RecordingRegistry()
        engine = JobEngine(state, registry)
        sync_ex = create_executor(connection={"type": "local"})
        await state.executor_state.set_executor(
            AsyncAdapter(wrapped=sync_ex, pool=AsyncAdapter.make_pool()),
            {"connection": {"type": "local"}})
        ctx = await state.executor_state.get_context()
        print(f"17a local connection: devices "
              f"{[str(d) for d in ctx.executor.devices]}")
        converted = get_converter("RAW")().to_python({
            "type": "RAW", "path": path, "dtype": "uint16",
            "nav_shape": list(NAV), "sig_shape": list(SIG)})
        ds = ctx.load("raw", **converted)
        state.dataset_state.register(
            "ds-scan", ds, {"params": {"type": "RAW", **converted}},
            converted)

        async def job(label, an_id, job_id, on_event=None):
            registry.events = []
            registry.on_event = on_event
            fused_moments.launches = 0
            t0 = time.perf_counter()
            out = await engine.run_analysis(an_id, job_id)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            count = fused_moments.launches
            heads, frames, ok, last = job_frames(registry.events, job_id)
            row(label, secs, count, heads, frames, ok, last)
            return out, count, last

        for id_ in GUI_JOBS:
            an = f"an-{id_.lower()}"
            state.analysis_state.create(an, "ds-scan", id_, params[id_])
            label = f"17a {id_} job"
            out, count, last = await job(label, an, f"job-{id_.lower()}")
            if last != "FINISH_JOB" or out is None:
                failures.append(f"{label}: ended with {last}")
                continue
            if count != p10[f"Context.run {id_} (phase 10)"]:
                failures.append(f"{label}: {count} launches, phase 10 "
                                f"{p10[f'Context.run {id_} (phase 10)']}")
            analysis = Analysis.get_analysis_by_type(id_)(ds, params[id_])
            e = check_channels(label, out, expected_channels(
                id_, analysis, o, data), failures)
            ref = raw_arrays(keep10["results"][id_])
            got = raw_arrays(out)
            diff = max(float(np.nanmax(np.abs(
                got[k].astype(np.float64) - ref[k].astype(np.float64)),
                initial=0.0)) for k in got)
            print(f"  {label}: {len(got)} channels, largest relative "
                  f"error {e:.3g} vs float64; largest difference to phase "
                  f"10's Context.run {diff:.3g}")
            res_a[id_] = got

        # only flip_y changes: need_rerun says no pass, the cached
        # results are post-processed again
        flipped = {**params["CENTER_OF_MASS"],
                   "flip_y": not params["CENTER_OF_MASS"]["flip_y"]}
        state.analysis_state.update("an-center_of_mass", "CENTER_OF_MASS",
                                    flipped)
        label = "17a CENTER_OF_MASS job, flip_y changed"
        out, count, last = await job(label, "an-center_of_mass",
                                     "job-com-flip")
        if count != 0 or last != "FINISH_JOB":
            failures.append(f"{label}: {count} launches, {last}")
        else:
            analysis = Analysis.get_analysis_by_type("CENTER_OF_MASS")(
                ds, flipped)
            e = check_channels(label, out, expected_channels(
                "CENTER_OF_MASS", analysis, o, data), failures)
            print(f"  {label}: largest relative error {e:.3g} vs float64")

        # a DISK job cancelled as its first partial is broadcast
        state.analysis_state.create("an-cancel", "ds-scan",
                                    "APPLY_DISK_MASK",
                                    params["APPLY_DISK_MASK"])
        removal = []

        def cancel_at_first(ev):
            if (isinstance(ev, dict) and not removal
                    and ev.get("messageType") == "TASK_RESULT"):
                removal.append(asyncio.ensure_future(
                    state.job_state.remove("job-cancel")))

        label = "17a APPLY_DISK_MASK job, cancelled at its first partial"
        out, count, last = await job(label, "an-cancel", "job-cancel",
                                     cancel_at_first)
        removed = all(await asyncio.gather(*removal)) and bool(removal)
        t0 = time.perf_counter()
        while readers_alive() and time.perf_counter() - t0 < READERS_END_S:
            await asyncio.sleep(0.02)
        alive = readers_alive()
        print(f"  {label}: removed {removed}, readers ended "
              f"{time.perf_counter() - t0:.3f} s after the job returned, "
              f"{len(alive)} still alive")
        if (not removed or last != "CANCEL_JOB_DONE" or out is not None
                or not 0 < count < p10["Context.run APPLY_DISK_MASK "
                                       "(phase 10)"] or alive):
            failures.append(f"{label}: removed {removed}, {last}, "
                            f"{count} launches, {len(alive)} readers")

        # CLUST: its controller runs the two feature passes, then the
        # clustering (scikit-learn, imported there)
        state.analysis_state.create("an-clust", "ds-scan", "CLUST",
                                    params["CLUST"])
        label = "17a CLUST job through its controller"
        out, count, last = await job(label, "an-clust", "job-clust")
        if count != clust_launches:
            failures.append(f"{label}: {count} launches, phase 10's "
                            f"feature passes {clust_launches}")
        try:
            import sklearn  # noqa: F401
        except ImportError:
            msgs = [ev.get("msg", "") for ev in registry.events
                    if isinstance(ev, dict)
                    and ev.get("messageType") == "JOB_ERROR"]
            print(f"  17a CLUST's clustering was not run: scikit-learn is "
                  f"not installed (its two device passes ran, then the "
                  f"job ended with JOB_ERROR: {msgs[:1]})")
            if last != "JOB_ERROR" or not any("sklearn" in m for m in msgs):
                failures.append(f"{label}: without scikit-learn it ended "
                                f"with {last} {msgs[:1]}")
        else:
            labels = np.asarray(out.intensity.raw_data) if out else None
            shape = None if labels is None else labels.shape
            n_clusters = 0 if labels is None else len(np.unique(labels))
            print(f"  {label}: labels {shape}, {n_clusters} clusters")
            if last != "FINISH_JOB" or labels is None \
                    or labels.shape != NAV or not np.isfinite(labels).all():
                failures.append(f"{label}: {last}")
        if readers_alive():
            failures.append("17a: readers alive after the jobs")
        state.executor_state.shutdown()
        return converted

    try:
        converted = asyncio.run(drive())
    finally:
        web_log.removeHandler(records)
        web_log.propagate = True
    unrendered = sum("visualization failed" in r.getMessage()
                     for r in records.records)
    print(f"  17a: {unrendered} channel images not rendered (logged, sent "
          f"without an image), {len(records.records)} log records of the "
          f"web modules in all")

    # -- (b) the server, where tornado imports -------------------------------
    try:
        import tornado  # noqa: F401
    except ImportError:
        print("17(b) was not run: tornado is not installed")
    else:
        gui_server(lt, path, params, res_a, row, at, failures)

    # -- (c) the generated notebook ------------------------------------------
    from libertem_tpu_torch.web.notebook_generator import notebook_for
    nb = notebook_for("RAW", converted, [
        {"analysisType": id_, "parameters": params[id_]}
        for id_ in ("APPLY_DISK_MASK", "CENTER_OF_MASS")])
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    ns = {}
    if not has_mpl:
        ns["plt"] = PlotStub()
    for i, cell in enumerate(cells):
        src = "".join(
            line for line in cell["source"]
            if not line.lstrip().startswith("%")
            and not (not has_mpl and "import matplotlib" in line))
        fused_moments.launches = 0
        t0 = time.perf_counter()
        exec(compile(src, f"<notebook cell {i}>", "exec"), ns)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if i < 3:
            continue
        id_ = ("APPLY_DISK_MASK", "CENTER_OF_MASS")[i - 3]
        label = f"17c notebook cell {i}, {id_}"
        count = fused_moments.launches
        launches[f"{label} (phase 17)"] = count
        got = raw_arrays(ns.pop("result"))
        bad = same_arrays(res_a.get(id_, {}), got)
        print(f"{label}: {secs:.3f} s, fused_moments launches {count}; "
              f"raw results bit for bit 17a's job: {not bad} {at}")
        if bad or count != p10[f"Context.run {id_} (phase 10)"]:
            failures.append(f"{label}: differs in {bad}, {count} launches")
    print(f"  17c: the notebook's Context on "
          f"{[str(d) for d in ns['ctx'].executor.devices]}, plt "
          f"{'matplotlib' if has_mpl else 'a stub'}")
    ns["ctx"].close()
    print("phase 17 summary: " + json.dumps(rows))
    return launches


def gui_server(lt, path, params, res_a, row, at, failures) -> None:
    """Phase 17(b): ``make_app`` on 127.0.0.1 (a free port) in a thread of
    its own, driven from here with tornado's HTTP and websocket clients:
    the config lists the card, the scan is detected and opened, a
    compound analysis with DISK and CoM is made and its jobs PUT, the
    websocket read until each FINISH_JOB (every header's image count
    against the frames after it), the NPZ downloads held bit for bit
    against 17(a), and ``DELETE /api/shutdown/`` ends the server."""
    import asyncio
    import io
    import socket

    import tornado.httpclient
    import tornado.ioloop
    import tornado.websocket

    import torch

    from libertem_tpu_torch.ops.moments import fused_moments
    from libertem_tpu_torch.web.server import make_app

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    ready = threading.Event()
    served = {}

    def serve():
        asyncio.set_event_loop(asyncio.new_event_loop())
        app = make_app()
        server = app.listen(port, address="127.0.0.1")
        served["app"] = app
        loop = tornado.ioloop.IOLoop.current()
        loop.add_callback(ready.set)
        try:
            loop.start()  # until DELETE /api/shutdown/ stops it
        finally:
            server.stop()
            app.shared_state.executor_state.shutdown()

    thread = threading.Thread(target=serve, name="gui-server", daemon=True)
    thread.start()
    if not ready.wait(60):
        failures.append("17b: the server did not start")
        return
    jobs = (("an-disk", "APPLY_DISK_MASK"), ("an-com", "CENTER_OF_MASS"))

    async def client():
        http = tornado.httpclient.AsyncHTTPClient()

        async def call(route, method="GET", body=None):
            resp = await http.fetch(
                base + route, method=method, raise_error=False,
                body=None if body is None else json.dumps(body))
            return resp.code, resp.body

        code, body = await call("/api/config/")
        cudas = json.loads(body)["config"]["devices"]["cudas"]
        print(f"17b /api/config/: {code}, cudas {cudas}")
        if cudas != list(range(torch.cuda.device_count())):
            failures.append(f"17b: the config lists cudas {cudas}")
        code, body = await call("/api/config/connection/", "PUT",
                                {"connection": {"type": "local"}})
        if code != 200:
            failures.append(f"17b connection: {code} {body[:200]}")
        code, body = await call(f"/api/datasets/detect/?path={path}")
        print(f"17b detect: {json.loads(body)['messageType']} (a raw file "
              f"has no header: the GUI's form gives its shape and dtype)")
        t0 = time.perf_counter()
        code, body = await call("/api/datasets/ds-b/", "PUT", {"dataset": {
            "params": {"type": "RAW", "path": path, "dtype": "uint16",
                       "nav_shape": list(NAV), "sig_shape": list(SIG)}}})
        opened = json.loads(body)
        shape = opened.get("details", {}).get("params", {}).get("shape")
        print(f"17b open (with the kernels' build primed): "
              f"{time.perf_counter() - t0:.3f} s, {opened['messageType']}, "
              f"shape {shape}")
        if opened["messageType"] != "CREATE_DATASET":
            failures.append(f"17b open: {opened}")
            return
        await call("/api/compoundAnalyses/ca-b/", "PUT", {
            "dataset": "ds-b", "details": {
                "mainType": "APPLY_DISK_MASK",
                "analyses": [an for an, _ in jobs]}})
        for an, id_ in jobs:
            await call(f"/api/compoundAnalyses/ca-b/analyses/{an}/", "PUT",
                       {"dataset": "ds-b", "details": {
                           "analysisType": id_, "parameters": params[id_]}})
        ws = await tornado.websocket.websocket_connect(
            base.replace("http://", "ws://") + "/api/events/")
        await ws.read_message()  # INITIAL_STATE
        for an, id_ in jobs:
            job_id = f"job-b-{id_.lower()}"
            fused_moments.launches = 0
            t0 = time.perf_counter()
            code, _ = await call(f"/api/jobs/{job_id}/", "PUT",
                                 {"job": {"analysis": an}})
            events = []
            while True:
                msg = await asyncio.wait_for(ws.read_message(), 120)
                if msg is None:
                    break
                events.append(msg if isinstance(msg, bytes)
                              else json.loads(msg))
                if not isinstance(msg, bytes) and events[-1].get(
                        "messageType") == "JOB_ERROR":
                    break
                fin = [e for e in events if isinstance(e, dict)
                       and e.get("messageType") == "FINISH_JOB"]
                if fin and len(events) - events.index(fin[0]) - 1 == \
                        fin[0]["followup"]["numMessages"]:
                    break
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            heads, frames, ok, last = job_frames(events, job_id)
            row(f"17b {id_} job over REST and the websocket", secs,
                fused_moments.launches, heads, frames, ok, last)
            code, body = await call(f"/api/compoundAnalyses/ca-b/analyses/"
                                    f"{an}/download/NPZ/")
            with np.load(io.BytesIO(body)) as z:
                got = {k: z[k] for k in z.files}
            bad = same_arrays(got, res_a.get(id_, {}))
            print(f"  17b {id_}: NPZ {sorted(got)}, bit for bit 17a's "
                  f"job: {not bad}")
            if last != "FINISH_JOB" or bad or not got:
                failures.append(f"17b {id_}: {last}, differs in {bad}")
        ws.close()
        code, body = await call("/api/shutdown/", "DELETE")
        print(f"17b shutdown: {code} {json.loads(body)['messageType']}")
        http.close()

    try:
        asyncio.run(client())
    finally:
        thread.join(60)
    if thread.is_alive():
        failures.append("17b: the server thread did not end")


# -- phase 18: the drop-in libertem namespace on the card --------------------

DROPIN_TIMEOUT_S = 400
# more environment for phase 18's processes (a CPU rehearsal pins the
# CPU here: LIBERTEM_TPU_TORCH_USE_CPU)
DROPIN_ENV: dict = {}

# the import spellings of tests/test_dropin.py, each with the port's
# object it must be: (alias module, name, port module)
DROPIN_SPELLINGS = (
    ("libertem.udf.base", "UDF", "libertem_tpu_torch.udf.base"),
    ("libertem.udf.sum", "SumUDF", "libertem_tpu_torch.udf.sum"),
    ("libertem.udf.stddev", "StdDevUDF", "libertem_tpu_torch.udf.stddev"),
    ("libertem.udf.masks", "ApplyMasksUDF", "libertem_tpu_torch.udf.masks"),
    ("libertem.udf.raw", "PickUDF", "libertem_tpu_torch.udf.raw"),
    ("libertem.udf.com", "CoMUDF", "libertem_tpu_torch.udf.com"),
    ("libertem.common", "Shape", "libertem_tpu_torch.common.shape"),
    ("libertem.common", "Slice", "libertem_tpu_torch.common.slice"),
    ("libertem.common.buffers", "BufferWrapper",
     "libertem_tpu_torch.common.buffers"),
    ("libertem.common.container", "MaskContainer",
     "libertem_tpu_torch.udf.masks"),
    ("libertem.common.executor", "JobExecutor",
     "libertem_tpu_torch.executor.base"),
    ("libertem.corrections", "CorrectionSet",
     "libertem_tpu_torch.io.corrections"),
    ("libertem", "masks", "libertem_tpu_torch"),
    ("libertem.io.dataset", "load", "libertem_tpu_torch.io.dataset"),
    ("libertem.io.dataset.memory", "MemoryDataSet",
     "libertem_tpu_torch.io.dataset.memory"),
    ("libertem.executor.inline", "InlineJobExecutor",
     "libertem_tpu_torch.executor.inline"),
    ("libertem.viz", "Dummy2DPlot", "libertem_tpu_torch.viz"),
    ("libertem.analysis", "COMAnalysis", "libertem_tpu_torch.analysis"),
)


def mixed_modules() -> list:
    """jax or JAX-package modules in this process."""
    return sorted(k for k in sys.modules
                  if k in ("jax", "libertem_tpu")
                  or k.startswith(("jax.", "libertem_tpu.")))


def dropin_child_main(spec_json: str) -> int:
    """``python -m libertem_tpu_torch.dropin chip_smoke.py --dropin-child
    SPEC``: phase 18's process (:func:`dropin_phase` starts it).
    ``SPEC`` is a JSON object: ``scan`` (phase 2's raw file), ``nav``,
    ``out`` (an .npz path) and ``t_spawn`` (the parent's ``time.time()``
    when it started this process).  (a) ``import libertem.api as lt`` and
    phase 4's five UDFs by their reference spellings, ``lt.Context()``
    (the card), one pass over the scan with the launch count set to 0
    just before and read just after, its results to ``out``, and a
    second pass for its time; (c) the reference spellings, each the
    port's object, the port's card pin, and no jax or JAX-package
    module.  The last line of the output is a JSON report."""
    import importlib
    import types

    spec = json.loads(spec_json)
    import libertem.api as lt
    from libertem import masks
    from libertem.udf.com import CoMUDF
    from libertem.udf.masks import ApplyMasksUDF
    from libertem.udf.stddev import StdDevUDF
    from libertem.udf.sum import SumUDF
    from libertem.udf.sumsigudf import SumSigUDF
    # the process start to here: the interpreter, the runner (which
    # imports the port, torch with it) and the imports through the finder
    import_s = time.time() - spec["t_spawn"]
    import torch
    from libertem.ops.moments import fused_moments

    problems = []
    ns = types.SimpleNamespace(
        ApplyMasksUDF=ApplyMasksUDF, CoMUDF=CoMUDF, SumUDF=SumUDF,
        SumSigUDF=SumSigUDF, StdDevUDF=StdDevUDF, masks=masks)
    t0 = time.perf_counter()
    ctx = lt.Context()

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    # the process's first CUDA work: the card's context
    torch.empty(1, device=ctx.device)
    sync()
    context_s = time.perf_counter() - t0
    ds = ctx.load("raw", path=spec["scan"], dtype="uint16",
                  nav_shape=tuple(spec["nav"]), sig_shape=SIG)
    # the first pass under cProfile (this thread only; the reader's
    # thread is not in it), for where a fresh process's first pass goes
    import cProfile
    import pstats
    prof = cProfile.Profile()
    fused_moments.launches = 0
    t0 = time.perf_counter()
    prof.enable()
    res = ctx.run_udf(ds, make_udfs(ns))
    sync()
    prof.disable()
    wall_s = time.perf_counter() - t0
    launches = fused_moments.launches
    report = io.StringIO()
    pstats.Stats(prof, stream=report).sort_stats("cumulative").print_stats(
        14)
    print("18a first pass, cProfile by cumulative time:\n"
          + "\n".join(ln for ln in report.getvalue().splitlines()
                      if ln.strip()))
    np.savez(spec["out"], **result_arrays(res))
    fused_moments.launches = 0
    t0 = time.perf_counter()
    ctx.run_udf(ds, make_udfs(ns))
    sync()
    wall2_s = time.perf_counter() - t0
    launches2 = fused_moments.launches

    # (c) the reference spellings, the pins, the two packages apart
    for alias, name, real in DROPIN_SPELLINGS:
        got = getattr(importlib.import_module(alias), name)
        if got is not getattr(importlib.import_module(real), name):
            problems.append(f"{alias}.{name} is not {real}.{name}")
    import libertem
    import libertem_tpu_torch
    if libertem.__version__ != libertem_tpu_torch.__version__ \
            or libertem.Context is not lt.Context:
        problems.append("libertem.__version__/Context are not the port's")
    from libertem.common.backend import (
        get_device_class, resolve_device, set_use_cuda)
    set_use_cuda(0)
    if get_device_class() != "cuda" or torch.cuda.is_available() and \
            resolve_device(None) != torch.device("cuda", 0):
        problems.append("set_use_cuda(0) does not pin card 0")
    try:
        importlib.import_module("libertem_tpu")
        problems.append("libertem_tpu imported beside the drop-in")
    except ImportError:
        pass
    mixed = mixed_modules()
    if mixed:
        problems.append(f"jax or the JAX package imported: {mixed[:5]}")
    print(json.dumps(dict(
        import_s=import_s, context_s=context_s, wall_s=wall_s,
        wall2_s=wall2_s,
        launches=launches, launches2=launches2,
        spellings=len(DROPIN_SPELLINGS), device=str(ctx.device),
        problems=problems)))
    return 1 if problems else 0


def dropin_phase(path, arrays4, launches4, at, failures,
                 nav=NAV) -> dict:
    """Phase 18: the drop-in namespace on the card, in processes of
    their own started through ``python -m libertem_tpu_torch.dropin``:
    (a) and (c) in :func:`dropin_child_main` (its results bit for bit
    phase 4's ``arrays4`` with ``launches4`` launches), (b) the four
    example scripts with ``libertem_tpu`` rewritten to ``libertem``,
    each on the card with its own asserts and no jax or JAX-package
    module.  Returns the launch count of (a)'s counted pass."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIBERTEM_TPU_TORCH_USE_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(DROPIN_ENV)
    # custom_udf's numpy UDF warns that it goes to the host engine
    runner = [sys.executable, "-W", "ignore::UserWarning", "-m",
              "libertem_tpu_torch.dropin"]

    def run(args, label):
        t0 = time.perf_counter()
        try:
            out = subprocess.run(runner + args, cwd=root, env=env,
                                 capture_output=True, text=True,
                                 timeout=DROPIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            failures.append(f"18 {label}: outlasted {DROPIN_TIMEOUT_S} s")
            return None, time.perf_counter() - t0
        secs = time.perf_counter() - t0
        if out.returncode != 0:
            failures.append(f"18 {label}: exited {out.returncode}")
            print(f"18 {label} output:\n{out.stdout[-2000:]}"
                  f"{out.stderr[-3000:]}")
            return None, secs
        return out.stdout, secs

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- (a) and (c) ---------------------------------------------------
        npz = os.path.join(tmp, "dropin.npz")
        spec = json.dumps(dict(scan=path, nav=list(nav), out=npz,
                               t_spawn=time.time()))
        stdout, secs = run([os.path.abspath(__file__), "--dropin-child",
                            spec], "(a)/(c) child")
        if stdout is not None:
            lines = stdout.splitlines()
            rep = json.loads([ln for ln in lines if ln.startswith("{")][-1])
            start = [i for i, ln in enumerate(lines)
                     if ln.startswith("18a first pass, cProfile")]
            if start:
                print("\n".join(lines[start[0]:start[0] + 24]))
            launches["drop-in main path, import libertem.api (phase 18a)"] \
                = rep["launches"]
            with np.load(npz) as z:
                got = {k: z[k] for k in z.files}
            bad = same_bits(arrays4, got)
            print(f"18a drop-in main path: process start to import "
                  f"libertem.api and the five UDFs done {rep['import_s']:.3f}"
                  f" s (interpreter, torch, the port, the finder), "
                  f"Context() and the card's context {rep['context_s']:.3f}"
                  f" s, first pass {rep['wall_s']:.3f} s wall (under "
                  f"cProfile; second pass "
                  f"{rep['wall2_s']:.3f} s) on {rep['device']}, "
                  f"fused_moments launches {rep['launches']} (phase 4: "
                  f"{launches4}), results bit for bit phase 4's: "
                  f"{not bad}; process {secs:.1f} s {at}")
            print(f"18c drop-in spellings: {rep['spellings']} names the "
                  f"port's, card pin, no jax: {not rep['problems']}")
            if bad:
                failures.append(f"18a: results differ from phase 4's in "
                                f"{bad[:5]}")
            if rep["launches"] != launches4 or rep["launches2"] != launches4:
                failures.append(f"18a: {rep['launches']} and "
                                f"{rep['launches2']} launches, phase 4 "
                                f"{launches4}")

        # -- (b) the example scripts in the reference spelling -------------
        for name in EXAMPLES:
            with open(os.path.join(root, "examples", f"{name}.py")) as f:
                code = f.read().replace("libertem_tpu", "libertem")
            script = os.path.join(tmp, f"{name}.py")
            with open(script, "w") as f:
                f.write(code + "\n\nimport sys as _sys\n"
                        "_bad = sorted(k for k in _sys.modules if k in "
                        "('jax', 'libertem_tpu') or k.startswith(('jax.', "
                        "'libertem_tpu.')))\n"
                        "assert not _bad, _bad\n")
            stdout, secs = run([script], f"(b) example {name}")
            if stdout is None:
                continue
            lines = stdout.strip().splitlines()
            last = lines[-1] if lines else ""
            if name == "strain_mapping" and not float(
                    last.split(":")[1]) < 0.01:
                failures.append(f"18b {name}: {last}")
            print(f"18b example {name} through the drop-in: ok in "
                  f"{secs:.1f} s (process); last line {last!r}")
    return launches


# -- phase 19: the reduced-precision modes -----------------------------------

PRECISION_ENV = "LIBERTEM_TPU_TORCH_MATMUL_PRECISION"
MALLOC_ENV = "LIBERTEM_TPU_TORCH_NO_MALLOC_TUNE"
BF16_MASKS = 8          # random float masks of 19(e)
READER_TIMEOUT_S = 300  # a reader child of 19(f)
# a one-pass y against float64: two TF32 roundings of at most 2^-11
# each, and the float32 sums, of |x| @ |m|
ONE_PASS_BOUND = 2.0 ** -9


@contextlib.contextmanager
def precision_env(value: str):
    """``LIBERTEM_TPU_TORCH_MATMUL_PRECISION`` set to ``value`` inside,
    restored after."""
    prev = os.environ.get(PRECISION_ENV)
    os.environ[PRECISION_ENV] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(PRECISION_ENV, None)
        else:
            os.environ[PRECISION_ENV] = prev


def reader_child_main(spec_json: str) -> int:
    """``python3 chip_smoke.py --reader-child SPEC``: one process of
    19(f) (:func:`malloc_tune`).  ``SPEC`` is a JSON object: ``scans``,
    each with ``kind`` and ``load`` (``Context.load``'s arguments),
    ``sig`` and ``bytes`` (on disk), and ``passes``.  For each scan,
    runs the main path's five UDFs at its sig once to warm up, then
    ``passes`` times, and prints one JSON line: whether the tune was
    on and, per scan, each pass's wall s, reader s, reader GB/s (bytes
    over the reader's time) and wall GB/s."""
    import torch

    import libertem_tpu_torch as lt

    spec = json.loads(spec_json)
    ctx = lt.Context()
    out = {"tune": not os.environ.get(MALLOC_ENV), "scans": []}
    for scan in spec["scans"]:
        ds = ctx.load(scan["kind"], **scan["load"])
        sig = tuple(scan["sig"])

        def udfs():
            return make_udfs(lt) if sig == SIG else format_udfs(lt, sig)[0]

        ctx.run_udf(ds, udfs())
        torch.cuda.synchronize()
        walls, reads = [], []
        for _ in range(spec["passes"]):
            t0 = time.perf_counter()
            ctx.run_udf(ds, udfs())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            reads.append(ctx.feed_stats["read_s"])
        n = scan["bytes"]
        out["scans"].append({
            "wall_s": walls, "read_s": reads,
            "reader_gbps": [n / r / 1e9 for r in reads],
            "wall_gbps": [n / w / 1e9 for w in walls]})
    print(json.dumps(out))
    return 0


def malloc_tune(path, data, tmp, at, failures) -> list:
    """19(f): phase 2's raw scan and 12a's MIB r12 file, each read by
    the main path's UDFs in a child process with the malloc tune on,
    then in one with it off (``LIBERTEM_TPU_TORCH_NO_MALLOC_TUNE=1``);
    reader and wall GB/s side by side.  Returns the rows."""
    f16 = data.reshape(-1)[:data.size // 65536 * 65536].reshape(-1, 65536)
    mib = os.path.join(tmp, "tune.mib")
    # the scan's frames as 256 x 256 frames: nav 128 x 128 on the card
    nav = (max(1, len(f16) // 128), min(128, len(f16)))
    n = int(np.prod(nav))
    mib_bytes = write_records(
        mib, n, 2 * 65536, lambda lo, hi: enc_r12(f16[lo:hi]),
        head=MIB_HEAD, head_fn=mib_heads(MIB_HEAD, 1, 256, 256, "R64",
                                         "1x1", 12))
    root = os.path.dirname(os.path.abspath(__file__))
    labels = ("phase 2's raw scan", "12a MIB r12")
    scans = [
        dict(kind="raw", load=dict(
            path=path, dtype="uint16", nav_shape=list(data.shape[:2]),
            sig_shape=list(SIG)), sig=list(SIG),
            bytes=os.path.getsize(path)),
        dict(kind="mib", load=dict(path=mib, nav_shape=nav),
             sig=[256, 256], bytes=mib_bytes),
    ]
    got = {}
    for tune in (True, False):
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        env.pop(MALLOC_ENV, None)
        if not tune:
            env[MALLOC_ENV] = "1"
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--reader-child",
             json.dumps(dict(scans=scans, passes=2))],
            env=env, capture_output=True, text=True,
            timeout=READER_TIMEOUT_S)
        if proc.returncode != 0:
            failures.append(f"19f tune {tune}: child exit "
                            f"{proc.returncode}: {proc.stderr[-2000:]}")
            continue
        got[tune] = json.loads(proc.stdout.strip().splitlines()[-1])
        if got[tune]["tune"] != tune:
            failures.append(f"19f: the child's tune is {got[tune]['tune']}, "
                            f"asked {tune}")
    os.remove(mib)
    rows = []
    if len(got) < 2:
        return rows
    for label, scan, on, off in zip(labels, scans, got[True]["scans"],
                                    got[False]["scans"]):
        rows.append(dict(path=f"19f {label}", bytes=scan["bytes"],
                         tune_reader_gbps=on["reader_gbps"],
                         no_tune_reader_gbps=off["reader_gbps"],
                         tune_wall_gbps=on["wall_gbps"],
                         no_tune_wall_gbps=off["wall_gbps"]))
        print(f"19f {label}, {scan['bytes']} bytes: reader GB/s with the "
              f"malloc tune {on['reader_gbps']} / without "
              f"{off['reader_gbps']}; wall GB/s {on['wall_gbps']} / "
              f"{off['wall_gbps']} (the child with the tune first) {at}")
    return rows


def precision_phase(ctx, ds, lt, data, arrays4, launches4, arrays6a,
                    corrections, n_blocks, depth, u16_blocks, f32_blocks,
                    ring_masks_t, sparse_t, path, tmp, at,
                    failures) -> dict:
    """Phase 19: the reduced-precision modes.  (a) phase 4's pass under
    ``LIBERTEM_TPU_TORCH_MATMUL_PRECISION=default``: its launches and
    every result bit for bit phase 4's (counts and 0/1 masks need one
    pass); (b) one-pass kernel calls at u16 M = 6, 12, 40 with random
    normal masks, 6a's corrected f32 block at M = 12 and 7a's M = 17
    whole frame: y against the plain version on the TF32-rounded
    operands (within 1e-5 of ``|x_hi| @ |m_hi|``) and within 2^-9 of
    ``|x| @ |m|`` of float64, colsum and colvar the three-pass call's
    bits, graph replays bit for bit; (c) those cases timed in both
    modes beside the one-pass bound; (d) 6a's pass with the variable
    flipped between two ``run_udf`` calls: one pass, then three; (e)
    ``ApplyMasksUDF(use_bf16=True)`` over the scan with random float
    masks against the float32 generic product and a float64 oracle of
    the bf16-rounded operands, beside the bf16 product's routes on a
    block; (f) :func:`malloc_tune`.  Returns the launches by path, the
    one-pass cases for the kernels line and the other rows."""
    import torch

    import libertem_tpu_torch.udf.masks as pmasks
    from libertem_tpu_torch.ops.moments import (
        fused_moments,
        fused_moments_reference,
        tf32_passes,
        tf32_round,
    )
    from libertem_tpu_torch.udf.base import _tf32_matmul

    dev = u16_blocks[0].device
    out = {"launches": {}, "cases": [], "rows": []}

    # (a) the main path under "default"
    with precision_env("default"):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, make_udfs(lt))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = fused_moments.launches
    prec = ctx.run_info["matmul_precision"]
    differ = same_bits(result_arrays(res), arrays4)
    out["launches"]["main path, precision default (phase 19a)"] = count
    print(f"19a phase 4's pass under {PRECISION_ENV}=default: {secs:.3f} s "
          f"wall, {count} launches (phase 4: {launches4}), run_info "
          f"matmul_precision {prec}; every result bit for bit phase 4's: "
          f"{not differ} {at}")
    if count != launches4 or prec != "default" or differ:
        failures.append(f"19a: {count} launches (phase 4 {launches4}), "
                        f"precision {prec}, results differ in {differ}")

    # (b), (c) one-pass kernel calls against the plain version, timed
    rng = np.random.default_rng(SEED + 19)
    pixels = u16_blocks[0].shape[1]

    def normal(m):
        return torch.from_numpy(rng.normal(size=(m, pixels)).astype(
            np.float32)).to(dev)

    def library_tf32(x, m, valid, compute_var):
        with _tf32_matmul(True):
            xf = x.float()
            return xf @ m.T, torch.var_mean(xf, dim=0, correction=0)

    n_ring = ring_masks_t.shape[0]
    cases = [
        ("u16 M=6 normal masks", u16_blocks, normal(6), None),
        ("u16 M=12", u16_blocks, normal(12), None),
        ("u16 M=40", u16_blocks, normal(40), None),
        (f"f32 corrected M={n_ring}", f32_blocks, ring_masks_t,
         "6a's pass, precision default (phase 19d)"),
        ("u16 M=17 whole frame (7a)", u16_blocks, sparse_t, None),
    ]
    worst = 0.0
    for label, blocks, m, path_key in cases:
        x = blocks[0]
        y1, s1, v1 = fused_moments(x, m, depth, precision="default")
        y3, s3, v3 = fused_moments(x, m, depth, precision="highest")
        xh, mh = tf32_round(x), tf32_round(m)
        want = fused_moments_reference(xh, mh, depth)[0].double()
        diff = (y1.double() - want).abs()
        plain_ok = bool(torch.all(
            diff <= RTOL * (xh.abs().double() @ mh.abs().double().T)))
        x64, m64 = x.double(), m.double()
        err64 = (y1.double() - x64 @ m64.T).abs()
        rel64 = float((err64 / (x64.abs() @ m64.abs().T).clamp_min(
            1e-300)).max())
        moments_same = torch.equal(s1, s3) and torch.equal(v1, v3)
        y_same = torch.equal(y1, y3)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = [fused_moments(x, m, depth, precision="default")
                        for _ in range(8)]
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        replays_same = all(torch.equal(a, b) for o in captured
                           for a, b in zip((y1, s1, v1), o))
        del graph, captured, x64, err64
        passes3 = tf32_passes(x, m)
        e = float(diff.max())
        worst = max(worst, e)
        print(f"  19b one pass, {label}: y vs plain on TF32-rounded "
              f"operands max abs err {e:.3g} (within 1e-5 of |x_hi| @ "
              f"|m_hi|: {plain_ok}); vs float64 {rel64:.3g} of |x| @ |m| "
              f"(bound 2^-9 = {ONE_PASS_BOUND:.3g}); colsum, colvar the "
              f"three-pass call's bits: {moments_same}; y the three-pass "
              f"call's bits ({passes3} passes there): {y_same}; 8 captured "
              f"calls replayed twice bit for bit: {replays_same}")
        if not (plain_ok and rel64 <= ONE_PASS_BOUND and moments_same
                and replays_same and (y_same or passes3 > 1)):
            failures.append(f"19b {label}: plain {plain_ok}, float64 "
                            f"{rel64}, moments {moments_same}, replays "
                            f"{replays_same}, y {y_same} at {passes3} "
                            f"passes")
        itemsize = x.element_size()
        k1, k1_eager = time_ms(fused_moments, [
            (b, m, depth, True, "default") for b in blocks])
        k3, _ = time_ms(fused_moments, [
            (b, m, depth, True, "highest") for b in blocks])
        rounded = [(tf32_round(b), mh, depth, True) for b in blocks]
        p_ms, _ = time_ms(fused_moments_reference, rounded)
        del rounded
        l_ms, _ = time_ms(library_tf32, [(b, m, depth, True)
                                         for b in blocks])
        b_ms, b_by = bound(depth, pixels, m.shape[0], itemsize, passes=1)
        b3_ms, _ = bound(depth, pixels, m.shape[0], itemsize, passes3)
        print(f"19c fused_moments {label}: one TF32 pass {k1:.4f} ms "
              f"(launched one by one {k1_eager:.4f}), bound {b_ms:.4f} ms "
              f"by {b_by} ({b_ms / k1:.1%} of it); three-pass mode "
              f"{k3:.4f} ms ({passes3} passes, bound {b3_ms:.4f}); plain "
              f"on rounded operands {p_ms:.4f} ms; library (TF32 matmul + "
              f"var_mean, yardstick only) {l_ms:.4f} ms {at}")
        out["cases"].append(dict(
            case=f"{label}, one TF32 pass (precision default)",
            launches_per_2GiB_run=None, path=path_key, ms=k1,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
            three_pass_mode_ms=k3, three_pass_mode_passes=passes3,
            max_abs_err=e, float64_rel=rel64))

    # (d) the variable flipped between two runs, on 6a's corrected pass
    runs = {}
    for prec in ("default", "highest"):
        with precision_env(prec):
            fused_moments.launches = 0
            t0 = time.perf_counter()
            res = ctx.run_udf(ds, make_ring_udfs(lt),
                              corrections=corrections)
            torch.cuda.synchronize()
            runs[prec] = (result_arrays(res), fused_moments.launches,
                          ctx.run_info["matmul_precision"],
                          time.perf_counter() - t0)
    (a1, c1, p1, s1), (a3, c3, p3, s3) = runs["default"], runs["highest"]
    # ApplyMasks (0), CoM (1) and SumSig (3) come from y; Sum (2) and
    # StdDev (4) from colsum and colvar
    moment_keys = [k for k in arrays6a if k.startswith(("2/", "4/"))]
    moments_differ = same_bits({k: a1[k] for k in moment_keys},
                               {k: arrays6a[k] for k in moment_keys})
    y1, y3 = a1["0/intensity"], arrays6a["0/intensity"]
    rel = float(np.max(np.abs(y1.astype(np.float64) - y3) / np.maximum(
        np.abs(y3.astype(np.float64)), 1e-30)))
    one_pass_seen = not np.array_equal(y1, y3)
    three_differ = same_bits(a3, arrays6a)
    for key, c in (("default", c1), ("highest", c3)):
        out["launches"][f"6a's pass, precision {key} (phase 19d)"] = c
    for case in out["cases"]:
        if case["path"] is not None:
            case["launches_per_2GiB_run"] = c1
    print(f"19d 6a's pass, {PRECISION_ENV} default then highest: {s1:.3f} "
          f"/ {s3:.3f} s wall, {c1} / {c3} launches, run_info "
          f"{p1} / {p3}; the first run's ApplyMasks differs from 6a's "
          f"(one pass): {one_pass_seen}, by {rel:.3g} relative at most; "
          f"its Sum and StdDev are 6a's bits: {not moments_differ}; the "
          f"second run bit for bit 6a's: {not three_differ} {at}")
    if not (c1 == c3 == n_blocks and (p1, p3) == ("default", "highest")
            and one_pass_seen and rel <= 2 * ONE_PASS_BOUND
            and not moments_differ and not three_differ):
        failures.append(f"19d: launches {c1}/{c3}, precision {p1}/{p3}, "
                        f"one pass seen {one_pass_seen} ({rel}), moments "
                        f"differ {moments_differ}, the second run "
                        f"differs in {three_differ}")

    # (e) ApplyMasksUDF(use_bf16=True) with random float masks
    stack = np.random.default_rng(SEED + 20).random(
        (BF16_MASKS,) + SIG).astype(np.float32)

    class GenericApplyMasksUDF(lt.ApplyMasksUDF):
        """ApplyMasks' float32 product on the generic path."""

        def fused_moments_spec(self):
            return None

    def bf16_udf(cls=lt.ApplyMasksUDF, **kw):
        return cls(mask_factories=lambda: stack, mask_count=BF16_MASKS,
                   **kw)

    walls = {}
    got = {}
    for key, make in (("bf16", lambda: bf16_udf(use_bf16=True)),
                      ("f32 generic", lambda: bf16_udf(GenericApplyMasksUDF)),
                      ("f32 generic again",
                       lambda: bf16_udf(GenericApplyMasksUDF)),
                      ("bf16 again", lambda: bf16_udf(use_bf16=True))):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, make())
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        got[key] = (res["intensity"].data, fused_moments.launches,
                    ctx.run_info["fused"])
    a, bf_launches, bf_fused = got["bf16"]
    b = got["f32 generic"][0]
    if int(data.max()) > 256:
        failures.append("19e: counts above 256 are not exact in bf16; the "
                        "oracle would need rounded frames")
    # float64 on the card, 4096 frames at a time
    rounded = torch.from_numpy(stack.reshape(BF16_MASKS, -1)).to(dev).to(
        torch.bfloat16).double()
    frames = data.reshape(-1, SIG[0] * SIG[1])
    want = np.concatenate([
        (torch.from_numpy(frames[lo:lo + 4096]).to(dev).double()
         @ rounded.T).cpu().numpy()
        for lo in range(0, len(frames), 4096)]).reshape(
        NAV + (BF16_MASKS,))
    del rounded
    e_f32, near_f32 = max_err(a, b, rtol=1e-2)
    e64, ok64 = max_err(a, want, rtol=RTOL)
    apart = not np.allclose(a, b, rtol=1e-7)
    out["launches"]["ApplyMasksUDF(use_bf16=True) (phase 19e)"] = \
        bf_launches
    # the bf16 product on a block, by route
    flat = u16_blocks[0].float()
    ops = torch.from_numpy(np.ascontiguousarray(
        stack.reshape(BF16_MASKS, -1).T)).to(dev)

    def widened(x, m, tf32):
        with _tf32_matmul(tf32):
            return x.to(torch.bfloat16).float() @ m.to(torch.bfloat16).float()

    def f32_product(x, m):
        with _tf32_matmul(False):
            return x @ m

    route_ms = {}
    ref = widened(flat, ops, False)
    for name, fn, bf16 in (
            ("bf16 mm, float32 output (the port's bf16_product)",
             pmasks.bf16_product, True),
            ("bf16 operands widened, TF32 matmul",
             lambda x, m: widened(x, m, True), True),
            ("bf16 operands widened, full fp32 matmul",
             lambda x, m: widened(x, m, False), True),
            ("float32 product, no bf16", f32_product, False)):
        r = fn(flat, ops)
        torch.cuda.synchronize()
        if bf16 and (r.dtype != torch.float32 or not torch.allclose(
                r, ref, rtol=RTOL, atol=0)):
            route_ms[name] = "wrong"
            failures.append(f"19e route {name} is not the widened "
                            f"product within 1e-5")
            continue
        route_ms[name] = time_ms(fn, [(flat, ops)])[0]
    print(f"19e ApplyMasksUDF(use_bf16=True), {BF16_MASKS} random float "
          f"masks over phase 2's scan: {bf_launches} fused launches (fused "
          f"{bf_fused}), dtype {a.dtype}; within 1e-2 of the float32 "
          f"generic run: {near_f32} (max abs {e_f32:.3g}); not within "
          f"1e-7 of it: {apart}; vs float64 of the bf16-rounded operands "
          f"max abs err {e64:.3g} (rtol 1e-5: {ok64}); wall bf16 "
          f"{walls['bf16']:.3f} / {walls['bf16 again']:.3f} s, float32 "
          f"generic {walls['f32 generic']:.3f} / "
          f"{walls['f32 generic again']:.3f} s {at}")
    print(f"  19e the bf16 product on a ({depth}, {pixels}) float32 block "
          f"and {BF16_MASKS} masks, device ms a call (CUDA graph of 32), "
          f"by route: {json.dumps(route_ms)} {at}")
    if (bf_launches != 0 or bf_fused or a.dtype != np.float32
            or not near_f32 or not apart or not ok64):
        failures.append(f"19e: launches {bf_launches}, fused {bf_fused}, "
                        f"{a.dtype}, near f32 {near_f32}, apart {apart}, "
                        f"float64 {ok64} ({e64})")
    out["rows"].append(dict(path="19e use_bf16", wall_s=walls,
                            route_ms=route_ms))

    # (f) the malloc tune
    out["rows"] += malloc_tune(path, data, tmp, at, failures)
    return out


def npy_header(shape, descr) -> bytes:
    """The .npy header (format 1.0) of a C-order array."""
    import io
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": descr, "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.ops import build
    from libertem_tpu_torch.ops.moments import (
        LIBRARIES,
        fused_moments,
        fused_moments_reference,
        tf32_passes,
    )
    from libertem_tpu_torch.ops.ablation import fp32_bound
    from libertem_tpu_torch.ops.sparse_masks import (
        CUDA_MAX_FILL,
        compaction_pays,
        gather_blocks,
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
    # the CUDA kernels and the host decoders, all compilers at once
    build.build([*LIBRARIES, "fused_moments_ablation", "decode"])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, a "
          f"process for each of {', '.join(LIBRARIES)} and "
          f"fused_moments_ablation; g++ for the decoders)")
    logs = [build.BUILD_DIR / f"{name}.log" for name in LIBRARIES]
    if all(log.exists() for log in logs):
        text = "".join(log.read_text() for log in logs)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text))
        print(f"  ptxas: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, {spills} bytes "
              f"spilled in all")
    hmma = tensor_core_kernels()
    print(f"  SASS: {hmma[0]} of {hmma[1]} partials kernels that take the "
          f"product hold HMMA (mma.sync on the tensor cores), the combine "
          f"{'does' if hmma[2] else 'does not'}")
    if hmma[0] != hmma[1] or hmma[1] == 0 or hmma[2]:
        failures.append(f"SASS: HMMA in {hmma[0]} of {hmma[1]} product "
                        f"kernels, in the combine: {hmma[2]}")

    t_start = time.perf_counter()
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
        # identical bits: three calls, then captured calls replayed
        # twice
        x0 = torch.from_numpy(poisson).to(dev)
        for label, m in (("M=6", masks_t), ("M=17", random_masks(17))):
            first = fused_moments(x0, m, depth - 37)
            outs = [fused_moments(x0, m, depth - 37) for _ in range(2)]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = [fused_moments(x0, m, depth - 37)
                            for _ in range(32)]
            graph.replay()
            graph.replay()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for o in outs + captured
                       for a, b in zip(first, o))
            del graph, captured
            print(f"  kernel fused_moments, {label}: 3 calls and 32 "
                  f"captured calls replayed twice give identical bits: "
                  f"{same}")
            if not same:
                failures.append(f"kernel {label}: calls differ in their "
                                f"bits")
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
        want = want4 = oracle(data, bf_adf)
        print(f"oracle: {time.perf_counter() - t0:.1f} s (float64 numpy)")
        check_results("main", res, want, failures)
        check_engines("main", ctx, [False] * 5, failures)
        arrays4 = result_arrays(res)

        # steady-state rerun, for timing only
        t0 = time.perf_counter()
        ctx.run_udf(ds, make_udfs(lt))
        torch.cuda.synchronize()
        e2e2_s = time.perf_counter() - t0
        feed2 = dict(ctx.feed_stats)
        counts = traced_run(ctx, ds, make_udfs(lt), at)
        traced = sum(c for k, c in counts.items() if "moments_partials" in k)
        combines = sum(c for k, c in counts.items()
                       if "moments_combine" in k)
        print(f"  4 trace: {traced} partials and {combines} combine "
              f"kernels for {n_blocks} blocks")
        if traced != n_blocks or combines != n_blocks:
            failures.append(f"4 trace: {traced} partials and {combines} "
                            f"combine kernels for {n_blocks} blocks")

        # -- 5. timings --------------------------------------------------------
        u16_blocks = [
            torch.from_numpy(np.random.default_rng(SEED + 2 + i).poisson(
                8.0, (depth, pixels)).astype(np.uint16)).to(dev)
            for i in range(4)
        ]
        f32_blocks = [corrected_block(SEED + 10 + i) for i in range(4)]

        def library(x, m, valid, compute_var):
            xf = x.float()
            return xf @ m.T, torch.var_mean(xf, dim=0, correction=0)

        def timed(label, blocks, m, valid, compute_var=True, lib=library):
            inputs = [(b, m, valid, compute_var) for b in blocks]
            k_ms, k_eager_ms = time_ms(fused_moments, inputs)
            p_ms, p_eager_ms = time_ms(fused_moments_reference, inputs)
            l_ms, _ = time_ms(lib, inputs)
            itemsize = blocks[0].element_size()
            npix = blocks[0].shape[1]
            passes = tf32_passes(blocks[0], m)
            b_ms, b_by = bound(depth, npix, m.shape[0], itemsize, passes)
            f_ms = fp32_bound(depth, npix, m.shape[0], itemsize)
            x_bytes = depth * npix * itemsize
            print(f"kernel fused_moments, {label}: {k_ms:.4f} ms per block "
                  f"({x_bytes / k_ms / 1e6:.1f} GB/s of input), bound "
                  f"{b_ms:.4f} ms by {b_by} ({b_ms / k_ms:.1%} of it; "
                  f"{passes} TF32 passes; with the product on the CUDA "
                  f"cores {f_ms:.4f} ms); launched from Python one by one "
                  f"{k_eager_ms:.4f} ms {at}")
            print(f"  plain version: {p_ms:.4f} ms (one by one "
                  f"{p_eager_ms:.4f} ms); library expression (matmul + "
                  f"var_mean, yardstick only): {l_ms:.4f} ms {at}")
            print(f"  fused_moments {label}: {k_ms:.4f} ms"
                  + beside(k_ms, EARLIER_MS.get(label),
                           PREDICTED_MS.get(label)) + f" {at}")
            return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": l_ms}

        main_t = timed("u16 M=6 (main path)", u16_blocks, masks_t, depth)
        cases = [
            dict(case="u16 M=12", launches_per_2GiB_run=n_blocks,
                 **timed("u16 M=12", u16_blocks, random_masks(12), depth)),
            dict(case="u16 M=40", launches_per_2GiB_run=n_blocks,
                 **timed("u16 M=40", u16_blocks, random_masks(40), depth)),
        ]
        corr_t = timed(f"f32 corrected M={n_ring_masks}", f32_blocks,
                       ring_masks_t, depth)
        # 8 blocks of 11.25 MiB (two column ranges of each u16 block)
        narrow = [b[:, lo:lo + 45 * 128].contiguous() for b in u16_blocks
                  for lo in (0, 45 * 128)]
        grid_sweep([
            ("u16 M=6 (main path)", u16_blocks, masks_t, True),
            ("u16 M=40", u16_blocks, random_masks(40), True),
            (f"f32 corrected M={n_ring_masks}", f32_blocks, ring_masks_t,
             True),
            ("u16 M=17 P=5760", narrow, random_masks(17)[:, :45 * 128]
             .contiguous(), True),
        ], depth, at, failures)
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
                  f"{nbytes / secs / 1e9:.2f} GB/s; reader "
                  f"{stats['read_s'] / secs:.1%} of the wall, consumer "
                  f"waited {stats['wait_s'] / secs:.1%}, host engine "
                  f"{stats['host_s'] / secs:.1%}; feed_stats "
                  f"{json.dumps(stats)} {at}")

        # (a) fused, corrected, 12 mask rows
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = res6a = ctx.run_udf(ds, make_ring_udfs(lt),
                                  corrections=corrections)
        torch.cuda.synchronize()
        corr_s = time.perf_counter() - t0
        corr_launches = fused_moments.launches
        report("6a fused + corrections, M=12", corr_s, total_bytes,
               ctx.feed_stats)
        check_engines("6a", ctx, [False] * 5, failures)
        if corr_launches != n_blocks:
            failures.append(
                f"6a launched fused_moments {corr_launches} times, "
                f"expected {n_blocks} (one per block for its "
                f"{n_ring_masks} mask rows)"
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
        check_engines("6b", ctx, [False] * 3, failures)
        t0 = time.perf_counter()
        pick = ctx.run_udf(ds, lt.PickUDF(), roi=pick_roi.reshape(NAV))
        torch.cuda.synchronize()
        pick_s = time.perf_counter() - t0
        report("6b PickUDF, roi of 5 frames", pick_s, 5 * pixels * 2,
               ctx.feed_stats)
        check_engines("6b PickUDF", ctx, [False], failures)
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

        # -- 7. the fifth slice's paths -------------------------------------
        # (a) sparse virtual detectors: fused, on the support blocks
        # where compaction pays on the card
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, sparse_udfs(lt))
        torch.cuda.synchronize()
        sp_s = time.perf_counter() - t0
        sp_launches = fused_moments.launches
        report("7a fused, sparse stack M=17", sp_s, total_bytes,
               ctx.feed_stats)
        check_engines("7a", ctx, [False, False], failures)
        # the plan of the run just timed, used or not
        comp = ctx.run_info["compaction"]
        sp_compacted = compaction_pays(comp, dev, "fused_moments")
        print(f"  7a plan: fused {ctx.run_info['fused']}, support "
              f"{None if comp is None else comp['support'].size} of "
              f"{None if comp is None else comp['n_blocks']} blocks, "
              f"used: {sp_compacted} (the port compacts the fused pass "
              f"up to a fill of {CUDA_MAX_FILL['fused_moments']}), "
              f"compacted_blocks {ctx.run_info['compacted_blocks']}")
        if comp is None or comp["support"].size != 45:
            failures.append(f"7a did not plan 45 support blocks: "
                            f"{ctx.run_info}")
            comp = None
        elif ctx.run_info["compacted_blocks"] != (
                45 if sp_compacted else None):
            failures.append(f"7a compacted_blocks "
                            f"{ctx.run_info['compacted_blocks']}, the "
                            f"plan used: {sp_compacted}")
        if sp_launches != n_blocks:
            failures.append(f"7a launched fused_moments {sp_launches} "
                            f"times, expected {n_blocks} (one per block "
                            f"for its 17 mask rows)")
        t0 = time.perf_counter()
        proj = projections64(data, sparse_stack(lt).reshape(17, -1),
                             np.arange(int(np.prod(NAV))))
        print(f"oracle 7a: {time.perf_counter() - t0:.1f} s (float64 numpy)")
        check_results("7a", res, {
            (0, "intensity"): proj[:, :1].reshape(NAV + (1,)),
            (1, "intensity"): proj[:, 1:].reshape(NAV + (16,)),
        }, failures)
        traced_run(ctx, ds, sparse_udfs(lt), at)

        def matmul_only(x, m, valid, compute_var):
            return x.float() @ m.T

        comp_t = None
        full_t = timed("u16 M=17 whole frame (7a)", u16_blocks,
                       torch.from_numpy(sparse_stack(lt).reshape(
                           17, -1).astype(np.float32)).to(dev),
                       depth, compute_var=False, lib=matmul_only)
        if comp is not None:
            n_sup = comp["support"].size
            support_t = torch.from_numpy(
                comp["support"].astype(np.int64)).to(dev)
            masks_c = torch.from_numpy(np.ascontiguousarray(
                comp["operand_c"].T)).to(dev)
            gathered = [gather_blocks(b, support_t) for b in u16_blocks]
            want_g = u16_blocks[0].cpu().numpy().reshape(
                depth, -1, 128)[:, comp["support"]].reshape(depth, -1)
            if not np.array_equal(gathered[0].cpu().numpy(), want_g):
                failures.append("7a gather is not the support blocks")
            label = f"u16 compacted M=17 P={n_sup}x128"
            _, e = checks[label] = case("compacted", gathered[0], depth,
                                        compute_var=False, masks=masks_c)
            kernel_max_err = max(kernel_max_err, e)
            print(f"  kernel fused_moments vs plain, {label}: max abs err "
                  f"{e:.3g}")
            g_ms, g_eager_ms = time_ms(
                gather_blocks, [(b, support_t) for b in u16_blocks])
            g_bound = 2 * depth * n_sup * 128 * 2 / HBM_BYTES_PER_S * 1e3
            print(f"gather of the support blocks: {g_ms:.4f} ms per block "
                  f"(one by one {g_eager_ms:.4f} ms), bound {g_bound:.4f} "
                  f"ms by bytes (read and write {n_sup} of "
                  f"{comp['n_blocks']} blocks) {at}")
            comp_t = timed(label, gathered, masks_c, depth,
                           compute_var=False, lib=matmul_only)
            comp_t["gather_ms"] = g_ms
        fill_sweep(u16_blocks, f32_blocks, depth, at)

        # (b) both engines in one read pass
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, mixed_udfs(lt))
        torch.cuda.synchronize()
        mix_s = time.perf_counter() - t0
        mix_launches = fused_moments.launches
        stats = dict(ctx.feed_stats)
        report("7b fused + host engine", mix_s, total_bytes, stats)
        check_engines("7b", ctx, [False, False, False, True], failures)
        if not ctx.run_info["fused"] or mix_launches != n_blocks:
            failures.append(f"7b: fused {ctx.run_info['fused']}, "
                            f"{mix_launches} launches, expected {n_blocks}")
        print(f"  7b host engine held each slot "
              f"{stats['host_s'] / stats['blocks'] * 1e3:.2f} ms on "
              f"average ({stats['blocks']} blocks) {at}")
        check_results("7b", res, {
            (0, "intensity"): want4[(2, "intensity")],
            **{(1, k): want4[(4, k)]
               for k in ("num_frames", "sum", "mean", "var", "std")},
            (2, "intensity"): want4[(0, "intensity")][..., :1],
        }, failures)
        frame_max = data.max(axis=(2, 3)).astype(np.float32)
        pixel_max = data.max(axis=(0, 1)).astype(np.float32)
        if not (np.array_equal(res[3]["frame_max"].data, frame_max)
                and np.array_equal(res[3]["pixel_max"].data, pixel_max)):
            failures.append("7b numpy UDF maxima are not exact")
        else:
            print("  7b result 3/frame_max, 3/pixel_max: exact")
        traced_run(ctx, ds, mixed_udfs(lt), at)

        # (c) generic, roi of half the scan: shifts, complex, hooks and
        # a small-support stack, compacted before its matmul
        aux_udfs = generic_aux_udfs(lt)
        fused_moments.launches = 0
        t0 = time.perf_counter()
        res = ctx.run_udf(ds, aux_udfs, roi=roi)
        torch.cuda.synchronize()
        aux_s = time.perf_counter() - t0
        aux_launches = fused_moments.launches
        report("7c generic + shifts + complex + hooks + spots, roi of "
               "half the scan", aux_s, n_sel * pixels * 2, ctx.feed_stats)
        check_engines("7c", ctx, [False] * 4, failures)
        if ctx.run_info["fused"] or aux_launches != 0:
            failures.append(f"7c: fused {ctx.run_info['fused']}, "
                            f"{aux_launches} launches, expected 0")
        spots = aux_udfs[3]
        spots_plan = spots.masks.get_compaction(SIG, np.float32)
        print(f"  7c spots: {spots_plan['support'].size} of "
              f"{spots_plan['n_blocks']} blocks, compacted: "
              f"{spots._compact_op is not None}")
        if (spots._compact_op is not None) != compaction_pays(
                spots_plan, dev, "matmul"):
            failures.append("7c: the spots' compaction does not follow "
                            "CUDA_MAX_FILL")
        t0 = time.perf_counter()
        want = oracle_generic_aux(lt, data, roi)
        print(f"oracle 7c: {time.perf_counter() - t0:.1f} s (float64 / "
              f"complex128 numpy)")
        check_results("7c", res, want, failures)
        traced_run(ctx, ds, generic_aux_udfs(lt), at, roi=roi)

        # -- 8. live partial results ------------------------------------------
        p8 = partial_results(ctx, ds, lt, data, want4, failures)
        if p8["launches"] != n_blocks:
            failures.append(f"8 launched fused_moments {p8['launches']} "
                            f"times, expected {n_blocks} blocks x 1 mask "
                            f"group")
        t0 = time.perf_counter()
        ctx.run_udf(ds, make_udfs(lt))
        torch.cuda.synchronize()
        print(f"8 wall: run_udf_iter with 4 partials and a patch "
              f"{p8['iter_s']:.3f} s, run_udf right after "
              f"{time.perf_counter() - t0:.3f} s, on the same scan {at}")

        # -- 9. the stage ablation --------------------------------------------
        p9 = stage_ablation(u16_blocks, masks_t, depth, dev, at, failures)

        # -- 10. the analyses -------------------------------------------------
        keep10 = {}
        p10 = analyses_phase(ctx, ds, lt, data, want4, tmp, at, failures,
                             keep10)

        # -- 11. the FFT UDFs and the dataset core ----------------------------
        p11 = slice9_phase(ctx, ds, lt, path, data, want4, res6a,
                           corrections, tmp, report, at, failures)

        # -- 12. the detector formats -----------------------------------------
        t0 = time.perf_counter()
        p12 = formats_phase(ctx, lt, data, tmp, at, failures)
        print(f"phase 12: {time.perf_counter() - t0:.1f} s")

        # -- 13. raw CSR, live, array-like, HDF5, the repaired API -------------
        t0 = time.perf_counter()
        p13 = slice11_phase(ctx, lt, path, data, want4, tmp, at, failures)
        print(f"phase 13: {time.perf_counter() - t0:.1f} s")

        # -- 14. executors, async, delayed, export, snooze, examples --------
        t0 = time.perf_counter()
        p14 = slice12_phase(lt, path, data, want4, n_blocks, tmp, at,
                            failures)
        print(f"phase 14: {time.perf_counter() - t0:.1f} s")

        # -- 15. the multi-device loop, several workers on the card ---------
        t0 = time.perf_counter()
        keep = {}
        p15 = slice13_phase(lt, path, data, want4, depth, n_blocks, at,
                            failures, keep)
        print(f"phase 15: {time.perf_counter() - t0:.1f} s")

        # -- 16. two processes on the card, over gloo ------------------------
        p16 = slice14_phase(keep, path, at, failures)

        # -- 17. the web GUI's path ------------------------------------------
        t0 = time.perf_counter()
        p17 = gui_phase(lt, path, data, keep10, p10, at, failures)
        print(f"phase 17: {time.perf_counter() - t0:.1f} s")

        # -- 18. the drop-in libertem namespace ------------------------------
        t0 = time.perf_counter()
        p18 = dropin_phase(path, arrays4, launches, at, failures)
        print(f"phase 18: {time.perf_counter() - t0:.1f} s")

        # -- 19. the reduced-precision modes ------------------------------
        t0 = time.perf_counter()
        sparse_t = torch.from_numpy(sparse_stack(lt).reshape(
            17, -1).astype(np.float32)).to(dev)
        p19 = precision_phase(
            ctx, ds, lt, data, arrays4, launches, result_arrays(res6a),
            corrections, n_blocks, depth, u16_blocks, f32_blocks,
            ring_masks_t, sparse_t, path, tmp, at, failures)
        print(f"phase 19: {time.perf_counter() - t0:.1f} s")

    print(f"phases 2-19: {time.perf_counter() - t_start:.1f} s (build "
          f"before them)")
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    cases.append(dict(
        case=f"f32 corrected M={n_ring_masks} (path 6a)",
        launches_per_2GiB_run=corr_launches, **corr_t,
    ))
    # the 7a run went through one of these two: the other is on no
    # path of this run and has no launch count
    cases.append(dict(
        case="u16 compacted M=17 P=45x128 (7a where compaction pays)",
        launches_per_2GiB_run=sp_launches if sp_compacted else None,
        **comp_t,
    ))
    cases.append(dict(
        case="u16 M=17 whole frame (7a where compaction does not pay)",
        launches_per_2GiB_run=None if sp_compacted else sp_launches,
        **full_t,
    ))
    # the one-pass mode (precision "default") of phase 19
    cases += [{k: v for k, v in c.items() if k != "path"}
              for c in p19["cases"]]
    print(json.dumps({"kernels": [dict(
        name="fused_moments",
        route="cuda",
        source="libertem_tpu_torch/csrc/fused_moments.cuh",
        replaces="libertem_tpu/ops/moments.py:135",
        launches=launches,
        max_abs_err=kernel_max_err,
        **main_t,
        checks={name: err for name, (_, err) in checks.items()},
        launches_by_path={
            "main (phase 4)": launches,
            "fused + corrections, M=12 (phase 6a)": corr_launches,
            "generic + roi (phase 6b)": gen_launches,
            "fused, sparse stack M=17 (phase 7a)": sp_launches,
            "fused + host engine (phase 7b)": mix_launches,
            "generic + shifts + complex + hooks + spots (phase 7c)":
                aux_launches,
            "partial results with a patch (phase 8)": p8["launches"],
            **p10,
            **p11,
            **p12,
            **p13,
            **p14,
            **p15,
            **p16,
            **p17,
            **p18,
            **p19["launches"],
        },
        cases=cases,
    ), dict(
        name="fused_moments_ablation",
        route="cuda",
        source="libertem_tpu_torch/csrc/fused_moments_ablation.cu",
        replaces="benchmarks/bench_kernel_ablation.py:48",
        launches=p9["launches"],
        max_abs_err=p9["max_abs_err"],
        # the top-level numbers: the ring alone at the main path's block
        **{k: v for k, v in p9["cases"][0].items() if k != "case"},
        launches_by_path={"stage ablation (phase 9)": p9["launches"]},
        cases=p9["cases"],
    )]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# -- other entry points: every card, and two checkouts end to end ----------


def time_paths_main(tree: str, scan: str) -> int:
    """``python3 chip_smoke.py --time-paths DIR SCAN``: imports
    ``libertem_tpu_torch`` from the checkout at DIR and prints one JSON
    line of wall seconds, each pass three times: the main path (the raw
    u16 scan at SCAN through ``Context().run_udf`` with phase 4's five
    UDFs), the same scan pushed by a producer thread into a live ring
    of 2048 frames (phase 13b), two and four workers on card 0
    (phase 15a; ``null`` where the checkout has no multi-device loop),
    and phase 13a's raw CSR scan (``EVT_NAV`` frames of ``EVT_SIG``,
    written beside SCAN in ``events/``) with phase 13a's five UDFs on
    one device and on four workers on card 0, each with its H2D bytes.
    SCAN and the events are written first when they are missing
    (:func:`write_dataset`, :func:`write_events`).  To compare two
    checkouts, run it for each in turns on one card (A, B, B, A)."""
    label, tree = tree, os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import libertem_tpu_torch as lt
    from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
    from libertem_tpu_torch.io.dataset.live import LiveDataSet

    if not lt.__file__.startswith(tree):
        raise RuntimeError(f"imported {lt.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    if not os.path.exists(scan):
        write_dataset(scan)
    n = int(np.prod(NAV))
    raw = np.memmap(scan, dtype=np.uint16, mode="r", shape=(n,) + SIG)

    def load(ctx):
        return ctx.load("raw", path=scan, dtype="uint16", nav_shape=NAV,
                        sig_shape=SIG)

    def timed(ctx, ds):
        t0 = time.perf_counter()
        ctx.run_udf(ds, make_udfs(lt))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def live(ctx):
        ds = LiveDataSet(nav_shape=NAV, sig_shape=SIG,
                         dtype=np.uint16, ring_capacity=2048,
                         num_partitions=4).initialize()

        def push():
            for lo in range(0, n, 1024):
                ds.push_frames(raw[lo:lo + 1024])
            ds.finish()

        t = threading.Thread(target=push, daemon=True)
        t.start()
        secs = timed(ctx, ds)
        t.join(60)
        return secs

    card = torch.device("cuda", 0)
    ctx = lt.Context()
    ds = load(ctx)
    timed(ctx, ds)  # builds the kernel, warms the page cache
    res = {"tree": label,
           "main": [timed(ctx, ds) for _ in range(3)],
           "live": [live(ctx) for _ in range(3)]}
    for n_dev in (2, 4):
        wctx = lt.Context(executor=ShardedJobExecutor(
            devices=[card] * n_dev))
        wds = load(wctx)
        try:
            res[f"{n_dev} workers"] = [timed(wctx, wds) for _ in range(3)]
        except NotImplementedError:
            res[f"{n_dev} workers"] = None
    events = os.path.join(os.path.dirname(os.path.abspath(scan)), "events")
    toml = os.path.join(events, "events.toml")
    if not os.path.exists(toml):
        os.makedirs(events, exist_ok=True)
        write_events(events, EVT_NAV, EVT_SIG)
    for key, cctx in (
            ("csr main", ctx),
            ("csr 4 workers", lt.Context(executor=ShardedJobExecutor(
                devices=[card] * 4)))):
        cds = cctx.load("raw_csr", path=toml)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            cctx.run_udf(cds, format_udfs(lt, EVT_SIG)[0])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        res[key] = secs
        res[key + " h2d_bytes"] = cctx.feed_stats["h2d_bytes"]
    print(json.dumps(res), flush=True)
    return 0


def every_card_main() -> int:
    """``python3 chip_smoke.py --every-card``: the multi-device loop over
    every CUDA card of a host with two or more (it exits non-zero on
    one), in one process, on phase 2's 2 GiB scan, each pass with the
    launch count set to 0 just before and read just after, printing its
    wall time, GB/s, each worker's reader share and its launches:

    1. the main path (phase 4's five UDFs), one worker a card (the
       first pass carries each card's CUDA start-up), two workers a
       card, and one worker a card again, against phase 4's float64
       answers, 64 launches each;
    2. phase 6a's corrections (M = 12) over a roi of every third frame,
       against the float64 answers of those frames;
    3. the generic path over a roi of half the scan (phase 6b's
       Logsum, FEM and Sum) and phase 7c's aux shifts, complex masks,
       hooks and compacted spots, against their float64 (complex128)
       answers: every card reads its own copy of the aux rows and mask
       stacks;
    4. phase 7b's numpy UDF beside the fused pass, its maxima exact;
    5. ``run_udf_iter`` with phase 8's patch after the second partial,
       against the patched float64 answers;
    6. phase 16 over NCCL, a process a card (:func:`slice14_phase`):
       one and two workers a process, passes 2 and 5 with one, and the
       numpy UDF refused; each process's results against the float64
       answers and bit for bit against passes 1, 2 and 5 at the same
       global worker count, the launches of the processes adding up to
       theirs.

    Every worker's sig and single state crosses to card 0 for the
    fold, and its nav rows to the host (in step 6 each process folds
    on its own card the states gathered over NCCL).  The last lines are the passes'
    JSON summary, the first card's name and power limit, and ``{"ok":
    true, "device": {...}}``."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --every-card: needs two or more CUDA cards",
              file=sys.stderr)
        return 1
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
    from libertem_tpu_torch.ops import build
    from libertem_tpu_torch.ops.moments import LIBRARIES, fused_moments

    torch.backends.cuda.matmul.allow_tf32 = False
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    card = card_line()
    at = f"[{len(cards)} x {card}]"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout)
    t0 = time.perf_counter()
    build.build(LIBRARIES)
    print(f"build: {time.perf_counter() - t0:.1f} s; {len(cards)} cards")
    failures, rows = [], []
    h, w = SIG
    n = int(np.prod(NAV))

    def counted(fn):
        fused_moments.launches = 0
        t0 = time.perf_counter()
        out = fn()
        for c in cards:
            torch.cuda.synchronize(c)
        return out, time.perf_counter() - t0, fused_moments.launches

    def row(label, ctx, secs, count, want_launches, size):
        st = ctx.feed_stats
        shares = [wk["read_s"] / secs for wk in st["workers"]]
        rows.append(dict(path=label, wall_s=secs, gbps=size / secs / 1e9,
                         workers=len(shares), reader_shares=shares,
                         consumer_wait_share=st["wait_s"] / secs,
                         launches=count))
        print(f"{label}: {secs:.3f} s wall, {size / secs / 1e9:.2f} GB/s; "
              f"readers {', '.join(f'{s:.0%}' for s in shares)} of the "
              f"wall; fused_moments launches {count} {at}")
        if want_launches is not None and count != want_launches:
            failures.append(f"{label}: {count} launches, expected "
                            f"{want_launches}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scan.raw")
        data = write_dataset(path)
        bf_adf = np.stack([lt.masks.circular(64, 64, w, h, 16),
                           lt.masks.ring(64, 64, w, h, 60, 40)])
        want4 = oracle(data, bf_adf, nav=NAV)
        ctx = lt.Context(executor=ShardedJobExecutor(devices=cards))
        ds = ctx.load("raw", path=path, dtype="uint16", nav_shape=NAV,
                      sig_shape=SIG)
        print(f"devices {[str(d) for d in ctx.executor.devices]}, "
              f"{ds.get_num_partitions()} partitions")

        # -- 1. the main path, one and two workers a card -----------------
        two = lt.Context(executor=ShardedJobExecutor(
            devices=[d for d in cards for _ in (0, 1)]))
        keep = {}
        for label, c, per_card in (
                ("1 main path, a worker a card (with each card's start-up)",
                 ctx, 1),
                ("1 main path, two workers a card", two, 2),
                ("1 main path, a worker a card", ctx, 1)):
            res, secs, count = counted(lambda: c.run_udf(ds, make_udfs(lt)))
            row(label, c, secs, count, n // 1024, data.nbytes)
            check_results(label, res, want4, failures)
            keep[f"16a {per_card} a process"] = dict(
                arrays=result_arrays(res), launches=count, want=want4)
        traced_run(ctx, ds, make_udfs(lt), at)

        # -- 2. corrections over a roi of every third frame ----------------
        corrections = make_corrections(lt)
        roi = np.zeros(n, dtype=bool)
        roi[::3] = True
        ids = np.flatnonzero(roi)
        res, secs, count = counted(lambda: ctx.run_udf(
            ds, make_ring_udfs(lt), roi=roi.reshape(NAV),
            corrections=corrections))
        row("2 corrections, M=12, every third frame", ctx, secs, count,
            sum(len(s) for s in shard_steps(
                len(ids), len(cards), 1024)), len(ids) * h * w * 2)
        flat = data.reshape(n, -1)
        want2 = oracle_at(
            lambda lo, hi: flat[ids[lo:hi]], len(ids), SIG,
            (len(ids) // 2, 2), ring_stack(lt), (64, 64), 32,
            corrections.make_plan(SIG))
        check_roi("2", res, want2, failures)
        keep["16b"] = dict(arrays=result_arrays(res), launches=count,
                           want=want2)

        # -- 3. the generic path over half the scan ---------------------------
        half = np.zeros(NAV, dtype=bool)
        half[:, :NAV[1] // 2] = True
        for label, udfs, want in (
                ("3 generic: Logsum, FEM, Sum", generic_udfs,
                 lambda: oracle_generic(data, half)),
                ("3 generic: aux shifts, complex masks, hooks, spots",
                 generic_aux_udfs,
                 lambda: oracle_generic_aux(lt, data, half))):
            res, secs, count = counted(lambda: ctx.run_udf(
                ds, udfs(lt), roi=half))
            row(label, ctx, secs, count, 0, data.nbytes // 2)
            check_results(label, res, want(), failures)

        # -- 4. a numpy UDF beside the fused pass -----------------------------
        res, secs, count = counted(lambda: ctx.run_udf(ds, mixed_udfs(lt)))
        row("4 fused + host engine", ctx, secs, count, n // 1024,
            data.nbytes)
        check_results("4", res, {
            (0, "intensity"): want4[(2, "intensity")],
            (2, "intensity"): want4[(0, "intensity")][..., :1],
        }, failures)
        if not (np.array_equal(res[3]["frame_max"].data,
                               data.max(axis=(2, 3)).astype(np.float32))
                and np.array_equal(res[3]["pixel_max"].data,
                                   data.max(axis=(0, 1)).astype(np.float32))):
            failures.append("4: the numpy UDF's maxima are not exact")

        # -- 5. run_udf_iter with a patch after the second partial --------
        new_masks = np.stack([lt.masks.circular(64, 64, w, h, 16),
                              lt.masks.ring(64, 64, w, h, 30, 10)])

        damages = []

        def iterate():
            gen = ctx.run_udf_iter(ds, make_udfs(lt))
            last = None
            for i, last in enumerate(gen):
                damages.append(int(np.count_nonzero(last.damage.data)))
                if i == 1:
                    gen.update_parameters_experimental([
                        {"mask_factories": [lambda m=m: m
                                            for m in new_masks]},
                        {}, {}, {}, {}])
            return last

        final, secs, count = counted(iterate)
        row("5 run_udf_iter, patch after the second partial", ctx, secs,
            count, n // 1024, data.nbytes)
        old = np.zeros(n, dtype=bool)
        for steps in shard_steps(n, len(cards), 1024):
            for lo, hi in steps[:2]:
                old[lo:hi] = True
        patched = want4[(0, "intensity")].reshape(n, 2).copy()
        patched[~old] = projections64(data, new_masks.reshape(2, -1),
                                         np.flatnonzero(~old))
        want5 = {(0, "intensity"): patched.reshape(NAV + (2,)),
                 **{k: v for k, v in want4.items() if k[0] != 0}}
        check_results("5", [final.buffers[ui] for ui in range(5)], want5,
                      failures)
        keep["16c"] = dict(arrays=result_arrays(final.buffers),
                           launches=count, want=want5, damages=damages)
        print("every card summary: " + json.dumps(rows))

        # -- 6. phase 16 over NCCL: a process a card -----------------------
        slice14_phase(keep, path, at, failures, backend="nccl",
                      devices=[str(c) for c in cards])

    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0



if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"] and len(sys.argv) == 3:
        sys.exit(rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dropin-child"] and len(sys.argv) == 3:
        sys.exit(dropin_child_main(sys.argv[2]))
    if sys.argv[1:2] == ["--reader-child"] and len(sys.argv) == 3:
        sys.exit(reader_child_main(sys.argv[2]))
    if sys.argv[1:2] == ["--every-card"]:
        sys.exit(every_card_main())
    if sys.argv[1:2] == ["--time-paths"] and len(sys.argv) == 4:
        sys.exit(time_paths_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
