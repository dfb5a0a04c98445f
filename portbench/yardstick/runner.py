"""One run of a cell.

Set-up: the inputs from the seed on the card, the program's Context
and dataset from the cell's traffic and source, and two passes of the
cell's own UDFs (the first timed on its own, the second under the
profiler, so that its first session starts before the window).  Then
the window, under ``torch.profiler`` in every run: passes of
``Context.run_udf`` back to back, one client, each timed from the call
until every result buffer is a host numpy array, the next started only
when the last has returned, for ``seconds``.  With ``trace``, three
passes more with the program's per-stage timings on, and the link and
memory probes.  Then, with the program's state freed, the reference
over the same inputs, compared with the results of the window's last
pass.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from . import cells, compare, data, probes, trace as tracing

WINDOW = "portbench.traced"
STATS_PASSES = 3
PRECISION_ENV = "LIBERTEM_TPU_TORCH_MATMUL_PRECISION"
STATS_ENV = "LIBERTEM_TPU_SHARDED_STATS"


class NoCard(Exception):
    """The cell's cards are not there."""


@dataclass
class Record:
    """What a run saw; the metric readers read it."""
    cell: cells.Cell
    pass_bytes: int
    frames: int
    kernel_itemsize: int
    setup_s: float = math.nan
    first_pass_s: float = math.nan
    spans: list = field(default_factory=list)
    feeds: list = field(default_factory=list)
    sharded: list = field(default_factory=list)
    trace: Optional[tracing.Summary] = None
    traced_passes: int = 0
    traced_launches: int = 0


def check_cards(cell: cells.Cell) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < len(cell.cards) or max(cell.cards) >= have:
        raise NoCard(f"the cell uses cards {cell.cards}, "
                     f"{have} visible")


def make_context(lt, cell: cells.Cell, device_type: str):
    """The traffic's executor on the cell's cards; on the CPU (the
    tests) as many CPU workers."""
    if device_type == "cuda":
        return lt.Context.make_with(cell.traffic["executor"],
                                    tpus=cell.devices)
    from libertem_tpu_torch.executor.sharded import ShardedJobExecutor
    return lt.Context(executor=ShardedJobExecutor(
        devices=["cpu"] * len(cell.devices)))


def one_pass(ctx, ds, udfs, corrections, groups) -> dict:
    """One ``run_udf`` pass; ``{group: {buffer: host array}}``."""
    res = ctx.run_udf(ds, udfs, corrections=corrections)
    return {g: {n: np.asarray(b.data) for n, b in r.items()}
            for g, r in zip(groups, res)}


def _sync(cards, device_type: str = "cuda") -> None:
    import torch

    if device_type != "cuda":
        return
    for c in cards:
        torch.cuda.synchronize(c)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, root: Path = cells.ROOT,
        device_type: str = "cuda", log=print) -> tuple:
    """``(result, checks, notes)``: the result line's object, the
    numbers compared ``(name, value, limit, held)``, and what is kept
    in the run's output file.  Raises :class:`NoCard` before any work
    where the cell's cards are missing."""
    cell = cells.load_cell(cell_name, root)
    wanted = cells.cell_metrics(cell.name, trace, root)
    config = cell.config
    if device_type == "cuda":
        check_cards(cell)
    os.environ[PRECISION_ENV] = config["matmul_precision"]
    os.environ.pop(STATS_ENV, None)
    # where set-up's time goes: seconds from the process's start at the
    # end of each of its steps (in the run's output file)
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_start

    import torch
    import libertem_tpu_torch as lt
    from libertem_tpu_torch.ops.moments import fused_moments
    mark("imports")

    cards = cell.cards
    main = f"cuda:{cards[0]}" if device_type == "cuda" else "cpu"
    inputs = data.make_inputs(config, seed, main)
    mark("inputs")
    udfset = cells.load_module("udfsets", config["udfset"], root)
    groups, udfs, corrections = udfset.build(lt, config, inputs)
    ctx = make_context(lt, cell, device_type)
    source = cells.load_module("sources", cell.traffic["source"], root)
    ds = source.open_dataset(lt, ctx, inputs, config)
    if device_type == "cuda":
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
    itemsize = 4 if corrections is not None else inputs.frames.itemsize
    rec = Record(cell=cell, pass_bytes=inputs.nbytes,
                 frames=int(np.prod(config["nav"])),
                 kernel_itemsize=itemsize)

    def passes():
        return one_pass(ctx, ds, udfs, corrections, groups)

    mark("context_and_dataset")
    t0 = time.perf_counter()
    passes()
    rec.first_pass_s = time.perf_counter() - t0
    mark("first_pass")
    with _profiler(device_type):
        passes()
    gc.collect()
    rec.setup_s = time.perf_counter() - t_start
    mark("second_pass")

    attempted = failed = 0
    last = None
    smi = probes.SmiSampler() if trace and device_type == "cuda" else None
    if smi is not None:
        smi.__enter__()
    launches = fused_moments.launches
    try:
        with _profiler(device_type) as prof:
            with _annotate(WINDOW):
                _sync(cards, device_type)
                end = time.perf_counter() + seconds
                while True:
                    t0 = time.perf_counter()
                    if attempted and t0 >= end:
                        break
                    attempted += 1
                    try:
                        out = passes()
                    except Exception:
                        failed += 1
                        if failed == 1:
                            traceback.print_exc()
                        continue
                    t1 = time.perf_counter()
                    rec.spans.append((t0, t1))
                    rec.feeds.append(copy.deepcopy(ctx.feed_stats))
                    last = out
                _sync(cards, device_type)
    finally:
        if smi is not None:
            smi.__exit__(None, None, None)
    rec.traced_passes = len(rec.spans)
    rec.traced_launches = fused_moments.launches - launches
    peak = (max(torch.cuda.max_memory_allocated(c) for c in cards)
            if device_type == "cuda" else 0)

    notes = {"cell": cell.name, "seed": seed, "trace": trace,
             "setup_s": rec.setup_s, "first_pass_s": rec.first_pass_s,
             "setup_marks_s": marks,
             "pass_s": [b - a for a, b in rec.spans]}
    t0 = time.perf_counter()
    rec.trace = _summarize(prof, rec.cell.name, seed, cards)
    del prof
    notes["trace_read_s"] = time.perf_counter() - t0
    if trace and device_type == "cuda":
        _stats_passes(rec, ctx, passes)
        notes["probes"] = probes.link_and_hbm(main)
        notes["smi"] = smi.rows
        notes["sharded_stats"] = rec.sharded
        log(f"probes on card {cards[0]}: {json.dumps(notes['probes'])}")
        for row in smi.rows:
            log(f"nvidia-smi during the window: {row}")

    ctx.close()
    del ctx, ds, udfs, corrections
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()

    reference = cells.load_module("reference", config["udfset"], root)
    want = reference.expected(config, inputs, "float64", main)
    errors = (compare.group_errors(last, want, reference.SCALES)
              if last is not None
              else {g: math.inf for g in want})
    checks = compare.checks(errors, config["limits"])
    correct = (last is not None and failed == 0
               and all(held for *_, held in checks))

    metrics = {}
    for name, unit in wanted.items():
        # a reader that fails, or finds nothing to read, leaves its own
        # metric out of the line and nothing else
        try:
            value = cells.load_module("metrics", name, root).read(rec)
        except Exception:
            print(f"portbench: metric {name} not read:", file=sys.stderr)
            traceback.print_exc()
            continue
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device = {"platform": "gpu" if device_type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cards[0])
                       if device_type == "cuda" else "cpu"),
              "count": len(cards), "memory_peak_bytes": int(peak)}
    if device_type == "cuda":
        device["power_limit_w"] = probes.power_limit_w(cards[0])
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        t = rec.trace
        device["busy_s"] = sum(t.busy_s.values()) / len(t.busy_s)
        device["window_s"] = t.window_s

        def top(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        result["breakdown"] = {"device_ops": top(t.op_s),
                               "idle_gaps": top(t.idle_by_host)}
    # a number that could not be read (a buffer missing on one side)
    # is null here and "inf" on standard error
    result["checks"] = {
        name: {"value": value if math.isfinite(value) else None,
               "limit": limit}
        for name, value, limit, _ in checks}
    notes["result"] = result
    return result, checks, notes


def _profiler(device_type: str):
    """``torch.profiler`` over the host's operations and, on the card,
    the device's kernels, copies and memsets."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _annotate(name: str):
    from torch.profiler import record_function

    return record_function(name)


def _summarize(prof, cell: str, seed: int, cards) -> tracing.Summary:
    """The window's :class:`~yardstick.trace.Summary` from the
    profiler's Chrome trace (written to ``$TMPDIR``, read, deleted)."""
    out_dir = Path(tempfile.gettempdir()) / "portbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace-{cell}-{seed}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    return tracing.summarize(events, WINDOW, cards)


def _stats_passes(rec, ctx, passes) -> None:
    """The program's per-stage timings over a few passes after the
    window (they synchronise each stage, so they stay out of it)."""
    made = []
    runner = ctx._runner

    def keep(*args, **kwargs):
        made.append(runner(*args, **kwargs))
        return made[-1]

    os.environ[STATS_ENV] = "1"
    ctx._runner = keep
    try:
        for _ in range(STATS_PASSES):
            passes()
            if made[-1].last_sharded_stats is not None:
                rec.sharded.append(dict(made[-1].last_sharded_stats))
    finally:
        del ctx._runner
        os.environ.pop(STATS_ENV, None)
