#!/usr/bin/env python3
"""Time the fused-moments kernel of the port in one checkout.

    python3 time_fused_moments.py DIR

imports ``libertem_tpu_torch`` from the checkout at DIR and prints one
JSON line: device ms per call of ``fused_moments`` at the block shapes
of ``chip_smoke.py`` phase 5 (D = 1024, u16 with 6, 12, 40 and 17 mask
rows, a float32 block of large mean with 12, and the 45-block gathered
width P = 5760 with 17), each from a CUDA graph of 32 calls over
distinct blocks (more bytes than the L2), replayed 8 times.  To compare
two checkouts, run it for each in turns on one card (A, B, B, A, ...).
Needs a CUDA card.
"""
import json
import os
import sys

import numpy as np
import torch


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import libertem_tpu_torch.ops.moments as mm

    if not mm.__file__.startswith(tree):
        raise RuntimeError(f"imported {mm.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def blocks(pixels, dtype=np.uint16, n=4):
        out = []
        for i in range(n):
            rng = np.random.default_rng(100 + i)
            if dtype == np.float32:
                x = ((rng.poisson(1000.0, (1024, pixels)) - 100.0) * 1.1)
            else:
                x = rng.poisson(8.0, (1024, pixels))
            out.append(torch.from_numpy(x.astype(dtype)).to(dev))
        return out

    def time_ms(fn, inputs, calls=32, replays=8):
        for b in inputs:
            fn(b)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(calls):
                fn(inputs[i % len(inputs)])
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls / replays

    rng = np.random.default_rng(7)
    u16, f32 = blocks(16384), blocks(16384, np.float32)
    narrow = blocks(5760, n=8)
    res = {}
    for label, bl, n_masks, var in (
        ("u16 M=6", u16, 6, True), ("u16 M=12", u16, 12, True),
        ("u16 M=40", u16, 40, True), ("f32 M=12", f32, 12, True),
        ("u16 M=17", u16, 17, False), ("u16 M=17 P=5760", narrow, 17, False),
    ):
        masks = torch.from_numpy(rng.normal(
            size=(n_masks, bl[0].shape[1])).astype(np.float32)).to(dev)
        res[label] = time_ms(
            lambda x: mm.fused_moments(x, masks, 1024, compute_var=var), bl)
    print(json.dumps({"tree": sys.argv[1], **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
