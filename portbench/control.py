"""The readings that a cell's limits are set from, on the card at the
cell's own size; the benchmark's runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--program-default] [--controls tf32,bf16]

For each seed, in one process: the inputs, one pass of the program as
the configuration states it (the lower readings), with
``--program-default`` one more pass under the program's own one-TF32-
pass mode (``LIBERTEM_TPU_TORCH_MATMUL_PRECISION=default``), and the
reference computed in each lower precision of ``--controls`` put in the
program's place (the upper readings); each compared with the float64
reference as a run compares, one JSON line each.  ``--config <name>``
in place of ``--workload`` reads the reference's controls alone, on
card 0 (a configuration whose cell needs more cards than the call
has).
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from yardstick import cells, compare, data, runner  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload")
    which.add_argument("--config")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-default", action="store_true")
    ap.add_argument("--controls", default="tf32,bf16")
    args = ap.parse_args(argv)
    import torch

    if args.workload:
        cell = cells.load_cell(args.workload)
        runner.check_cards(cell)
        config = cell.config
        main_dev = f"cuda:{cell.cards[0]}"
    else:
        cell = None
        config = cells.load_json("configs", args.config)
        if not torch.cuda.is_available():
            raise SystemExit("no card")
        main_dev = "cuda:0"
    reference = cells.load_module("reference", config["udfset"])
    controls = [c for c in args.controls.split(",") if c]

    def emit(seed, mode, got, want, seconds):
        errors = compare.group_errors(got, want, reference.SCALES)
        checks = compare.checks(errors, config["limits"])
        print(json.dumps({
            "seed": seed, "mode": mode, "seconds": round(seconds, 3),
            "errors": errors,
            "held": all(h for *_, h in checks)}), flush=True)

    import libertem_tpu_torch as lt

    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = data.make_inputs(config, seed, main_dev)
        want = reference.expected(config, inputs, "float64", main_dev)
        if cell is not None:
            udfset = cells.load_module("udfsets", config["udfset"])
            groups, udfs, corrections = udfset.build(lt, config, inputs)
            ctx = runner.make_context(lt, cell, "cuda")
            source = cells.load_module("sources", cell.traffic["source"])
            ds = source.open_dataset(lt, ctx, inputs, config)
            modes = [config["matmul_precision"]]
            if args.program_default:
                modes.append("default")
            for mode in modes:
                os.environ[runner.PRECISION_ENV] = mode
                t0 = time.perf_counter()
                got = runner.one_pass(ctx, ds, udfs, corrections, groups)
                emit(seed, f"program:{mode}", got, want,
                     time.perf_counter() - t0)
            ctx.close()
            del ctx, ds, udfs
            torch.cuda.empty_cache()
        for control in controls:
            t0 = time.perf_counter()
            got = reference.expected(config, inputs, control, main_dev)
            emit(seed, f"reference:{control}", got, want,
                 time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
