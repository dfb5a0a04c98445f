"""The benchmark of libertem_tpu_torch on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell (``portbench/workloads/<cell>.json``) from the root of a
checkout: set-up, ``--seconds`` of passes back to back, the comparison
with the plain reference, and as the last line of standard output one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; last ``checks``, each
number compared with its limit).  The same numbers end standard error.
It exits 3, printing no result, where the cell's cards are missing,
and 4 where JAX or the JAX package was loaded.  Each run keeps what it
saw in ``$TMPDIR/portbench/<cell>-<seed>-trace<0|1>.json``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# the program's kernel caches stay inside the checkout, at fixed paths
# (its own nvcc libraries go to CHECKOUT/build already)
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" /
                                         "torch_extensions")
sys.path[:0] = [str(HERE), str(CHECKOUT)]

from yardstick import guard, runner  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, checks, notes = runner.run(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=T_START)
    except runner.NoCard as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 3
    found = guard.loaded_forbidden()
    if found:
        print(f"portbench: no result: loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    out_dir = Path(tempfile.gettempdir()) / "portbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{args.workload}-{args.seed}-trace{args.trace}.json"
    out.write_text(json.dumps(notes, indent=1, default=str))
    print(f"portbench: kept {out}")
    sys.stdout.flush()
    for name, value, limit, held in checks:
        print(f"check {name}: {value!r} limit {limit!r} "
              f"{'held' if held else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
