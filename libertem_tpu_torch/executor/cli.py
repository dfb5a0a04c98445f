"""The ``libertem-worker`` entry point's counterpart: the port has no
worker processes to start, so it says what to do instead.

    python -m libertem_tpu_torch.executor.cli
"""
import sys


def main(argv=None):
    sys.stderr.write(
        "libertem_tpu_torch has no separate worker processes: one\n"
        "process drives the local CUDA devices. Use\n"
        "Context.make_with('sharded') (every card) or\n"
        "Context.make_with('inline') (one) in your script.\n"
    )
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
