"""``libertem-tpu-torch-server``: the port's web GUI server
(counterpart of ``libertem_tpu/web/cli.py``, with the same flags:
port, host, browser, token file, preload, open-ds, cpus spec, snooze
timeout).  Run as ``python -m libertem_tpu_torch.web.cli --port
9009``; a GUI "local" connection runs the jobs on every visible CUDA
card.
"""
from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="libertem_tpu_torch web API server"
    )
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--browser", dest="browser",
                        action="store_true", default=False,
                        help="open a browser after startup")
    parser.add_argument("--no-browser", dest="browser",
                        action="store_false",
                        help="don't open a browser (default)")
    parser.add_argument("--token-path", default=None,
                        help="file containing the auth token")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--local-directory", default=None,
                        help="scratch directory")
    parser.add_argument("--snooze-timeout", type=float, default=None,
                        help="idle seconds before releasing caches")
    parser.add_argument("--open-ds", default=None,
                        help="dataset path to open in the GUI")
    parser.add_argument("--cpus", type=int, default=None,
                        help="pre-create a local executor with this "
                             "many workers")
    parser.add_argument(
        "--preload", action="append", default=[],
        help="module(s) to import before starting",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="[%(asctime)s] %(levelname)s "
               "[%(name)s.%(funcName)s:%(lineno)d] %(message)s",
    )
    from ..common.tracing import maybe_setup_tracing
    from ..preload import do_preloads, preload_modules
    maybe_setup_tracing("libertem-tpu-torch-server")
    do_preloads()  # LIBERTEM_TPU_TORCH_PRELOAD env hook
    preload_modules(args.preload)
    token = None
    if args.token_path:
        with open(args.token_path) as f:
            token = f.read().strip()
    executor_spec = None
    if args.cpus is not None:
        executor_spec = {"cpus": args.cpus, "cudas": 0}
    from .server import run_server
    try:
        run_server(
            host=args.host, port=args.port, token=token,
            browser=args.browser, executor_spec=executor_spec,
            snooze_timeout=args.snooze_timeout,
            local_directory=args.local_directory,
            preload=tuple(args.preload), open_ds=args.open_ds,
        )
    except KeyboardInterrupt:
        # ctrl+c: exit cleanly
        sys.exit(0)


if __name__ == "__main__":
    main()
