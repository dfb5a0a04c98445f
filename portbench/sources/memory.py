"""The ``memory`` source: the inputs' host array as the program's
in-memory dataset (``Context.load("memory", ...)``), read by the
program's own readers into its pinned slots."""
from __future__ import annotations


def open_dataset(lt, ctx, inputs, config):
    return ctx.load("memory", data=inputs.frames,
                    sig_dims=len(config["sig"]))
