"""Set-up: from the start of the process until the window's first pass
begins: imports, the inputs from the seed, the Context and dataset,
and the two warm-up passes (in a fresh checkout, the build of the
kernels too)."""


def read(rec):
    return rec.setup_s
