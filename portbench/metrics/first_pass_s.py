"""The first pass of a fresh process (the set-up's first, host clock):
the engine's first call, with the program's lazy imports and probes."""


def read(rec):
    return rec.first_pass_s
