"""The multi-device loop's fold of the workers' states and the wrap of
the results, a pass: ``last_sharded_stats`` ``fold_s + wrap_s`` of the
passes run with the program's per-stage timings on."""


def read(rec):
    if not rec.sharded:
        return None
    total = sum(s["fold_s"] + s["wrap_s"] for s in rec.sharded)
    return total / len(rec.sharded) * 1e3
