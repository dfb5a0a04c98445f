"""The engine's time a super-step (every worker's fused step, waited
for): ``last_sharded_stats`` ``step_s / n_steps`` over the passes run
with the program's per-stage timings on."""


def read(rec):
    steps = sum(s["n_steps"] for s in rec.sharded)
    if not steps:
        return None
    return sum(s["step_s"] for s in rec.sharded) / steps * 1e3
