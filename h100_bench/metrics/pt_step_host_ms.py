"""``pt_step_host_ms``: host ms a sampler iteration spends in the program's
span ``pt.step`` less its child spans (the objective's): the tempered step's
own eager work (the per-rung proposal, the reflection, the tempered accept,
the MAP records and the scales; waits for the card included). Timed window
of a traced run; None where the program has no such span."""

from h100_bench.metrics._program import per_iteration_ms, spans


def read(rec):
    s = (spans(rec) or {}).get("pt.step")
    return None if s is None else per_iteration_ms(rec, s["self_s"])
