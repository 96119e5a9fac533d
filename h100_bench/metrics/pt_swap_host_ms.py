"""``pt_swap_host_ms``: host ms a sampler iteration spends in the program's
span ``pt.swap``: the even-odd swap sweep (the exchange of ``(x, logp)``
rows between rungs, the counters, the swap-probability EMA). Timed window
of a traced run; None where the program has no such span."""

from h100_bench.metrics._program import per_iteration_ms, spans


def read(rec):
    s = (spans(rec) or {}).get("pt.swap")
    return None if s is None else per_iteration_ms(rec, s["total_s"])
