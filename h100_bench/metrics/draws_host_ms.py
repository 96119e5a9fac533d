"""``draws_host_ms``: host ms a sampler iteration spends making its draws:
the program's span ``mh.draws`` (the draw source's ``step``, and
``partners`` for DE) over the window's iterations. Timed window."""

from h100_bench.metrics._program import per_iteration_ms, spans


def read(rec):
    s = (spans(rec) or {}).get("mh.draws")
    return per_iteration_ms(rec, s["total_s"]) if s else None
