"""``sampler_self_ms``: host ms a sampler iteration spends in the sampler's
own eager work: the self time (less every child span: the draws, the
objective, the I/O) of the program's spans ``campaign.segment``,
``mh.step``, ``mh.adapt_cov`` and ``mh.finish``, over the window's
iterations. Timed window."""

from h100_bench.metrics._program import per_iteration_ms, spans

SPANS = ("campaign.segment", "mh.step", "mh.adapt_cov", "mh.finish")


def read(rec):
    sp = spans(rec)
    if not sp or "mh.step" not in sp:
        return None
    return per_iteration_ms(rec, sum(sp[n]["self_s"] for n in SPANS if n in sp))
