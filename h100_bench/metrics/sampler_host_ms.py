"""``sampler_host_ms``: host ms a sampler iteration spends outside the
objective and campaign I/O spans (the sampler's own eager work, waits for
the card included). Timed window."""

from h100_bench.metrics._lib import span


def read(rec):
    t = rec.timed
    if not t.iterations:
        return None
    inside = span(t, "objective")[0] + span(t, "campaign_io")[0]
    return 1e3 * (t.seconds - inside) / t.iterations
