"""``draws_per_s``: chains x sampler iterations completed in the timed
window over its wall time (host clock, from a synchronize to a
synchronize)."""


def read(rec):
    return rec.chains * rec.timed.iterations / rec.timed.seconds
