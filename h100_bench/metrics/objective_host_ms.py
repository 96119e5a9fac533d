"""``objective_host_ms``: host ms an objective call takes inside the
benchmark's span around the callable handed to the runner (K1's
log-likelihood with its prep). Timed window."""

from h100_bench.metrics._lib import span


def read(rec):
    seconds, count = span(rec.timed, "objective")
    return 1e3 * seconds / count if count else None
