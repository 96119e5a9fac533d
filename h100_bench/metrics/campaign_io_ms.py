"""``campaign_io_ms``: host ms a segment spends after its samples reached
the host (a synchronising copy) until the next segment starts: the
checkpoint's write (``save_mh_state``). Timed window."""

from h100_bench.metrics._lib import span


def read(rec):
    seconds, count = span(rec.timed, "campaign_io")
    return 1e3 * seconds / count if count else None
