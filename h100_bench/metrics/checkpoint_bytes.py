"""``checkpoint_bytes``: bytes a campaign segment's checkpoint file holds:
the program's counter ``checkpoint.bytes`` (each file's size as written)
over its span ``campaign.checkpoint``'s count. Timed window."""

from h100_bench.metrics._program import counter, spans


def read(rec):
    c, s = counter(rec, "checkpoint.bytes"), (spans(rec) or {}).get(
        "campaign.checkpoint")
    if not c or not s or not s["count"]:
        return None
    return sum(c.values()) / s["count"]
