"""``mfu``: the whole step's share of the cards' peak, in %: the frozen
operation counts of every objective call in the timed window (K1's
forward, times the chains of the call, as the harness counts the calls
around the objective it hands the runner, summed over the ranks) over the
window times the cell's chips times one card's non-tensor peak. It bounds
a gain of a later change that removes or merges a kernel."""

from h100_bench import roofline


def read(rec):
    if not rec.cuda:
        return None
    t, cfg = rec.timed, rec.config
    ops = sum(n * roofline.call_cost("k1", cfg, B)["ops"] for B, n in t.calls.items())
    if not ops:
        return None
    return 100.0 * ops / (t.seconds * rec.chips * roofline.PEAK_FLOPS[cfg["dtype"]])
