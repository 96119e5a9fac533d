"""``k1_roofline``: K1's share of its roofline, in %: the least time of the
objective calls in the traced window (max of bytes / 3.35 TB/s and
operations / the non-tensor peak, from the frozen counts) over the device
time of K1's kernels. Kernel names: ``k1_roofline.json``.

On several ranks it is rank 0's: local work over a local trace (rank 0's
own calls in the traced window, over rank 0's profile)."""

from h100_bench.metrics._lib import roofline_share


def read(rec):
    return roofline_share(rec, __file__)
