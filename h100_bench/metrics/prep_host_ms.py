"""``prep_host_ms``: host ms of K1's prep a call: the program's span
``objective.prep`` (``FusedPrep.kernel_args``: constrain, apply, the initial
state, the packing of the kernel's inputs) over its count. Timed window."""

from h100_bench.metrics._program import per_call_ms


def read(rec):
    return per_call_ms(rec, "objective.prep")
