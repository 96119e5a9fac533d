"""``launch_host_ms``: host ms of a K1 launch: the program's span
``k1.launch`` (``fused_objective``: the input checks, the host constants,
the ctypes call) over its count. Timed window."""

from h100_bench.metrics._program import per_call_ms


def read(rec):
    return per_call_ms(rec, "k1.launch")
