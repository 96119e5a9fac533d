"""``launches_per_step``: device kernels in the traced window over the
sampler iterations it completed (every kernel, eager work included; a NUTS
iteration holds its 2**depth evaluations)."""


def read(rec):
    if rec.trace is None or not rec.traced.iterations:
        return None
    n = len(rec.trace.kernels())
    return n / rec.traced.iterations if n else None
