"""``idle_share``: 100 x (1 - the device's busy seconds a sampler iteration
in the traced window / the timed window's seconds an iteration). The busy
time is the union of the device's operation intervals from the trace; the
time an iteration is the untraced window's, since the profiler slows the
host and would stretch the traced window's own."""


def read(rec):
    if rec.trace is None or not rec.traced.iterations or not rec.timed.iterations:
        return None
    busy = rec.trace.busy_s() / rec.traced.iterations
    return 100.0 * (1.0 - busy * rec.timed.iterations / rec.timed.seconds) \
        if busy > 0 else None
