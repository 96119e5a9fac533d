"""What the readers of the program's own tracer share: its snapshot of the
timed window (``Phase.program``, kept by ``program_trace.ProgramWindow``),
absent where the window did not switch the tracer on or the program has
none."""


def spans(rec):
    """The timed window's program spans ``{name: {count, total_s,
    self_s}}``, or None."""
    snap = getattr(rec.timed, "program", None)
    return None if snap is None else snap["spans"]


def counter(rec, name):
    """The timed window's counter ``name`` ``{key: n}``, or None."""
    snap = getattr(rec.timed, "program", None)
    return None if snap is None else snap["counters"].get(name)


def per_call_ms(rec, name):
    """Host ms a call of span ``name`` took on average, or None."""
    s = (spans(rec) or {}).get(name)
    return 1e3 * s["total_s"] / s["count"] if s and s["count"] else None


def per_iteration_ms(rec, seconds):
    """``seconds`` of the timed window in host ms a sampler iteration."""
    it = rec.timed.iterations
    return 1e3 * seconds / it if it else None
