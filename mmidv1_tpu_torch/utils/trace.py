"""The port's tracer: named host spans and counters, in memory.

Spans are off until :func:`enable` (nothing else switches them on). Off,
:func:`span` returns one shared null context: no clock is read and nothing
is allocated. On, each span name keeps its count, its total host time and
its self time (the total less the time its child spans took; the parent
is the innermost span open when the child starts), from
``time.perf_counter_ns``. With ``enable(profile=True)`` every span also
opens ``torch.profiler.record_function("mmid." + name)``, so under a
running ``torch.profiler`` it lands in the kineto trace on the clock of
the device's operations.

Counters count whether spans are on or off: an integer add under a name
and a key (a tuple), e.g. the kernels' launches by ``(kernel, regime,
tableau, chains)``.

The state is per process and assumes one host thread drives the spans
(the samplers' loops); :func:`snapshot` copies it out as plain dicts.
"""

from __future__ import annotations

import contextlib
import time

_NULL = contextlib.nullcontext()
_on = False
_profile = False
_spans: dict = {}        # name -> [count, total ns, self ns]
_stack: list = []        # the open spans, innermost last
_counters: dict = {}     # name -> {key: n}


class _Span:
    __slots__ = ("name", "t0", "child_ns", "mark")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0
        self.mark = None

    def __enter__(self):
        if _profile:
            import torch
            self.mark = torch.profiler.record_function("mmid." + self.name)
            self.mark.__enter__()
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        _stack.pop()
        if _stack:
            _stack[-1].child_ns += ns
        rec = _spans.get(self.name)
        if rec is None:
            rec = _spans[self.name] = [0, 0, 0]
        rec[0] += 1
        rec[1] += ns
        rec[2] += ns - self.child_ns
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that books the enclosed host time to ``name``
    while spans are on, and does nothing while they are off."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, key: tuple = (), n: int = 1) -> None:
    """Add ``n`` to counter ``name`` under ``key``, spans on or off."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = {}
    c[key] = c.get(key, 0) + n


def enable(profile: bool = False) -> None:
    """Switch spans on; with ``profile`` each also opens a
    ``record_function`` range named ``mmid.<name>``."""
    global _on, _profile
    _on, _profile = True, bool(profile)


def disable() -> None:
    global _on, _profile
    _on = _profile = False


def reset() -> None:
    """Forget every span and counter recorded so far (spans open now
    still close into the new record)."""
    _spans.clear()
    _counters.clear()


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: {key: n}}}``, a copy."""
    return {"spans": {name: {"count": c, "total_s": t * 1e-9,
                             "self_s": s * 1e-9}
                      for name, (c, t, s) in _spans.items()},
            "counters": {name: dict(c) for name, c in _counters.items()}}


def counts(name: str, prefix: tuple = (), snap: dict = None) -> dict:
    """Counter ``name`` over the keys that begin with ``prefix``, keyed by
    the rest of the key: ``counts("launches", ("k1",))`` is K1's launches
    by ``(regime, tableau, chains)``. From ``snap`` (a :func:`snapshot`)
    where given, else from the counters now."""
    k = len(prefix)
    src = _counters if snap is None else snap["counters"]
    return {key[k:]: n for key, n in src.get(name, {}).items()
            if key[:k] == prefix}


def total(name: str, prefix: tuple = ()) -> int:
    """The sum of :func:`counts`: ``total("launches", ("k1",))`` is every
    K1 launch."""
    return sum(counts(name, prefix).values())
