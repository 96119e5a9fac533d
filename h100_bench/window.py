"""The measured window and the benchmark's own spans.

A sampler driver runs the program's runner and reports each unit it
finishes (a campaign segment, a block of steps, a NUTS iteration) to
:meth:`Window.unit_done`, which says when to stop. The window opens at
:meth:`Window.start` (after a ``torch.cuda.synchronize()``: everything
before it is set-up) and closes at the first unit boundary after
``seconds``, again after a synchronize, so the rate is all the work over
all the time in between.

With ``trace`` the timed window is followed by a traced one of
``trace_units`` units, under ``torch.profiler`` on a card; the host spans
are timed in both (a ``perf_counter`` pair around each call), and
``record_function`` marks them in the profiled one only. On the host (the
rehearsal) the traced window runs unprofiled: there is no device to trace.

On a ``mesh`` of more than one rank (one process a rank, ``ranks.py``) the
window spans every rank's work: each opening and closing synchronises the
rank's card and then holds a barrier, so set-up ends when the slowest rank
is ready; at each unit boundary of the timed window rank 0's clock decides
whether it has closed, shared by one small ``all_reduce``, so that every
rank leaves the runner at the same unit. The profiler runs on rank 0 only;
every rank keeps its own spans and call counts. With one rank none of this
runs.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class WindowClosed(Exception):
    """Raised by a driver's hook to leave the program's runner once the
    window has closed."""


class Span:
    __slots__ = ("seconds", "count")

    def __init__(self):
        self.seconds, self.count = 0.0, 0


class Phase:
    """What one window (timed or traced) saw."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = self.t1 = 0.0
        self.units = self.iterations = 0
        self.spans: Dict[str, Span] = {}
        self.calls: Dict[int, int] = {}     # objective calls by chain count

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Window:
    def __init__(self, *, seconds: float, trace: bool, trace_units: int,
                 device: torch.device, t_process: float, mesh=None):
        self.seconds, self.trace, self.trace_units = seconds, trace, trace_units
        self.device, self.t_process = device, t_process
        self.cuda = device.type == "cuda"
        # the ranks this window spans (an EnsembleMesh), None for one rank
        self.mesh = mesh if mesh is not None and mesh.world_size > 1 else None
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.timed = Phase("timed")
        self.traced: Optional[Phase] = Phase("traced") if trace else None
        self.phase: Optional[Phase] = None
        self.setup_s: Optional[float] = None
        self.profiler = None
        self._mark = None
        self._open_span = (None, None, 0.0)
        self._open_mark = None
        self.closed = False

    # -- clock ------------------------------------------------------------
    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        if self.mesh is not None:          # a barrier of every rank
            self.mesh.psum(torch.ones(1, device=self.device)).item()

    def _open(self, phase: Phase):
        self._sync()
        phase.t0 = time.perf_counter()
        self.phase = phase

    def _close(self, phase: Phase):
        self._sync()
        phase.t1 = time.perf_counter()

    def _over(self, phase: Phase) -> bool:
        """Whether the timed window has run ``seconds``: by this rank's
        clock, or on a mesh by rank 0's, the same answer on every rank."""
        over = time.perf_counter() - phase.t0 >= self.seconds
        if self.mesh is None:
            return over
        flag = torch.tensor([1.0 if over and self.rank == 0 else 0.0],
                            device=self.device)
        return bool(self.mesh.psum(flag).item())

    def start(self):
        """Set-up ends: the timed window opens."""
        self._open(self.timed)
        self.setup_s = self.timed.t0 - self.t_process

    def unit_done(self, iterations: int) -> bool:
        """A unit of ``iterations`` sampler iterations finished; True once
        the window (and the traced one after it) has closed."""
        ph = self.phase
        ph.units += 1
        ph.iterations += iterations
        if ph is self.timed:
            if not self._over(ph):
                return False
            self._close(ph)
            if self.traced is None:
                self.closed = True
                return True
            self._start_trace()
            return False
        if ph.units < self.trace_units:
            return False
        self._stop_trace()
        self.closed = True
        return True

    # -- tracing -----------------------------------------------------------
    def _start_trace(self):
        if not self.cuda or self.rank != 0:
            self._open(self.traced)
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self.profiler = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        self.profiler.__enter__()
        self._open(self.traced)
        self._mark = record_function("bench.window")
        self._mark.__enter__()

    def _stop_trace(self):
        self._close(self.traced)
        if self.profiler is not None:
            self._mark.__exit__(None, None, None)
            self.profiler.__exit__(None, None, None)

    def _marked(self, ph) -> bool:
        return ph is not None and ph is self.traced and self.profiler is not None

    # -- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """Host time of the enclosed call, booked to the open window."""
        ph = self.phase
        if ph is None or self.closed:
            yield
            return
        mark = None
        if self._marked(ph):
            from torch.profiler import record_function
            mark = record_function(f"bench.{name}")
            mark.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            s = ph.spans.setdefault(name, Span())
            s.seconds += time.perf_counter() - t
            s.count += 1
            if mark is not None:
                mark.__exit__(None, None, None)

    def begin(self, name: str):
        """The start of a span that a later :meth:`end` closes (a span that
        begins in one hook of the runner and ends in the next)."""
        self._open_span = (name, self.phase, time.perf_counter())
        if self._marked(self.phase):
            from torch.profiler import record_function
            self._open_mark = record_function(f"bench.{name}")
            self._open_mark.__enter__()
        else:
            self._open_mark = None

    def end(self):
        name, ph, t = self._open_span
        self._open_span = (None, None, 0.0)
        if self._open_mark is not None:
            self._open_mark.__exit__(None, None, None)
            self._open_mark = None
        if ph is None or name is None or ph is not self.phase:
            return
        s = ph.spans.setdefault(name, Span())
        s.seconds += time.perf_counter() - t
        s.count += 1

    def wrap(self, fn):
        """The objective ``fn(x (B, d)) -> (B,)`` with every call booked to
        the span ``objective`` and counted by its chain count ``B`` in the
        open window's ``calls``: the harness's own count of the work, which
        ``mfu`` and the rooflines read whatever implements the call."""
        def wrapped(x, *args, **kwargs):
            ph = self.phase
            if ph is not None and not self.closed:
                B = int(x.shape[0])
                ph.calls[B] = ph.calls.get(B, 0) + 1
            with self.span("objective"):
                return fn(x, *args, **kwargs)
        return wrapped
