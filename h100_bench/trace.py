"""Reduction of the traced window's profile to what the per-layer readers
take: the device's operations (name, start, length), the benchmark's host
spans (``bench.*``), the busy time (the union of device intervals inside
the ``bench.window`` span) and the breakdown the result line carries."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Tuple

NOT_KERNELS = ("Memcpy", "Memset", "cudaMemcpy", "cudaMemset")
NAME_CHARS = 96           # of a demangled kernel name in the breakdown


class TraceSummary:
    def __init__(self, device_ops, spans, window):
        self.device_ops: List[Tuple[str, int, int]] = device_ops   # name, start, end (ns)
        self.spans: List[Tuple[str, int, int]] = spans
        self.window = window                                       # (start, end) ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self):
        return [op for op in self.device_ops if not op[0].startswith(NOT_KERNELS)]

    def union(self):
        """The device's busy intervals inside the window, merged."""
        w0, w1 = self.window
        ivs = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device_ops
                     if e > w0 and s < w1)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) * 1e-9

    def top_ops(self, n=10):
        tot = defaultdict(int)
        for name, s, e in self.device_ops:
            tot[name[:NAME_CHARS]] += e - s
        return [[name, ns * 1e-9] for name, ns in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """Idle time between device operations, summed by the innermost
        benchmark span the host was in at the gap's midpoint (``sampler``
        outside every span: the sampler's own host work)."""
        busy = self.union()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        spans = sorted((s, e, n) for n, s, e in self.spans if n != "bench.window")
        starts = [sp[0] for sp in spans]
        tot = defaultdict(int)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            # the last span to start before the midpoint: the innermost
            # one, as the benchmark's spans nest or follow one another
            i = bisect.bisect_right(starts, mid) - 1
            name = spans[i][2] if i >= 0 and spans[i][1] >= mid else "sampler"
            tot[name] += e - s
        return [[name, ns * 1e-9] for name, ns in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def summarize(profiler) -> TraceSummary:
    """The traced window of a finished ``torch.profiler.profile``."""
    device_ops, spans, window = [], [], None
    for e in profiler.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if str(e.device_type()).endswith("CPU"):
            if name.startswith("bench."):
                spans.append((name, start, end))
                if name == "bench.window":
                    window = (start, end)
        elif not name.startswith("bench."):
            device_ops.append((name, start, end))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return TraceSummary(device_ops, spans, window)
