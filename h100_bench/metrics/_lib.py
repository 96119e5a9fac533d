"""What several metric readers share: span arithmetic over a window, and a
kernel's share of its roofline."""

from __future__ import annotations

import json
import os
import re

from h100_bench import roofline


def span(phase, name):
    s = phase.spans.get(name)
    return (s.seconds, s.count) if s is not None else (0.0, 0)


def patterns(path):
    """The kernel-name patterns beside a reader (``<reader>.json``)."""
    with open(os.path.splitext(path)[0] + ".json") as f:
        spec = json.load(f)
    return spec["kernel"], [re.compile(p) for p in spec["patterns"]]


def roofline_share(rec, reader_path):
    """Least time / device time, in %, of one kernel over the traced
    window: the least time of the objective calls the harness counted
    there, from the frozen counts at each call's chain count, over the
    device time of the kernels the reader's patterns name. None where
    nothing ran."""
    if rec.trace is None or rec.traced is None:
        return None
    kernel, pats = patterns(reader_path)
    dev_ns = sum(e - s for name, s, e in rec.trace.kernels()
                 if any(p.search(name) for p in pats))
    calls = rec.traced.calls
    if not dev_ns or not calls:
        return None
    least = sum(n * roofline.least_seconds(
        roofline.call_cost(kernel, rec.config, B), rec.config["dtype"])[0]
        for B, n in calls.items())
    return 100.0 * least / (dev_ns * 1e-9)
