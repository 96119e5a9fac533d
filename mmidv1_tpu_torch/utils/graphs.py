"""The port's one cache of CUDA graphs: capture a call once, then replay it.

Its graphs share one memory pool, so one may reuse memory another freed
while it was captured: safe while they replay one after the other on one
stream in the order they were captured, and a caller copies a graph's
output before the next replay overwrites it. The cyclic garbage collector
is off during a capture: freeing a dead cycle that holds another graph
there would invalidate the capture (PyTorch no longer collects first).
"""

from __future__ import annotations

import collections
import gc
from typing import Callable, Optional

import torch

from . import trace


class Graphs:
    """One key's captured graphs: ``held``, what the caller's build kept
    beside them (static inputs, buffers); ``outputs``, what each callable
    returned while it was captured; ``counts``, each graph's taken-back
    ``(counter, key, n)``."""

    def __init__(self, held, graphs, outputs, counts):
        self.held, self.graphs = held, graphs
        self.outputs, self.counts = outputs, counts

    def replay(self, i: int = 0) -> None:
        """Replay graph ``i`` and add the counters its capture took back."""
        self.graphs[i].replay()
        for name, key, n in self.counts[i]:
            trace.count(name, key, n)


class GraphCache:
    """CUDA graphs by a key the caller gives (None: the call cannot be
    graphed, as on host tensors or under autograd).

    A key's first ``eager_calls`` calls run eagerly (they warm the
    allocator, cuBLAS and the kernels); the next captures the callables
    the caller builds, in turn, each as a graph on the key's device into the
    cache's pool; every call from then on replays them. With a ``capacity``
    the least recently used key's graphs are dropped past it; that key
    recaptures when it comes back, with no eager call. The tracer's counter
    ``counter`` counts the calls by ``("eager" | "capture" | "replay",
    B)``. Every counter a capture counts (the kernels' ``launches``) is
    taken back and kept with its graph, which adds it again at each replay:
    the counters read as if every call had run eagerly."""

    def __init__(self, counter: str, eager_calls: int,
                 capacity: Optional[int] = None):
        self.counter, self.eager_calls = counter, eager_calls
        self.capacity = capacity
        self.eager = {}                            # key -> eager calls made
        self.entries = collections.OrderedDict()   # key -> Graphs, LRU first
        self.pool = None

    def get(self, key, device, B: int, build: Callable) -> Optional[Graphs]:
        """The graphs this call replays, or None: it runs eagerly. At the
        capture ``build()`` gives ``(held, callables)``: the first callable
        takes no argument, each later one the output of the one before."""
        entry = None if key is None else self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
            kind = "replay"
        elif key is not None and self.eager.get(key, 0) >= self.eager_calls:
            entry = self._capture(key, device, *build())
            kind = "capture"
        else:
            if key is not None:
                self.eager[key] = self.eager.get(key, 0) + 1
            kind = "eager"
        trace.count(self.counter, (kind, B))
        return entry

    def _capture(self, key, device, held, fns) -> Graphs:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graphs, outputs, counts, args = [], [], [], ()
        with torch.cuda.device(device):
            for fn in fns:
                before = trace.snapshot()["counters"]
                graph = torch.cuda.CUDAGraph()
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self.pool):
                        out = fn(*args)
                finally:
                    if collecting:
                        gc.enable()
                taken = [(name, k, n - before.get(name, {}).get(k, 0))
                         for name, c in trace.snapshot()["counters"].items()
                         for k, n in c.items()
                         if n != before.get(name, {}).get(k, 0)]
                for name, k, n in taken:
                    trace.count(name, k, -n)
                graphs.append(graph)
                outputs.append(out)
                counts.append(taken)
                args = (out,)
        self.entries[key] = entry = Graphs(held, graphs, outputs, counts)
        if self.capacity is not None and len(self.entries) > self.capacity:
            self.entries.popitem(last=False)
        return entry
