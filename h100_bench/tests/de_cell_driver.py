"""The DE-MC cell's driver (``samplers/de.py``) with an ``extra`` for the
harness's tests and for the readings that set the cell's limits: besides
the driver's own step check, rank 0's counters ``mh.graph`` and
``mesh.bytes`` over the timed window of a traced run, and, where the cell's overrides set ``control``, the control's
readings at the window's final states (``control.readings``, over every
rank's rows):

    python3 h100_bench/run.py --workload de32768-x4-cashkarp3 --seed <n> \\
        --seconds 5 --trace 1 --driver h100_bench/tests/de_cell_driver.py \\
        --overrides '{"control": true}'
"""

from __future__ import annotations

import json
import os
import resource
import time

from h100_bench import control
from h100_bench.run import load_module

_de = load_module(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "samplers", "de.py"), "h100_bench.samplers.de")
KERNEL_LIBS = _de.KERNEL_LIBS
TIMED = {}              # rank 0's timed counters, kept by the driver


def _cpu_now() -> int:
    """The CPU this process's main thread last ran on (``/proc/self/stat``'s
    39th field)."""
    with open("/proc/self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


class Driver(_de.Driver):
    """With ``DE_RANKINFO`` in the environment every rank writes
    ``$DE_RANKINFO.rank<r>.json``: its CPU affinity, and at the window's
    opening and each unit's end the clock, the process's CPU seconds, its
    voluntary and involuntary context switches and the CPU it ran on; its
    host spans (the harness's and, traced, the program's)."""

    def __init__(self, setup, cell, seed, window, tmpdir):
        super().__init__(setup, cell, seed, window, tmpdir)
        self.marks = []
        start, done = window.start, window.unit_done

        def mark():
            r = resource.getrusage(resource.RUSAGE_SELF)
            self.marks.append((time.perf_counter(), r.ru_utime + r.ru_stime,
                               r.ru_nvcsw, r.ru_nivcsw, _cpu_now()))

        def start_():
            start()
            mark()

        def unit_done(iterations):
            out = done(iterations)
            mark()
            return out

        window.start, window.unit_done = start_, unit_done

    def run(self):
        super().run()
        snap = getattr(self.win.timed, "program", None)
        if snap is not None:
            TIMED.update(snap["counters"])
        path = os.environ.get("DE_RANKINFO")
        if path:
            import torch

            info = dict(rank=self.s.mesh.rank, cpus=os.cpu_count(),
                        affinity=sorted(os.sched_getaffinity(0)),
                        threads=torch.get_num_threads(), marks=self.marks,
                        bench_spans={k: (v.seconds, v.count) for k, v in
                                     self.win.timed.spans.items()},
                        spans=(snap or {}).get("spans"))
            with open(f"{path}.rank{self.s.mesh.rank}.json", "w") as f:
                json.dump(info, f)


def extra(final, config, cell, device, num_days):
    out = _de.extra(final, config, cell, device, num_days)
    out.update({name: {repr(k): n for k, n in TIMED.get(name, {}).items()}
                for name in ("mh.graph", "mesh.bytes")})
    if cell.get("control"):
        out["control"] = control.readings(final, config, cell, device, num_days)
    return out
