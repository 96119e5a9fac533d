"""``gather_roofline``: the walker exchange's share of its roofline, in %:
the least time of a step's exchange over rank 0's device time a step in
NCCL kernels over the traced window. The least time is the bytes a rank
needs from the others -- the rows of the frozen half that live on other
ranks, ``(W - 1) / W x N / 2 x d`` values, frozen from the cell and never
read from the program's counter -- over the per-direction NVLink bandwidth
of the card (``gather_roofline.json``, with the ``nvidia-smi`` lines it
comes from). A program that gathers only what the step needs reads a
higher share, and none reads over 100 %. None where the trace holds no
NCCL kernel (one chip, or a program whose exchange runs none)."""

import json
import os
import re

DTYPE_BYTES = {"float32": 4, "float64": 8}


def spec():
    with open(os.path.splitext(__file__)[0] + ".json") as f:
        return json.load(f)


def needed_bytes(cell, config) -> int:
    """Bytes of the frozen half's rows that a rank needs from the others."""
    W, N = int(cell["chips"]), int(cell["chains"])
    d, size = int(config["parameters"]), DTYPE_BYTES[config["dtype"]]
    return (W - 1) * (N // 2) * d * size // W


def read(rec):
    if rec.trace is None or not rec.traced.iterations or rec.chips < 2:
        return None
    s = spec()
    pats = [re.compile(p) for p in s["patterns"]]
    ns = sum(e - b for name, b, e in rec.trace.kernels()
             if any(p.search(name) for p in pats))
    if not ns:
        return None
    least_s = needed_bytes(rec.cell, rec.config) / s["bytes_per_s"]
    return 100.0 * least_s * rec.traced.iterations / (ns * 1e-9)
