"""The yardstick of the kernels: operations and bytes a call needs, and the
card's published peaks.

The operation counts are a frozen copy of the program's own arithmetic
(``ops/sepaihrd_fused.op_count``), counted from the kernel's source per age
lane: 41 per right-hand side evaluated, 20 per non-zero stage or update
coefficient in a substep, 18 per observed day. A stage is evaluated when a later
stage input or the update reads it (or it is carried by FSAL); first-same-
as-last carries the first stage of every substep of a day but the first.
Bytes count each input read once and each output written once.

Peaks: NVIDIA H100 SXM data sheet, outside the tensor cores, at its 700 W
limit.
"""

from __future__ import annotations

import numpy as np

from .reference.spain import TABLEAUS

PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
N_AGES = 4


def _tableau(name):
    rows, b = TABLEAUS[name]
    S = len(b)
    a = np.zeros((S, S))
    for i, row in enumerate(rows):
        a[i, :len(row)] = row
    b = np.asarray(b, dtype=np.float64)
    fsal = bool(np.allclose(a[-1], b)) and len(rows[-1]) == S - 1
    return a, b, fsal


def evaluated_stages(tableau: str):
    """Which stages a substep evaluates: those a later stage input or the
    update reads, and the last under first-same-as-last."""
    a, b, fsal = _tableau(tableau)
    S = len(b)
    feeds = [bool(np.any(a[i + 1:, i] != 0.0)) for i in range(S)]
    live = [f or b[i] != 0.0 for i, f in enumerate(feeds)]
    return [x or (fsal and i == S - 1) for i, x in enumerate(live)]


def dependent_stages(tableau: str, substeps: int) -> int:
    """Right-hand sides a chain evaluates in one day."""
    n = sum(evaluated_stages(tableau))
    return 1 + substeps * (n - 1) if _tableau(tableau)[2] else substeps * n


def fwd_ops(tableau: str, substeps: int, n_intervals: int, n_obs: int) -> int:
    """Operations of one chain's forward solve and fold (K1)."""
    a, b, _ = _tableau(tableau)
    nnz = int(np.count_nonzero(np.tril(a, -1))) + int(np.count_nonzero(b))
    lane = (n_intervals * (41 * dependent_stages(tableau, substeps)
                           + 20 * nnz * substeps) + 18 * n_obs)
    return N_AGES * lane


def shapes(config: dict) -> dict:
    """The sizes the counts take, from a configuration file."""
    n_obs = int(config["observed_days"])
    runup = int(config["runup_days"])
    return dict(n_obs=n_obs, n_intervals=runup + n_obs - 1,
                n_runs=int(config["schedule_runs"]))


def call_cost(kernel: str, config: dict, B: int) -> dict:
    """``{"ops", "bytes"}`` of one call of ``kernel`` (``k1``: the forward
    solve and fold) on ``B`` chains of a configuration."""
    if kernel != "k1":
        raise ValueError(f"unknown kernel {kernel!r}")
    sh = shapes(config)
    elem = 8 if config["dtype"] == "float64" else 4
    obs = 2 * sh["n_obs"] * 3 * N_AGES                      # obs and valid
    y0, agevec, scal, beff = 11 * N_AGES * B, 8 * N_AGES * B, 7 * B, sh["n_runs"] * B
    ops = fwd_ops(config["tableau"], int(config["substeps"]), sh["n_intervals"],
                  sh["n_obs"]) * B
    return dict(ops=ops, bytes=(y0 + agevec + scal + beff + obs + B) * elem)


def least_seconds(cost: dict, dtype: str):
    """``(seconds, "ops" or "bytes")``: the least time the card could take."""
    t_ops = cost["ops"] / PEAK_FLOPS[dtype]
    t_bytes = cost["bytes"] / PEAK_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
