"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the plain
reference (``reference/``, float64) recomputes what the timed path produced
for the window's final states: the objective value the sampler holds for
every chain. The numbers compared:

- ``value_gap``: the largest gap of a chain's value,
  ``|program - reference|``, over the reference's ``|value|`` of that chain
  or of the median chain, whichever is larger (a log-likelihood is a sum of
  terms of both signs: where they cancel, its rounding error is one of the
  terms', not of the small sum, so a chain's own value is no scale there);
- ``value_gap_p99``: the 99th percentile of those gaps over the chains;
- ``floor_mismatch``: chains the program floors as infeasible or
  non-finite while the reference gives a finite value, or the reverse;
- ``unmoved_share``: the share of chains whose position did not change
  over the window (a step that returns its state unchanged).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .reference.spain import SpainReference

FLOOR = -1e17             # the samplers' floor for infeasible or non-finite values


def reference_for(config: dict, root: str, *, device, num_days=None,
                  dtype=torch.float64, tf32: bool = False) -> SpainReference:
    """The configuration's reference in ``dtype`` (with ``tf32``, its
    contact product's operands rounded to TF32: the control)."""
    return SpainReference(
        os.path.join(root, "data"), tableau=config["tableau"],
        substeps=int(config["substeps"]), num_days=num_days, device=device,
        dtype=dtype, tf32=tf32, bounds_dtype=np.dtype(config["dtype"]))


def values(ref: SpainReference, x, block: int) -> torch.Tensor:
    """The reference's value of every row of ``x``, in blocks of rows."""
    with torch.no_grad():
        return torch.cat([ref.loglik(x[i:i + block]).double().cpu()
                          for i in range(0, x.shape[0], block)])


def scaled_gaps(program: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """``|program - reference|`` over ``max(|reference|, median |reference|)``:
    the reference's magnitude of that chain or of the median chain,
    whichever is larger."""
    scale = reference.abs()
    floor = scale.median() if scale.numel() else scale.new_tensor(1.0)
    return (program - reference).abs() / torch.maximum(scale, floor).clamp_min(1e-300)


def numbers(final: dict, vr: torch.Tensor, limits: dict):
    """``(numbers, chains beyond a limit)``: the compared numbers of the
    sampler's final states against the reference's values ``vr``."""
    x = final["x"]
    vp = final["logp"].double().cpu()
    floored = vp <= FLOOR
    finite_r = torch.isfinite(vr)
    out = {"floor_mismatch": int((floored == finite_r).sum())}
    ok = ~floored & finite_r
    gap = torch.full_like(vr, math.nan)
    gap[ok] = scaled_gaps(vp[ok], vr[ok])
    out["value_gap"] = float(gap[ok].max()) if bool(ok.any()) else math.nan
    out["value_gap_p99"] = (float(np.quantile(gap[ok].numpy(), 0.99))
                            if bool(ok.any()) else math.nan)
    bad = (floored == finite_r) | (ok & ~(gap <= limits["value_gap"]))
    unmoved = torch.all(x == final["x_start"], dim=1).cpu()
    out["unmoved_share"] = float(unmoved.double().mean())
    if not out["unmoved_share"] <= limits["unmoved_share"]:
        bad |= unmoved
    return out, int(bad.sum())


def judge(nums: dict, limits: dict):
    """``(correct, failed names, checks)``: each number beside its limit.
    A number that is missing (NaN), or that has no limit, fails."""
    checks, failed = {}, []
    for name, value in nums.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            failed.append(name)
    return not failed, failed, checks
