"""Leapfrog energy error against step size on the production gradient path.

Port of ``scripts/energy_error_probe.py``. Fixed-step leapfrog trajectories
(no U-turn logic) in whitened logit coordinates on the path NUTS runs:
power-logit transform, dense y-space mass, and every gradient from K2 + K3
in float32 over the whole ensemble. For each step size it prints the
distribution of the Hamiltonian error ``dH = (logp - |r|^2 / 2)_end -
(...)_start`` and the expected Metropolis acceptance ``E[min(1, exp(dH))]``:
the largest step whose acceptance still clears ~0.6 is the operating point
for ``nuts_campaign --eps-floor`` / ``--delta-target``. Float32 gradient
noise accumulated over a trajectory shows here, where curvature analysis
cannot see it. Momenta come from a ``torch.Generator`` seeded by
``(--seed, step-size index)``.

Usage:
    python -m mmidv1_tpu_torch.cli.energy_error_probe --trace samples.npz
        [--chains 64] [--steps 128] [--eps 2e-4 1e-3 3e-3 6e-3 1.2e-2]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..calibration.nuts import logit_transform, logit_vag_z
from ._logit_posterior import logit_mass, power_for
from .common import REPO_ROOT


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="energy_error_probe",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", default=os.path.join(
        REPO_ROOT, "results", "spain2020_nuts_r9", "samples.npz"))
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--eps", type=float, nargs="+",
                   default=[2e-4, 1e-3, 3e-3, 6e-3, 1.2e-2])
    p.add_argument("--floor", type=float, default=0.25)
    p.add_argument("--power", default="1",
                   help="'auto' or a number: power-logit exponent")
    p.add_argument("--mass-file", default=None,
                   help="precomputed logit-space mass .npz (mu / scale); "
                        "overrides the trace-derived mass")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


def trajectory_dh(vag_z, z, eps: float, steps: int, r0):
    """``dH`` of a ``steps``-step leapfrog from ``(z, r0)``."""
    lp0, g = vag_z(z)
    h0 = lp0 - 0.5 * torch.sum(r0 * r0, dim=-1)
    r = r0
    for _ in range(steps):
        r_half = r + 0.5 * eps * g
        z = z + eps * r_half
        _lp, g = vag_z(z)
        r = r_half + 0.5 * eps * g
    lp_end, _g = vag_z(z)
    return lp_end - 0.5 * torch.sum(r * r, dim=-1) - h0


def run(argv=None) -> list:
    """The probe, as :func:`main` runs it; returns a row per step size."""
    args = build_parser().parse_args(argv)
    from ..calibration.draws import seeded_generator
    from ..calibration.param_space import REFLECT
    from ..ops import build_objective_fused_grad
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    dev = resolve_device(args.device)
    dtype = torch.float32
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} / {kind}")
    pipe = load_spain_pipeline(REPO_ROOT, dtype=dtype, device=dev,
                               num_days=args.num_days)
    space = pipe.space
    vag = build_objective_fused_grad(space, pipe.params, pipe.data, pipe.ts,
                                     substeps=4, tableau="dopri5",
                                     constraint_mode=REFLECT, dtype=dtype,
                                     device=dev)
    d = space.dim
    lo = space.lower.cpu().numpy().astype(np.float64)
    hi = space.upper.cpu().numpy().astype(np.float64)

    X = np.load(args.trace)["samples"].astype(np.float64)
    power_k = power_for(X.reshape(-1, d), lo, hi, args.power)
    if args.power == "auto":
        print(f"power-logit: k=8 for {int((power_k > 1).sum())}/{d} params")
    if args.mass_file:
        mf = np.load(args.mass_file)
        mu_y = mf["mu"].astype(np.float64)
        S = mf["scale"].astype(np.float64)
        if "power" in mf.files:
            power_k = mf["power"].astype(np.float64)
    else:
        mu_y, cov = logit_mass(logit_transform(
            X[X.shape[0] // 2:].reshape(-1, d), lo, hi, power=power_k),
            args.floor)
        S = np.linalg.cholesky(cov)

    t = lambda a: torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)
    vag_z = logit_vag_z(vag, t(lo), t(hi - lo), t(mu_y), t(S), t(power_k))
    # start positions: the trace's final ensemble, in z
    y0 = logit_transform(X[-1, :args.chains], lo, hi, power=power_k)
    z0 = t(np.linalg.solve(S, (y0 - mu_y).T).T)
    n = z0.shape[0]
    rows = []
    for i, eps in enumerate(args.eps):
        g = seeded_generator(args.seed, (i,), dev)
        r0 = torch.randn(z0.shape, generator=g, dtype=dtype, device=dev)
        dh = trajectory_dh(vag_z, z0, eps, args.steps, r0).cpu().numpy()
        dh = dh[np.isfinite(dh)].astype(np.float64)
        acc = (np.minimum(1.0, np.exp(np.clip(dh, -60, 0))).mean()
               if len(dh) else 0.0)
        rows.append(dict(eps=eps, dh_mean=float(dh.mean()) if len(dh) else None,
                         dh_std=float(dh.std()) if len(dh) else None,
                         accept=float(acc), finite=int(len(dh))))
        print(f"eps {eps:8.1e}: dH mean {dh.mean():8.3f} std {dh.std():8.3f} "
              f"median {np.median(dh):8.3f} -> E[accept] {acc:.3f} "
              f"({len(dh)}/{n} finite)")
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
