"""A curvature-capped logit-space dense mass for the NUTS campaign.

Port of ``scripts/make_capped_mass.py``. A dense mass from the pooled
covariance of a trace that has not converged has the right width along the
posterior's soft directions but can overstate its stiff ones, which collapses
the leapfrog's stable step. The blend of trace and curvature:

1. ``S = chol(Sigma)``, the logit-space pooled covariance of the trace's
   second half (10 % shrinkage, marginal stds floored at ``--floor``);
2. ``A = S^T (-H) S`` with ``H`` the exact float64 Hessian of the logit
   posterior (``_logit_posterior.exact_hessian``) at the top ``--points``
   ensemble positions of the trace's last iteration;
3. ``A = V diag(lambda) V^T``, and every direction whose whitened curvature
   exceeds ``cap^2`` shrunk: ``S' = S V diag(min(1, cap / sqrt(lambda)))``,
   two sweeps over the points.

Writes ``mu`` (y-space centre), ``scale`` (the capped factor), ``power`` and
``names`` for ``nuts_campaign --mass logit-file``.

Usage:
    python -m mmidv1_tpu_torch.cli.make_capped_mass --trace samples.npz
        --out mass.npz [--points 3] [--cap 0.5] [--power 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..calibration.nuts import logit_transform
from ._logit_posterior import LogitObjective, logit_mass, power_for


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="make_capped_mass",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", required=True,
                   help="samples.npz of the widest-coverage campaign so far")
    p.add_argument("--out", required=True, help="output mass .npz")
    p.add_argument("--points", type=int, default=3,
                   help="ensemble positions to evaluate the Hessian at (the "
                        "per-direction maximum curvature is used)")
    p.add_argument("--cap", type=float, default=0.5,
                   help="whitened-curvature cap c: S^T(-H)S <= c^2")
    p.add_argument("--floor", type=float, default=0.25,
                   help="y-marginal-std floor before capping")
    p.add_argument("--power", default="1",
                   help="'auto' or a number: power-logit exponent")
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


def cap_scale(S: np.ndarray, H_list, cap: float):
    """``(S', directions capped, worst whitened curvature after)``: two
    sweeps of eigen-capping ``S`` against each Hessian (each pass only
    shrinks directions)."""
    S_capped = S.copy()
    total = 0
    for _sweep in range(2):
        for H in H_list:
            A = S_capped.T @ (-H) @ S_capped
            lam, V = np.linalg.eigh(0.5 * (A + A.T))
            dshrink = np.minimum(1.0, cap / np.sqrt(np.maximum(lam, 1e-30)))
            total += int((dshrink < 1.0 - 1e-12).sum())
            S_capped = S_capped @ (V * dshrink[None, :])
    worst = max(np.linalg.eigvalsh(S_capped.T @ (-H) @ S_capped).max()
                for H in H_list)
    return S_capped, total, float(worst)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    tr = np.load(args.trace)
    X = tr["samples"].astype(np.float64)
    T, _C, d = X.shape
    flat = X.reshape(-1, d)
    obj = LogitObjective(args)
    lo, hi = obj.lo, obj.hi
    power_k = power_for(flat, lo, hi, args.power)
    if args.power == "auto":
        print(f"power-logit: k=8 for {int((power_k > 1).sum())}/{d} params")

    mu_y, cov = logit_mass(logit_transform(X[T // 2:].reshape(-1, d), lo, hi,
                                           power=power_k), args.floor)
    S = np.linalg.cholesky(cov)
    lp_last = tr["logps"][-1]
    picks = np.argsort(-lp_last)[:args.points]
    H_list, secs = obj.hessians(
        power_k, [logit_transform(X[-1, ci], lo, hi, power=power_k)
                  for ci in picks])
    print(f"exact Hessians: {len(H_list)} in "
          f"{', '.join(f'{s:.1f}' for s in secs)} s")
    S_capped, total, worst = cap_scale(S, H_list, args.cap)
    print(f"capped directions (cumulative over sweeps): {total}; post-cap "
          f"whitened curvature max {worst:.3f} (target <= "
          f"{args.cap ** 2:.3f})")
    np.savez(args.out, mu=mu_y, scale=S_capped, power=power_k,
             names=np.array([str(n) for n in tr["names"]]))
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
