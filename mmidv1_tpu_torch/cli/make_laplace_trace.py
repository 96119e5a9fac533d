"""A samples.npz trace drawn from a Laplace approximation (host-side).

Port of ``scripts/make_laplace_trace.py``. The serovalid NUTS campaign needs
a ``--trace`` for its logit-dense mass and a ``--warm`` ensemble; the
committed serovalid artifact has a MAP and its Laplace
(``laplace_serovalid.npz``), so the trace is drawn from N(theta_map, cov)
with NumPy (``default_rng(--seed)``), clipped to an interior margin of the
relaxed bounds so every draw's logit transform is finite. The bounds are the
float32 configuration widened by ``relax_bounds`` in float64, as the JAX
script computes them, so both write the same bits.

Usage:
    python -m mmidv1_tpu_torch.cli.make_laplace_trace [--laplace ...]
        [--out .../laplace_trace.npz] [--iters 64] [--chains 64] [--seed 53]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from ._logit_posterior import laplace_cov
from .common import REPO_ROOT


def relaxed_bounds_f64(space):
    """The variant-C bounds of a float32 space, kept in float64."""
    from ..calibration.serovalid import relax_bounds

    space64 = dataclasses.replace(space, lower=space.lower.double(),
                                  upper=space.upper.double())
    relaxed, _ = relax_bounds(space64)
    return (relaxed.lower.numpy().astype(np.float64),
            relaxed.upper.numpy().astype(np.float64))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="make_laplace_trace",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--laplace", default=os.path.join(
        REPO_ROOT, "results", "spain2020_serovalid", "laplace_serovalid.npz"))
    p.add_argument("--out", default=os.path.join(
        REPO_ROOT, "results", "spain2020_serovalid", "laplace_trace.npz"))
    p.add_argument("--iters", type=int, default=64)
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--seed", type=int, default=53)
    p.add_argument("--margin", type=float, default=1e-4,
                   help="interior clip margin as a fraction of each "
                        "parameter's bound width")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .common import load_spain_pipeline

    space = load_spain_pipeline(REPO_ROOT, dtype=torch.float32,
                                device="cpu").space
    lap = np.load(args.laplace)
    if [str(n) for n in lap["names"]] != list(space.names):
        raise SystemExit("Laplace parameter names do not match the space")
    cov = laplace_cov(lap)
    mean = lap["theta_map"].astype(np.float64)

    rng = np.random.default_rng(args.seed)
    n = args.iters * args.chains
    draws = rng.multivariate_normal(mean, cov, size=n, method="cholesky")
    lo, hi = relaxed_bounds_f64(space)
    width = hi - lo
    draws = np.clip(draws, lo + args.margin * width, hi - args.margin * width)
    samples = draws.reshape(args.iters, args.chains, space.dim)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        np.savez(f, samples=samples.astype(np.float64),
                 names=np.asarray(space.names))
    frac_edge = float(np.mean(
        (samples <= (lo + 1.5 * args.margin * width)) |
        (samples >= (hi - 1.5 * args.margin * width))))
    print(f"wrote {args.out}: samples {samples.shape}, {frac_edge:.1%} of "
          f"coordinates at the clip margin (MAP ll "
          f"{float(lap['ll_map']):.6e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
