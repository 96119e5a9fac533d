"""Posterior summary of the serovalid (ENE-COVID-consistent) artifact.

Port of ``scripts/serovalid_posterior_summary.py``. After a serovalid NUTS
campaign is promoted into ``results/spain2020_serovalid/``
(``refresh_artifact --artifact ...``), this computes what the comparison
report renders as credible intervals:

- the day-64 seroprevalence quantiles (2.5 / 50 / 97.5 %), replaying a
  seeded subsample of the posterior (``default_rng(--seed)``) in float32,
  in batches, through the ``sero_of`` of the sampler's data term
  (``calibration/serovalid.make_sero_penalty``);
- the Poisson log-likelihood quantiles of the stored per-draw logls;
- the fraction of replayed draws inside the ENE-COVID 95 % CI;

and merges them into ``run_metadata.json`` as ``posterior_summary``.

Usage:
    python -m mmidv1_tpu_torch.cli.serovalid_posterior_summary
        [--artifact results/spain2020_serovalid] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .common import REPO_ROOT


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="serovalid_posterior_summary",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default=os.path.join(
        REPO_ROOT, "results", "spain2020_serovalid"))
    p.add_argument("--replay-draws", type=int, default=512)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def run(argv=None) -> dict:
    """The summary, as :func:`main` runs it; returns ``posterior_summary``."""
    args = build_parser().parse_args(argv)
    from ..analysis.aggregate import ENE_COVID_MEAN
    from ..calibration.param_space import REFLECT
    from ..calibration.serovalid import make_sero_penalty, relax_bounds
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    post = np.load(os.path.join(args.artifact, "posterior_samples.npz"))
    samples, logls = post["samples"], post["logls"]
    meta_path = os.path.join(args.artifact, "run_metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)

    dev = resolve_device(args.device)
    dtype = torch.float32
    pipe = load_spain_pipeline(REPO_ROOT, dtype=dtype, device=dev)
    space, _ = relax_bounds(pipe.space)
    if [str(n) for n in post["names"]] != list(space.names):
        raise SystemExit("posterior parameter names do not match the space")
    camp = meta.get("campaign", {})
    pen = make_sero_penalty(space, pipe.params, pipe.data, pipe.ts,
                            substeps=int(camp.get("substeps", 4)),
                            tableau=str(camp.get("tableau", "dopri5")),
                            constraint_mode=REFLECT, dtype=dtype, device=dev)

    rng = np.random.default_rng(args.seed)
    n = min(args.replay_draws, samples.shape[0])
    idx = rng.choice(samples.shape[0], size=n, replace=False)
    thetas = torch.as_tensor(samples[idx]).to(device=dev, dtype=dtype)
    with torch.no_grad():
        seros = np.concatenate([
            pen.sero_of(thetas[i:i + args.batch]).cpu().numpy()
            for i in range(0, n, args.batch)]).astype(np.float64)

    with open(os.path.join(args.artifact, "serovalid_metadata.json")) as f:
        ci = json.load(f)["sero_target"]["ci"]
    q = lambda a, qs=(2.5, 50.0, 97.5): {
        f"q{s:g}": float(v) for s, v in zip(qs, np.percentile(a, qs))}
    meta["posterior_summary"] = {
        "n_replayed": int(n),
        "sero_day64": q(seros),
        "sero_inside_ci_frac": float(np.mean((seros >= ci[0])
                                             & (seros <= ci[1]))),
        "ene_covid_mean": float(ENE_COVID_MEAN),
        "logl": q(logls.astype(np.float64)),
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    s = meta["posterior_summary"]["sero_day64"]
    print(f"sero day-64 posterior: {100 * s['q50']:.2f}% "
          f"[{100 * s['q2.5']:.2f}, {100 * s['q97.5']:.2f}] (inside "
          f"ENE-COVID CI: "
          f"{100 * meta['posterior_summary']['sero_inside_ci_frac']:.0f}% of "
          f"draws); run_metadata.json updated")
    return meta["posterior_summary"]


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
