"""Promote a converged campaign into the committed Spain-2020 artifact.

Port of ``scripts/refresh_artifact.py``. Takes a campaign directory
(``nuts_campaign`` or ``production_campaign``) and refreshes the artifact
(``results/spain2020/`` by default):

1. a subsample of the post-warmup trace into ``posterior_samples.npz``
   (``(N, 62)`` flattened draws, ``default_rng(--seed)``);
2. the campaign's ``calibrated_parameters.txt`` adopted only when its
   float64 log-likelihood beats the artifact's, never for a serovalid
   campaign (its re-selection ranks by the plain Poisson LL, which would
   undo the ENE-COVID constraint);
3. the campaign and its diagnostics recorded in ``run_metadata.json``;
4. with ``--report``, the full analysis tree replayed from the new
   posterior (on the card unless ``--device cpu``), then the figures and
   HTML report by ``scripts/post_calibration_analysis.py`` (host-side
   plotting, run as a separate process).

A serovalid campaign is refused for a reference-bounds artifact, and every
input is checked before anything is written.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from .common import REPO_ROOT


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="refresh_artifact",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("campaign", help="campaign output dir (samples.npz + "
                                    "campaign_metadata.json)")
    p.add_argument("--artifact",
                   default=os.path.join(REPO_ROOT, "results", "spain2020"))
    p.add_argument("--draws", type=int, default=50_000,
                   help="posterior subsample size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report", action="store_true",
                   help="regenerate the analysis tree from the new posterior")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where --report replays the draws")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    with open(os.path.join(args.campaign, "campaign_metadata.json")) as f:
        cmeta = json.load(f)
    tr = np.load(os.path.join(args.campaign, "samples.npz"))
    samples, logps = tr["samples"], tr["logps"]        # (T, B, d), (T, B)
    names = [str(n) for n in tr["names"]]
    T, B, d = samples.shape
    flat = samples.reshape(T * B, d)
    flat_lp = logps.reshape(T * B)

    if cmeta.get("serovalid") and "serovalid" not in os.path.basename(
            os.path.normpath(args.artifact)):
        raise SystemExit(
            "refusing: this campaign sampled the serovalid (relaxed-bounds "
            "+ sero-term) problem; promoting it into the reference-bounds "
            "artifact would silently swap the posterior's meaning. Pass "
            "--artifact results/spain2020_serovalid (or similar).")

    diag = cmeta.get("diagnostics", {})
    print(f"campaign: {cmeta.get('sampler')} {T} draws x {B} chains; "
          f"max split-R-hat {diag.get('max_rhat', float('nan')):.3f} "
          f"(rank {diag.get('max_rank_rhat', float('nan')):.3f}), "
          f"min ESS {diag.get('min_ess', float('nan')):.0f}")

    # every input is checked before the artifact changes, so a failure never
    # leaves posterior_samples.npz out of step with the metadata and MAP
    meta_path = os.path.join(args.artifact, "run_metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    camp_map = os.path.join(args.campaign, "calibrated_parameters.txt")
    if not os.path.exists(camp_map):
        raise FileNotFoundError(camp_map)

    rng = np.random.default_rng(args.seed)
    idx = (rng.choice(T * B, size=args.draws, replace=False)
           if T * B > args.draws else np.arange(T * B))
    os.makedirs(args.artifact, exist_ok=True)
    np.savez_compressed(
        os.path.join(args.artifact, "posterior_samples.npz"),
        samples=flat[idx], logls=flat_lp[idx], names=np.asarray(names))
    print(f"posterior_samples.npz: {len(idx)} of {T * B} draws")

    old_ll = float(meta.get("best_logl_float64", -np.inf))
    new_ll = float(cmeta.get("best_logl_float64", -np.inf))
    if cmeta.get("serovalid"):
        # the campaign's re-selection ranks by the plain-Poisson LL; a
        # serovalid artifact's MAP must stay inside the survey CI, so
        # constrained-MAP updates go through serovalid_pipeline instead
        print(f"MAP kept: serovalid artifact (campaign plain-Poisson best "
              f"{new_ll:.8e} not adopted; constrained-MAP updates go "
              "through serovalid_pipeline)")
    elif new_ll > old_ll:
        shutil.copy2(camp_map,
                     os.path.join(args.artifact, "calibrated_parameters.txt"))
        meta["best_logl"] = meta["best_logl_float64"] = new_ll
        print(f"MAP adopted: {new_ll:.8e} (beats committed {old_ll:.8e})")
    else:
        print(f"MAP kept: committed {old_ll:.8e} >= campaign {new_ll:.8e}")

    meta["posterior_source"] = (
        f"{len(idx)} draws subsampled (seed {args.seed}) from the "
        f"{os.path.basename(os.path.normpath(args.campaign))} campaign "
        f"({cmeta.get('sampler')}, {T} post-warmup iterations x {B} chains)")
    meta["campaign"] = {k: cmeta.get(k) for k in
                        ("sampler", "engine", "chains", "iterations",
                         "warmup", "max_tree_depth", "substeps", "tableau",
                         "wall_seconds", "mean_accept", "mean_tree_depth",
                         "seed", "device") if k in cmeta}
    meta["campaign_diagnostics"] = {
        k: diag.get(k) for k in ("max_rhat", "max_rank_rhat", "min_ess",
                                 "min_ess_per_sec") if k in diag}
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    print("run_metadata.json updated")

    if args.report:
        from ..analysis import generate_full_report
        from ..utils.device import resolve_device
        from .common import load_spain_pipeline

        dev = resolve_device(args.device)
        pipe = load_spain_pipeline(REPO_ROOT, device=dev)
        analysis_dir = os.path.join(args.artifact, "analysis")
        # replayed with the integrator settings that produced the posterior
        out = generate_full_report(
            flat[idx], pipe.space, pipe.params, pipe.data, pipe.ts,
            analysis_dir, num_samples_for_ppc=200, batch_size=1024,
            substeps=int(cmeta.get("substeps", 4)),
            tableau=str(cmeta.get("tableau", "dopri5")), seed=args.seed)
        print(f"report over {out['n_draws']} draws -> {analysis_dir}")
        # the figures and analysis_report.html render from the analysis tree
        rc = subprocess.run(
            [sys.executable, os.path.join(REPO_ROOT, "scripts",
                                          "post_calibration_analysis.py"),
             "--input", analysis_dir]).returncode
        if rc != 0:
            print(f"WARNING: figure/HTML regeneration exited rc={rc}")
            return rc
        print("figures + analysis_report.html regenerated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
