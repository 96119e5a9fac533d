"""Production MCMC campaign: a segmented 8192-chain ensemble on the card.

Port of ``scripts/production_campaign.py`` (the JAX repo's campaign driver),
the production counterpart of the reference's 100k-iteration single-chain
run (``data/configuration/mcmc_settings.txt``): an ensemble advances in
checkpointed segments with the fused objective (K1), as adaptive Metropolis,
differential-evolution MCMC (``--proposal de``) or replica exchange
(``--rungs > 1``); every segment's draws go to their own file before the
state checkpoint, so a killed campaign resumes where it stopped and ends
with exactly the uninterrupted campaign's posterior. Then the posterior
trace, split-R-hat / ESS, the full report (unless ``--skip-report``), the
float64 re-selection of the MAP over every chain's best point through K1,
and the re-loadable calibrated parameters.

Files in ``--out``: ``campaign_checkpoint.npz`` (``_pt.npz`` for PT),
``mh_segment_NNNN.npz`` / ``pt_segment_NNNN.npz``, ``posterior_trace.csv``,
``calibrated_parameters.txt``, ``campaign_metadata.json``.

Usage:
    python -m mmidv1_tpu_torch.cli.production_campaign [--chains 8192]
        [--iterations 20000] [--segments 20] [--thinning 500]
        [--out results/spain2020_campaign] [--device cuda]

``--device cpu --num-days 30`` runs the plain versions on the host at a
small size (checks).

Started by a launcher, the AM or DE-MC campaign runs on every rank of its
process group (``parallel.multihost.initialize``: ``nccl`` on cards, one
rank a card, ``gloo`` with ``--device cpu``), each rank on its share of
``--chains``:

    torchrun --nproc-per-node 4 -m mmidv1_tpu_torch.cli.production_campaign \
        --proposal de --chains 32768 --tableau cash_karp --substeps 3

Each rank checkpoints its own shard
(``campaign_checkpoint.rank<r>-of-<W>.npz``) and resumes from it on as many
ranks; rank 0 alone writes the segment files, the trace, the report and the
parameters, from the gathered samples.
Replica exchange (``--rungs > 1``) runs on one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob as glob_mod
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .common import REPO_ROOT

REFERENCE_BEST_LL = 1.41969205e+06


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="production_campaign",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--chains", type=int, default=8192)
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--segments", type=int, default=20)
    p.add_argument("--burn-in", type=int, default=500)
    p.add_argument("--thinning", type=int, default=500)
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5",
                   help="fixed-grid RK tableau; cash_karp with --substeps 3 "
                        "is the JAX package's equal-accuracy fast config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "calibrated_parameters.txt"))
    p.add_argument("--out",
                   default=os.path.join(REPO_ROOT, "results",
                                        "spain2020_campaign"))
    p.add_argument("--skip-report", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--rungs", type=int, default=1,
                   help=">1 switches to replica exchange (parallel "
                        "tempering): --chains chains split over this many "
                        "temperature rungs; posterior = the cold rung")
    p.add_argument("--beta-min", type=float, default=0.05,
                   help="hottest inverse temperature of the geometric ladder")
    p.add_argument("--proposal", default="am", choices=["am", "de"],
                   help="MH proposal family (rungs=1 only): 'am' adaptive "
                        "Metropolis, 'de' differential evolution (walker "
                        "differences, which follow the curved Spain-2020 "
                        "posterior manifold)")
    p.add_argument("--laplace", default=None,
                   help="path to a laplace_mass.npz: start every chain at the "
                        "polished MAP, jitter and propose at the Laplace "
                        "posterior scale, and seed the adaptive-Metropolis "
                        "covariance with the Laplace covariance")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the host")
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


def _segment_posterior(out, prefix, segments):
    """The draws of segments ``0 .. segments-1`` from their files, exactly
    those (stale files of an earlier, larger campaign are reported and
    left out); raises if one is missing."""
    seg_files = [os.path.join(out, f"{prefix}_segment_{s:04d}.npz")
                 for s in range(segments)]
    missing = [f for f in seg_files if not os.path.exists(f)]
    if missing:
        raise SystemExit(f"missing {prefix.upper()} segment files: "
                         f"{missing[:3]}... (pre-resume segments ran without "
                         "persistence?) — rerun without the checkpoint for a "
                         "fresh campaign")
    stale = sorted(set(glob_mod.glob(os.path.join(
        out, f"{prefix}_segment_*.npz"))) - set(seg_files))
    if stale:
        print(f"WARNING: ignoring {len(stale)} stale {prefix}_segment files "
              f"beyond --segments {segments} (e.g. {stale[-1]})")
    xs, lps = [], []
    for f in seg_files:
        with np.load(f) as z:
            xs.append(z["samples"])
            lps.append(z["sample_logps"])
    return np.concatenate(xs, axis=0), np.concatenate(lps, axis=0)


def _save_segment(out, prefix, s, res):
    np.savez_compressed(os.path.join(out, f"{prefix}_segment_{s:04d}.npz"),
                        samples=res.samples.cpu().numpy(),
                        sample_logps=res.sample_logps.cpu().numpy())


def run(argv=None) -> dict:
    """The campaign, as :func:`main` runs it; returns the metadata it writes
    to ``campaign_metadata.json``."""
    args = build_parser().parse_args(argv)

    from ..analysis import generate_full_report
    from ..analysis.diagnostics import summarize
    from ..calibration.calibrator import condition_covariance
    from ..calibration.mh import MHConfig, run_mh_checkpointed
    from ..calibration.param_space import REFLECT
    from ..calibration.tempering import PTConfig, run_pt_checkpointed
    from ..data import read_sepaihrd_parameters, save_calibration_results
    from ..ops import build_objective_fused
    from ..parallel import ensemble_mesh, multihost
    from ..parallel.mesh import LOCAL
    from ..utils.checkpoint import (checkpoint_worlds,
                                    write_posterior_trace)
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    launched = multihost.initialize(device=args.device)
    if launched and args.rungs > 1:
        raise SystemExit("--rungs > 1 runs on one process: parallel tempering "
                         "on a mesh of ranks is not supported; start it "
                         "without a launcher")
    dev = resolve_device(args.device)
    mesh = ensemble_mesh(device=dev) if launched else LOCAL
    primary = mesh.rank == 0
    say = print if primary else (lambda *a, **k: None)
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"device: {dev.type} / {kind}"
        + (f", {mesh.world_size} ranks ({mesh.backend})" if launched else ""))
    pipe = load_spain_pipeline(REPO_ROOT, dtype=dtype, device=dev,
                               num_days=args.num_days)
    data, params, space, ts = pipe.data, pipe.params, pipe.space, pipe.ts

    ll_batch = build_objective_fused(space, params, data, ts,
                                     substeps=args.substeps,
                                     tableau=args.tableau,
                                     constraint_mode=REFLECT, dtype=dtype,
                                     device=dev)
    init = read_sepaihrd_parameters(args.init, 4, N=data.population_by_age,
                                    M_baseline=params.M_baseline.cpu().numpy(),
                                    dtype=dtype, device=dev)
    theta0 = space.extract(init)
    as_t = lambda a: torch.as_tensor(a).to(device=dev, dtype=dtype)

    initial_cov = None
    if args.laplace:
        # Laplace warm start: MAP + curvature-scale init/proposals
        lap = np.load(args.laplace)
        assert list(lap["names"]) == list(space.names)
        std = np.maximum(lap["std"].astype(np.float64), 1e-12)
        theta0 = as_t(lap["theta_map"])
        space = dataclasses.replace(space, sigmas=as_t(std))
        free = lap["free"]
        cov = np.diag(std ** 2)
        cov[np.ix_(free, free)] = lap["cov_free"]
        initial_cov = condition_covariance(as_t(cov), space.sigmas)
        say(f"Laplace warm start from {args.laplace}: MAP LL "
            f"{float(lap['ll_map']):.8e}, {int(free.sum())}/{space.dim} "
            f"free, std range {std.min():.2e}..{std.max():.2e}")
    else:
        # warm proposal covariance from the committed posterior ensemble
        # (same conditioning as the phase-1 -> phase-2 transfer)
        post_path = os.path.join(os.path.dirname(args.init),
                                 "posterior_samples.npz")
        if os.path.exists(post_path):
            with np.load(post_path) as z:
                post = z["samples"].reshape(-1, space.dim)[-50000:]
            initial_cov = condition_covariance(as_t(np.cov(post.T)),
                                               space.sigmas)
            say(f"warm covariance from {post_path} ({post.shape[0]} draws)")

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    swap_rate = None
    if args.rungs > 1:
        # replica-exchange campaign: --chains slots split over the ladder;
        # the returned samples are the cold rung's
        n_per_rung, rem = divmod(args.chains, args.rungs)
        if rem:
            raise SystemExit("--chains must divide evenly by --rungs")
        pt_cfg = PTConfig(iterations=args.iterations, burn_in=args.burn_in,
                          adaptation_period=100, thinning=args.thinning,
                          n_rungs=args.rungs, beta_min=args.beta_min)
        ckpt = os.path.join(args.out, "campaign_checkpoint_pt.npz")
        resumed = os.path.exists(ckpt)
        if resumed:
            with np.load(ckpt) as z:
                print(f"resuming PT campaign at step {int(z['step'])}")
        try:
            # this segment's cold-rung draws beside the checkpoint, written
            # first: a resumed campaign's posterior covers earlier segments
            res = run_pt_checkpointed(
                ll_batch, space, theta0, pt_cfg, seed=args.seed,
                n_chains=n_per_rung, segments=args.segments,
                checkpoint_path=ckpt, initial_cov=initial_cov,
                on_segment=lambda s, r: _save_segment(args.out, "pt", s, r))
        except ValueError as e:
            if "already covers" not in str(e):
                raise
            raise SystemExit("PT checkpoint already covers all segments")
        all_samples, all_logps = _segment_posterior(args.out, "pt",
                                                    args.segments)
        # the ladder still adapts during burn-in: those draws come from a
        # moving kernel and are dropped
        n_burn_draws = min(args.burn_in // args.thinning,
                           all_samples.shape[0] - 1)
        if n_burn_draws:
            print(f"dropping {n_burn_draws} stored burn-in draws "
                  f"(of {all_samples.shape[0]})")
        samples = all_samples[n_burn_draws:]
        sample_logps = all_logps[n_burn_draws:]
        swap_rate = res.swap_rate.cpu().numpy()
        best_x = res.final_state.best_x
        print(f"swap rates per rung pair: {np.round(swap_rate, 3)}")
        print(f"final (adapted) ladder: "
              f"{np.round(res.final_state.betas.cpu().numpy(), 4)}")
        print("per-pair swap-prob EMA: "
              f"{np.round(res.final_state.swap_prob.cpu().numpy(), 3)}")
    else:
        cfg = MHConfig(iterations=args.iterations, burn_in=args.burn_in,
                       adaptation_period=100, thinning=args.thinning,
                       proposal=args.proposal)
        ckpt = os.path.join(args.out, "campaign_checkpoint.npz")
        # a checkpoint of any number of processes makes the campaign not a
        # fresh one: one of another number refuses to resume (ValueError)
        # before anything in the directory is touched
        resumed = bool(checkpoint_worlds(ckpt))
        if not resumed and primary:
            # fresh campaign: segment files of an older run in the same
            # directory must not leak into this posterior
            for f in glob_mod.glob(os.path.join(args.out, "mh_segment_*.npz")):
                os.remove(f)
        res = run_mh_checkpointed(
            ll_batch, space, theta0, cfg, seed=args.seed,
            n_chains=args.chains, segments=args.segments,
            checkpoint_path=ckpt, initial_cov=initial_cov,
            on_segment=((lambda s, r: _save_segment(args.out, "mh", s, r))
                        if primary else None),
            mesh=mesh)
        # every chain's MAP, in rank order (a collective)
        best_x = mesh.all_gather(res.final_state.best_x)
        if not primary:
            dist.destroy_process_group()
            return {}
        if resumed:
            samples, sample_logps = _segment_posterior(args.out, "mh",
                                                       args.segments)
            print(f"resumed posterior reassembled from {args.segments} "
                  f"segment files (pre-resume draws included)")
        else:
            samples = res.samples.numpy()
            sample_logps = res.sample_logps.numpy()
    wall = time.perf_counter() - t0
    # a resumed campaign adds the previous completed run's wall, so
    # chain-steps/s divides total steps (the step includes pre-resume ones)
    # by total time
    prev_meta_path = os.path.join(args.out, "campaign_metadata.json")
    if resumed and os.path.exists(prev_meta_path):
        with open(prev_meta_path) as f:
            wall += float(json.load(f).get("wall_seconds", 0.0))
    steps = res.final_state.step * args.chains
    mean_acc = float(res.acceptance_rate.mean())
    print(f"campaign: {args.iterations} iters x {args.chains} chains in "
          f"{wall:.0f}s ({steps / wall:.3e} chain-steps/s incl. host overhead)")
    print(f"mean acceptance {mean_acc:.3f}")

    write_posterior_trace(os.path.join(args.out, "posterior_trace.csv"),
                          samples, sample_logps, list(space.names))

    # convergence diagnostics over a chain subset (host-side NumPy)
    sub = samples[:, :: max(1, samples.shape[1] // 512), :]
    diag = summarize(sub, list(space.names))
    max_rhat = max(v["rhat"] for v in diag.values())
    min_ess = min(v["ess"] for v in diag.values())
    print(f"convergence: max split-R-hat {max_rhat:.3f}, min ESS "
          f"{min_ess:.0f}")

    if not args.skip_report:
        out = generate_full_report(samples, space, params, data, ts, args.out,
                                   num_samples_for_ppc=200, batch_size=1024,
                                   substeps=args.substeps, seed=args.seed)
        print(f"report over {out['n_draws']} draws -> {args.out}")

    # float64 MAP re-selection across every chain's MAP, through K1 in f64
    # on the same parameters widened to f64
    params64 = params.to(dev, torch.float64)
    ll64 = build_objective_fused(space, params64, data, ts,
                                 substeps=args.substeps, tableau=args.tableau,
                                 constraint_mode=REFLECT, dtype=torch.float64,
                                 device=dev)
    cands = best_x.reshape(-1, space.dim).to(torch.float64)
    lls = ll64(cands).cpu().numpy()
    k = int(np.argmax(lls))
    print(f"float64 MAP over {len(lls)} chains: {float(lls[k]):.8e} "
          f"({'BEATS' if lls[k] > REFERENCE_BEST_LL else 'below'} reference)")

    # the float64 MAP in the re-loadable initial-guess format, for the
    # hillmcmc polish or the next campaign's warm start
    save_calibration_results(
        os.path.join(args.out, "calibrated_parameters.txt"),
        space.apply(params64, cands[k]), list(space.names), float(lls[k]))

    meta = {"chains": args.chains, "iterations": args.iterations,
            "proposal": args.proposal,
            "diagnostics": {"max_rhat": max_rhat, "min_ess": min_ess,
                            "per_parameter": diag},
            "segments": args.segments, "thinning": args.thinning,
            "wall_seconds": wall, "chain_steps_per_sec_incl_host": steps / wall,
            "best_logl_float64": float(lls[k]),
            "mean_acceptance": mean_acc,
            "stored_samples": int(samples.shape[0] * samples.shape[1]),
            "rungs": args.rungs,
            "swap_rate": (None if swap_rate is None
                          else [float(x) for x in swap_rate]),
            "final_ladder": (None if args.rungs <= 1 else
                             [float(b) for b in res.final_state.betas.cpu()]),
            "device": f"{dev.type}/{kind}", "seed": args.seed}
    with open(prev_meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    if launched:
        dist.destroy_process_group()
    return meta


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
