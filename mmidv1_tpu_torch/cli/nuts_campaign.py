"""Production NUTS campaign on the Spain-2020 posterior, on the card.

Port of ``scripts/nuts_campaign.py`` (its ``--engine pallas`` path): the
recipe that produced the committed posterior (``results/spain2020/
run_metadata.json``: ``nuts_logit-dense``, 64 chains, depth 10). Every
leapfrog's value and gradient is one K2 + K3 call over the whole ensemble
(``ops/sepaihrd_adjoint.build_objective_fused_grad``), and the sampler runs
in whitened coordinates of a mass chosen by ``--mass``:

- ``laplace-dense``: the Cholesky factor of the polished MAP's Laplace
  covariance (``map_polish``), chains start at that MAP;
- ``empirical-dense``: the pooled covariance of a previous trace
  (``--trace``), 10 % diagonal shrinkage;
- ``logit-dense``: unconstrained power-logit coordinates with a dense mass
  on y from ``--trace`` (marginal y-stds floored at 0.25, ``--power
  auto`` sets k = 8 where the trace stays below 0.8 of the box);
- ``logit-file``: a precomputed y-space ``mu`` / ``scale`` / ``power``
  (``make_capped_mass``);
- ``laplace``, ``posterior``, ``sigmas``: a diagonal mass (Laplace stds,
  the posterior trace's stds, the proposal sigmas).

``--stages`` refreshes a dense mass from each pre-final stage's post-warmup
draws. The final stage writes each segment's draws to
``partial_samples_NNNN.npz`` before the sampler state (``nuts_state.npz``,
the commit point) and its mass to ``active_mass.npz``; ``--resume``
continues exactly where the last checkpoint stopped (NUTS draws are keyed
by seed and iteration). A live split / rank R-hat monitor can stop the run
early (``--stop-when-converged``); ``--require-rhat`` exits 3 when the end
gate fails. Then ``samples.npz``, ``posterior_trace.csv``, the diagnostics,
the float64 MAP re-selection through K1, ``calibrated_parameters.txt`` and
``campaign_metadata.json``. ``--serovalid`` samples the ENE-COVID-consistent
problem: relaxed bounds plus the sero data term, whose gradient (autograd
through the eager solve) adds onto K2 + K3's.

Usage:
    python -m mmidv1_tpu_torch.cli.nuts_campaign [--chains 512]
        [--iterations 1500] [--warmup 500] [--depth 6] [--segments 30]
        [--mass laplace-dense] [--out results/spain2020_nuts]

``--device cpu --num-days 30`` runs the plain versions on the host at a
small size (checks).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob as glob_mod
import json
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..calibration.nuts import logit_transform
from ._logit_posterior import laplace_cov, logit_mass, power_for, shrink
from .common import REPO_ROOT

REFERENCE_BEST_LL = 1.41969205e+06
DENSE_MODES = ("laplace-dense", "empirical-dense", "logit-dense",
               "logit-file")
LOGIT_MODES = ("logit-dense", "logit-file")
STAGE_WORD = 0x5354   # seeds of the pre-final stages: (seed, STAGE_WORD, stage)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nuts_campaign",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--chains", type=int, default=512)
    p.add_argument("--iterations", type=int, default=1500)
    p.add_argument("--warmup", type=int, default=500,
                   help="dual-averaging adaptation window (iterations)")
    p.add_argument("--depth", type=int, default=6, help="max tree depth")
    p.add_argument("--delta-target", type=float, default=0.8,
                   help="dual-averaging acceptance target")
    p.add_argument("--eps-floor", type=float, default=0.0,
                   help="lower clamp on the adapted step (whitened units)")
    p.add_argument("--eps-ceil", type=float, default=float("inf"),
                   help="upper clamp on the adapted step (whitened units)")
    p.add_argument("--posterior-burn-frac", type=float, default=0.5,
                   help="fraction of the post-warmup draws also discarded "
                        "from the posterior and its diagnostics")
    p.add_argument("--posterior-burn-iters", type=int, default=0,
                   help="absolute post-warmup burn-in (overrides "
                        "--posterior-burn-frac when > 0; capped at 90%% of "
                        "the post-warmup draws)")
    p.add_argument("--segments", type=int, default=30,
                   help="checkpointed segments of the final stage")
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5")
    p.add_argument("--jitter", type=float, default=1.0)
    p.add_argument("--mass", default="laplace-dense",
                   choices=["laplace-dense", "laplace", "posterior", "sigmas",
                            "empirical-dense", "logit-dense", "logit-file"])
    p.add_argument("--power", default="1",
                   help="power-logit exponent for logit-dense: 'auto' or a "
                        "number")
    p.add_argument("--mass-file", default=None,
                   help="y-space mass .npz (mu / scale / power, from "
                        "make_capped_mass) for --mass logit-file")
    p.add_argument("--trace", default=None,
                   help="samples.npz of a previous campaign (empirical-dense "
                        "and logit-dense masses)")
    p.add_argument("--warm", default=None,
                   help="samples.npz whose final iteration warm-starts the "
                        "ensemble")
    p.add_argument("--resume", action="store_true",
                   help="continue a checkpointed run from <out>/nuts_state.npz "
                        "and its partial sample files")
    p.add_argument("--posterior",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "posterior_samples.npz"))
    p.add_argument("--laplace",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "laplace_mass.npz"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "calibrated_parameters.txt"))
    p.add_argument("--out",
                   default=os.path.join(REPO_ROOT, "results", "spain2020_nuts"))
    p.add_argument("--stages", type=int, default=1,
                   help="mass-refinement ladder depth (dense modes only)")
    p.add_argument("--stage-iterations", type=int, default=0,
                   help="iterations per pre-final stage (0 -> 2x --warmup)")
    p.add_argument("--report", action="store_true",
                   help="write the full analysis tree from the posterior")
    p.add_argument("--require-rhat", type=float, default=0.0,
                   help="exit 3 unless both max split-R-hat and max "
                        "rank-normalized R-hat land under this bar (0: no "
                        "gate)")
    p.add_argument("--stop-when-converged", type=int, default=0,
                   help="stop the final stage once the burned-window worst "
                        "split- and rank-R-hat stayed below the stop bar for "
                        "this many consecutive segments (0: never)")
    p.add_argument("--serovalid", action="store_true",
                   help="sample the ENE-COVID-consistent problem: variant-C "
                        "relaxed bounds plus the sero data term")
    p.add_argument("--sero-se", type=float, default=0.0028,
                   help="sero-term standard error (serovalid mode)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the host (plain versions)")
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


class Mass(NamedTuple):
    """A mass choice in float64 NumPy: ``mu`` / ``scale`` of a dense mass
    (theta or y units), ``power`` of the logit modes, ``theta0`` (start of
    the non-logit modes), ``sigmas`` (the diagonal modes' whitening)."""

    mu: Optional[np.ndarray]
    scale: Optional[np.ndarray]
    power: Optional[np.ndarray]
    theta0: Optional[np.ndarray]
    sigmas: Optional[np.ndarray]


def _load_names_checked(path, names):
    z = np.load(path)
    if [str(n) for n in z["names"]] != list(names):
        raise SystemExit(f"{path}: parameter names do not match the space")
    return z


def build_mass(args, names, lo: np.ndarray, hi: np.ndarray,
               theta0: np.ndarray) -> Mass:
    """The mass of ``args.mass`` (``scripts/nuts_campaign.py:309-400``)."""
    d = len(names)
    mode = args.mass
    if mode == "posterior":
        post = _load_names_checked(args.posterior, names)
        std = post["samples"].std(axis=0, ddof=1).astype(np.float64)
        std = np.maximum(std, 1e-12)
        print(f"mass matrix: diag posterior stds from {args.posterior} "
              f"(range {std.min():.2e}..{std.max():.2e})")
        return Mass(None, None, None, theta0, std)
    if mode in ("laplace", "laplace-dense"):
        lap = _load_names_checked(args.laplace, names)
        std = np.maximum(lap["std"].astype(np.float64), 1e-12)
        theta_map = lap["theta_map"].astype(np.float64)
        print(f"mass matrix: Laplace ({mode}) from {args.laplace} (std range "
              f"{std.min():.2e}..{std.max():.2e}); chains start at the "
              f"polished MAP (LL {float(lap['ll_map']):.8e})")
        if mode == "laplace":
            return Mass(None, None, None, theta_map, std)
        return Mass(theta_map, np.linalg.cholesky(laplace_cov(lap)),
                    None, theta_map, None)
    if mode == "empirical-dense":
        if not args.trace:
            raise SystemExit("--mass empirical-dense needs --trace samples.npz")
        tr = _load_names_checked(args.trace, names)
        flat = tr["samples"].reshape(-1, d).astype(np.float64)
        cov = shrink(np.cov(flat, rowvar=False))
        theta_map = np.load(args.laplace)["theta_map"].astype(np.float64)
        print(f"mass matrix: dense empirical covariance of {args.trace} "
              f"({flat.shape[0]} draws; marginal-std range "
              f"{np.sqrt(np.diag(cov)).min():.2e}.."
              f"{np.sqrt(np.diag(cov)).max():.2e})")
        return Mass(theta_map, np.linalg.cholesky(cov), None, theta_map, None)
    if mode == "logit-dense":
        if not args.trace:
            raise SystemExit("--mass logit-dense needs --trace samples.npz")
        tr = _load_names_checked(args.trace, names)
        flat = tr["samples"].reshape(-1, d).astype(np.float64)
        power_k = power_for(flat, lo, hi, args.power)
        if args.power == "auto":
            print(f"power-logit: k=8 (log-like) for "
                  f"{int((power_k > 1).sum())}/{d} parameters, k=1 for the "
                  f"rest")
        mu_y, cov = logit_mass(logit_transform(flat, lo, hi, power=power_k))
        print(f"mass matrix: logit-space dense covariance of {args.trace} "
              f"({flat.shape[0]} draws; y-marginal-std range "
              f"{np.sqrt(np.diag(cov)).min():.2e}.."
              f"{np.sqrt(np.diag(cov)).max():.2e})")
        return Mass(mu_y, np.linalg.cholesky(cov), power_k, None, None)
    if mode == "logit-file":
        if not args.mass_file:
            raise SystemExit("--mass logit-file needs --mass-file mass.npz")
        mf = _load_names_checked(args.mass_file, names)
        scale = mf["scale"].astype(np.float64)
        power_k = (mf["power"].astype(np.float64) if "power" in mf.files
                   else np.ones(d))
        sd = np.sqrt((scale ** 2).sum(axis=1))
        print(f"mass matrix: precomputed logit-space factor {args.mass_file} "
              f"(y-marginal-std range {sd.min():.2e}..{sd.max():.2e})")
        return Mass(mf["mu"].astype(np.float64), scale, power_k, None, None)
    return Mass(None, None, None, theta0, None)          # sigmas


def warm_ensemble(path: str, n_chains: int) -> np.ndarray:
    """The final iteration of a trace, cut or tiled to ``n_chains`` rows."""
    last = np.load(path)["samples"][-1]
    if last.shape[0] >= n_chains:
        return last[:n_chains]
    reps = -(-n_chains // last.shape[0])
    return np.tile(last, (reps, 1))[:n_chains]


def stage_seed(seed: int, stage: int) -> int:
    """The seed of pre-final stage ``stage`` (0-based): a pure function of
    ``(seed, stage + 1)`` that differs from the final stage's ``seed``."""
    s = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, STAGE_WORD,
                                stage + 1]).generate_state(2, np.uint32)
    return int(s[0]) | (int(s[1]) << 32)


def burn_window(total_t: int, warmup: int, burn_iters: int,
                burn_frac: float):
    """The first kept iteration of a ``total_t``-iteration trace and the
    policy's description."""
    if burn_iters > 0:
        burn = warmup + min(burn_iters, int(0.9 * max(0, total_t - warmup)))
        desc = f"absolute --posterior-burn-iters {burn_iters}"
    else:
        burn = warmup + int(burn_frac * max(0, total_t - warmup))
        desc = f"{burn_frac:.0%} of {total_t - warmup}"
    return burn, desc


def reconcile_partials(seg_files, it_ck: int, error):
    """Load the partial files and cut them back to the checkpoint's
    ``it_ck`` iterations: draws written after the last state save are
    dropped, in memory and on disk; fewer draws than ``it_ck`` (a hole)
    calls ``error``. Returns ``(xs, lps)`` lists."""
    xs, lps = [], []
    for f in seg_files:
        with np.load(f) as z:
            xs.append(z["samples"])
            lps.append(z["logps"])
    total = sum(x.shape[0] for x in xs)
    if total > it_ck:
        drop = total - it_ck
        print(f"dropping {drop} uncheckpointed draws (crash between partial "
              f"write and state save)")
        while drop > 0 and xs:
            take = min(drop, xs[-1].shape[0])
            keep = xs[-1].shape[0] - take
            src = seg_files[len(xs) - 1]
            if keep == 0:
                xs.pop()
                lps.pop()
                os.remove(src)
            else:
                xs[-1], lps[-1] = xs[-1][:keep], lps[-1][:keep]
                np.savez(src + ".rewrite", samples=xs[-1], logps=lps[-1])
                os.replace(src + ".rewrite.npz", src)
            drop -= take
    elif total < it_ck:
        error(f"--resume: partial files hold {total} iterations but the "
              f"checkpoint is at {it_ck}; the trace has a hole and cannot be "
              f"reconstructed — restart without --resume")
    return xs, lps


class LiveMonitor:
    """The final stage's live convergence read after each segment: a
    <= 128-chain subset of every segment kept, split R-hat of the
    post-warmup draws and of the burned window (the slice the end gate
    sees), rank R-hat once split is within 0.03 of the stop bar, and the
    early-stop streak (``--stop-when-converged``)."""

    def __init__(self, names, args, prev_xs=()):
        self.names, self.args = names, args
        self.xs = [self._subset(x) for x in prev_xs]
        self.streak = 0

    @staticmethod
    def _subset(x):
        return x[:, :: max(1, x.shape[1] // 128), :]

    def update(self, xs: np.ndarray, it: int) -> bool:
        """Add a segment's draws; True asks the sampler to stop."""
        from ..analysis.diagnostics import rank_normalized_rhat, split_rhat

        a = self.args
        self.xs.append(self._subset(xs))
        acc = np.concatenate(self.xs, axis=0)
        if acc.shape[0] <= a.warmup + 20:
            return False
        r = split_rhat(acc[a.warmup:])
        worst = np.argsort(-r)[:3]
        stat = ", ".join(f"{self.names[j]} {r[j]:.2f}" for j in worst)
        nb, _ = burn_window(acc.shape[0], a.warmup, a.posterior_burn_iters,
                            a.posterior_burn_frac)
        rb = split_rhat(acc[nb:]) if acc.shape[0] - nb > 20 else r
        # the stop keys on split and rank R-hat of the burned window, as the
        # end gate does; the margin is on the excess over 1.0
        stop_bar = 1.0 + 0.98 * (a.require_rhat - 1.0)
        rkb = None
        if (a.require_rhat > 1.0 and acc.shape[0] - nb > 20
                and float(np.max(rb)) < stop_bar + 0.03):
            rkb = float(np.max(rank_normalized_rhat(acc[nb:])))
        print(f"  [seg @ iter {it}] worst split-R-hat: {stat} | "
              f"burned-window worst {float(np.max(rb)):.2f}"
              + (f" (rank {rkb:.2f})" if rkb is not None else ""), flush=True)
        if (a.stop_when_converged > 0 and a.require_rhat > 1.0
                and acc.shape[0] - nb >= 100 and rkb is not None
                and max(float(np.max(rb)), rkb) < stop_bar):
            self.streak += 1
            if self.streak >= a.stop_when_converged:
                print(f"  [seg @ iter {it}] EARLY STOP: burned-window worst "
                      f"split- and rank-R-hat under {stop_bar:.3f} for "
                      f"{self.streak} consecutive segments", flush=True)
                return True
        else:
            self.streak = 0
        return False


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.stages > 1 and args.mass not in DENSE_MODES:
        p.error("--stages > 1 requires a dense mass mode")
    if args.stages > 1 and (args.stage_iterations
                            or 2 * args.warmup) <= args.warmup:
        p.error("--stage-iterations must exceed --warmup: each pre-final "
                "stage re-estimates the mass from its post-warmup draws")
    if args.resume and args.stages > 1:
        p.error("--resume continues a single-stage run; rerun the final "
                "stage alone (its mass is already on disk via --trace)")
    state_path = os.path.join(args.out, "nuts_state.npz")
    if args.resume:
        # the checkpointed state lives in the z-coordinates of a dense mass;
        # a whitened-mode resume would restart silently
        if args.mass not in DENSE_MODES:
            p.error("--resume requires a dense mass mode (laplace-dense / "
                    "empirical-dense / logit-dense / logit-file)")
        if not os.path.exists(state_path):
            p.error(f"--resume: no checkpoint at {state_path}")

    from ..analysis import generate_full_report
    from ..analysis.diagnostics import summarize
    from ..calibration.nuts import (NUTSConfig, run_nuts_dense,
                                    run_nuts_logit, run_nuts_whitened)
    from ..calibration.param_space import REFLECT
    from ..data import read_sepaihrd_parameters, save_calibration_results
    from ..ops import build_objective_fused, build_objective_fused_grad
    from ..utils.checkpoint import (load_nuts_state, save_nuts_state,
                                    write_posterior_trace)
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    dev = resolve_device(args.device)
    dtype = torch.float32
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} / {kind}")
    pipe = load_spain_pipeline(REPO_ROOT, dtype=dtype, device=dev,
                               num_days=args.num_days)
    data, params, space, ts = pipe.data, pipe.params, pipe.space, pipe.ts
    as_t = lambda a: torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    if args.serovalid:
        from ..calibration.serovalid import (add_sero_term,
                                             make_sero_penalty, relax_bounds)
        space, relaxed_idx = relax_bounds(space)
    vag = build_objective_fused_grad(space, params, data, ts,
                                     substeps=args.substeps,
                                     tableau=args.tableau,
                                     constraint_mode=REFLECT, dtype=dtype,
                                     device=dev)
    if args.serovalid:
        pen = make_sero_penalty(space, params, data, ts,
                                substeps=args.substeps, tableau=args.tableau,
                                se=args.sero_se, constraint_mode=REFLECT,
                                dtype=dtype, device=dev)
        # K2 + K3 give the Poisson stream's value and gradient, autograd
        # through the eager solve the sero term's
        vag = add_sero_term(vag, pen)
        print(f"serovalid mode: variant-C relaxed bounds "
              f"({len(relaxed_idx)} parameters) + ENE-COVID sero term "
              f"(se {args.sero_se})")
        print("gradient engine: K2 + K3 kernels + autograd sero-term grads")
    else:
        print("gradient engine: K2 + K3 kernels" if dev.type == "cuda"
              else "gradient engine: K2 + K3 plain versions (host)")

    names = list(space.names)
    lo_np = space.lower.cpu().numpy().astype(np.float64)
    hi_np = space.upper.cpu().numpy().astype(np.float64)
    init = read_sepaihrd_parameters(args.init, 4, N=data.population_by_age,
                                    M_baseline=params.M_baseline.cpu().numpy(),
                                    dtype=dtype, device=dev)
    theta0_np = space.extract(init).cpu().numpy().astype(np.float64)
    mass = build_mass(args, names, lo_np, hi_np, theta0_np)
    mu_np, dense_scale, power_k, theta0 = (mass.mu, mass.scale, mass.power,
                                           mass.theta0)
    if mass.sigmas is not None:
        space = dataclasses.replace(space, sigmas=as_t(mass.sigmas))

    warm_init = None
    if args.warm:
        warm_init = warm_ensemble(args.warm, args.chains)
        print(f"warm start: ensemble from the final iteration of {args.warm}")

    cfg = NUTSConfig(iterations=args.iterations,
                     adaptation_window=args.warmup, max_tree_depth=args.depth,
                     delta_target=args.delta_target, eps_floor=args.eps_floor,
                     eps_ceil=args.eps_ceil)

    # the z-state decodes only under the mass active when it was written, and
    # stages refresh the mass: the final stage's mass persists beside it
    os.makedirs(args.out, exist_ok=True)
    mass_path = os.path.join(args.out, "active_mass.npz")
    partial_path = os.path.join(args.out, "partial_samples.npz")

    def save_active_mass(mu, scale, power=None):
        kw = dict(names=np.asarray(names), mu=np.asarray(mu, np.float64),
                  scale=np.asarray(scale, np.float64))
        if power is not None:
            kw["power"] = np.asarray(power, np.float64)
        tmp = mass_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **kw)
        os.replace(tmp, mass_path)

    prev_xs, prev_lps = [], []
    initial_state = None
    seg_glob = os.path.join(args.out, "partial_samples_[0-9]*.npz")
    if args.resume:
        seg_files = sorted(glob_mod.glob(seg_glob))
        if os.path.exists(partial_path):      # a cumulative file is oldest
            seg_files.insert(0, partial_path)
        if not seg_files:
            p.error(f"--resume: checkpoint exists but no partial samples in "
                    f"{args.out}; cannot reconstruct the full trace")
        initial_state = load_nuts_state(state_path, device=dev)
        if os.path.exists(mass_path):
            with np.load(mass_path) as mz:
                if [str(n) for n in mz["names"]] != names:
                    p.error(f"{mass_path}: parameter names do not match")
                if args.mass in LOGIT_MODES:
                    mu_np = mz["mu"].astype(np.float64)
                    if "power" in mz.files:
                        power_k = mz["power"].astype(np.float64)
                else:
                    mu_np = theta0 = mz["mu"].astype(np.float64)
                dense_scale = mz["scale"].astype(np.float64)
            print("resume: active mass restored from active_mass.npz (the "
                  "checkpointed z-state decodes only under it)")
        else:
            if args.mass in LOGIT_MODES:
                p.error(f"--resume: {mass_path} is missing and the logit "
                        "z-checkpoint cannot be decoded without the exact "
                        "active mass; restore the file or restart")
            print("WARNING: resume without active_mass.npz — falling back to "
                  "the mass recomputed from the inputs; if the original run "
                  "refreshed its mass (--stages) every chain position shifts. "
                  "Writing the file so the next resume is protected.",
                  flush=True)
            save_active_mass(as_t(theta0).cpu().numpy(), dense_scale)
        prev_xs, prev_lps = reconcile_partials(seg_files,
                                               int(initial_state.it), p.error)
        print(f"resuming from iteration {int(initial_state.it)} "
              f"({len(prev_xs)} partial files)")
    else:
        # a fresh run must not inherit another campaign's partial files or
        # its mass
        for f in [mass_path, partial_path] + glob_mod.glob(seg_glob) \
                + glob_mod.glob(os.path.join(args.out, ".tmp_partial_*.npz")):
            if os.path.exists(f):
                os.remove(f)

    seg_counter = {"n": len(prev_xs)}
    monitor = LiveMonitor(names, args, prev_xs)

    def on_segment(state, xs, lps):
        xs, lps = xs.cpu().numpy(), lps.cpu().numpy()
        prev_xs.append(xs)
        prev_lps.append(lps)
        # the partial file first, the state last: the state is the commit
        # point, so a crash between them leaves one extra partial that
        # --resume drops; the dot-prefixed name never matches its glob
        n = seg_counter["n"]
        f = os.path.join(args.out, f"partial_samples_{n:04d}.npz")
        tmp = os.path.join(args.out, f".tmp_partial_{n:04d}.npz")
        np.savez(tmp, samples=xs, logps=lps)
        os.replace(tmp, f)
        save_nuts_state(state_path, state)
        seg_counter["n"] += 1
        return monitor.update(xs, int(state.it))

    def stage_cfg(iters):
        return dataclasses.replace(cfg, iterations=iters)

    stage_iters = args.stage_iterations or 2 * args.warmup
    warm_t = None if warm_init is None else as_t(warm_init)
    t0 = time.perf_counter()
    if args.mass in LOGIT_MODES:
        power_t = as_t(power_k)
        for stage in range(args.stages - 1):
            res = run_nuts_logit(
                None, space, stage_cfg(stage_iters), mu=as_t(mu_np),
                scale=as_t(dense_scale), seed=stage_seed(args.seed, stage),
                n_chains=args.chains, jitter=args.jitter,
                value_and_grad_batch=vag, init=warm_t, power=power_t,
                segments=max(1, args.segments * stage_iters
                             // max(args.iterations, 1)))
            draws = res.samples[args.warmup:].cpu().numpy().reshape(
                -1, space.dim).astype(np.float64)
            mu_np, cov_s = logit_mass(logit_transform(draws, lo_np, hi_np,
                                                      power=power_k))
            dense_scale = np.linalg.cholesky(cov_s)
            warm_t = res.samples[-1]
            print(f"stage {stage + 1}/{args.stages}: logit-space mass "
                  f"refreshed from {draws.shape[0]} draws (y-marginal-std "
                  f"range {np.sqrt(np.diag(cov_s)).min():.2e}.."
                  f"{np.sqrt(np.diag(cov_s)).max():.2e})", flush=True)
        if not args.resume:
            save_active_mass(mu_np, dense_scale, power_k)
        res = run_nuts_logit(None, space, cfg, mu=as_t(mu_np),
                             scale=as_t(dense_scale), seed=args.seed,
                             n_chains=args.chains, jitter=args.jitter,
                             value_and_grad_batch=vag, segments=args.segments,
                             init=warm_t, initial_state=initial_state,
                             on_segment=on_segment, power=power_t)
    elif args.mass in DENSE_MODES:
        # the mass-refinement ladder: each pre-final stage re-estimates the
        # dense mass from its post-warmup draws and warm-starts the next
        mu_t = as_t(theta0)
        for stage in range(args.stages - 1):
            res = run_nuts_dense(
                None, space, stage_cfg(stage_iters), mu=mu_t,
                scale=as_t(dense_scale), seed=stage_seed(args.seed, stage),
                n_chains=args.chains, jitter=args.jitter,
                value_and_grad_batch=vag, init=warm_t,
                segments=max(1, args.segments // 4))
            draws = res.samples[args.warmup:].cpu().numpy().reshape(
                -1, space.dim).astype(np.float64)
            cov_emp = np.cov(draws, rowvar=False)
            dense_scale = np.linalg.cholesky(shrink(cov_emp))
            warm_t = res.samples[-1]
            print(f"stage {stage + 1}/{args.stages}: mass refreshed from "
                  f"{draws.shape[0]} draws (marginal-std range "
                  f"{np.sqrt(np.diag(cov_emp)).min():.2e}.."
                  f"{np.sqrt(np.diag(cov_emp)).max():.2e})", flush=True)
        if not args.resume:
            save_active_mass(mu_t.cpu().numpy(), dense_scale)
        res = run_nuts_dense(None, space, cfg, mu=mu_t,
                             scale=as_t(dense_scale), seed=args.seed,
                             n_chains=args.chains, jitter=args.jitter,
                             value_and_grad_batch=vag, segments=args.segments,
                             init=warm_t, initial_state=initial_state,
                             on_segment=on_segment)
    else:
        # a warm ensemble goes in as a 2-D theta0
        res = run_nuts_whitened(None, space,
                                as_t(theta0) if warm_t is None else warm_t,
                                cfg, seed=args.seed, n_chains=args.chains,
                                jitter=args.jitter, value_and_grad_batch=vag,
                                segments=args.segments)
    samples_all = res.samples.cpu().numpy()
    wall_proc = time.perf_counter() - t0
    # a resumed run adds the previous completed run's wall
    wall = wall_proc
    prev_meta_path = os.path.join(args.out, "campaign_metadata.json")
    if args.resume and os.path.exists(prev_meta_path):
        try:
            with open(prev_meta_path) as f:
                wall += float(json.load(f).get("wall_seconds", 0.0))
        except (OSError, ValueError):
            pass
    logps_all = res.sample_logps.cpu().numpy()
    if prev_xs:          # the whole history, pre-resume parts included
        samples_all = np.concatenate(prev_xs, axis=0)
        logps_all = np.concatenate(prev_lps, axis=0)
    # every iteration runs its trees to full depth: 2^depth value_and_grad
    # calls over the ensemble
    iters_run = args.iterations - (int(initial_state.it)
                                   if initial_state is not None else 0)
    grads = max(iters_run, 1) * (2 ** args.depth) * args.chains
    mean_accept = float(res.mean_accept.mean())
    mean_depth = float(res.mean_depth.mean())
    print(f"campaign: {args.iterations} iters x {args.chains} chains in "
          f"{wall_proc:.0f}s this process ({grads / wall_proc:.3e} "
          f"value_and_grads/s incl. host; {wall:.0f}s campaign total)")
    print(f"mean accept-stat {mean_accept:.3f}; median step size "
          f"{float(res.step_sizes.median()):.4f} (whitened units); mean tree "
          f"depth {mean_depth:.2f}/{args.depth}")

    total_t = int(samples_all.shape[0])
    burn, burn_desc = burn_window(total_t, args.warmup,
                                  args.posterior_burn_iters,
                                  args.posterior_burn_frac)
    burn = min(burn, max(total_t - 8, args.warmup))
    if burn > args.warmup:
        print(f"posterior: discarding {burn - args.warmup} post-warmup "
              f"burn-in draws ({burn_desc}); keeping {total_t - burn}")
    samples = samples_all[burn:]
    logps = logps_all[burn:]
    np.savez_compressed(os.path.join(args.out, "samples.npz"),
                        samples=samples, logps=logps, names=np.array(names))
    write_posterior_trace(os.path.join(args.out, "posterior_trace.csv"),
                          samples, logps, names)

    sub = samples[:, :: max(1, samples.shape[1] // 512), :]
    diag = summarize(sub, names)
    max_rhat = max(v["rhat"] for v in diag.values())
    max_rank_rhat = max(v["rank_rhat"] for v in diag.values())
    min_ess = min(v["ess"] for v in diag.values())
    print(f"convergence: max split-R-hat {max_rhat:.3f} (rank-normalized "
          f"{max_rank_rhat:.3f}), min ESS {min_ess:.0f} -> min-ESS/s "
          f"{min_ess / wall:.2f}")

    if args.report:
        out = generate_full_report(samples, space, params, data, ts, args.out,
                                   num_samples_for_ppc=200, batch_size=1024,
                                   substeps=args.substeps,
                                   tableau=args.tableau, seed=args.seed)
        print(f"report over {out['n_draws']} draws -> {args.out}")

    # float64 MAP re-selection over the best chain's point and the top 256
    # draws, through K1 in float64 (float32's noise floor is ~1e2 at 1.4e6)
    params64 = params.to(dev, torch.float64)
    ll64 = build_objective_fused(space, params64, data, ts,
                                 substeps=args.substeps, tableau=args.tableau,
                                 constraint_mode=REFLECT, dtype=torch.float64,
                                 device=dev)
    flat = samples.reshape(-1, space.dim)
    top = flat[np.argsort(logps.reshape(-1))[-256:]]
    cands = torch.as_tensor(np.concatenate(
        [res.best_x.cpu().numpy()[None], top], axis=0)).to(
        device=dev, dtype=torch.float64)
    lls = ll64(cands).cpu().numpy()
    k = int(np.argmax(lls))
    print(f"float64 MAP over {len(lls)} candidates: {float(lls[k]):.8e} "
          f"({'BEATS' if lls[k] > REFERENCE_BEST_LL else 'below'} reference)")
    save_calibration_results(
        os.path.join(args.out, "calibrated_parameters.txt"),
        space.apply(params64, cands[k]), names, float(lls[k]))

    meta = {"sampler": f"nuts_{args.mass}",
            "engine": "cuda" if dev.type == "cuda" else "plain",
            "chains": args.chains, "iterations": args.iterations,
            "warmup": args.warmup, "max_tree_depth": args.depth,
            "substeps": args.substeps, "tableau": args.tableau,
            "wall_seconds": wall,
            "value_and_grads_per_sec_incl_host": grads / wall_proc,
            "mean_accept": mean_accept, "mean_tree_depth": mean_depth,
            "best_logl_float64": float(lls[k]),
            "diagnostics": {"max_rhat": max_rhat,
                            "max_rank_rhat": max_rank_rhat,
                            "min_ess": min_ess,
                            "min_ess_per_sec": min_ess / wall,
                            "per_parameter": diag},
            "posterior_burn": {"iters": burn - args.warmup,
                               "policy": burn_desc, "kept": total_t - burn},
            "seed": args.seed, "device": f"{dev.type}/{kind}"}
    if args.serovalid:
        # logps in samples.npz are the joint (Poisson + sero) density;
        # best_logl_float64 stays plain Poisson
        from ..calibration.serovalid import (RUNUP_LO, SEED_CAP,
                                             SEVERITY_FLOOR_DIV)
        meta["serovalid"] = {"sero_se": args.sero_se, "seed_cap": SEED_CAP,
                             "runup_lo": RUNUP_LO,
                             "severity_floor_div": SEVERITY_FLOOR_DIV}
    with open(prev_meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    print(f"artifacts -> {args.out}")
    if args.require_rhat > 0:
        if max(max_rhat, max_rank_rhat) >= args.require_rhat:
            print(f"CONVERGENCE GATE FAILED: max(split {max_rhat:.3f}, rank "
                  f"{max_rank_rhat:.3f}) >= {args.require_rhat}")
            # 3, not argparse's 2: "ran, not converged" (extend with
            # --resume) differs from "bad invocation"
            return 3
        print(f"convergence gate passed (< {args.require_rhat})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
