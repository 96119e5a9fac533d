#!/usr/bin/env python3
"""Drive the PyTorch port's Spain-2020 calibration paths on one NVIDIA card.

    python3 chip_smoke.py          # everything; the last line says ok
    python3 chip_smoke.py --k3     # build, then phases 7 and 8 only (no ok line)
    python3 chip_smoke.py --fwd    # build, then phase 2b only: K1 and K2 (no ok line)
    python3 chip_smoke.py --main   # build, then phases 12-14 only (no ok line)
    python3 chip_smoke.py --campaign  # build, then phases 15-17 only (no ok line)
    python3 chip_smoke.py --sir    # build, then phases 18-21 only (no ok line)
    python3 chip_smoke.py --parallel  # build, then phase 22 only (no ok line)

Phases (any failure exits non-zero before the final line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of ``mmidv1_tpu_torch/csrc`` from source, one
     nvcc per source, all at once (K1; K2 and K3);
  2b. the forward kernels K1 and K2 in their two regimes (split: the
     infection subsystem on producer warps, the linear rows and the fold on
     consumer warps; wide: one thread per (chain, age)): ptxas (registers,
     spills, shared memory), the SASS instruction count of the substep loop
     (cuobjdump), the SM clock under load, each regime forced and held
     against the plain version at B = 64, 1024 and 8192 in float32 (rtol
     5e-6) and float64 (rtol 1e-10) and against the other regime (to the
     bit: any value that differs fails), timed in turns (wide, split, split,
     wide; CUDA events over 10 launches), both regimes over B = 64 ... 8192,
     3072 included (the crossover behind `choose_forward_regime`), and for
     each the ns per dependent RK stage beside the chain bound (stages x the
     cycles a stage of the recurrence's longest dependency cycle / the SM
     clock);
  3. hold K1 (the fused SEPAIHRD objective) against its plain PyTorch
     version on the card, at the full Spain-2020 width (62 parameters,
     325 daily intervals, 7 schedule runs): B = 8192 chains in float64
     (rtol 1e-10) and float32 (rtol 5e-6: every reading on an H100 was
     below 1e-6), dopri5@4 and cash_karp@3, plus the main path's
     own shape (1024 chains, float32, dopri5@4); a few chains carry a NaN
     parameter and must come out as NaN from both and as finfo.min from
     the objective; time the kernel (CUDA events) and the plain version;
  4. evaluate the committed float64 MAP through K1:
     1432889.7908967654 at rtol 1e-10;
  5. the PSO -> AM-MH path, ``mmidv1_tpu_torch.cli.calibrate_spain``,
     psomcmc in float32 (512 PSO particles x 5 iterations, then AM-MH with
     1024 chains x 100 steps), K1's launch count set to 0 just before and
     read just after: the 100 MH steps must have run in the regime the rule
     picks at 1024 chains;
  6. hold K2 (forward with checkpoints) against its plain version: LL and
     checkpoints at B = 8192, f64 rtol 1e-10 and f32 rtol 5e-6;
  7. hold K3 (the adjoint) against its plain version (autograd through the
     plain forward, whose saved tensors limit it to B = 512): all four
     gradient outputs, f64 rtol 1e-9 with an absolute floor of 1e-9 x the
     chain's largest entry, f32 per-chain relative 2-norm <= 1e-3; NaN
     chains come out NaN from both and finfo.min from value_and_grad. K3
     has two regimes (chunk-parallel for few chains, one sweep for many):
     the one its rule picks and each one forced are all held;
  8. time K2 and K3 (CUDA events) at B = 8192 and at the NUTS path's
     B = 64, f32 and f64, beside their op-count bounds, K3 in the regime
     its rule picks and in each regime forced; at B = 64, on
     CLAMP-prepared inputs as NUTS gives them, also hold both against their
     plain versions with the tolerances of phases 6 and 7, and read from
     torch.profiler K3's time by stage and how long a value_and_grad keeps
     the card busy; then time both regimes over B = 64 ... 2048 in f32 and
     f64, with 320, 384 and 448 between (the crossover behind the rule);
  9. the gradient anchor in float64: at the committed MAP + 0.05 sigma
     noise, value_and_grad against a central difference of K1 along a
     random sigma-scaled direction (step 1e-4 sigma, rtol 1e-4), and its
     value against K1's (rtol 1e-12);
 10. the NUTS path, ``calibrate_spain`` with ``--algorithm nuts --full``
     (64 chains, nuts_settings.txt: 25 iterations of depth 3), float32,
     with the K1/K2/K3 launch counts set to 0 just before and read after:
     every K2 and K3 call must run in the regime its rule picks at 64
     chains, K3 launching that regime's kernels;
 11. two short MALA runs through the same K2/K3 engine, float32, launches
     counted from 0: 64 chains x 20 iterations (K3's regime 1), and 1024
     chains x 5 iterations, above the crossover, where every K3 call must
     run in regime 2;
 12. the primary executable, ``cli.sepaihrd_main``, on the card in float32,
     dopri5@4, on the full Spain-2020 grid. First K1 is held against its
     plain version (as in phase 3) at the hill climber's shapes, taken from
     ``HillClimbConfig`` as the entry point builds it: its start (1 chain),
     its cloud and its two line-search ladders; then ``--algorithm hillmcmc
     --chains 1024 --scale MAIN_SCALE`` with K1's launch counts set to 0
     just before and read after, by chain count and regime (the hill
     climber's cloud and its two line-search ladders, and the 1024-chain
     MH, each in the regime the rule picks for its chain count), best >=
     initial, the files of ``tests/test_cli.py:170-175``, a finite R0; the
     hill climber's seconds per iteration and the report's; then
     ``--algorithm nuts --chains 64 --skip-report`` at nuts_settings.txt's
     depth, K2 and K3 counted from 0;
 13. the report at real size: ``generate_full_report`` on the committed
     50 000-draw posterior with the arguments that wrote
     ``results/spain2020/analysis/`` (``report_anchor.py``), into
     ``chiprun_out/``, every group of compared numbers within its bar in
     ``report_anchor.GROUP_RTOL`` of the committed tree (beyond one unit of
     the last printed digit; each bar fixed from the host CPU readings); its
     seconds and draws/s, and the card's idle share over one replay batch
     of 1024 draws (torch.profiler);
 14. serovalid in float64: the ENE-COVID term's ``sero_of`` at the
     committed serovalid MAP gives ``serovalid_metadata.json``'s
     ``sero_day64`` to rtol 5e-3; the penalty and its autograd gradient at
     the MAP and two draws near it are finite and equal the same call on
     the CPU to rtol 1e-9;
 15. K1 held against its plain version (as in phase 3) at the bench's
     micro shape (4096 chains) and the campaigns' (8192), float32
     dopri5@4, wide; then the port's bench, ``cli.benchmark_main --mode
     all --batch 4096 --iterations 20 --repeats 5`` in float32 on the full
     grid, K1's
     launches counted by chain count and regime from 0: the micro mode's
     4096 chains all in the wide regime, the pso / hill / mcmc / hillmcmc
     modes at 1024 chains and below all split; its JSON on a line of its
     own, every number finite;
 16. the checkpointed campaign, ``cli.production_campaign --chains 8192
     --iterations 200 --segments 4 --thinning 25 --burn-in 50
     --skip-report`` (AM-MH) into ``chiprun_out/``, then the same campaign
     killed after 2 segments (``--segments 2`` over half the iterations
     into a fresh directory) and resumed with ``--segments 4``: its segment
     files, final ``x`` and posterior trace equal the uninterrupted run's
     to the bit (the bulk files are then deleted, the metadata kept); then one DE-MC campaign of the same size (``--proposal
     de``), acceptance in (0, 1). K1 counted from 0 for each: every call at
     8192 chains, all wide (start, steps, the float64 re-selection);
 17. replica exchange, ``--rungs 8`` over the same 8192 chains (1024 a
     rung, 8192 rows a K1 call, wide): the same kill-and-resume check to
     the bit, finite swap rates per pair, a final ladder that falls from
     ``betas[0] == 1``;
 18. the adaptive integrators on the card, each run held against the same
     call on the host (rtol 1e-6 with a floor of 1e-8 x the largest entry,
     the measure and bar of ``tests/test_integrators.py:113``; the reading
     is printed; float32 runs at rtol 1e-5, the float32 parity test's bar,
     since one accept/reject that rounds the other way moves a float32
     trajectory by the tolerance): the ``sir_model`` solve (the committed
     ``sir_input_parameters.txt``: rkf45, atol 1e-6, rtol 0) in float64 and
     float32, the age-SIR baseline (100 days, dopri5, 1e-6) in both, and
     SEPAIHRD ``solve(method="adaptive", atol=rtol=1e-9)`` on the Spain
     grid in float64; then 8 lanes of different beta solved with
     ``batch_dims=1`` against each lane solved alone (rtol 1e-12); the
     attempts and seconds of each run;
 19. the four SIR mains through the dispatcher, ``python -m
     mmidv1_tpu_torch.cli`` ``sir_model`` and ``sir_pop_var`` with ``--x64``
     (every CSV value equals the same main run with ``--device cpu`` to
     rtol 1e-9), ``sir_stochastic`` on the committed configuration (100
     simulations x 36 000 binomial steps, float32: the population
     conserved in every simulation and step, every value >= 0, p05 <=
     median <= p95, the mean final R within 5 standard errors of a host run
     of the same settings; the 100 per-simulation CSVs are deleted once
     checked), and ``sir_age_structured_main`` at its defaults (peak
     baseline > peak with the intervention > 0), into ``chiprun_out/``;
     the seconds of each main;
 20. ``sir_age_structured_calibration_demo`` at 32 chains, depth cut to 2
     hill iterations and 10 MH steps and the window to the first
     ``SIR_DEMO_DAYS`` of its 306 days (on an H100 the phase took 68.4 s
     at 306 days on one host and 68.8 s at 200 days on a slower one: one
     objective call is 2.5-4.6 s of eager launches, set by the host); best
     >= initial objective, both CSVs in the JAX formats, every sample
     finite; the seconds of one objective call at the full 306 days, at 32
     and at 1024 chains;
 21. K1 held against its plain version (as in phase 3) at the PSO swarm's
     shape (512 chains), then ``run_pso`` on the full Spain grid, float32,
     dopri5@4, 512 particles x 5 iterations, in each of QUANTUM,
     LEVY_FLIGHT and HYBRID, K1's launches counted from 0 by chain count
     and regime (all split: the swarm at 512, HYBRID's elitist probe at 3):
     best > the start's log-likelihood, the best inside the bounds; one more
     step from each run's final state on the card and on the host, fed the
     same draws and fitness values, agrees to 1e-4 of the bounds' width;
 22. the sharded runners of ``mmidv1_tpu_torch.parallel`` on the full
     Spain-2020 grid, dopri5@4. Ranks are processes spawned here, started
     by ``multihost.initialize`` over a file store: 2 ``gloo`` ranks
     sharing the card, and 1 ``nccl`` rank. Each path runs unsharded here
     first, its launches counted from 0, then on the ranks, each counting
     its own: (a) AM-MH, 8192 chains x 40 steps, the covariance every 10,
     float64, on 2 gloo ranks (rtol 1e-9; K1 wide at 4096 a rank) and on 1
     nccl rank (no value may differ in any bit); (b) DE-MC at the same size
     on 2 gloo ranks; (c) PT, 8 rungs x 1024 chains (4096 rows a rank,
     wide); (d) PSO at ``pso_settings.txt`` (VON_NEUMANN), 512 x 5 (K1
     split at 256; ``best_f`` rtol 1e-8); (e) NUTS at ``nuts_settings.txt``
     and logit-NUTS for 5 iterations, 64 chains (K2 + K3 at 32 a rank, K3
     in the regime it runs at 64); (f) MALA 64 x 20. Every global result
     of a rank equals the other rank's to the bit and the unsharded run's
     to rtol 1e-9 (relative, floored at 1e-9 x the field's largest entry);
     every rank launches each kernel as often as the unsharded run, in the
     regime the rule picks for its local chain count. (g) AM-MH, 8192
     float32 chains x 200 steps (the covariance each 25), timed unsharded,
     on 2 gloo ranks and on 1 nccl rank: chain-steps/s, the milliseconds a
     step spends in collectives (a second run, the card synchronized
     around each; a collective's time includes waiting for the other
     rank), and the card's idle share over one 10-step block
     (torch.profiler, the ranks' kernels merged);
 23. print the kernels line and, last, the device line.

It needs one CUDA card; it imports nothing of JAX or of ``mmidv1_tpu``.
Everything measured also goes to ``chiprun_out/chip_smoke.json``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAP_LL = 1432889.7908967654          # results/spain2020/run_metadata.json
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}   # H100 SXM, non-tensor
PEAK_BYTES = 3.35e12                                 # H100 SXM HBM3
# K1 and K2 against the plain version, relative: log-likelihoods, and
# checkpoints with a floor of the row's largest entry. float32 read 1.0e-7 to
# 8.0e-7 at every shape on an H100 (the kernel contracts into FMAs, the plain
# version does not), so a wrong coefficient on one stage cannot pass.
FWD_TOL = {"float64": 1e-10, "float32": 5e-6}
# phase 12: the depth of the hillmcmc run (MH 100 000 x MAIN_SCALE steps)
MAIN_SCALE = 0.002


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_once(fn):
    """``(fn(), its time in ms)`` by CUDA events, one run, no warm-up."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(case, B, dtype_name, tableau, substeps, tol, pipe_cache, seed):
    """Kernel vs plain version on the card for one configuration (the plain
    version's time is that of the one call that is checked)."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import build_objective_fused
    from mmidv1_tpu_torch.ops.sepaihrd_fused import (fused_objective,
                                                     fused_objective_reference,
                                                     op_count)

    dtype = getattr(torch, dtype_name)
    if dtype_name not in pipe_cache:
        pipe_cache[dtype_name] = load_spain_pipeline(HERE, dtype=dtype,
                                                     device="cuda")
    pipe = pipe_cache[dtype_name]
    ll = build_objective_fused(pipe.space, pipe.params, pipe.data, pipe.ts,
                               substeps=substeps, tableau=tableau,
                               constraint_mode=REFLECT, dtype=dtype,
                               device="cuda")
    rng = np.random.default_rng(seed)
    theta0 = pipe.theta0.double().cpu().numpy()
    sig = pipe.space.sigmas.double().cpu().numpy()
    th = theta0[None, :] + 0.05 * sig[None, :] * rng.standard_normal((B, theta0.size))
    bad_rows = [1, B // 2, B - 1] if B > 3 else []
    for r in bad_rows:
        th[r, 5] = np.nan                      # beta_6 -> NaN log-likelihood
    thetas = torch.as_tensor(th, dtype=dtype, device="cuda")
    args, kw, infeasible = ll.prep.kernel_args(thetas)
    kw = dict(kw, substeps=substeps, tableau=tableau)
    k = fused_objective(*args, **kw)
    regime = fused_objective.regime
    torch.cuda.synchronize()
    r, plain_ms = cuda_once(lambda: fused_objective_reference(*args, **kw))
    k_np, r_np = k.double().cpu().numpy(), r.double().cpu().numpy()
    if not np.array_equal(np.isnan(k_np), np.isnan(r_np)):
        fail(f"{case}: NaN pattern differs between kernel and plain version")
    nan_rows = sorted(np.flatnonzero(np.isnan(k_np)).tolist())
    if nan_rows != bad_rows:
        fail(f"{case}: NaN rows {nan_rows[:10]} != injected {bad_rows}")
    fin = np.isfinite(r_np)
    if fin.sum() != B - len(bad_rows) or not np.isfinite(k_np[fin]).all():
        fail(f"{case}: non-finite log-likelihoods besides the injected rows")
    abs_err = np.abs(k_np[fin] - r_np[fin])
    max_abs = float(abs_err.max())
    max_rel = float((abs_err / np.abs(r_np[fin])).max())
    full = ll(thetas).double().cpu().numpy()
    if not (full[bad_rows] == torch.finfo(dtype).min).all():
        fail(f"{case}: NaN chains not masked to finfo.min")
    if not np.array_equal(full[fin], k_np[fin]):
        fail(f"{case}: objective differs from the bare kernel on feasible rows")
    if max_rel > tol:
        fail(f"{case}: kernel vs plain max rel err {max_rel:.3e} > {tol:.0e}")

    ms = cuda_ms(lambda: fused_objective(*args, **kw), reps=10)
    objective_ms = cuda_ms(lambda: ll(thetas), reps=10)
    elem = torch.finfo(dtype).bits // 8
    nbytes = sum(a.numel() for a in args[:6]) * elem + B * elem
    n_intervals = int(sum(kw["run_count"]))
    flops = B * op_count(tableau, substeps, n_intervals, pipe.data.n_data_points)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    out = dict(case=case, B=B, dtype=dtype_name, tableau=tableau,
               substeps=substeps, regime=regime, tol_rel=tol,
               max_rel_err=max_rel,
               max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
               objective_ms=objective_ms, bytes=nbytes, flops=flops,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes > t_ops else "operations")
    print(f"[compare] {case} ({REGIMES[regime]} regime): max rel err "
          f"{max_rel:.3e} (tol {tol:.0e}), "
          f"max abs err {max_abs:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"objective (prep + kernel) {objective_ms:.3f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']})", flush=True)
    return out


def spain_case(pipe_cache, dtype_name, mode, tableau, substeps, B, seed,
               bad_rows=()):
    """(engine, kernel args, kw, thetas): the value_and_grad engine of one
    configuration and the kernel inputs of B chains near the initial guess
    (0.05 sigma noise), with beta_6 NaN on ``bad_rows``."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import build_objective_fused_grad

    dtype = getattr(torch, dtype_name)
    if dtype_name not in pipe_cache:
        pipe_cache[dtype_name] = load_spain_pipeline(HERE, dtype=dtype,
                                                     device="cuda")
    pipe = pipe_cache[dtype_name]
    vg = build_objective_fused_grad(pipe.space, pipe.params, pipe.data,
                                    pipe.ts, substeps=substeps,
                                    tableau=tableau, constraint_mode=mode,
                                    dtype=dtype, device="cuda")
    rng = np.random.default_rng(seed)
    theta0 = pipe.theta0.double().cpu().numpy()
    sig = pipe.space.sigmas.double().cpu().numpy()
    th = theta0[None, :] + 0.05 * sig[None, :] * rng.standard_normal((B, theta0.size))
    for r in bad_rows:
        th[r, 5] = np.nan
    thetas = torch.as_tensor(th, dtype=dtype, device="cuda")
    args, kw, _inf = vg.prep.kernel_args(thetas)
    return vg, args, dict(kw, substeps=substeps, tableau=tableau), thetas


def adjoint_bounds(B, dtype_name, kw, n_obs, args, ckpt):
    """K2's and K3's bounds: max(bytes / HBM rate, ops / peak), each input
    read once and each output written once (K3's scratch is not counted),
    ops from ``op_count_adjoint``: K3's ``bound_ms`` from the function's
    least arithmetic ("bwd"), ``design_bound_ms`` from K3 as built, by
    regime."""
    from mmidv1_tpu_torch.ops.sepaihrd_adjoint import op_count_adjoint

    elem = 8 if dtype_name == "float64" else 4
    ops = op_count_adjoint(kw["tableau"], kw["substeps"], sum(kw["run_count"]),
                           n_obs, n_runs=len(kw["run_count"]))
    n_in = sum(a.numel() for a in args[:6])
    n_ck = ckpt.numel()
    y0, agevec, scal, beff, obs, valid = args[:6]
    n_bwd = (agevec.numel() + scal.numel() + beff.numel() + obs.numel()
             + valid.numel() + n_ck + B                        # inputs
             + y0.numel() + agevec.numel() + scal.numel() + beff.numel())

    def bound(nbytes, flops):
        t_b = nbytes / PEAK_BYTES * 1e3
        t_o = flops / PEAK_FLOPS[dtype_name] * 1e3
        return dict(bytes=nbytes, flops=flops, bound_ms=max(t_b, t_o),
                    bound_by="bytes" if t_b > t_o else "operations")

    bwd = bound(n_bwd * elem, B * ops["bwd"])
    bwd["design_bound_ms"] = {
        r: bound(n_bwd * elem, B * flops)["bound_ms"]
        for r, flops in ops["bwd_design"].items()}
    return {"fwd": bound((n_in + B + n_ck) * elem, B * ops["fwd"]), "bwd": bwd}


def check_k2(case, got, ref, tol):
    """K2's ``(ll, ckpt)`` against its plain version's: LL at rtol ``tol``,
    checkpoints per compartment row at rtol ``tol`` with a floor of ``tol``
    x the row's largest magnitude (entries near 0 keep only absolute
    accuracy)."""
    import numpy as np
    ll, ck = (t.double().cpu().numpy() for t in got)
    rl, rck = (t.double().cpu().numpy() for t in ref)
    if not (np.isfinite(ll).all() and np.isfinite(ck).all()):
        fail(f"K2 {case}: non-finite output")
    rel_ll = float((np.abs(ll - rl) / np.abs(rl)).max())
    scale = np.abs(rck).max(axis=(0, 2, 3), keepdims=True)
    rel_ck = float((np.abs(ck - rck) / (np.abs(rck) + scale)).max())
    if not (rel_ll <= tol and rel_ck <= tol):
        fail(f"K2 {case}: rel err LL {rel_ll:.3e}, checkpoints {rel_ck:.3e} "
             f"> {tol:.0e}")
    print(f"[K2] {case}: max rel err LL {rel_ll:.3e}, checkpoints "
          f"{rel_ck:.3e} (tol {tol:.0e})", flush=True)
    return dict(case=case, max_rel_err_ll=rel_ll, max_rel_err_ckpt=rel_ck,
                max_abs_err=float(np.abs(ll - rl).max()), tol_rel=tol)


def compare_k2(case, B, dtype_name, tableau, substeps, tol, cache, seed):
    """K2 vs its plain version: LL and checkpoints."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import (fused_forward_ckpt,
                                      fused_forward_ckpt_reference)

    _vg, args, kw, _th = spain_case(cache, dtype_name, REFLECT, tableau,
                                    substeps, B, seed)
    got = fused_forward_ckpt(*args, **kw)
    torch.cuda.synchronize()
    ref = fused_forward_ckpt_reference(*args, **kw)
    torch.cuda.synchronize()
    return check_k2(case, got, ref, tol)


def check_k3(case, got, ref, dtype_name, tol, bad=()):
    """K3's four gradient outputs against its plain version's: NaN exactly
    on the ``bad`` chains in both; elsewhere, f64 the largest |diff| /
    (|ref| + max|ref| of the chain) (rtol with a floor of rtol x max), f32
    the largest per-chain relative 2-norm, each <= ``tol``."""
    import numpy as np
    import torch
    B = got[0].shape[-1]
    for a, b in zip(got, ref):
        nan_a = torch.isnan(a).reshape(-1, B).any(0).cpu().numpy()
        nan_b = torch.isnan(b).reshape(-1, B).any(0).cpu().numpy()
        if not np.array_equal(nan_a, nan_b) or \
                sorted(np.flatnonzero(nan_a)) != sorted(bad):
            fail(f"K3 {case}: NaN chains {np.flatnonzero(nan_a)[:8]} (plain "
                 f"{np.flatnonzero(nan_b)[:8]}) != injected {list(bad)}")
    good = [c for c in range(B) if c not in bad]
    err, max_abs = 0.0, 0.0
    for a, b in zip(got, ref):
        a = a[..., good].double().cpu().numpy().reshape(-1, len(good))
        b = b[..., good].double().cpu().numpy().reshape(-1, len(good))
        max_abs = max(max_abs, float(np.abs(a - b).max()))
        if dtype_name == "float64":
            e = np.abs(a - b) / (np.abs(b) + np.abs(b).max(axis=0) + 1e-300)
        else:
            e = np.linalg.norm(a - b, axis=0) / (np.linalg.norm(b, axis=0) + 1e-300)
        err = max(err, float(e.max()))
    if not err <= tol:
        fail(f"K3 {case}: gradient error {err:.3e} > {tol:.0e}")
    print(f"[K3] {case}: gradient error {err:.3e} (tol {tol:.0e}), max abs "
          f"err {max_abs:.3e}", flush=True)
    return dict(case=case, err=err, tol=tol, max_abs_err=max_abs)


def k3_forced(regime, agevec, scal, beff, obs, valid, ck, g, M, kw):
    """K3 in ``regime`` (1 or 2) whatever its rule would pick: ``(outputs,
    kernels launched)``, through the launcher's private argument."""
    from mmidv1_tpu_torch.ops import sepaihrd_adjoint as adj
    out, _regime, n_kernels = adj._launch_adjoint(
        agevec, scal, beff, obs, valid, ck, g, M, regime=regime, **kw)
    return out, n_kernels


def compare_k3(case, B, dtype_name, tableau, substeps, tol, cache, seed):
    """K3 vs its plain version, NaN chains included, in the regime its rule
    picks and in each regime forced; the masked engine."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_adjoint_reference,
                                      fused_forward_ckpt)

    bad = [1, B // 2, B - 1]
    vg, args, kw, thetas = spain_case(cache, dtype_name, REFLECT, tableau,
                                      substeps, B, seed, bad)
    y0, agevec, scal, beff, obs, valid, M = args
    ll, ck = fused_forward_ckpt(*args, **kw)
    g = torch.ones_like(ll)
    got = fused_adjoint(agevec, scal, beff, obs, valid, ck, g, M, **kw)
    picked = fused_adjoint.regime
    torch.cuda.synchronize()
    ref = fused_adjoint_reference(agevec, scal, beff, obs, valid, ck, g, M, **kw)
    torch.cuda.synchronize()
    out = check_k3(f"{case} regime {picked} (picked)", got, ref, dtype_name,
                   tol, bad)
    out["regime"] = picked
    out["forced"] = {}
    for regime in (1, 2):
        forced, _n = k3_forced(regime, agevec, scal, beff, obs, valid, ck, g,
                               M, kw)
        torch.cuda.synchronize()
        out["forced"][regime] = check_k3(f"{case} regime {regime} (forced)",
                                         forced, ref, dtype_name, tol, bad)
    good = [c for c in range(B) if c not in bad]
    lv, gv = vg(thetas)
    lv, gv = lv.cpu(), gv.cpu()
    if not (lv[bad] == torch.finfo(lv.dtype).min).all() or \
            not torch.isfinite(gv[good]).all() or not torch.isnan(gv[bad]).any():
        fail(f"K3 {case}: value_and_grad does not mask the NaN chains")
    print(f"[K3] {case}: NaN chains NaN in both, finfo.min from "
          f"value_and_grad", flush=True)
    return out


def time_adjoint(B, dtype_name, cache, plain):
    """K2 and K3 times (CUDA events) and bounds at dopri5@4 on CLAMP inputs,
    as the NUTS path prepares them, K3 in the regime its rule picks and in
    each regime forced (regime 1 up to B = 2048: it keeps every stage
    input); with ``plain`` also their plain versions' (one run each), and
    the kernels' outputs held against them (LL and checkpoints at rtol
    ``FWD_TOL``, gradients at 1e-9 f64 / 1e-3 f32 as in ``check_k3``)."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import CLAMP
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_adjoint_reference,
                                      fused_forward_ckpt,
                                      fused_forward_ckpt_reference)

    vg, args, kw, thetas = spain_case(cache, dtype_name, CLAMP, "dopri5", 4, B,
                                      B + 7)
    y0, agevec, scal, beff, obs, valid, M = args
    ll, ck = fused_forward_ckpt(*args, **kw)
    g = torch.ones_like(ll)
    k3_args = (agevec, scal, beff, obs, valid, ck, g, M)
    bwd = lambda: fused_adjoint(*k3_args, **kw)
    calls, kernels = fused_adjoint.launches, fused_adjoint.kernel_launches
    grads = bwd()
    reps = 10 if B <= 1024 else 3
    out = dict(B=B, dtype=dtype_name, k2_regime=fused_forward_ckpt.regime,
               k3_regime=fused_adjoint.regime,
               k3_kernels_per_call=(fused_adjoint.kernel_launches - kernels)
               // (fused_adjoint.launches - calls),
               k2_ms=cuda_ms(lambda: fused_forward_ckpt(*args, **kw), reps),
               k3_ms=cuda_ms(bwd, reps),
               vag_ms=cuda_ms(lambda: vg(thetas), reps))
    forced = {}
    for regime in (1, 2) if B <= 2048 else (2,):
        run = lambda regime=regime: k3_forced(regime, *k3_args, kw)
        res, n_kernels = run()
        forced[regime] = dict(grads=res, kernels_per_call=n_kernels,
                              ms=cuda_ms(run, reps),
                              stage_ms=device_profile(run)[0])
    bounds = adjoint_bounds(B, dtype_name, kw, obs.shape[0], args, ck)
    out["k2_bound"], out["k3_bound"] = bounds["fwd"], bounds["bwd"]
    design = bounds["bwd"]["design_bound_ms"]
    print(f"[time] B={B} {dtype_name} dopri5@4: K2 {out['k2_ms']:.3f} ms "
          f"({REGIMES[out['k2_regime']]} regime; bound {bounds['fwd']['bound_ms']:.4f}, {bounds['fwd']['bound_by']}), "
          f"K3 {out['k3_ms']:.3f} ms in regime {out['k3_regime']} "
          f"({out['k3_kernels_per_call']} kernels a call; bound "
          f"{bounds['bwd']['bound_ms']:.4f}, {bounds['bwd']['bound_by']}; as "
          f"built {design[out['k3_regime']]:.4f}), value_and_grad "
          f"{out['vag_ms']:.3f} ms", flush=True)
    for regime, f in forced.items():
        stages = ", ".join(f"{k} {v:.3f}" for k, v in f["stage_ms"].items())
        print(f"[time] B={B} {dtype_name}: K3 forced into regime {regime} "
              f"{f['ms']:.3f} ms ({f['kernels_per_call']} kernels a call; as "
              f"built {design[regime]:.4f}); stages by the profiler, ms a "
              f"call: {stages}", flush=True)
    if plain:
        # how much of a value_and_grad the card works: the rest it waits
        # for the host (eager prep, its backward, launches)
        out["vag_device_busy_ms"] = device_profile(lambda: vg(thetas))[1]
        print(f"[time] B={B} {dtype_name}: value_and_grad keeps the card "
              f"busy {out['vag_device_busy_ms']:.3f} ms of {out['vag_ms']:.3f} "
              f"ms a call (idle share "
              f"{1 - out['vag_device_busy_ms'] / out['vag_ms']:.2f})",
              flush=True)
        ref2, out["k2_plain_ms"] = cuda_once(
            lambda: fused_forward_ckpt_reference(*args, **kw))
        ref3, out["k3_plain_ms"] = cuda_once(
            lambda: fused_adjoint_reference(*k3_args, **kw))
        case = f"{dtype_name} dopri5@4 B={B} CLAMP (NUTS shape)"
        tol2 = FWD_TOL[dtype_name]
        tol3 = 1e-9 if dtype_name == "float64" else 1e-3
        out["k2_check"] = check_k2(case, (ll, ck), ref2, tol2)
        out["k3_check"] = check_k3(f"{case} regime {out['k3_regime']} (picked)",
                                   grads, ref3, dtype_name, tol3)
        for regime, f in forced.items():
            f["check"] = check_k3(f"{case} regime {regime} (forced)",
                                  f["grads"], ref3, dtype_name, tol3)
        print(f"[time] B={B} {dtype_name}: plain K2 {out['k2_plain_ms']:.1f} ms, "
              f"K3 {out['k3_plain_ms']:.1f} ms", flush=True)
    out["k3_forced"] = {r: {k: v for k, v in f.items() if k != "grads"}
                        for r, f in forced.items()}
    return out


def device_profile(run, calls=5):
    """Device time of ``run`` from ``torch.profiler`` (CUPTI) over ``calls``
    calls, ms a call: ``(by K3 stage, all kernels and copies together)``;
    fails where the profiler reports no device time."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    stages, busy = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue                       # an op's total repeats its kernels'
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        busy += us / 1e3 / calls
        m = re.search(r"sepaihrd_adjoint_([a-z]+)_kernel", ev.key)
        if m:
            stages[m.group(1)] = stages.get(m.group(1), 0.0) + us / 1e3 / calls
    if not busy:
        fail("torch.profiler reported no device time")
    return stages, busy


def device_busy_ms(run):
    """Device time of one call of ``run`` (a warm one) from torch.profiler's
    CUDA activity alone, summed from the raw events: an eager replay
    launches some 10^5 kernels, too many for ``key_averages``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    if not busy:
        fail("torch.profiler reported no device time")
    return busy


def regime_crossover(cache, sizes=(64, 128, 256, 320, 384, 448, 512, 1024,
                                   2048)):
    """K3 in each regime (CUDA events, 10 launches, in turns) over B in
    float32 and float64, dopri5@4, CLAMP inputs, and what the rule picks
    there: the measurement behind ``choose_regime``."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import CLAMP
    from mmidv1_tpu_torch.ops import fused_adjoint, fused_forward_ckpt

    rows = []
    for dtype_name in ("float32", "float64"):
        for B in sizes:
            _vg, args, kw, _th = spain_case(cache, dtype_name, CLAMP, "dopri5",
                                            4, B, B + 7)
            y0, agevec, scal, beff, obs, valid, M = args
            ll, ck = fused_forward_ckpt(*args, **kw)
            k3_args = (agevec, scal, beff, obs, valid, ck, torch.ones_like(ll), M)
            fused_adjoint(*k3_args, **kw)
            row = dict(B=B, dtype=dtype_name, picked=fused_adjoint.regime,
                       regime1_ms=0.0, regime2_ms=0.0)
            for regime in (1, 2, 2, 1):        # the mean of the two turns
                row[f"regime{regime}_kernels"] = k3_forced(regime, *k3_args,
                                                           kw)[1]
                row[f"regime{regime}_ms"] += cuda_ms(
                    lambda: k3_forced(regime, *k3_args, kw), reps=10) / 2
            rows.append(row)
            print(f"[crossover] B={B} {dtype_name}: regime 1 "
                  f"{row['regime1_ms']:.3f} ms, regime 2 "
                  f"{row['regime2_ms']:.3f} ms, the rule picks {row['picked']}",
                  flush=True)
    return rows


REGIMES = {1: "split", 2: "wide"}


def forward_ptxas(build_dir):
    """Registers, spills and static shared memory of every forward kernel
    (K1's instantiations in sepaihrd_fused, K2's in sepaihrd_adjoint), from
    the builds' own ptxas reports; one line each."""
    import re
    out = {}
    for src in ("sepaihrd_fused", "sepaihrd_adjoint"):
        key = None
        with open(os.path.join(build_dir, f"{src}.ptxas.txt")) as f:
            for ln in f:
                if "Function properties for" in ln:
                    m = re.search(r"sepaihrd_forward_(wide|split)_kernelI([fd])"
                                  r"Li(\d+)ELb([01])E", ln)
                    key = m and (f"{'K2' if m.group(4) == '1' else 'K1'} "
                                 f"{m.group(1)} "
                                 f"{'float32' if m.group(2) == 'f' else 'float64'}"
                                 f" S={m.group(3)}")
                elif key and "bytes stack frame" in ln:
                    stack, stores, loads = (int(x) for x in
                                            re.findall(r"(\d+) bytes", ln))
                    out[key] = dict(stack=stack, spill_stores=stores,
                                    spill_loads=loads)
                elif key and "Used" in ln and "registers" in ln:
                    out[key]["registers"] = int(
                        re.search(r"Used (\d+) registers", ln).group(1))
                    m = re.search(r"(\d+) bytes smem", ln)
                    out[key]["static_smem"] = int(m.group(1)) if m else 0
    if not any(k.startswith("K1 split") for k in out) or \
            not any(k.startswith("K2 split") for k in out):
        fail("no forward kernel in the ptxas reports")
    for name, u in sorted(out.items()):
        print(f"[ptxas-fwd] {name}: {u.get('registers')} registers, spill "
              f"stores {u['spill_stores']} B, loads {u['spill_loads']} B, "
              f"stack {u['stack']} B, static smem {u.get('static_smem')} B",
              flush=True)
    return out


def sass_loops(lib_paths, out_dir):
    """What the card runs: for the dopri5 forward kernels (S = 7, both
    regimes, both types; K1 from the fused library, K2 from the adjoint
    one) the SASS of the built libraries (cuobjdump), its loops (a backward
    branch and its target) and their instruction counts by opcode. A loop's
    RK stages are its shuffles over 4 (float32) or 8 (float64, two a value)
    a right-hand side; a loop without shuffles is the consumer's. Returns
    None where the toolkit has no cuobjdump."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        print("[sass] no cuobjdump in the toolkit: not counted", flush=True)
        return None
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for lib_path in lib_paths:
        text = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                              text=True, timeout=600, check=True).stdout
        for blk in re.split(r"\n\s*Function : ", text)[1:]:
            name = blk.split("\n", 1)[0].strip()
            m = re.search(r"sepaihrd_forward_(wide|split)_kernelI([fd])Li7ELb([01])E",
                          name)
            if m:
                kind = (f"{'K2' if m.group(3) == '1' else 'K1'} {m.group(1)} "
                        f"{'float32' if m.group(2) == 'f' else 'float64'}")
                out[kind] = _sass_kernel(kind, blk, 4 if m.group(2) == "f" else 8,
                                         out_dir)
    if not out:
        fail(f"cuobjdump shows no forward kernel in {lib_paths}")
    return out


def _sass_kernel(kind, blk, shuffles_per_rhs, out_dir):
    """One kernel's SASS block: saved under ``out_dir``, its loops of 40
    instructions or more printed and returned."""
    import re
    with open(os.path.join(out_dir, kind.replace(" ", "_") + ".sass"), "w") as f:
        f.write(blk)
    ins = []
    for ln in blk.splitlines():
        mm = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if mm:
            toks = mm.group(2).split()
            op = toks[1] if toks[0].startswith("@") else toks[0]
            ins.append((int(mm.group(1), 16), op.split(".")[0], mm.group(2)))
    loops = []
    for addr, op, txt in ins:
        tgt = re.search(r"\b0x([0-9a-f]+)\s*$", txt)
        if op != "BRA" or not tgt or int(tgt.group(1), 16) > addr:
            continue
        body = [i for i in ins if int(tgt.group(1), 16) <= i[0] <= addr]
        if len(body) < 40:
            continue
        hist = {}
        for _a, o, _t in body:
            hist[o] = hist.get(o, 0) + 1
        loops.append(dict(start=hex(int(tgt.group(1), 16)), end=hex(addr),
                          instructions=len(body),
                          stages=hist.get("SHFL", 0) / shuffles_per_rhs,
                          by_opcode=dict(sorted(hist.items(),
                                                key=lambda kv: -kv[1]))))
    print(f"[sass] {kind} dopri5: {len(ins)} instructions", flush=True)
    for lp in loops:
        top = ", ".join(f"{k} {v}" for k, v in list(lp["by_opcode"].items())[:9])
        per = (f"{lp['instructions'] / lp['stages']:.1f} a stage"
               if lp["stages"] else "no shuffle")
        print(f"[sass]   loop {lp['start']}..{lp['end']}: {lp['instructions']} "
              f"instructions, {lp['stages']:g} RHS by its shuffles ({per}); "
              f"{top}", flush=True)
    return dict(instructions=len(ins), loops=loops)


def sm_clock_mhz(busy, launches=400):
    """The SM clock in MHz that nvidia-smi reads while ``launches`` calls of
    ``busy`` keep the card working, and the card's maximum."""
    import torch
    for _ in range(launches):
        busy()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    torch.cuda.synchronize()
    now, top = (float(x) for x in out.splitlines()[0].split(","))
    print(f"[clock] SM clock under load {now:.0f} MHz (maximum {top:.0f})",
          flush=True)
    return now, top


def forward_bounds(B, dtype_name, kw, n_obs, args, n_ckpt, clock_mhz):
    """K1's (``n_ckpt`` 0) or K2's two bounds in ms: the roofline (bytes
    over the memory rate against ``op_count`` over the non-tensor peak) and
    the chain (dependent stages x the stage's shortest dependent chain in
    cycles / the SM clock); ``design_bound_ms`` is the larger."""
    from mmidv1_tpu_torch.ops import sepaihrd_fused as sf
    elem = 8 if dtype_name == "float64" else 4
    n_intervals = int(sum(kw["run_count"]))
    nbytes = (sum(a.numel() for a in args[:6]) + B + n_ckpt) * elem
    flops = B * sf.op_count(kw["tableau"], kw["substeps"], n_intervals, n_obs)
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    stages = sf.dependent_stages(kw["tableau"], kw["substeps"], n_intervals)
    chain = stages * sf.chain_cycles(elem) / (clock_mhz * 1e3)
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b > t_o else "operations",
                dependent_stages=stages, chain_cycles=sf.chain_cycles(elem),
                chain_bound_ms=chain, design_bound_ms=max(t_b, t_o, chain))


def forward_runs(args, kw):
    """``{"K1": run(regime), "K2": ...}``: the two forward kernels through
    their wrappers on one set of inputs, a regime forced."""
    from mmidv1_tpu_torch.ops import fused_forward_ckpt, fused_objective
    return {"K1": lambda regime: fused_objective(*args, **kw, regime=regime),
            "K2": lambda regime: fused_forward_ckpt(*args, **kw, regime=regime)}


def forward_case(cache, B, dtype_name, clock_mhz):
    """K1 and K2 at dopri5@4 with ``B`` chains: each regime forced, held
    against the plain version (LL, and K2's checkpoints row by row) and
    against the other regime, and timed in turns."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.param_space import CLAMP, REFLECT
    from mmidv1_tpu_torch.ops import (fused_forward_ckpt,
                                      fused_forward_ckpt_reference,
                                      fused_objective)

    mode = CLAMP if B == 64 else REFLECT        # as NUTS / as MH prepare them
    _vg, args, kw, _th = spain_case(cache, dtype_name, mode, "dopri5", 4, B,
                                    B + 11)
    tol = FWD_TOL[dtype_name]
    case = f"{dtype_name} dopri5@4 B={B}"
    # one plain run serves both: K1's plain LL is K2's to the bit
    ref, plain_ms = cuda_once(lambda: fused_forward_ckpt_reference(*args, **kw))
    out = dict(B=B, dtype=dtype_name, plain_ms=plain_ms, tol_rel=tol,
               K1={}, K2={})
    got = {}
    for regime, name in REGIMES.items():
        ll1 = fused_objective(*args, **kw, regime=regime)
        ll2, ck = fused_forward_ckpt(*args, **kw, regime=regime)
        torch.cuda.synchronize()
        if fused_objective.regime != regime or fused_forward_ckpt.regime != regime:
            fail(f"{case}: the wrappers did not run the forced regime {regime}")
        got[regime] = (ll1, ll2, ck)
        ll1n, rl = ll1.double().cpu().numpy(), ref[0].double().cpu().numpy()
        if not np.isfinite(ll1n).all():
            fail(f"K1 {case} {name}: non-finite log-likelihood")
        rel = float((np.abs(ll1n - rl) / np.abs(rl)).max())
        if not rel <= tol:
            fail(f"K1 {case} {name}: rel err {rel:.3e} > {tol:.0e}")
        print(f"[K1] {case} {name}: max rel err LL {rel:.3e} (tol {tol:.0e})",
              flush=True)
        out["K1"][name] = dict(max_rel_err=rel,
                               max_abs_err=float(np.abs(ll1n - rl).max()))
        out["K2"][name] = check_k2(f"{case} {name}", (ll2, ck), ref, tol)
        out["K2"][name]["k1_bits_differ"] = int((ll1 != ll2).sum())
    # the regimes do the same operations in the same order: no bit may differ
    s, w = got[1], got[2]
    out["regimes_differ"] = dict(
        k1_ll=int((s[0] != w[0]).sum()), k2_ll=int((s[1] != w[1]).sum()),
        k2_ckpt=int((s[2] != w[2]).sum()), ckpt_values=s[2].numel(),
        k1_ll_max_rel=float(((s[0] - w[0]).abs() / w[0].abs()).max()))
    d = out["regimes_differ"]
    print(f"[regimes] {case}: split vs wide differ in {d['k1_ll']} of {B} K1 "
          f"log-likelihoods (max rel {d['k1_ll_max_rel']:.2e}), {d['k2_ll']} "
          f"of K2's, {d['k2_ckpt']} of {d['ckpt_values']} checkpoint values",
          flush=True)
    if d["k1_ll"] or d["k2_ll"] or d["k2_ckpt"]:
        fail(f"{case}: the split and the wide regime differ: {d}")

    runs = forward_runs(args, kw)
    reps = 10 if B <= 1024 else 5
    for kname, run in runs.items():
        bounds = forward_bounds(B, dtype_name, kw, args[4].shape[0], args,
                                0 if kname == "K1" else s[2].numel(), clock_mhz)
        out[kname]["bounds"] = bounds
        for regime in (2, 1, 1, 2):               # the mean of the two turns
            name = REGIMES[regime]
            out[kname][name]["ms"] = out[kname][name].get("ms", 0.0) + cuda_ms(
                lambda: run(regime), reps) / 2
        for name in REGIMES.values():
            ms = out[kname][name]["ms"]
            ns = ms * 1e6 / bounds["dependent_stages"]
            out[kname][name]["ns_per_stage"] = ns
            out[kname][name]["cycles_per_stage"] = ns * clock_mhz / 1e3
            print(f"[time-fwd] {kname} {case} {name}: {ms:.4f} ms = {ns:.1f} ns "
                  f"= {ns * clock_mhz / 1e3:.0f} cycles a dependent stage at "
                  f"{clock_mhz:.0f} MHz; roofline bound "
                  f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']}), chain "
                  f"bound {bounds['chain_bound_ms']:.4f} ms "
                  f"({bounds['chain_cycles']} cycles a stage)", flush=True)
    return out


def forward_crossover(cache, sizes=(64, 256, 512, 1024, 2048, 3072, 4096, 8192)):
    """K1 and K2 in each regime (CUDA events, 10 launches, in turns) over B
    in float32 and float64, dopri5@4, and what the rule picks there: the
    measurement behind ``choose_forward_regime``."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import sepaihrd_fused as sf

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for dtype_name in ("float32", "float64"):
        for B in sizes:
            _vg, args, kw, _th = spain_case(cache, dtype_name, REFLECT,
                                            "dopri5", 4, B, B + 11)
            row = dict(B=B, dtype=dtype_name,
                       picked=sf.choose_forward_regime(B, sm_count))
            for kname, run in forward_runs(args, kw).items():
                for regime in (1, 2, 2, 1):        # the mean of the two turns
                    key = f"{kname}_{REGIMES[regime]}_ms"
                    row[key] = row.get(key, 0.0) + cuda_ms(
                        lambda: run(regime), reps=10) / 2
            rows.append(row)
            print(f"[crossover-fwd] B={B} {dtype_name}: K1 split "
                  f"{row['K1_split_ms']:.4f} ms, wide {row['K1_wide_ms']:.4f}; "
                  f"K2 split {row['K2_split_ms']:.4f}, wide "
                  f"{row['K2_wide_ms']:.4f}; the rule picks "
                  f"{REGIMES[row['picked']]}", flush=True)
    return rows


def forward_phases(cache, build_dir):
    """Phase 2b: ``{ptxas, sass, clock, cases, crossover}`` of K1 and K2."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import _build

    out = dict(ptxas=forward_ptxas(build_dir))
    out["sass"] = sass_loops([_build.library_path("sepaihrd_fused"),
                              _build.library_path("sepaihrd_adjoint")],
                             os.path.join(HERE, "chiprun_out", "sass"))
    _vg, args, kw, _th = spain_case(cache, "float32", REFLECT, "dopri5", 4,
                                    1024, 3)
    run = forward_runs(args, kw)["K1"]
    out["clock_mhz"], out["clock_max_mhz"] = sm_clock_mhz(lambda: run(2))
    out["cases"] = [forward_case(cache, B, d, out["clock_mhz"])
                    for B in (64, 1024, 8192) for d in ("float32", "float64")]
    out["crossover"] = forward_crossover(cache)
    torch.cuda.synchronize()
    return out


def zero_counts():
    """Set every kernel's launch count to 0, just before a path is driven."""
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_forward_ckpt,
                                      fused_objective)
    for fwd in (fused_objective, fused_forward_ckpt):
        fwd.launches = 0
        fwd.regime_calls = {1: 0, 2: 0}
        fwd.batch_calls = {}
    fused_adjoint.launches = 0
    fused_adjoint.kernel_launches = 0
    fused_adjoint.regime_calls = {1: 0, 2: 0}


def read_counts(path, B, crossover):
    """The launch counts of the path just driven with ``B`` float32 chains.
    Fails unless every K3 call ran in the one regime that the rule picks at
    ``B`` and launched that regime's kernels (both from the crossover row of
    ``B``, whose forced calls do not count here)."""
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_forward_ckpt,
                                      fused_objective)
    row = next(r for r in crossover if r["B"] == B and r["dtype"] == "float32")
    regime = row["picked"]
    counts = dict(k1=fused_objective.launches, k2=fused_forward_ckpt.launches,
                  k1_regime_calls=dict(fused_objective.regime_calls),
                  k2_regime_calls=dict(fused_forward_ckpt.regime_calls),
                  k3=fused_adjoint.launches,
                  k3_kernels=fused_adjoint.kernel_launches,
                  k3_regime_calls=dict(fused_adjoint.regime_calls),
                  k3_regime=regime,
                  k3_kernels_per_call=row[f"regime{regime}_kernels"])
    if counts["k3"] < 1 or counts["k3_regime_calls"] != {
            regime: counts["k3"], 3 - regime: 0} or \
            counts["k3_kernels"] != counts["k3"] * counts["k3_kernels_per_call"]:
        fail(f"{path}: K3 calls by regime and kernels {counts}, expected all "
             f"in regime {regime} at {counts['k3_kernels_per_call']} kernels "
             f"a call")
    fwd_regime = forward_pick(B)
    if counts["k2_regime_calls"] != {fwd_regime: counts["k2"],
                                     3 - fwd_regime: 0}:
        fail(f"{path}: K2 calls by regime {counts['k2_regime_calls']}, expected "
             f"all {counts['k2']} in regime {fwd_regime}")
    counts["k2_regime"] = fwd_regime
    print(f"[{path}] K3: {counts['k3']} calls, all in regime {regime}, "
          f"{counts['k3_kernels']} kernels = {counts['k3_kernels_per_call']} a "
          f"call; K2 {counts['k2']} launches, all {REGIMES[fwd_regime]}; K1 "
          f"{counts['k1']} ({counts['k1_regime_calls']})", flush=True)
    return counts


def forward_pick(B):
    """The regime ``choose_forward_regime`` picks for ``B`` chains here."""
    import torch
    from mmidv1_tpu_torch.ops.sepaihrd_fused import choose_forward_regime
    return choose_forward_regime(
        B, torch.cuda.get_device_properties(0).multi_processor_count)


def mala_path(path, vg, pipe, n_chains, iterations, crossover):
    """A short MALA run through the K2/K3 engine ``vg``, launches counted
    from 0: ``iterations`` + 1 calls of each, finite samples."""
    import torch
    from mmidv1_tpu_torch.calibration.mala import MALAConfig, run_mala
    zero_counts()
    calls = vg.calls
    t0 = time.perf_counter()
    res = run_mala(None, pipe.space, pipe.theta0,
                   MALAConfig(iterations=iterations, burn_in=iterations // 2,
                              adaptation_period=max(1, iterations // 2),
                              initial_step_size=0.02),
                   generator=torch.Generator(device="cuda").manual_seed(0),
                   n_chains=n_chains, jitter=0.05, value_and_grad_batch=vg)
    best = float(res.best_logp)
    seconds = time.perf_counter() - t0
    out = dict(read_counts(path, n_chains, crossover), best_logp=best,
               seconds=seconds, acceptance=float(res.acceptance_rate.mean()),
               grad_evals_per_s=n_chains * (vg.calls - calls) / seconds)
    if out["k2"] != iterations + 1 or out["k3"] != iterations + 1 \
            or not abs(best) < float("inf") \
            or not bool(torch.isfinite(res.samples).all()):
        fail(f"{path}: {out}")
    print(f"[{path}] {n_chains} chains x {iterations} iterations: K2/K3 "
          f"launches {out['k2']}/{out['k3']}, best logL {best:.6e}, acceptance "
          f"{out['acceptance']:.3f}, {out['grad_evals_per_s']:.4e} "
          f"grad-evals/s", flush=True)
    return out


def gradient_anchor(cache, n_chains=4, h=1e-4, seed=5):
    """float64 value_and_grad (CLAMP, dopri5@4) at the committed MAP + 0.05
    sigma noise against K1: the value (rtol 1e-12) and a central difference
    along a random sigma-scaled direction (rtol 1e-4)."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.param_space import CLAMP
    from mmidv1_tpu_torch.data import read_sepaihrd_parameters
    from mmidv1_tpu_torch.ops import build_objective_fused_grad

    pipe = cache["float64"]
    calib = read_sepaihrd_parameters(
        os.path.join(HERE, "results", "spain2020", "calibrated_parameters.txt"),
        4, N=pipe.data.population_by_age,
        M_baseline=pipe.params.M_baseline.cpu().numpy(),
        dtype=torch.float64, device=pipe.params.device)
    vg = build_objective_fused_grad(pipe.space, pipe.params, pipe.data, pipe.ts,
                                    substeps=4, constraint_mode=CLAMP,
                                    device=pipe.params.device)
    rng = np.random.default_rng(seed)
    sig = pipe.space.sigmas.double()
    theta = pipe.space.extract(calib)[None, :] + 0.05 * sig * torch.as_tensor(
        rng.standard_normal((n_chains, sig.numel())), device=sig.device)
    u = sig * torch.as_tensor(rng.standard_normal((n_chains, sig.numel())),
                              device=sig.device)
    ll, grad = vg(theta)
    k1 = vg.value_batch(theta)
    fd = (vg.value_batch(theta + h * u) - vg.value_batch(theta - h * u)) / (2 * h)
    dd = torch.sum(grad * u, dim=-1)
    rel_v = float(torch.max(torch.abs(ll - k1) / torch.abs(k1)))
    rel_g = float(torch.max(torch.abs(dd - fd) / torch.abs(fd)))
    out = dict(value_rel_err=rel_v, fd_rel_err=rel_g,
               directional=dd.tolist(), central_difference=fd.tolist())
    print(f"[anchor-grad] float64 value vs K1 rel err {rel_v:.3e}; directional "
          f"derivative vs central difference rel err {rel_g:.3e} "
          f"({[f'{x:.6e}' for x in dd.tolist()]})", flush=True)
    if not (rel_v <= 1e-12 and rel_g <= 1e-4):
        fail(f"gradient anchor off: value {rel_v:.3e}, gradient {rel_g:.3e}")
    return out


def k3_ptxas(report):
    """Registers and spill bytes of every K3 kernel, from the build's own
    ptxas report: ``{stage: {"float32 S=7": {registers, spill_stores,
    spill_loads, stack}}}``; printed one line a stage and type."""
    import re
    out = {}
    key = None
    with open(report) as f:
        for ln in f:
            m = re.search(r"sepaihrd_adjoint_([a-z]+)_kernelI([fd])(?:Li(\d+)E)?", ln)
            if "Function properties for" in ln:
                key = m and (m.group(1), ("float32" if m.group(2) == "f"
                                          else "float64")
                             + (f" S={m.group(3)}" if m.group(3) else ""))
            elif key and "bytes stack frame" in ln:
                stack, stores, loads = (int(x) for x in re.findall(r"(\d+) bytes", ln))
                out.setdefault(key[0], {})[key[1]] = dict(
                    stack=stack, spill_stores=stores, spill_loads=loads)
            elif key and "registers" in ln:
                out[key[0]][key[1]]["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
    if not out:
        fail(f"no K3 kernel in {report}")
    for stage, builds in out.items():
        for name, u in sorted(builds.items()):
            print(f"[ptxas-K3] {stage} {name}: {u.get('registers')} registers, "
                  f"spill stores {u['spill_stores']} B, loads "
                  f"{u['spill_loads']} B, stack {u['stack']} B", flush=True)
    return out


def k3_phases(cache):
    """Phases 7 and 8: ``(K3 comparisons, K2/K3 timings, regime crossover)``."""
    k3_cases = []
    for dtype_name, tol in (("float64", 1e-9), ("float32", 1e-3)):
        for tableau, substeps in (("dopri5", 4), ("cash_karp", 3)):
            k3_cases.append(compare_k3(f"{dtype_name} {tableau}@{substeps} B=512",
                                       512, dtype_name, tableau, substeps, tol,
                                       cache, seed=30 + len(k3_cases)))
    timings = [time_adjoint(B, dtype_name, cache, plain=B <= 64)
               for B in (8192, 64) for dtype_name in ("float32", "float64")]
    return k3_cases, timings, regime_crossover(cache)


def k3_pick_row(cache, B):
    """What K3's rule picks for ``B`` float32 chains on the NUTS shape and
    how many kernels that regime launches a call, as a crossover row for
    :func:`read_counts` (one call, before the counts are set to 0)."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import CLAMP
    from mmidv1_tpu_torch.ops import fused_adjoint, fused_forward_ckpt
    _vg, args, kw, _th = spain_case(cache, "float32", CLAMP, "dopri5", 4, B,
                                    B + 7)
    y0, agevec, scal, beff, obs, valid, M = args
    ll, ck = fused_forward_ckpt(*args, **kw)
    kernels = fused_adjoint.kernel_launches
    fused_adjoint(agevec, scal, beff, obs, valid, ck, torch.ones_like(ll), M,
                  **kw)
    torch.cuda.synchronize()
    regime = fused_adjoint.regime
    return dict(B=B, dtype="float32", picked=regime, **{
        f"regime{regime}_kernels": fused_adjoint.kernel_launches - kernels})


def primary_executable(cache, card):
    """Phase 12: ``sepaihrd_main`` with hillmcmc (K1 counted by chain count
    and regime) and with nuts (K2 / K3 counted)."""
    import torch
    from mmidv1_tpu_torch.cli import sepaihrd_main
    from mmidv1_tpu_torch.ops import fused_objective
    from mmidv1_tpu_torch.calibration.hill import HillClimbConfig
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    # K1 against its plain version at the shapes the climber hands it, from
    # the configuration the entry point builds (the full grid, float32)
    if "float32" not in cache:
        cache["float32"] = load_spain_pipeline(HERE, dtype=torch.float32,
                                               device="cuda")
    cfg = HillClimbConfig.from_settings(cache["float32"].settings.get("hill", {}))
    hill_shapes = sorted({1, cfg.cloud_size, cfg.max_backtrack,
                          cfg.max_expansion})
    hill_cases = [compare(f"float32 dopri5@4 B={B} (hill climber shape)", B,
                          "float32", "dopri5", 4, FWD_TOL["float32"], cache,
                          seed=200 + B)
                  for B in hill_shapes]

    out_dir = os.path.join(HERE, "chiprun_out", "chip_smoke_main")
    common = ["--device", "cuda", "--project-root", HERE]
    zero_counts()
    t0 = time.perf_counter()
    s = sepaihrd_main.run(["--algorithm", "hillmcmc", "--chains", "1024",
                           "--scale", str(MAIN_SCALE), "--output-dir", out_dir]
                          + common)
    wall = time.perf_counter() - t0
    by_batch = {B: dict(v) for B, v in fused_objective.batch_calls.items()}
    counts = dict(k1=fused_objective.launches,
                  k1_regime_calls=dict(fused_objective.regime_calls),
                  k1_batch_calls=by_batch)
    hill, steps = s["hill"], s["mh_steps"]
    ran = sorted({1, hill["cloud_size"], hill["max_backtrack"],
                  hill["max_expansion"]})
    if ran != hill_shapes:
        fail(f"the climber ran at B = {ran}; K1 was held at B = {hill_shapes}")
    # main's initial value and the climber's start (1 chain); per climber
    # iteration the cloud and the two ladders; MH's start and its steps
    expected = {}
    for B, n in ((1, 2), (hill["cloud_size"], hill["iterations"]),
                 (hill["max_backtrack"], hill["iterations"]),
                 (hill["max_expansion"], hill["iterations"]),
                 (1024, 1 + steps)):
        regime = forward_pick(B)
        expected.setdefault(B, {})
        expected[B][regime] = expected[B].get(regime, 0) + n
    print(f"[main-hill] K1 launches {counts['k1']} by chain count and regime "
          f"{by_batch} (expected {expected}; "
          f"{ {B: REGIMES[forward_pick(B)] for B in expected} })", flush=True)
    if by_batch != expected:
        fail(f"sepaihrd_main hillmcmc launched K1 {by_batch}, expected "
             f"{expected}")
    if not (abs(s["best_logl"]) < float("inf")
            and s["best_logl"] >= s["initial_logl"]):
        fail(f"sepaihrd_main: best {s['best_logl']} not finite and >= "
             f"initial {s['initial_logl']}")
    if not (abs(s["r0"]) < float("inf") and s["r0"] > 0):
        fail(f"sepaihrd_main: R0 {s['r0']}")
    for rel in ("sepaihrd_age_baseline_results.csv",
                "calibrated_parameters.txt",
                "sepaihrd_age_calibrated_results.csv",
                "mcmc_aggregated/metrics_summary.csv",
                "posterior_predictive/daily_deaths_median.csv"):
        if not os.path.exists(os.path.join(out_dir, rel)):
            fail(f"sepaihrd_main did not write {rel}")
    hill_s = s["phase1_seconds"] / hill["iterations"]
    steps_per_s = 1024 * steps / s["phase2_seconds"]
    print(f"[main-hill] sepaihrd_main hillmcmc, 1024 chains, scale "
          f"{MAIN_SCALE}: {wall:.1f} s in all; hill climber "
          f"{hill['iterations']} iterations of a {hill['cloud_size']}-point "
          f"cloud + 10 + 12 ladder points, {hill_s:.4f} s an iteration; "
          f"AM-MH {steps} steps, {steps_per_s:.4e} chain-steps/s; report "
          f"{s['report_draws']} draws in {s['report_seconds']:.2f} s; best "
          f"logL {s['best_logl']:.6e} >= initial {s['initial_logl']:.6e}; "
          f"R0 {s['r0']:.4f} on {card}", flush=True)
    hillmcmc = dict(s, wall_seconds=wall, launches=counts,
                    hill_seconds_per_iteration=hill_s,
                    chain_steps_per_s=steps_per_s, k1_compare=hill_cases)

    row = k3_pick_row(cache, 64)
    zero_counts()
    t0 = time.perf_counter()
    s = sepaihrd_main.run(["--algorithm", "nuts", "--chains", "64",
                           "--skip-report", "--output-dir",
                           os.path.join(HERE, "chiprun_out",
                                        "chip_smoke_main_nuts")] + common)
    wall = time.perf_counter() - t0
    counts = read_counts("main-nuts", 64, [row])
    if min(counts["k2"], counts["k3"]) < 200 or counts["k1"] != 1:
        fail(f"sepaihrd_main nuts launched K1/K2/K3 {counts}")
    if s["samples_shape"] != [25, 64, 62] or not abs(s["best_logl"]) < float("inf"):
        fail(f"sepaihrd_main nuts: samples {s['samples_shape']}, best "
             f"{s['best_logl']}")
    print(f"[main-nuts] sepaihrd_main nuts, 64 chains, nuts_settings.txt: "
          f"{wall:.1f} s; NUTS {s['phase2_seconds']:.2f} s, K2/K3 launches "
          f"{counts['k2']}/{counts['k3']}; best logL {s['best_logl']:.6e}, "
          f"R0 {s['r0']:.4f} on {card}", flush=True)
    return dict(hillmcmc=hillmcmc, nuts=dict(s, wall_seconds=wall,
                                             launches=counts))


def report_phase(card):
    """Phase 13: the 50 000-draw report against the committed tree, its
    speed, and the card's idle share over one replay batch."""
    import numpy as np
    import torch
    import report_anchor as ra
    from mmidv1_tpu_torch.analysis.report import _replay_fn
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    out = os.path.join(HERE, "chiprun_out", "report_anchor_torch_cuda")
    seconds, n = ra.run_torch(out, "cuda", "float32")
    ra.drop_bulky(out)
    groups = ra.compare_trees(out)
    max_err = max(g["max_err"] for g in groups.values())
    for name, g in groups.items():
        print(f"[report] {name}: {g['files']} files, {g['values']} values, max "
              f"error {g['max_err']:.3e} beyond the last printed digit (bar "
              f"{ra.GROUP_RTOL[name]:.0e}; {g['file']} {g['where']})",
              flush=True)
    print(f"[report] 50 000 draws in {seconds:.1f} s = {n / seconds:.1f} "
          f"draws/s (float32, batches of 1024, dopri5@4) on {card}; max error "
          f"vs the committed tree {max_err:.3e}", flush=True)
    over = ra.over_bar(groups)
    if over:
        fail(f"report vs results/spain2020/analysis: (error, bar) by group "
             f"{over}")

    # one replay batch: wall time on the host clock, and the card's busy time
    pipe = load_spain_pipeline(HERE, dtype=torch.float32, device="cuda")
    base_y0 = torch.as_tensor(pipe.data.initial_sepaihrd_state(
        sigma=pipe.params.sigma, gamma_p=pipe.params.gamma_p,
        gamma_A=pipe.params.gamma_A, gamma_I=pipe.params.gamma_I,
        p=pipe.params.p, h=pipe.params.h), dtype=torch.float32, device="cuda")
    replay = _replay_fn(pipe.space, pipe.params, base_y0,
                        torch.as_tensor(pipe.ts, dtype=torch.float32,
                                        device="cuda"), 4, False)
    batch = torch.as_tensor(ra.load_posterior()[:1024], device="cuda")
    with torch.inference_mode():                 # as generate_full_report
        run = lambda: replay(batch)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = device_busy_ms(run)
    idle = 1 - busy_ms / batch_ms
    print(f"[report] one replay batch of 1024 draws: {batch_ms:.1f} ms on the "
          f"host clock, the card busy {busy_ms:.1f} ms of it (idle share "
          f"{idle:.3f}) on {card}", flush=True)
    return dict(seconds=seconds, draws=n, draws_per_s=n / seconds,
                groups=groups, max_err=max_err, rtol=ra.GROUP_RTOL,
                batch_ms=batch_ms, batch_device_busy_ms=busy_ms,
                batch_idle_share=idle, out=out,
                committed_rows_checked=int(np.sum([g["values"] for g in
                                                   groups.values()])))


def serovalid_phase(card):
    """Phase 14: the ENE-COVID term in float64 on the card, against the
    committed serovalid MAP and against the same call on the CPU."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.serovalid import (make_sero_penalty,
                                                        relax_bounds)
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.data import read_sepaihrd_parameters
    sv = os.path.join(HERE, "results", "spain2020_serovalid")
    with open(os.path.join(sv, "serovalid_metadata.json")) as f:
        target = json.load(f)["sero_day64"]
    noise = np.random.default_rng(14).standard_normal((2, 62))
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = load_spain_pipeline(HERE, dtype=torch.float64, device=dev)
        space, _idx = relax_bounds(pipe.space)
        calib = read_sepaihrd_parameters(
            os.path.join(sv, "calibrated_parameters.txt"), 4,
            N=pipe.data.population_by_age,
            M_baseline=pipe.params.M_baseline.cpu().numpy(),
            dtype=torch.float64, device=dev)
        theta = space.extract(calib)
        sig = space.sigmas
        thetas = torch.stack([theta] + [
            theta + 0.02 * sig * torch.as_tensor(z, device=dev) for z in noise])
        pen = make_sero_penalty(space, pipe.params, pipe.data, pipe.ts)
        sero = float(pen.sero_of(theta))
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, grad = pen.value_and_grad(thetas)
        value, grad = value.cpu().numpy(), grad.cpu().numpy()
        out[dev] = dict(sero=sero, value=value, grad=grad,
                        seconds=time.perf_counter() - t0)
    c, h = out["cuda"], out["cpu"]
    rel_sero = abs(c["sero"] - target) / target
    rel_v = float(np.max(np.abs(c["value"] - h["value"]) / np.abs(h["value"])))
    rel_g = float(np.max(np.abs(c["grad"] - h["grad"]) /
                         (np.abs(h["grad"]) + np.abs(h["grad"]).max())))
    print(f"[serovalid] float64 sero_day64 at the committed serovalid MAP "
          f"{c['sero']:.6f} vs {target:.6f} (rel err {rel_sero:.3e}, bar 5e-3); "
          f"penalty {c['value'].tolist()}; card vs CPU: value rel err "
          f"{rel_v:.3e}, gradient {rel_g:.3e} (bar 1e-9); value_and_grad of 3 "
          f"draws {c['seconds']:.2f} s on {card} ({h['seconds']:.2f} s on the "
          f"host)", flush=True)
    if not (np.isfinite(c["value"]).all() and np.isfinite(c["grad"]).all()):
        fail("serovalid: non-finite penalty or gradient on the card")
    if not (rel_sero <= 5e-3 and rel_v <= 1e-9 and rel_g <= 1e-9):
        fail(f"serovalid: sero {rel_sero:.3e}, value {rel_v:.3e}, gradient "
             f"{rel_g:.3e}")
    return dict(sero_day64=c["sero"], target=target, rel_err=rel_sero,
                penalty=c["value"].tolist(), card_vs_cpu_value=rel_v,
                card_vs_cpu_grad=rel_g, seconds=c["seconds"],
                cpu_seconds=h["seconds"])


def main_phases(cache, card):
    """Phases 12-14."""
    t0 = time.perf_counter()
    out = dict(primary=primary_executable(cache, card),
               report=report_phase(card), serovalid=serovalid_phase(card))
    out["seconds"] = time.perf_counter() - t0
    print(f"[main] phases 12-14: {out['seconds']:.1f} s on {card}", flush=True)
    return out


def bench_phase(card):
    """Phase 15: the port's bench, K1 counted by chain count and regime."""
    import math
    from mmidv1_tpu_torch.cli import benchmark_main
    from mmidv1_tpu_torch.ops import fused_objective
    batch, iterations, repeats = 4096, 20, 5
    zero_counts()
    t0 = time.perf_counter()
    res = benchmark_main.run(
        ["--mode", "all", "--batch", str(batch), "--iterations",
         str(iterations), "--repeats", str(repeats), "--json", "--device",
         "cuda", "--project-root", HERE])
    wall = time.perf_counter() - t0
    by_batch = {B: dict(v) for B, v in fused_objective.batch_calls.items()}
    print(json.dumps(res), flush=True)
    bad = [k for k, v in res.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        fail(f"bench: non-finite {bad}")
    # micro: the first call, the repeats, the back-to-back calls
    micro = 1 + repeats + repeats * benchmark_main.INSCAN_CALLS
    if forward_pick(batch) != 2 or by_batch.get(batch) != {2: micro}:
        fail(f"bench: K1 at B = {batch} ran {by_batch.get(batch)}, expected "
             f"all {micro} wide")
    for B, calls in by_batch.items():
        if B != batch and (B > 1024 or set(calls) != {1}):
            fail(f"bench: K1 at B = {B} ran {calls}, expected split at "
                 f"1024 chains and below")
    print(f"[bench] mode all, batch {batch}, {iterations} iterations, "
          f"{repeats} repeats: {wall:.1f} s; micro "
          f"{res['micro_evals_per_sec']:.4e} evals/s (min "
          f"{res['micro_evals_per_sec_min']:.4e}, max "
          f"{res['micro_evals_per_sec_max']:.4e}), back to back "
          f"{res['micro_evals_per_sec_inscan']:.4e}; mcmc "
          f"{res['mcmc_chain_steps_per_sec']:.4e} chain-steps/s; K1 by chain "
          f"count and regime {by_batch} on {card}", flush=True)
    return dict(results=res, wall_seconds=wall,
                launches=dict(k1=fused_objective.launches,
                              k1_regime_calls=dict(fused_objective.regime_calls),
                              k1_batch_calls=by_batch))


CAMPAIGN_CHAINS = 8192


def drive_campaign(name, argv, card, expected):
    """One ``production_campaign`` run on the card, K1 counted from 0: every
    call at 8192 chains in the wide regime, ``expected`` of them (the start
    unless resumed, one a step, the float64 re-selection)."""
    from mmidv1_tpu_torch.cli import production_campaign
    from mmidv1_tpu_torch.ops import fused_objective
    zero_counts()
    t0 = time.perf_counter()
    meta = production_campaign.run(argv)
    wall = time.perf_counter() - t0
    by_batch = {B: dict(v) for B, v in fused_objective.batch_calls.items()}
    if forward_pick(CAMPAIGN_CHAINS) != 2 or set(by_batch) != {CAMPAIGN_CHAINS} \
            or by_batch[CAMPAIGN_CHAINS] != {2: expected}:
        fail(f"campaign {name}: K1 by chain count and regime {by_batch}, "
             f"expected {expected}, all at {CAMPAIGN_CHAINS} chains, wide")
    acc = meta["mean_acceptance"]
    if not (0.0 < acc < 1.0 and abs(meta["best_logl_float64"]) < float("inf")):
        fail(f"campaign {name}: acceptance {acc}, float64 MAP "
             f"{meta['best_logl_float64']}")
    print(f"[campaign] {name}: {wall:.1f} s, "
          f"{meta['chain_steps_per_sec_incl_host']:.4e} chain-steps/s, mean "
          f"acceptance {acc:.4f}, float64 MAP {meta['best_logl_float64']:.8e}"
          f", K1 {fused_objective.launches} launches, all wide on {card}",
          flush=True)
    return dict(meta=meta, wall_seconds=wall,
                launches=dict(k1=fused_objective.launches,
                              k1_regime_calls=dict(fused_objective.regime_calls),
                              k1_batch_calls=by_batch))


def same_bits(a_dir, b_dir, prefix, segments):
    """The segment files, the checkpoint's ``x`` and the trace of two
    campaign directories are equal to the bit."""
    import numpy as np
    ckpt = "campaign_checkpoint" + ("_pt" if prefix == "pt" else "") + ".npz"
    names = [f"{prefix}_segment_{s:04d}.npz" for s in range(segments)]
    for name, keys in [(n, ("samples", "sample_logps")) for n in names] + [
            (ckpt, ("x", "logp", "best_x"))]:
        with np.load(os.path.join(a_dir, name)) as a, \
                np.load(os.path.join(b_dir, name)) as b:
            for k in keys:
                if a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes():
                    fail(f"resumed campaign differs from the uninterrupted "
                         f"one in {name}:{k}")
    with open(os.path.join(a_dir, "posterior_trace.csv"), "rb") as fa, \
            open(os.path.join(b_dir, "posterior_trace.csv"), "rb") as fb:
        if fa.read() != fb.read():
            fail("resumed campaign's posterior_trace.csv differs")
    return len(names) + 2


def prune_campaign(out_dir):
    """Keep a checked campaign's metadata and parameters, drop its bulk
    (trace, segment files, checkpoint: ~70 MB at 8192 chains)."""
    for name in os.listdir(out_dir):
        if name.endswith((".npz", ".csv")):
            os.remove(os.path.join(out_dir, name))


def campaign_phases(cache, card):
    """Phases 15-17: K1 against its plain version at the bench's and the
    campaigns' shapes, the bench, the AM / DE campaigns at 8192 chains, the
    8-rung PT campaign; each campaign killed and resumed to the bit."""
    import shutil
    t0 = time.perf_counter()
    k1_compare = [compare(f"float32 dopri5@4 B={B} ({what} shape)", B,
                          "float32", "dopri5", 4, FWD_TOL["float32"], cache,
                          seed=300 + B)
                  for B, what in ((4096, "bench micro"),
                                  (CAMPAIGN_CHAINS, "campaign"))]
    out = dict(k1_compare=k1_compare, bench=bench_phase(card))
    base = os.path.join(HERE, "chiprun_out", "campaign")
    shutil.rmtree(base, ignore_errors=True)
    common = ["--chains", str(CAMPAIGN_CHAINS), "--thinning", "25",
              "--burn-in", "50", "--skip-report", "--device", "cuda"]
    full = ["--iterations", "200", "--segments", "4"]
    half = ["--iterations", "100", "--segments", "2"]
    for name, extra in (("am", []), ("pt", ["--rungs", "8"])):
        d_full, d_kill = (os.path.join(base, f"{name}{s}")
                          for s in ("", "_killed"))
        # K1 calls: the start, 50 steps a segment, the float64 re-selection
        runs = dict(
            full=drive_campaign(name, common + extra + full + ["--out", d_full],
                                card, 1 + 200 + 1),
            killed=drive_campaign(f"{name} killed after 2 segments",
                                  common + extra + half + ["--out", d_kill],
                                  card, 1 + 100 + 1),
            resumed=drive_campaign(f"{name} resumed",
                                   common + extra + full + ["--out", d_kill],
                                   card, 100 + 1))
        if runs["resumed"]["meta"]["segments"] != 4:
            fail(f"campaign {name}: resume ran {runs['resumed']['meta']}")
        runs["files_equal"] = same_bits(d_full, d_kill,
                                        "mh" if name == "am" else "pt", 4)
        print(f"[campaign] {name}: killed after 2 of 4 segments and resumed: "
              f"{runs['files_equal']} files equal to the uninterrupted run's "
              f"to the bit", flush=True)
        if name == "pt":
            import numpy as np
            meta = runs["full"]["meta"]
            swap, betas = np.asarray(meta["swap_rate"]), \
                np.asarray(meta["final_ladder"])
            if len(swap) != 7 or not np.isfinite(swap).all() or \
                    betas[0] != 1.0 or not (np.diff(betas) < 0).all():
                fail(f"PT: swap rates {swap}, final ladder {betas}")
            print(f"[campaign] pt: swap rates per pair {swap.round(4)}, final "
                  f"ladder {betas.round(5)}", flush=True)
        out[name] = runs
        prune_campaign(d_full)
        prune_campaign(d_kill)
    out["de"] = dict(full=drive_campaign(
        "de", common + full + ["--proposal", "de", "--out",
                               os.path.join(base, "de")], card,
        1 + 200 + 1))
    prune_campaign(os.path.join(base, "de"))
    out["seconds"] = time.perf_counter() - t0
    print(f"[campaign] phases 15-17: {out['seconds']:.1f} s on {card}",
          flush=True)
    return out


def campaign_paths(camp):
    """K1's launches on phases 15-17, by path."""
    paths = {"bench (benchmark_main --mode all, batch 4096)":
             camp["bench"]["launches"]}
    for name, label in (("am", "AM-MH"), ("pt", "PT 8 x 1024")):
        for run in ("full", "killed", "resumed"):
            paths[f"campaign {label} B=8192 ({run})"] = \
                camp[name][run]["launches"]
    paths["campaign DE-MC B=8192"] = camp["de"]["full"]["launches"]
    return paths


SIR_CONFIG = os.path.join(HERE, "data", "configuration",
                          "sir_input_parameters.txt")
# card vs host: tests/test_integrators.py:113's bar in float64; in float32
# the bar of the float32 parity test (tests/test_torch_adaptive.py): one
# accept/reject decision that rounds the other way moves the trajectory by
# the solver's own tolerance (sir_model float32 read 5.1e-6 on an H100,
# 459 attempts against the host's 456)
ADAPTIVE_RTOL = {"float64": 1e-6, "float32": 1e-5}
SIR_MAIN_RTOL = 1e-9     # the --x64 mains' CSVs, card vs host
PSO_SWARM = 512
SIR_DEMO_DAYS = 120      # phase 20's window (see the docstring)


def rel_err(a, b):
    """max |a - b| / (|b| + 1e-8 max |b|), the measure of
    ``tests/test_integrators.py``; inf unless both are finite."""
    import numpy as np
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-8 * np.abs(b).max())))


def adaptive_runs(name, solve, dtype_name, card):
    """``solve(device, stats)`` on the card and on the host: the reading
    and, for each, the controller's attempts and seconds."""
    out = {}
    for dev in ("cuda", "cpu"):
        stats = {}
        t0 = time.perf_counter()
        y = solve(dev, stats).cpu().numpy()
        out[dev] = dict(y=y, attempts=stats["attempts"],
                        seconds=time.perf_counter() - t0)
    err, bar = rel_err(out["cuda"]["y"], out["cpu"]["y"]), \
        ADAPTIVE_RTOL[dtype_name]
    print(f"[adaptive] {name} {dtype_name}: card {out['cuda']['attempts']} "
          f"attempts in {out['cuda']['seconds']:.3f} s, host "
          f"{out['cpu']['attempts']} in {out['cpu']['seconds']:.3f} s; card vs "
          f"host {err:.3e} (bar {bar:.0e}) on {card}", flush=True)
    if not err <= bar:
        fail(f"adaptive {name} {dtype_name}: card vs host {err:.3e} > "
             f"{bar:.0e}")
    return dict(case=f"{name} {dtype_name}", rel_err=err, bar=bar,
                **{f"{d}_{k}": out[d][k] for d in out
                   for k in ("attempts", "seconds")})


def adaptive_phase(cache, card):
    """Phase 18: the adaptive integrators, card against host."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.data import (CalibrationData,
                                       read_scalar_sir_parameters)
    from mmidv1_tpu_torch.data.contact_matrix import read_matrix_from_csv
    from mmidv1_tpu_torch.models import sepaihrd, sir
    from mmidv1_tpu_torch.ode import integrate_times

    t_phase = time.perf_counter()
    prm = read_scalar_sir_parameters(SIR_CONFIG)
    p = sir.SIRParams(N=prm["N"], beta=prm["beta"], gamma=prm["gamma"])
    ts = np.arange(0.0, 366.0)
    y0 = [prm["S0"], prm["I0"], prm["R0"]]
    kw = dict(atol=prm["eps"], rtol=0.0, dt0=prm["h"], method="rkf45")
    runs = []
    for dtype in (torch.float64, torch.float32):
        runs.append(adaptive_runs(
            "sir_model solve",
            lambda dev, st: integrate_times(
                lambda t, y: sir.sir_rhs(t, y, p),
                torch.tensor(y0, dtype=dtype, device=dev), ts, stats=st, **kw),
            str(dtype)[6:], card))

    C = read_matrix_from_csv(os.path.join(HERE, "data", "contacts.csv"), 4, 4)
    data = CalibrationData.from_csv(
        os.path.join(HERE, "data", "processed", "processed_data.csv"),
        "2020-03-01", "2020-12-31")
    N, I0 = data.population_by_age, data.initial_active_cases()
    y0_age = np.stack([N - I0, I0, np.zeros_like(I0)])
    for dtype in (torch.float64, torch.float32):
        def age_solve(dev, st, dtype=dtype):
            params = sir.make_age_sir_params(N=N, C=C, q=0.05, gamma=[0.1] * 4,
                                             dtype=dtype, device=dev)
            y = torch.as_tensor(y0_age).to(dev, dtype)
            return sir.solve_age_sir(params, y, np.arange(0.0, 101.0),
                                     method="adaptive", stats=st)
        runs.append(adaptive_runs("age-SIR baseline 100 days dopri5 1e-6",
                                  age_solve, str(dtype)[6:], card))

    def spain_solve(dev, st):
        pipe = (cache["float64"] if dev == "cuda" and "float64" in cache else
                load_spain_pipeline(HERE, dtype=torch.float64, device=dev))
        y = sepaihrd.runup_seeded_state(pipe.params, None)
        return sepaihrd.solve(pipe.params, y, pipe.ts, method="adaptive",
                              atol=1e-9, rtol=1e-9, stats=st)
    runs.append(adaptive_runs("SEPAIHRD Spain grid (326 points) atol=rtol=1e-9",
                              spain_solve, "float64", card))

    # one controller a lane: 8 lanes of different beta, each as if alone
    betas = np.linspace(0.15, 1.6, 8)
    lane_p = sir.SIRParams(N=prm["N"], beta=torch.tensor(betas, device="cuda"),
                           gamma=prm["gamma"])
    st = {}
    t0 = time.perf_counter()
    batch = integrate_times(lambda t, y: sir.sir_rhs(t, y, lane_p),
                            torch.tensor(y0, dtype=torch.float64,
                                         device="cuda").expand(8, 3),
                            ts, batch_dims=1, stats=st, **kw).cpu().numpy()
    batch_s = time.perf_counter() - t0
    alone, worst = [], 0.0
    for i, beta in enumerate(betas):
        one = {}
        pi = sir.SIRParams(N=prm["N"], beta=float(beta), gamma=prm["gamma"])
        y = integrate_times(lambda t, y: sir.sir_rhs(t, y, pi),
                            torch.tensor(y0, dtype=torch.float64,
                                         device="cuda"), ts, stats=one,
                            **kw).cpu().numpy()
        diff = np.abs(batch[:, i] - y)
        if not (diff <= 1e-12 * np.abs(y)).all():
            fail(f"adaptive: lane {i} of the batch differs from its solve "
                 f"alone by {diff.max():.3e}")
        worst = max(worst, float((diff / np.maximum(np.abs(y), 1e-300)).max()))
        alone.append(one["attempts"])
    print(f"[adaptive] 8 lanes, batch_dims=1, float64: {st['attempts']} "
          f"attempts in {batch_s:.3f} s (alone: {alone}); every lane equals "
          f"its solve alone, worst rel diff {worst:.3e} (bar 1e-12)",
          flush=True)
    out = dict(runs=runs, lanes=dict(betas=betas.tolist(),
                                     attempts=st["attempts"],
                                     seconds=batch_s, alone_attempts=alone,
                                     worst_rel_diff=worst))
    out["seconds"] = time.perf_counter() - t_phase
    return out


def dispatch(argv):
    """``python -m mmidv1_tpu_torch.cli argv...`` in this process: its
    printout and seconds; fails unless it exits 0."""
    import contextlib
    import io
    from mmidv1_tpu_torch.cli.__main__ import main as cli_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    seconds = time.perf_counter() - t0
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        fail(f"{' '.join(argv[:1])} exited {rc}")
    return buf.getvalue(), seconds


def read_csv(path):
    import numpy as np
    with open(path) as f:
        header = f.readline().strip()
    return header, np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def sir_mains_phase(card):
    """Phase 19: the four SIR mains through the dispatcher."""
    import shutil
    import numpy as np
    import torch
    from mmidv1_tpu_torch.data import read_scalar_sir_parameters
    from mmidv1_tpu_torch.models import sir

    t_phase = time.perf_counter()
    base = os.path.join(HERE, "chiprun_out", "sir_mains")
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    for cmd, csv in (("sir_model", "sir_result.csv"),
                     ("sir_pop_var", "sir_variable_population_result.csv")):
        res = {}
        for dev in ("cuda", "cpu"):
            _, res[dev] = dispatch([cmd, "--x64", "--device", dev, "--params",
                                    SIR_CONFIG, "--output-dir",
                                    os.path.join(base, f"{cmd}_{dev}")])
        (hc, c), (hh, h) = (read_csv(os.path.join(base, f"{cmd}_{d}", csv))
                            for d in ("cuda", "cpu"))
        diff = np.abs(c - h)
        err = float((diff / np.where(h == 0, 1.0, np.abs(h))).max()) \
            if c.shape == h.shape else float("inf")
        print(f"[sir-mains] {cmd} --x64: card {res['cuda']:.2f} s, host "
              f"{res['cpu']:.2f} s; CSV {c.shape}, card vs host {err:.3e} (bar "
              f"{SIR_MAIN_RTOL:.0e}) on {card}", flush=True)
        if hc != hh or not err <= SIR_MAIN_RTOL:
            fail(f"{cmd}: card CSV differs from the host's ({hc!r} / {hh!r}, "
                 f"{err:.3e})")
        out[cmd] = dict(card_seconds=res["cuda"], host_seconds=res["cpu"],
                        rel_err=err, rows=int(c.shape[0]))

    # the committed stochastic run: 100 simulations x 36 000 steps, float32
    prm = read_scalar_sir_parameters(SIR_CONFIG)
    d = os.path.join(base, "sir_stochastic")
    _, secs = dispatch(["sir_stochastic", "--device", "cuda", "--params",
                        SIR_CONFIG, "--output-dir", d])
    n_sims, h = int(prm["numSimulations"]), max(prm["h"], 0.01)
    steps = int(np.floor((prm["t_end"] - prm["t_start"]) / h))
    sims = sorted(f for f in os.listdir(d) if f.startswith("stochastic_sir_sim_"))
    if len(sims) != min(n_sims, 100):
        fail(f"sir_stochastic wrote {len(sims)} per-simulation CSVs")
    final_R = []
    for name in sims:
        hdr, t = read_csv(os.path.join(d, name))
        if hdr != "t,S,I,R" or t.shape != (steps + 1, 4):
            fail(f"sir_stochastic {name}: {hdr!r} {t.shape}")
        if (t[:, 1:] < 0).any() or (t[:, 1:].sum(axis=1) != prm["N"]).any():
            fail(f"sir_stochastic {name}: a negative count or the population "
                 "not conserved")
        final_R.append(t[-1, 3])
    hdr, st = read_csv(os.path.join(d, "stochastic_sir_stats.csv"))
    median, p05, p95 = st[:, 4:7], st[:, 7:10], st[:, 10:13]
    if st.shape != (steps + 1, 13) or not ((p05 <= median).all()
                                           and (median <= p95).all()):
        fail(f"sir_stochastic stats {st.shape}: p05 <= median <= p95 broken")
    for name in sims:
        os.remove(os.path.join(d, name))
    t0 = time.perf_counter()
    host = sir.run_stochastic_sir(
        sir.SIRParams(N=prm["N"], beta=prm["beta"], gamma=prm["gamma"]),
        [prm["S0"], prm["I0"], prm["R0"]], prm["t_start"], prm["t_end"], h,
        n_sims, generator=torch.Generator().manual_seed(1),
        dtype=torch.float32, device="cpu").numpy()[:, -1, 2]
    host_s = time.perf_counter() - t0
    card_R = np.asarray(final_R)
    se = float(np.sqrt(card_R.var(ddof=1) / len(card_R)
                       + host.var(ddof=1) / len(host)))
    gap = abs(float(card_R.mean()) - float(host.mean()))
    print(f"[sir-mains] sir_stochastic: {n_sims} simulations x {steps} steps "
          f"on the card, {secs:.2f} s with the CSVs; population conserved, all "
          f">= 0, p05 <= median <= p95; mean final R card {card_R.mean():.3f} "
          f"vs host {host.mean():.3f} (host run {host_s:.2f} s): gap "
          f"{gap:.3f} = {gap / se:.2f} SE (bar 5) on {card}", flush=True)
    if not gap <= 5.0 * se:
        fail(f"sir_stochastic: mean final R {card_R.mean()} vs host "
             f"{host.mean()}, {gap / se:.2f} standard errors")
    out["sir_stochastic"] = dict(seconds=secs, simulations=n_sims, steps=steps,
                                 mean_final_R=float(card_R.mean()),
                                 host_mean_final_R=float(host.mean()),
                                 gap_se=gap / se, host_seconds=host_s)

    text, secs = dispatch(["sir_age_structured_main", "--device", "cuda",
                           "--project-root", HERE, "--output-dir",
                           os.path.join(base, "sir_age_structured_main")])
    peak = lambda k: float(text.split(f"peak_infected_{k}")[1].split()[0])
    base_peak, int_peak = peak("baseline"), peak("intervention")
    print(f"[sir-mains] sir_age_structured_main: {secs:.2f} s; peak "
          f"{base_peak} baseline > {int_peak} with the intervention on {card}",
          flush=True)
    if not base_peak > int_peak > 0:
        fail(f"sir_age_structured_main peaks {base_peak} / {int_peak}")
    out["sir_age_structured_main"] = dict(seconds=secs, peak_baseline=base_peak,
                                          peak_intervention=int_peak)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def sir_demo_phase(card):
    """Phase 20: the age-SIR calibration demo, and its objective's seconds
    a call at 32 and 1024 chains."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.cli import sir_calibration_demo as demo

    t_phase = time.perf_counter()
    d = os.path.join(HERE, "chiprun_out", "sir_calibration_demo")
    chains, mcmc_iters = 32, 10
    argv = ["--device", "cuda", "--project-root", HERE, "--chains",
            str(chains), "--hill-iters", "2", "--mcmc-iters", str(mcmc_iters),
            "--burn-in", "2", "--num-days", str(SIR_DEMO_DAYS),
            "--output-dir", d]
    t0 = time.perf_counter()
    s = demo.run(argv)
    wall = time.perf_counter() - t0
    hdr, samples = read_csv(s["mcmc_samples"])
    bhdr, best = read_csv(s["best_fit"])
    want = ("sample_index,objective_value,q,scale_C_total,gamma_0,gamma_1,"
            "gamma_2,gamma_3")
    if hdr != want or samples.shape != (chains * mcmc_iters, 8) or \
            bhdr != ("Time,simulated_I_0_30,simulated_I_30_60,"
                     "simulated_I_60_80,simulated_I_80_plus") or \
            best.shape != (SIR_DEMO_DAYS, 5):
        fail(f"sir demo CSVs: {hdr!r} {samples.shape}, {bhdr!r} {best.shape}")
    if not (s["samples_finite"] and np.isfinite(samples).all()
            and s["best_logl"] >= s["initial_logl"]):
        fail(f"sir demo: best {s['best_logl']} vs initial {s['initial_logl']}"
             f", samples finite {s['samples_finite']}")
    args = demo.build_parser().parse_args(["--project-root", HERE])
    _root, space, params0, _y0, _ts, ll, _ = demo.setup(
        args, torch.device("cuda"), torch.float32)
    theta0 = space.extract(params0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    call_s = {}
    for B in (chains, 1024):
        thetas = theta0 + 0.01 * space.sigmas * torch.randn(
            (B, space.dim), generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = ll(thetas)
        torch.cuda.synchronize()
        call_s[B] = time.perf_counter() - t0
        if not torch.isfinite(v).all():
            fail(f"sir objective at {B} chains is not finite")
    print(f"[sir-demo] sir_age_structured_calibration_demo, {SIR_DEMO_DAYS} "
          f"days, {chains} chains, 2 hill iterations, {mcmc_iters} MH steps: "
          f"{wall:.1f} s (hill {s['phase1_seconds']:.1f} s, MH "
          f"{s['phase2_seconds']:.1f} s); best {s['best_logl']:.6e} >= initial "
          f"{s['initial_logl']:.6e}; one objective call at 306 days "
          f"{call_s[chains]:.3f} s at {chains} chains, {call_s[1024]:.3f} s at "
          f"1024 on {card}",
          flush=True)
    return dict(s, wall_seconds=wall,
                objective_call_seconds={str(B): v for B, v in call_s.items()},
                seconds=time.perf_counter() - t_phase)


def pso_variants_phase(cache, card):
    """Phase 21: PSO's QUANTUM, LEVY_FLIGHT and HYBRID through K1."""
    import dataclasses
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.param_space import CLAMP
    from mmidv1_tpu_torch.calibration.pso import (PSOConfig, PSOState,
                                                  PSOVariant, _neighbor_table,
                                                  _step_draws, pso_step,
                                                  run_pso)
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import build_objective_fused, fused_objective

    t_phase = time.perf_counter()
    k1_compare = compare(f"float32 dopri5@4 B={PSO_SWARM} (PSO swarm shape)",
                         PSO_SWARM, "float32", "dopri5", 4, FWD_TOL["float32"],
                         cache, seed=400)
    if "float32" not in cache:
        cache["float32"] = load_spain_pipeline(HERE, dtype=torch.float32,
                                               device="cuda")
    pipe = cache["float32"]
    ll = build_objective_fused(pipe.space, pipe.params, pipe.data, pipe.ts,
                               substeps=4, tableau="dopri5",
                               constraint_mode=CLAMP, device="cuda")
    ll0 = float(ll(pipe.theta0[None, :])[0])
    host = lambda t: t.cpu() if torch.is_tensor(t) else t
    host_space = dataclasses.replace(pipe.space, lower=pipe.space.lower.cpu(),
                                     upper=pipe.space.upper.cpu(),
                                     sigmas=pipe.space.sigmas.cpu())
    width = (pipe.space.upper - pipe.space.lower).cpu().numpy()
    runs = {}
    for variant in (PSOVariant.QUANTUM, PSOVariant.LEVY_FLIGHT,
                    PSOVariant.HYBRID):
        cfg = dataclasses.replace(
            PSOConfig.from_settings(pipe.settings.get("pso", {})),
            swarm_size=PSO_SWARM, iterations=5, variant=variant)
        # opposition-based start, one call an iteration; HYBRID's elitist
        # probe (3 points) at iteration 0
        expected = {PSO_SWARM: {forward_pick(PSO_SWARM): (
            2 if cfg.use_opposition_learning else 1) + cfg.iterations}}
        if variant == PSOVariant.HYBRID:
            expected[3] = {forward_pick(3): 1}
        gen = torch.Generator(device="cuda").manual_seed(int(variant))
        zero_counts()
        t0 = time.perf_counter()
        res = run_pso(ll, pipe.space, cfg, generator=gen, theta0=pipe.theta0)
        best = float(res.best_f)
        wall = time.perf_counter() - t0
        by_batch = {B: dict(v) for B, v in fused_objective.batch_calls.items()}
        in_bounds = bool(pipe.space.in_bounds(res.best_x))
        print(f"[pso] {variant.name}: {PSO_SWARM} particles x {cfg.iterations} "
              f"iterations, {wall:.2f} s; best logL {best:.6e} > start "
              f"{ll0:.6e}, in bounds {in_bounds}; K1 by chain count and regime "
              f"{by_batch} (expected {expected}) on {card}", flush=True)
        if by_batch != expected or any(r != 1 for v in by_batch.values()
                                       for r in v):
            fail(f"PSO {variant.name}: K1 ran {by_batch}, expected {expected}"
                 f", all split")
        # particle 0 starts at theta0, so only a strict gain shows a search
        if not (best > ll0 and in_bounds):
            fail(f"PSO {variant.name}: best {best} vs start {ll0}, in bounds "
                 f"{in_bounds}")
        runs[variant.name] = dict(best_logl=best, start_logl=ll0,
                                  wall_seconds=wall,
                                  launches=dict(
                                      k1=fused_objective.launches,
                                      k1_regime_calls=dict(
                                          fused_objective.regime_calls),
                                      k1_batch_calls=by_batch))
        # one more step from the run's final state, on the card and on the
        # host, fed the same draws and the same fitness values (K1's, read
        # on the card): the update's arithmetic. The quantum move reaches
        # log(1 / u) <= 27.6 widths before its clamp, so a few float32 ulps
        # there are ~1e-5 of the width; a wrong update is of order 1
        dgen = torch.Generator(device="cuda").manual_seed(100 + int(variant))
        rand = lambda *shape: torch.rand(shape, generator=dgen,
                                         dtype=torch.float32, device="cuda")
        randn = lambda *shape: torch.randn(shape, generator=dgen,
                                           dtype=torch.float32, device="cuda")
        draws = _step_draws(cfg, PSO_SWARM, pipe.space.dim, rand, randn, dgen,
                            "cuda")
        seen = []

        def card_fit(x):
            seen.append(ll(x))
            return seen[-1]
        it = cfg.iterations - 1
        tab = _neighbor_table(cfg)
        on_card = pso_step(res.final_state, draws, it, cfg, pipe.space,
                           card_fit, tab)
        on_host = pso_step(PSOState(*map(host, res.final_state)),
                           type(draws)(*map(host, draws)), it, cfg, host_space,
                           lambda x: seen[0].cpu(), tab)
        step_err = {}
        for key in ("x", "v", "pbest_x", "gbest_x"):
            a = getattr(on_card, key).cpu().numpy()
            b = getattr(on_host, key).numpy()
            step_err[key] = float((np.abs(a - b) / width).max())
            if not step_err[key] <= 1e-4:
                fail(f"PSO {variant.name}: one step's {key} on the card differs "
                     f"from the host's by {step_err[key]:.3e} of the bounds' "
                     f"width (bar 1e-4)")
        for key in ("pbest_f", "gbest_f", "success_count", "total_updates"):
            if not torch.equal(getattr(on_card, key).cpu(),
                               getattr(on_host, key)):
                fail(f"PSO {variant.name}: one step's {key} on the card differs "
                     f"from the host's")
        print(f"[pso] {variant.name}: one step card vs host, same draws and "
              f"fitness: max diff / bounds' width {step_err}", flush=True)
        runs[variant.name]["step_vs_host"] = step_err
    return dict(k1_compare=k1_compare, runs=runs,
                seconds=time.perf_counter() - t_phase)


def sir_phases(cache, card):
    """Phases 18-21."""
    t0 = time.perf_counter()
    out = dict(adaptive=adaptive_phase(cache, card),
               mains=sir_mains_phase(card), demo=sir_demo_phase(card),
               pso=pso_variants_phase(cache, card))
    out["seconds"] = time.perf_counter() - t0
    print(f"[sir] phases 18-21: {out['seconds']:.1f} s (18: "
          f"{out['adaptive']['seconds']:.1f}, 19: {out['mains']['seconds']:.1f}"
          f", 20: {out['demo']['seconds']:.1f}, 21: "
          f"{out['pso']['seconds']:.1f}) on {card}", flush=True)
    return out


# ------------------------------------------------------------------ phase 22
# The sharded runners of mmidv1_tpu_torch/parallel on the card: ranks are
# processes spawned here, sharing the one card over gloo (2 ranks) or alone
# over nccl (1 rank), each held against the unsharded run of the same path
# in this process, from the same global draws.
PAR_CHAINS = 8192          # AM / DE-MC; PT is 8 rungs x 1024
PAR_SMALL = 64             # NUTS, logit-NUTS, MALA
PAR_TIMED_STEPS = 200
PAR_TIMEOUT = 420          # seconds a spawned group may take in all
PAR_SEED = 22


def par_objective(pipes, dtype, mode, grad=False):
    """The full-grid dopri5@4 objective (K1) or value_and_grad engine (K2 +
    K3) of ``pipes[dtype]``, built once."""
    from mmidv1_tpu_torch.ops import (build_objective_fused,
                                      build_objective_fused_grad)
    key = (dtype, mode, grad)
    if key not in pipes["objectives"]:
        pipe = pipes[dtype]
        build = build_objective_fused_grad if grad else build_objective_fused
        pipes["objectives"][key] = build(
            pipe.space, pipe.params, pipe.data, pipe.ts, substeps=4,
            tableau="dopri5", constraint_mode=mode, device="cuda")
    return pipes["objectives"][key]


def par_gen():
    import torch
    return torch.Generator(device="cuda").manual_seed(PAR_SEED)


def par_mh(mesh, pipes, proposal="am", dtype="float64", iterations=40,
           thinning=10, n_chains=PAR_CHAINS):
    """AM-MH (or DE-MC) over ``n_chains`` chains, the covariance
    re-estimated at each block of ``thinning`` steps (every 10 steps from
    step 10 by default)."""
    from mmidv1_tpu_torch.calibration.mh import MHConfig, run_mh
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.parallel import run_mh_sharded
    pipe = pipes[dtype]
    cfg = MHConfig(iterations=iterations, burn_in=0, adaptation_period=10,
                   thinning=thinning, proposal=proposal)
    kw = dict(n_chains=n_chains, generator=par_gen(), jitter=0.1)
    ll = par_objective(pipes, dtype, REFLECT)
    res = (run_mh(ll, pipe.space, pipe.theta0, cfg, **kw) if mesh is None
           else run_mh_sharded(ll, pipe.space, pipe.theta0, cfg, mesh=mesh,
                               **kw))
    return res, ("samples", "sample_logps", "best_x", "best_logp",
                 "acceptance_rate", "final_cov", "final_scale")


def par_pt(mesh, pipes):
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.calibration.tempering import PTConfig, run_pt
    from mmidv1_tpu_torch.parallel import run_pt_gspmd
    pipe = pipes["float64"]
    cfg = PTConfig(iterations=40, burn_in=20, adaptation_period=10,
                   thinning=10, n_rungs=8)
    kw = dict(n_chains=PAR_CHAINS // 8, generator=par_gen(), jitter=0.1)
    ll = par_objective(pipes, "float64", REFLECT)
    res = (run_pt(ll, pipe.space, pipe.theta0, cfg, **kw) if mesh is None
           else run_pt_gspmd(ll, pipe.space, pipe.theta0, cfg, mesh=mesh,
                             **kw))
    return res, ("samples", "sample_logps", "best_x", "best_logp",
                 "acceptance_rate", "swap_rate")


def par_pso(mesh, pipes):
    import dataclasses
    from mmidv1_tpu_torch.calibration.param_space import CLAMP
    from mmidv1_tpu_torch.calibration.pso import PSOConfig, run_pso
    from mmidv1_tpu_torch.parallel import run_pso_sharded
    pipe = pipes["float64"]
    cfg = dataclasses.replace(PSOConfig.from_settings(pipe.settings["pso"]),
                              swarm_size=PSO_SWARM, iterations=5)
    ll = par_objective(pipes, "float64", CLAMP)
    kw = dict(generator=par_gen(), theta0=pipe.theta0)
    res = (run_pso(ll, pipe.space, cfg, **kw) if mesh is None else
           run_pso_sharded(ll, pipe.space, cfg, mesh=mesh, **kw))
    return res, ("best_x", "best_f", "history_best_f")


def par_nuts(mesh, pipes, logit=False):
    """NUTS at nuts_settings.txt, or logit-NUTS for 5 iterations, through
    the K2 / K3 engine on the CLAMP objective."""
    import dataclasses
    import torch
    from mmidv1_tpu_torch.calibration.nuts import (NUTSConfig,
                                                   logit_transform, run_nuts,
                                                   run_nuts_logit)
    from mmidv1_tpu_torch.calibration.param_space import CLAMP
    from mmidv1_tpu_torch.parallel import run_nuts_gspmd, run_nuts_logit_gspmd
    pipe = pipes["float64"]
    space = pipe.space
    vg = par_objective(pipes, "float64", CLAMP, grad=True)
    cfg = NUTSConfig.from_settings(pipe.settings["nuts"])
    fields = ("samples", "sample_logps", "best_x", "best_logp", "step_sizes",
              "mean_accept", "mean_depth")
    if not logit:
        kw = dict(seed=PAR_SEED, n_chains=PAR_SMALL, value_and_grad_batch=vg)
        res = (run_nuts(None, space, pipe.theta0, cfg, **kw) if mesh is None
               else run_nuts_gspmd(None, space, pipe.theta0, cfg, mesh=mesh,
                                   **kw))
        return res, fields
    cfg = dataclasses.replace(cfg, iterations=5)
    mu = logit_transform(pipe.theta0, space.lower, space.upper)
    kw = dict(mu=mu, scale=0.05 * torch.eye(space.dim, dtype=mu.dtype,
                                            device=mu.device),
              seed=PAR_SEED, n_chains=PAR_SMALL, value_and_grad_batch=vg)
    res = (run_nuts_logit(None, space, cfg, **kw) if mesh is None else
           run_nuts_logit_gspmd(None, space, cfg, mesh=mesh, **kw))
    return res, fields


def par_mala(mesh, pipes):
    from mmidv1_tpu_torch.calibration.mala import MALAConfig, run_mala
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.parallel import run_mala_gspmd
    pipe = pipes["float64"]
    vg = par_objective(pipes, "float64", REFLECT, grad=True)
    cfg = MALAConfig(iterations=20, burn_in=10, adaptation_period=10,
                     initial_step_size=0.02)
    kw = dict(n_chains=PAR_SMALL, generator=par_gen(), jitter=0.05,
              value_and_grad_batch=vg)
    res = (run_mala(None, pipe.space, pipe.theta0, cfg, **kw) if mesh is None
           else run_mala_gspmd(None, pipe.space, pipe.theta0, cfg, mesh=mesh,
                               **kw))
    return res, ("samples", "sample_logps", "best_x", "best_logp",
                 "acceptance_rate", "final_cov", "final_eps")


# path -> (runner, kwargs, {field: rtol}). Float64: a sharded run differs
# from the unsharded one only by the order of the collectives' sums (one
# nccl rank: in no bit).
PAR_PATHS = {
    "am": (par_mh, {}, dict(samples=1e-9, sample_logps=1e-9, best_logp=1e-9,
                            acceptance_rate=1e-12, final_cov=1e-8,
                            final_scale=1e-9)),
    "de": (par_mh, dict(proposal="de"), dict(samples=1e-9, sample_logps=1e-9,
                                             best_logp=1e-9,
                                             acceptance_rate=1e-12)),
    "pt": (par_pt, {}, dict(samples=1e-9, sample_logps=1e-9, best_logp=1e-9,
                            swap_rate=1e-12, acceptance_rate=1e-12)),
    "pso": (par_pso, {}, dict(best_f=1e-8, best_x=1e-8)),
    "nuts": (par_nuts, {}, dict(samples=1e-9, sample_logps=1e-9,
                                step_sizes=1e-9, best_logp=1e-9)),
    "nuts_logit": (par_nuts, dict(logit=True), dict(
        samples=1e-9, sample_logps=1e-9, step_sizes=1e-9)),
    "mala": (par_mala, {}, dict(samples=1e-9, sample_logps=1e-9,
                                best_logp=1e-9, final_cov=1e-8)),
}


def launch_counts():
    """Every kernel's launches since ``zero_counts``, by chain count and
    regime (K3: by regime)."""
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_forward_ckpt,
                                      fused_objective)
    return dict(
        k1=fused_objective.launches,
        k1_regime_calls=dict(fused_objective.regime_calls),
        k1_batch_calls={B: dict(v) for B, v in
                        fused_objective.batch_calls.items()},
        k2=fused_forward_ckpt.launches,
        k2_regime_calls=dict(fused_forward_ckpt.regime_calls),
        k2_batch_calls={B: dict(v) for B, v in
                        fused_forward_ckpt.batch_calls.items()},
        k3=fused_adjoint.launches, k3_kernels=fused_adjoint.kernel_launches,
        k3_regime_calls=dict(fused_adjoint.regime_calls))


def par_drive(name, mesh, pipes):
    """One path, its launches counted from 0: ``(arrays, counts,
    seconds)``."""
    import torch
    fn, kw, _tol = PAR_PATHS[name]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, fields = fn(mesh, pipes, **kw)
    arrays = {f: getattr(res, f).detach().cpu().numpy() for f in fields}
    return arrays, launch_counts(), time.perf_counter() - t0


class CollectiveTimer:
    """Time every ``all_reduce`` of the mesh (the card synchronized before
    and after each), while in a ``with`` block."""

    def __init__(self):
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        import torch
        import torch.distributed as dist
        self._saved = all_reduce = dist.all_reduce

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = all_reduce(*a, **k)
            torch.cuda.synchronize()
            self.calls += 1
            self.seconds += time.perf_counter() - t0
            return out
        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_reduce = self._saved


def par_timed(mesh, pipes):
    """(g): AM-MH over PAR_CHAINS float32 chains, PAR_TIMED_STEPS steps in
    blocks of 25 (a sample kept and the covariance re-estimated a block):
    wall and chain-steps/s;
    the same run with every collective timed; on a mesh, the same steps
    over this rank's chains as an unsharded run of its own, every rank at
    once (the card shared, no collective; on one rank, the unsharded run in
    the rank's process); then
    torch.profiler over one 10-step block (its covariance update
    included): this rank's kernel intervals and the window's ends, on the
    profiler's clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kw = dict(dtype="float32", iterations=PAR_TIMED_STEPS, thinning=25)

    def run(sharded=True, **over):
        if mesh is not None:       # start together
            mesh.psum(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _ = par_mh(mesh if sharded else None, pipes, **dict(kw, **over))
        float(res.best_logp)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(iterations=10, thinning=10)                 # warm-up
    zero_counts()
    wall = run()
    counts = launch_counts()
    with CollectiveTimer() as ct:
        wall_timed = run()
    wall_alone = None
    if mesh is not None:
        wall_alone = run(sharded=False,
                         n_chains=PAR_CHAINS // mesh.world_size)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_block = run(iterations=10, thinning=10)
    events = list(prof.profiler.kineto_results.events())
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in events if e.device_type() == DeviceType.CUDA)
    if not kernels:
        fail("torch.profiler reported no device time in phase 22")
    window = (min(e.start_ns() for e in events),
              max(e.start_ns() + e.duration_ns() for e in events))
    return dict(wall=wall, wall_collectives_timed=wall_timed,
                wall_alone=wall_alone,
                collective_calls=ct.calls, collective_seconds=ct.seconds,
                block_wall=wall_block, kernels=kernels, window=window,
                counts=counts)


def busy_ns(intervals):
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_share(timed):
    """The card's idle share over the profiled window of one or more ranks
    (their kernels merged, the window from the first event to the last)."""
    window = (min(t["window"][0] for t in timed),
              max(t["window"][1] for t in timed))
    busy = busy_ns([k for t in timed for k in t["kernels"]])
    return 1.0 - busy / (window[1] - window[0]), busy / 1e6, \
        (window[1] - window[0]) / 1e6


def par_load_pipes():
    import torch
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    pipes = {d: load_spain_pipeline(HERE, dtype=getattr(torch, d),
                                    device="cuda")
             for d in ("float64", "float32")}
    pipes["objectives"] = {}
    return pipes


def _par_rank(rank, world, backend, store, out, plan):
    """One spawned rank of phase 22: ``multihost.initialize`` over a file
    store, then every path of ``plan`` and, last, the timed run. Rank 0
    keeps the (global) arrays; every rank its launch counts."""
    import datetime
    import hashlib
    import pickle
    import traceback
    sys.path.insert(0, HERE)
    import torch.distributed as dist
    from mmidv1_tpu_torch.parallel import ensemble_mesh, multihost
    status, payload = "error", None
    # every rank is on this host: rendezvous over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        multihost.initialize(f"file://{store}", world, rank, backend=backend,
                             device="cuda",
                             timeout=datetime.timedelta(seconds=120))
        mesh = ensemble_mesh()
        pipes = par_load_pipes()
        paths = {}
        for name in plan:
            arrays, counts, secs = par_drive(name, mesh, pipes)
            digest = {f: hashlib.sha256(a.tobytes()).hexdigest()
                      for f, a in arrays.items()}
            paths[name] = dict(counts=counts, seconds=secs, digest=digest,
                               arrays=arrays if rank == 0 else None)
        payload = dict(paths=paths, timed=par_timed(mesh, pipes),
                       backend=dist.get_backend(), device=str(mesh.device))
        status = "ok"
    except BaseException:
        payload = traceback.format_exc()
    finally:
        with open(out, "wb") as f:
            pickle.dump((status, payload), f)
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(0 if status == "ok" else 1)


def par_spawn(world, backend, plan, work):
    """Spawn ``world`` ranks on the card, wait for them (PAR_TIMEOUT), and
    return each one's payload; fail on a timeout or a rank's error."""
    import multiprocessing as mp
    import pickle
    store = os.path.join(work, f"store_{backend}_{world}")
    outs = [os.path.join(work, f"rank{r}_{backend}_{world}.pkl")
            for r in range(world)]
    for path in [store] + outs:
        if os.path.exists(path):
            os.remove(path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_par_rank,
                         args=(r, world, backend, store, outs[r], plan))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(30)
        if p.is_alive():
            p.kill()
            p.join()
    payloads, errors = [], []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            errors.append(f"rank {r} wrote no result (exit code "
                          f"{procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            status, payload = pickle.load(f)
        os.remove(path)
        if status != "ok":
            errors.append(f"rank {r}:\n{payload}")
        payloads.append(payload)
    if hung:
        errors.insert(0, f"{backend} ranks {hung} still running after "
                         f"{PAR_TIMEOUT} s")
    if errors:
        fail(f"phase 22, {world} {backend} rank(s):\n" + "\n".join(errors))
    return payloads


def par_compare(label, got, want, tol):
    """A sharded path's global arrays against the unsharded run's: the
    largest relative error by field (floored at 1e-9 x the field's largest
    entry) within ``tol[field]``, or with ``tol`` None no value differing
    in any bit; returns both numbers by field."""
    import numpy as np
    out = {}
    for f, w in want.items():
        g = got[f]
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"phase 22 {label}: {f} is {g.shape} {g.dtype}, the "
                 f"unsharded run's {w.shape} {w.dtype}")
        gb = g.reshape(-1).view(np.uint8).reshape(g.size, -1)
        wb = w.reshape(-1).view(np.uint8).reshape(w.size, -1)
        differ = int(np.count_nonzero((gb != wb).any(axis=1)))
        w64, g64 = w.astype(np.float64), g.astype(np.float64)
        scale = np.maximum(np.abs(w64), 1e-9 * np.abs(w64).max())
        rel = float((np.abs(g64 - w64) / np.where(scale > 0, scale, 1.0))
                    .max()) if g.size else 0.0
        out[f] = dict(max_rel_err=rel, values_differing=differ)
        if tol is None and differ:
            fail(f"phase 22 {label}: {differ} values of {f} differ from the "
                 f"unsharded run's; one rank must give the same bits")
        if tol is not None and f in tol and not rel <= tol[f]:
            fail(f"phase 22 {label}: {f} off the unsharded run by {rel:.3e} "
                 f"(bar {tol[f]:.0e})")
    return out


def par_expect_regimes(label, counts, B, want_k3=None):
    """Every K1 / K2 call of a rank at its local chain count ``B`` (or
    ``K * B`` rows for PT, passed as B) in the regime the rule picks there;
    K3 all in the regime ``want_k3``."""
    pick = forward_pick(B)
    for k in ("k1", "k2"):
        calls = counts[f"{k}_batch_calls"]
        if counts[k] and (set(calls) != {B} or set(calls[B]) != {pick}):
            fail(f"phase 22 {label}: {k.upper()} calls by chain count and "
                 f"regime {calls}, expected all at {B} in "
                 f"{REGIMES[pick]}")
    if want_k3 is not None and counts["k3"] and \
            counts["k3_regime_calls"] != {want_k3: counts["k3"],
                                          3 - want_k3: 0}:
        fail(f"phase 22 {label}: K3 calls by regime "
             f"{counts['k3_regime_calls']}, expected all in regime {want_k3}")


def parallel_phase(card):
    """Phase 22: every sharded runner on the card against its unsharded
    run, 2 gloo ranks sharing the card and 1 nccl rank; then AM-MH at 8192
    float32 chains timed unsharded, on 2 gloo ranks and on 1 nccl rank."""
    import shutil
    t_phase = time.perf_counter()
    work = os.path.join(HERE, "chiprun_out", "parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pipes = par_load_pipes()
    ref = {}
    for name in PAR_PATHS:
        arrays, counts, secs = par_drive(name, None, pipes)
        ref[name] = dict(arrays=arrays, counts=counts, seconds=secs)
        print(f"[parallel] {name} unsharded: {secs:.2f} s, launches "
              f"{ {k: counts[k] for k in ('k1', 'k2', 'k3')} }", flush=True)
    ref_timed = par_timed(None, pipes)
    gloo = par_spawn(2, "gloo", list(PAR_PATHS), work)
    nccl = par_spawn(1, "nccl", ["am"], work)
    out = dict(paths={}, launches={}, compare={})
    # local chain counts (PT: rows a K1 call) and K3's regime: as unsharded
    local = dict(am=PAR_CHAINS, de=PAR_CHAINS, pt=PAR_CHAINS, pso=PSO_SWARM,
                 nuts=PAR_SMALL, nuts_logit=PAR_SMALL, mala=PAR_SMALL)
    for backend, ranks in (("gloo", gloo), ("nccl", nccl)):
        world = len(ranks)
        for name in ranks[0]["paths"]:
            label = f"{name} {backend} x{world}"
            r0 = ranks[0]["paths"][name]
            if any(r["paths"][name]["digest"] != r0["digest"] for r in ranks):
                fail(f"phase 22 {label}: the ranks' global results differ")
            tol = None if backend == "nccl" else PAR_PATHS[name][2]
            cmp = out["compare"][label] = par_compare(
                label, r0["arrays"], ref[name]["arrays"], tol)
            want_k3 = None
            rc = ref[name]["counts"]["k3_regime_calls"]
            if ref[name]["counts"]["k3"]:
                want_k3 = max(rc, key=rc.get)
            par_expect_regimes(f"{name} unsharded", ref[name]["counts"],
                               local[name], want_k3)
            for rank, r in enumerate(ranks):
                counts = r["paths"][name]["counts"]
                B = local[name] // world
                par_expect_regimes(f"{label} rank {rank}", counts, B, want_k3)
                for k in ("k1", "k2", "k3"):
                    if counts[k] != ref[name]["counts"][k]:
                        fail(f"phase 22 {label} rank {rank}: {k.upper()} "
                             f"{counts[k]} launches, the unsharded run "
                             f"{ref[name]['counts'][k]}")
                out["launches"][f"{label} rank {rank} B={B}"] = counts
            print(f"[parallel] {label}: {r0['seconds']:.2f} s (unsharded "
                  f"{ref[name]['seconds']:.2f}); max rel err "
                  f"{ {f: f'{c['max_rel_err']:.2e}' for f, c in cmp.items()} }"
                  f"; values differing in any bit "
                  f"{ {f: c['values_differing'] for f, c in cmp.items()} }",
                  flush=True)
    for name in PAR_PATHS:
        out["launches"][f"{name} unsharded B={local[name]}"] = \
            ref[name]["counts"]
    # before the first covariance update (step 10) no sum crosses ranks:
    # the 2-rank AM samples of step 10 should equal the unsharded ones
    first = out["compare"]["am gloo x2"]
    g0 = gloo[0]["paths"]["am"]["arrays"]["samples"][0]
    w0 = ref["am"]["arrays"]["samples"][0]
    out["am_gloo_step10_bits_equal"] = bool(g0.tobytes() == w0.tobytes())
    print(f"[parallel] AM 2 gloo ranks: step-10 samples (before any sum "
          f"across ranks reaches a proposal) equal to the bit: "
          f"{out['am_gloo_step10_bits_equal']}; of all samples "
          f"{first['samples']['values_differing']} values differ in a bit",
          flush=True)
    timed = {}
    steps = PAR_CHAINS * PAR_TIMED_STEPS
    for label, runs in (("unsharded", [ref_timed]),
                        ("gloo x2", [r["timed"] for r in gloo]),
                        ("nccl x1", [r["timed"] for r in nccl])):
        wall = max(t["wall"] for t in runs)
        idle, busy_ms, window_ms = idle_share(runs)
        rank_idle = [idle_share([t])[0] for t in runs]
        alone = (steps / max(t["wall_alone"] for t in runs)
                 if runs[0]["wall_alone"] is not None else None)
        coll_ms = max(t["collective_seconds"] for t in runs) * 1e3
        timed[label] = dict(
            wall_seconds=wall, chain_steps_per_s=steps / wall,
            collective_ms_per_step=coll_ms / PAR_TIMED_STEPS,
            collective_calls=runs[0]["collective_calls"],
            wall_collectives_timed=max(t["wall_collectives_timed"]
                                       for t in runs),
            block_idle_share=idle, block_busy_ms=busy_ms,
            block_window_ms=window_ms, block_idle_share_by_rank=rank_idle,
            unsharded_ranks_sharing_card_chain_steps_per_s=alone,
            per_rank_k1=[t["counts"]["k1_batch_calls"] for t in runs])
        print(f"[parallel] (g) AM-MH {PAR_CHAINS} chains f32 x "
              f"{PAR_TIMED_STEPS} steps, {label}: "
              f"{steps / wall:.4e} chain-steps/s ({wall:.2f} s), collectives "
              f"{coll_ms / PAR_TIMED_STEPS:.3f} ms a step "
              f"({runs[0]['collective_calls']} calls a rank), card idle "
              f"{idle:.3f} of a 10-step block ({busy_ms:.1f} ms busy of "
              f"{window_ms:.1f}, profiled; by rank "
              f"{[round(x, 3) for x in rank_idle]})"
              + ("" if alone is None else
                 f"; the same ranks each running its {PAR_CHAINS // len(runs)}"
                 f" chains unsharded at once, no collective: {alone:.4e} "
                 f"chain-steps/s ({steps / alone:.2f} s)")
              + f" on {card}", flush=True)
    out["timed"] = timed
    for label, runs in (("unsharded", [ref_timed]),
                        ("gloo x2", [r["timed"] for r in gloo]),
                        ("nccl x1", [r["timed"] for r in nccl])):
        for rank, t in enumerate(runs):
            B = PAR_CHAINS // len(runs)
            par_expect_regimes(f"(g) {label} rank {rank}", t["counts"], B)
            out["launches"][f"(g) AM-MH f32 {label} rank {rank} B={B}"] = \
                t["counts"]
    out["seconds"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    print(f"[parallel] phase 22: {out['seconds']:.1f} s on {card}",
          flush=True)
    return out


def main():
    k3_only = "--k3" in sys.argv[1:]
    main_only = "--main" in sys.argv[1:]
    fwd_only = "--fwd" in sys.argv[1:]
    campaign_only = "--campaign" in sys.argv[1:]
    sir_only = "--sir" in sys.argv[1:]
    parallel_only = "--parallel" in sys.argv[1:]
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "mmidv1_tpu_torch")):
        fail(f"the mmidv1_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, HERE)
    results = {}

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card, flush=True)
    results["card"] = card
    results["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"

    # 2. build every kernel from source (one nvcc per source, all at once)
    from mmidv1_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build(["sepaihrd_fused", "sepaihrd_adjoint"])
    results["build_seconds"] = secs
    print(f"[build] {secs} (wall {time.perf_counter() - t0:.1f}s)", flush=True)
    usage = []
    for src in ("sepaihrd_fused", "sepaihrd_adjoint"):
        report = os.path.join(_build.BUILD_DIR, f"{src}.ptxas.txt")
        if not os.path.exists(report):
            continue
        name = "?"
        with open(report) as f:
            for ln in f:
                if "Function properties for" in ln:
                    name = ln.split("for", 1)[1].strip()
                elif "spill" in ln or "registers" in ln:
                    usage.append(f"{name}: {ln.strip()}")
    results["ptxas"] = usage
    for ln in usage:
        print(f"[ptxas] {ln}", flush=True)
    results["k3_ptxas"] = k3_ptxas(os.path.join(_build.BUILD_DIR,
                                                "sepaihrd_adjoint.ptxas.txt"))

    cache = {}
    if fwd_only:
        results["forward"] = forward_phases(cache, _build.BUILD_DIR)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_fwd.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --fwd: K1 and K2 held and timed in both regimes; "
              "run without arguments for the whole check", flush=True)
        return 0
    if k3_only:
        k3_phases(cache)
        print("chip_smoke --k3: K3 held and timed; run without arguments for "
              "the whole check", flush=True)
        return 0
    if main_only:
        results["main"] = main_phases(cache, card)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_main.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --main: sepaihrd_main, the report and serovalid "
              "checked on the card; run without arguments for the whole "
              "check", flush=True)
        return 0

    if campaign_only:
        results["campaign"] = campaign_phases(cache, card)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_campaign.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --campaign: the bench and the checkpointed AM, DE "
              "and PT campaigns checked on the card; run without arguments "
              "for the whole check", flush=True)
        return 0

    if sir_only:
        results["sir"] = sir_phases(cache, card)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_sir.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --sir: the adaptive integrators, the SIR mains, the "
              "SIR calibration demo and PSO's three variants checked on the "
              "card; run without arguments for the whole check", flush=True)
        return 0

    if parallel_only:
        results["parallel"] = parallel_phase(card)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_parallel.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --parallel: every sharded runner held on the card "
              "against its unsharded run, and AM-MH timed sharded; run "
              "without arguments for the whole check", flush=True)
        return 0

    # 2b. the forward kernels in both regimes
    fwd = results["forward"] = forward_phases(cache, _build.BUILD_DIR)

    # 3. kernel vs plain version on the card
    from mmidv1_tpu_torch.ops import fused_objective
    cases = []
    for dtype_name, tol in FWD_TOL.items():
        for tableau, substeps in (("dopri5", 4), ("cash_karp", 3)):
            cases.append(compare(f"{dtype_name} {tableau}@{substeps} B=8192",
                                 8192, dtype_name, tableau, substeps, tol,
                                 cache, seed=len(cases)))
    main_shape = compare("float32 dopri5@4 B=1024 (main-path MH shape)", 1024,
                         "float32", "dopri5", 4, FWD_TOL["float32"], cache,
                         seed=99)
    results["compare"] = cases + [main_shape]

    # 4. the float64 MAP anchor through the kernel
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.data import read_sepaihrd_parameters
    from mmidv1_tpu_torch.ops import build_objective_fused
    pipe64 = cache["float64"]
    calib = read_sepaihrd_parameters(
        os.path.join(HERE, "results", "spain2020", "calibrated_parameters.txt"),
        4, N=pipe64.data.population_by_age,
        M_baseline=pipe64.params.M_baseline.cpu().numpy(),
        dtype=torch.float64, device="cuda")
    ll64 = build_objective_fused(pipe64.space, pipe64.params, pipe64.data,
                                 pipe64.ts, substeps=4, constraint_mode=REFLECT,
                                 device="cuda")
    anchor = float(ll64(pipe64.space.extract(calib)[None, :])[0])
    rel = abs(anchor - MAP_LL) / MAP_LL
    print(f"[anchor] float64 MAP log-likelihood {anchor!r} vs {MAP_LL!r}: "
          f"rel err {rel:.3e}", flush=True)
    if not rel <= 1e-10:
        fail(f"MAP anchor off: {anchor!r} vs {MAP_LL!r}")
    results["anchor"] = dict(value=anchor, rel_err=rel)

    # 5. the PSO -> AM-MH path, counted
    from mmidv1_tpu_torch.cli.calibrate_spain import run_calibration
    zero_counts()
    summary = run_calibration(
        algorithm="psomcmc", chains=1024, pso_particles=512, pso_iters=5,
        mcmc_iters=100, thinning=5, burn_in=20, substeps=4, tableau="dopri5",
        x64=False, seed=0, device="cuda", root=HERE,
        out=os.path.join(HERE, "chiprun_out", "chip_smoke_calibration"),
        log=lambda m: print(f"[main] {m}", flush=True))
    launches = fused_objective.launches
    k1_by_regime = dict(fused_objective.regime_calls)
    k1_regime = forward_pick(1024)
    results["main_path"] = dict(summary, launches=launches,
                                k1_regime_calls=k1_by_regime,
                                k1_regime=k1_regime)
    # 1 initial + 2 opposition + 5 PSO + 1 MH init + 100 MH + 1 float64
    if launches < 5 + 100 or sum(k1_by_regime.values()) != launches or \
            k1_by_regime[k1_regime] < 101:
        fail(f"main path launched the kernel {launches} times, by regime "
             f"{k1_by_regime}: the 101 MH calls at 1024 chains belong to "
             f"regime {k1_regime}")
    best, init = summary["best_logl"], summary["initial_logl"]
    if not (abs(best) < float("inf") and best >= init):
        fail(f"best log-likelihood {best} is not finite and >= initial {init}")
    if not abs(summary["best_logl_float64"]) < float("inf"):
        fail("float64 re-selection is not finite")
    print(f"[main] launches {launches}, by regime {k1_by_regime} (the rule picks "
          f"{REGIMES[k1_regime]} at 1024 chains); best logL {best:.6e} >= initial "
          f"{init:.6e}; {summary['chain_steps_per_s']:.4e} chain-steps/s "
          f"(AM-MH, 1024 chains, float32) on {card}", flush=True)

    # 6. K2 vs its plain version
    k2_cases = []
    for dtype_name, tol in FWD_TOL.items():
        for tableau, substeps in (("dopri5", 4), ("cash_karp", 3)):
            k2_cases.append(compare_k2(f"{dtype_name} {tableau}@{substeps} B=8192",
                                       8192, dtype_name, tableau, substeps, tol,
                                       cache, seed=20 + len(k2_cases)))
    results["k2_compare"] = k2_cases

    # 7, 8. K3 vs its plain version; K2 / K3 times beside their bounds
    k3_cases, timings, crossover = k3_phases(cache)
    results["k3_compare"] = k3_cases
    results["adjoint_timings"] = timings
    results["k3_crossover"] = crossover

    # 9. the float64 gradient anchor
    results["gradient_anchor"] = gradient_anchor(cache)

    # 10. the NUTS path, counted
    zero_counts()
    nuts = run_calibration(
        algorithm="nuts", chains=64, full=True, x64=False, tableau="dopri5",
        substeps=4, seed=0, device="cuda", root=HERE,
        out=os.path.join(HERE, "chiprun_out", "chip_smoke_nuts"),
        log=lambda m: print(f"[nuts] {m}", flush=True))
    nuts_launches = read_counts("nuts", 64, crossover)
    results["nuts_path"] = dict(nuts, launches=nuts_launches)
    # 7 (epsilon search) + 1 (init) + 25 x (1 + 2 + 4 leaves + 1): 208
    if min(nuts_launches["k2"], nuts_launches["k3"]) < 200:
        fail(f"NUTS path launched K2/K3 {nuts_launches} times")
    best, init = nuts["best_logl"], nuts["initial_logl"]
    if not (abs(best) < float("inf") and best >= init - 1e-6 * abs(init)):
        fail(f"NUTS best log-likelihood {best} is not finite and >= initial {init}")
    if nuts["samples_shape"] != [25, 64, 62] or not nuts["samples_finite"]:
        fail(f"NUTS samples {nuts['samples_shape']}, finite "
             f"{nuts['samples_finite']}")
    if not abs(nuts["best_logl_float64"]) < float("inf"):
        fail("NUTS float64 re-selection is not finite")
    print(f"[nuts] launches {nuts_launches}; best logL {best:.6e} >= initial "
          f"{init:.6e}; {nuts['grad_evals_per_s']:.4e} grad-evals/s, mean accept "
          f"{nuts['mean_accept']:.3f}, mean depth {nuts['mean_depth']:.2f} "
          f"(64 chains, float32) on {card}", flush=True)

    # 11. MALA through the same engine, counted: at the NUTS chain count,
    # and above the crossover, where K3 runs in regime 2
    from mmidv1_tpu_torch.ops import build_objective_fused_grad
    pipe32 = cache["float32"]
    vg = build_objective_fused_grad(pipe32.space, pipe32.params, pipe32.data,
                                    pipe32.ts, substeps=4,
                                    constraint_mode=REFLECT, device="cuda")
    mala = mala_path("mala", vg, pipe32, 64, 20, crossover)
    mala_wide = mala_path("mala-1024", vg, pipe32, 1024, 5, crossover)
    if mala["k3_regime"] != 1 or mala_wide["k3_regime"] != 2:
        fail(f"MALA at 64 / 1024 chains ran K3 in regimes {mala['k3_regime']} "
             f"/ {mala_wide['k3_regime']}, not 1 / 2")
    results["mala"], results["mala_1024"] = mala, mala_wide

    # 12-14. the primary executable, the report at real size, serovalid
    main_run = results["main"] = main_phases(cache, card)
    hill_counts = main_run["primary"]["hillmcmc"]["launches"]
    main_nuts = main_run["primary"]["nuts"]["launches"]

    # 15-17. the bench, the checkpointed AM / DE and PT campaigns
    camp = results["campaign"] = campaign_phases(cache, card)
    camp_paths = campaign_paths(camp)

    # 18-21. the adaptive integrators, the SIR mains and demo, PSO's variants
    sir_run = results["sir"] = sir_phases(cache, card)
    camp_paths.update({f"pso {name} B={PSO_SWARM} (run_pso)": r["launches"]
                       for name, r in sir_run["pso"]["runs"].items()})

    # 22. the sharded runners, 2 gloo ranks and 1 nccl rank
    par = results["parallel"] = parallel_phase(card)
    par_paths = {f"parallel {label}": c for label, c in par["launches"].items()}
    camp_paths.update({k: {f: c[f] for f in ("k1", "k1_regime_calls")}
                       for k, c in par_paths.items() if c["k1"]})
    grad_paths = [(k, c) for k, c in par_paths.items() if c["k2"]]

    # 23. the kernels line, the card, the device line: each kernel's top-level
    # numbers at its main path's shape, every other comparison under configs
    head = main_shape
    main32, main64 = (next(t for t in timings if t["B"] == 64
                           and t["dtype"] == d) for d in ("float32", "float64"))
    # K3's counts and regime are the NUTS run's own; its time and error are
    # phase 8's at the same shape, which must have run the same regime
    k3_regime = nuts_launches["k3_regime"]
    if main32["k3_regime"] != k3_regime:
        fail(f"K3 was timed in regime {main32['k3_regime']} but the NUTS path "
             f"ran regime {k3_regime}")
    if main32["k2_regime"] != nuts_launches["k2_regime"] or \
            head["regime"] != k1_regime:
        fail(f"K2 / K1 were timed in regimes {main32['k2_regime']} / "
             f"{head['regime']} but their paths ran {nuts_launches['k2_regime']}"
             f" / {k1_regime}")

    def fcase(B, dtype_name):
        return next(c for c in fwd["cases"]
                    if c["B"] == B and c["dtype"] == dtype_name)

    def chain_keys(bounds, ms, clock_mhz):
        """The chain bound beside the roofline, and the time per stage."""
        ns = ms * 1e6 / bounds["dependent_stages"]
        return dict(chain_bound_ms=bounds["chain_bound_ms"],
                    design_bound_ms=bounds["design_bound_ms"],
                    dependent_stages=bounds["dependent_stages"],
                    ns_per_stage=ns, cycles_per_stage=ns * clock_mhz / 1e3,
                    sm_clock_mhz=clock_mhz)

    def by_regime(kname):
        return {f"B={c['B']} {c['dtype']}": {
            name: {k: v for k, v in c[kname][name].items() if k != "case"}
            for name in REGIMES.values()} for c in fwd["cases"]}

    kernels = [{
        "name": "sepaihrd_fused", "route": "cuda",
        "source": "mmidv1_tpu_torch/csrc/sepaihrd_fused.cu",
        "replaces": "mmidv1_tpu/ops/sepaihrd_pallas.py:364",
        "launches": launches + hill_counts["k1"]
        + sum(c["k1"] for c in camp_paths.values()),
        "max_abs_err": head["max_abs_err"], "max_rel_err": head["max_rel_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "regime": head["regime"], "kernels_per_call": 1,
        "launches_by_regime": {
            r: k1_by_regime[r] + hill_counts["k1_regime_calls"][r]
            + sum(c["k1_regime_calls"][r] for c in camp_paths.values())
            for r in k1_by_regime},
        "paths": {"psomcmc (calibrate_spain) B=1024": dict(
                      k1=launches, k1_regime_calls=k1_by_regime),
                  "hillmcmc (sepaihrd_main)": hill_counts, **camp_paths},
        **chain_keys(fcase(1024, "float32")["K1"]["bounds"], head["ms"],
                     fwd["clock_mhz"]),
        "by_regime": by_regime("K1"),
        "crossover": [{k: r[k] for k in ("B", "dtype", "picked", "K1_split_ms",
                                         "K1_wide_ms")}
                      for r in fwd["crossover"]],
        "shape": "B=1024 float32 dopri5@4",
        "configs": [{k: c[k] for k in ("case", "max_rel_err", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms", "bound_by")}
                    for c in cases + main_run["primary"]["hillmcmc"][
                        "k1_compare"] + camp["k1_compare"]
                    + [sir_run["pso"]["k1_compare"]]]}, {
        "name": "sepaihrd_fwd_ckpt", "route": "cuda",
        "source": "mmidv1_tpu_torch/csrc/sepaihrd_adjoint.cu",
        "replaces": "mmidv1_tpu/ops/sepaihrd_adjoint.py:359",
        "launches": nuts_launches["k2"],
        "max_abs_err": main32["k2_check"]["max_abs_err"],
        "max_rel_err_ll": main32["k2_check"]["max_rel_err_ll"],
        "max_rel_err_ckpt": main32["k2_check"]["max_rel_err_ckpt"],
        "ms": main32["k2_ms"], "plain_ms": main32["k2_plain_ms"],
        "bound_ms": main32["k2_bound"]["bound_ms"],
        "bound_by": main32["k2_bound"]["bound_by"], "library_ms": None,
        "regime": main32["k2_regime"], "kernels_per_call": 1,
        "launches_by_regime": nuts_launches["k2_regime_calls"],
        **chain_keys(fcase(64, "float32")["K2"]["bounds"], main32["k2_ms"],
                     fwd["clock_mhz"]),
        "by_regime": by_regime("K2"),
        "crossover": [{k: r[k] for k in ("B", "dtype", "picked", "K2_split_ms",
                                         "K2_wide_ms")}
                      for r in fwd["crossover"]],
        "paths": {name: {k: c[k] for k in ("k2", "k2_regime_calls")}
                  for name, c in [("nuts B=64", nuts_launches),
                                  ("nuts (sepaihrd_main) B=64", main_nuts),
                                  ("mala B=64", mala),
                                  ("mala B=1024", mala_wide)] + grad_paths},
        "shape": "B=64 float32 dopri5@4 CLAMP",
        "configs": [main64["k2_check"]] + k2_cases}, {
        "name": "sepaihrd_adjoint", "route": "cuda",
        "source": "mmidv1_tpu_torch/csrc/sepaihrd_adjoint.cu",
        "replaces": "mmidv1_tpu/ops/sepaihrd_adjoint.py:397",
        "launches": nuts_launches["k3"],
        "max_abs_err": main32["k3_check"]["max_abs_err"],
        "grad_err": main32["k3_check"]["err"],
        "ms": main32["k3_ms"], "plain_ms": main32["k3_plain_ms"],
        "bound_ms": main32["k3_bound"]["bound_ms"],
        "bound_by": main32["k3_bound"]["bound_by"], "library_ms": None,
        "regime": k3_regime,
        "calls": nuts_launches["k3"],
        "kernel_launches": nuts_launches["k3_kernels"],
        "kernels_per_call": nuts_launches["k3_kernels"] // nuts_launches["k3"],
        "design_bound_ms": main32["k3_bound"]["design_bound_ms"][k3_regime],
        "shape": "B=64 float32 dopri5@4 CLAMP",
        "paths": {name: {k: c[k] for k in ("k3", "k3_kernels",
                                           "k3_regime_calls")}
                  for name, c in [("nuts B=64", nuts_launches),
                                  ("nuts (sepaihrd_main) B=64", main_nuts),
                                  ("mala B=64", mala),
                                  ("mala B=1024", mala_wide)] + grad_paths},
        "by_regime": {f"B={t['B']} {t['dtype']}": t["k3_forced"]
                      for t in timings},
        "configs": [main64["k3_check"]] + k3_cases}]
    results["kernels"] = kernels
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(card, flush=True)
    # compact: every path of every kernel is listed on this one line
    print(json.dumps({"kernels": kernels}, separators=(",", ":")), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
