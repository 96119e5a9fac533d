#!/usr/bin/env python3
"""Drive the PyTorch port's Spain-2020 calibration paths on one NVIDIA card.

    python3 chip_smoke.py          # everything; the last line says ok
    python3 chip_smoke.py --k3     # build, then phases 7 and 8 only (no ok line)
    python3 chip_smoke.py --fwd    # build, then phase 2b only: K1 and K2 (no ok line)
    python3 chip_smoke.py --main   # build, then phases 12-14 only (no ok line)
    python3 chip_smoke.py --campaign  # build, then phases 15-17 only (no ok line)
    python3 chip_smoke.py --sir    # build, then phases 18-21 only (no ok line)
    python3 chip_smoke.py --parallel  # build, then phase 22 only (no ok line)
    python3 chip_smoke.py --nuts   # build, then phases 23-25 only (no ok line)
    python3 chip_smoke.py --probes # build, then phases 26-28 only (no ok line)
    python3 chip_smoke.py --recovery  # build, then phase 29 only (no ok line)
    python3 chip_smoke.py --tableaus  # build, then phase 30 only (no ok line;
                                      # exits 1 on a miss, after the timings)
    python3 chip_smoke.py --prep   # build, then phase 2c only (no ok line)

Phases (any failure exits non-zero before the final line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of ``mmidv1_tpu_torch/csrc`` from source, one
     nvcc per source, all at once (K1; K2 and K3; the prep and the mask);
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
  2c. the objective's prep and mask kernels (csrc/sepaihrd_prep.cu): the
     prep against its plain version (``FusedPrep._prep_plain``) at 1024 and
     8192 float32 chains under REFLECT, 512 and 64 under CLAMP and the
     float64 MAP re-selection's 257 over the float32 space, every output
     equal to the bit, reflected, clamped and NaN rows included; the mask
     against ``torch.where`` on NaN, +-Inf and infeasible rows; both timed
     in CUDA graphs beside their byte bounds and their plain versions. Every
     path driven below (phases 5-29) also checks, from its counts set to 0
     just before, one prep and one mask launch for each K1 or K2 launch at
     each chain count;
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
     plain forward, whose saved tensors limit it to B = 512; float64
     dopri5@4 and float32 cash_karp@3, the other two pairs until phase 30
     needed the time): all four
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
     at 306 days on one host and 68.8 s at 200 days on a slower one, 32.3
     s at 120 days; cut to 60 with phases 23-25: one objective call is
     2.5-4.6 s of eager launches, set by the host); best
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
 23. the production NUTS recipe (``cli.nuts_campaign``) and the MAP polish,
     each through its ``main`` into a temporary directory: K1 (float64, B =
     257, the MAP re-selection's shape) and K2 / K3 (float32 at 64 chains,
     float64 at 71, the polish's Hessian rows) held against their plain
     versions as in phases 3, 6 and 7 (K2 / K3 only under ``--nuts``: the
     whole script has held their regimes and dtypes in phases 2b and 6-8);
     ``map_polish --rounds 0`` from the committed theta_map on the card and
     on the host: ``ll_map`` equals
     ``results/spain2020/laplace_mass.npz``'s to rtol 1e-10, the free mask
     equals the host's, ``std`` / ``cov_free`` card vs host within
     ``POLISH_STD_RTOL`` / ``POLISH_COV_RTOL`` (the mask against the
     committed one is printed: that file's gradient came from another
     engine); ``--mass logit-dense`` with the committed logit-seed trace as
     ``--trace`` and ``--warm``, 64 chains, depth 10, 3 iterations:
     grad-evals/s including the host, then one more iteration resumed from
     its checkpoint under torch.profiler: the card's idle share; depth 4, 8
     iterations in 4 segments, against the same killed after 2 segments (a
     third partial file written without its state) and resumed: every
     partial file, the state, samples.npz and the trace to the bit;
     ``--stages 2`` with ``laplace-dense`` at depth 3; ``--serovalid`` on
     the serovalid Laplace trace, depth 1 (2 until phase 30 needed the
     time), 2 iterations, each of its
     value_and_grad calls with K2 + K3 and the sero term timed apart, and
     the composed float64 value_and_grad at 4 chains card vs host (rtol
     1e-9, floored). Every campaign is counted from 0: every K2 call at 64
     chains in the regime the rule picks, one K3 call each, one K1 call for
     the re-selection. The host's runs (the polish, phase 24's curvature,
     the composed value_and_grad) go in a process of their own beside the
     card's (``--host-refs``);
 24. under ``--nuts``, ``curvature_probe --points 1`` on the card and on the
     host (the exact float64 Hessian of the logit posterior, reverse over
     reverse through the eager solve, 50-144 s on the card: left out of the
     whole script since phases 26-28 came): eig_max and eps_stable to rtol
     1e-8, and the seconds of each Hessian; ``make_capped_mass --points 1``
     on the host beside
     the card (the same Hessian code: 66.5 s more on an H100);
     ``nuts_campaign --mass logit-file`` on the capped mass at depth 3;
     ``energy_error_probe`` at its defaults (64 chains, 128 leapfrogs, 5 step
     sizes: 650 K2 / K3 calls);
 25. ``serovalid_pipeline --maxiter 2 --skip-laplace`` (its Laplace is the
     exact Hessian of phase 24, 86 s more on an H100): its
     ``reference_bounds_map`` row
     1432889.790896839 (rtol 1e-10) and sero 0.010137770903508477 (rtol
     1e-9), the committed serovalid MAP through K1 1434295.2737713018 (rtol
     1e-10); ``serovalid_posterior_summary`` on a copy of
     ``results/spain2020_serovalid``: the committed sero quantiles within
     ``SV_SERO_RTOL``, the inside-CI fraction within 1/512, the logl
     quantiles exact; ``refresh_artifact`` of phase 23's depth-10 campaign
     into a copy of ``results/spain2020``: the committed MAP kept, and the
     serovalid campaign refused;
 26. the native IO layer and the simulated dynamics: ``utils/native``'s
     library builds (g++) and loads; ``CalibrationData.from_csv`` gives the
     same arrays with it and with ``MMIDV1_NO_NATIVE=1``, equal in every
     bit; ``write_posterior_trace`` writes the same bytes both ways at
     phase 16's AM campaign size (6 x 8192 rows x 63 values) and at the
     checkpoints' 5000 rows, the seconds of each beside the card's name;
     ``data_visualization.simulate_frame`` (306 days, float32, dopri5@4) on
     the card against the host at rtol ``DYN_RTOL``;
 27. ``mala_rematch`` at 2048 float32 chains, cash_karp@3, REFLECT: K1 and
     K2 held against their plain versions at that shape (rtol 5e-6), K3 in
     regime 2 with rows 0-511 of its 2048-row call against the plain
     version on those rows (per-chain 2-norm 1e-3), each timed; then its
     ``main`` with depth cut from ``--steps 2000 --burn 500`` to 40 / 10
     and one ``--fixed-eps``, counted from 0: every K1 call at 2048 in the
     regime the rule picks, every K2 call at 2048 with one K3 call each,
     all K3 in regime 2; every row finite, its chain-steps/s printed;
 28. the four seroprevalence probes, float64, dopri5@4, REFLECT, at full
     width: on each box (the reference bounds, "B", "C") the composed joint
     value_and_grad (K2 + K3 plus the sero term) at the MAP card vs host
     (the ``--host-refs`` child; rtol 1e-9, floored), K1 / K2 / K3 at B = 1
     timed beside their bounds (under ``--probes`` also their plain
     versions, on box C), K2 + K3's ms and the sero term's seconds a call;
     then each probe's ``main`` with depth cut to ``--maxiter 1 --rounds
     1`` (2 until phase 30 needed the time; the ridge's 7-point k grid,
     one ladder rung a variant), counted
     from 0 (K1, K2 at B = 1, one K3 call each, regime 1), its fixed-point
     rows against ``results/sero_*.json``: LL rtol 1e-10, sero 1e-9,
     ``grad_seed_exposed`` 1e-8, ``grad_runup_days`` exactly 0, the ridge's
     clipped names equal;
 29. the JAX package's whole-run recovery tests on the real model, with
     their settings and bars (``tests/torch_recovery.py``), float64,
     dopri5@2: R1 (``tests/test_sepaihrd_recovery.py``), synthetic Poisson
     data over 60 days made on the host, then ``calibrate(psomcmc)`` (PSO
     128 x 40, AM-MH 32 chains x 400) through K1, counted from 0: every call
     at 128 or 32 chains in the regime the rule picks, 401 at 32; the truth
     back within rtol 0.10 / 0.30 / 0.40, best >= logL(truth) - 5, the
     posterior median of beta_1 within 0.15; phase 1 / 2 seconds and AM-MH
     chain-steps/s. R3 (``tests/test_gradients.py``), 30 days, 5
     parameters, ``run_nuts`` (25 iterations of depth 3, 4 chains) through
     K2 + K3, counted from 0: one K2 and one K3 call a value_and_grad, K3 in
     regime 1; finite, moving, in bounds, best >= logL(theta0) - 5;
     grad-evals/s. Then each run's kernels at its shape, on its last
     samples: K1 at 32 chains, K2 and K3 at 4, held against their plain
     versions (rtol 1e-10, 1e-10, 1e-9) and timed beside their bounds.
     Not here: the age-SIR recovery (R2, an eager solve that
     is launch-bound on the card, 3-4x slower than the host) and the golden
     triangulation of the committed calibration (R4, SciPy on the host; no
     card work); both run in the host tests;
 30. the tableaus and the zero-coefficient rule: K1 and K2 in each regime
     and K3 in each regime (the one its rule picks counted, the other
     forced) against their plain versions for each of the five tableaus
     (rk4, cash_karp, rkf45, dopri5, fehlberg78; each its own
     instantiation), float64 and float32, 5 chains on the Spain tree cut
     to 10 days (30 intervals, 2 chunks; one substep a day, dopri5 two,
     so that FSAL carries a stage), at the bars of
     ``tests/test_torch_kernels.py`` for small sizes (LL and checkpoints
     1e-10 / 2e-5, gradients 1e-9 / 1e-3); the same at the stiff input of
     ``tests/torch_stiff.py`` (dopri5's discarded last stage overflows),
     where the objective must be finite, not finfo.min; the SASS of every
     kernel (cuobjdump): no float compare of a tableau coefficient against
     zero, and the coefficients it loads from the parameter bank are
     exactly the non-zero ones of the stages it runs (a zero coefficient
     is never loaded, so no instruction uses it), beside the coefficient
     FMAs read from the SASS and the count a substep implies (rows the
     right-hand side reads x non-zero stage coefficients + rows x non-zero
     update coefficients); then K1, and K2 + K3, timed at every shape of
     PERF.md's kernel table beside their roofline and chain bounds and the
     time a dependent stage;
 31. print the kernels line and, last, the device line.

It needs one CUDA card; it imports nothing of JAX or of ``mmidv1_tpu``.
Everything measured also goes to ``chiprun_out/chip_smoke.json``.
"""

import contextlib
import json
import os
import shutil
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
MAIN_SCALE = 0.001       # 0.002 until phases 23-25 needed the time


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
                                                     fused_objective_reference)

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
    k, regime = regime_of("k1", lambda: fused_objective(*args, **kw))
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
    out = dict(case=case, B=B, dtype=dtype_name, tableau=tableau,
               substeps=substeps, regime=regime, tol_rel=tol,
               max_rel_err=max_rel,
               max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
               objective_ms=objective_ms,
               **k1_bound(B, dtype_name, args, kw, pipe.data.n_data_points))
    print(f"[compare] {case} ({REGIMES[regime]} regime): max rel err "
          f"{max_rel:.3e} (tol {tol:.0e}), "
          f"max abs err {max_abs:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"objective (prep + kernel) {objective_ms:.3f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']})", flush=True)
    return out


def spain_case(pipe_cache, dtype_name, mode, tableau, substeps, B, seed,
               bad_rows=(), num_days=None):
    """(engine, kernel args, kw, thetas): the value_and_grad engine of one
    configuration and the kernel inputs of B chains near the initial guess
    (0.05 sigma noise), with beta_6 NaN on ``bad_rows``; on the first
    ``num_days`` observed days (with the run-up) where given."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import build_objective_fused_grad

    dtype = getattr(torch, dtype_name)
    key = dtype_name if num_days is None else f"{dtype_name} {num_days} days"
    if key not in pipe_cache:
        pipe_cache[key] = load_spain_pipeline(HERE, dtype=dtype, device="cuda",
                                              num_days=num_days)
    pipe = pipe_cache[key]
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
    ll, rl = got[0].double().cpu().numpy(), ref[0].double().cpu().numpy()
    if not (np.isfinite(ll).all() and bool(got[1].isfinite().all())):
        fail(f"K2 {case}: non-finite output")
    rel_ll, rel_ck = _rel(got[0], ref[0]), _rel_ckpt(got[1], ref[1])
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
    got, ref = [a[..., good] for a in got], [b[..., good] for b in ref]
    err = _grad_err(got, ref, dtype_name)
    max_abs = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, ref))
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
    got, picked = regime_of("k3", lambda: fused_adjoint(
        agevec, scal, beff, obs, valid, ck, g, M, **kw))
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
    (ll, ck), k2_regime = regime_of("k2", lambda: fused_forward_ckpt(*args,
                                                                     **kw))
    g = torch.ones_like(ll)
    k3_args = (agevec, scal, beff, obs, valid, ck, g, M)
    bwd = lambda: fused_adjoint(*k3_args, **kw)
    kernels = launch_counts()["k3_kernels"]
    grads, k3_regime = regime_of("k3", bwd)
    reps = 10 if B <= 1024 else 3
    out = dict(B=B, dtype=dtype_name, k2_regime=k2_regime,
               k3_regime=k3_regime,
               k3_kernels_per_call=launch_counts()["k3_kernels"] - kernels,
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
            _grads, picked = regime_of("k3", lambda: fused_adjoint(*k3_args,
                                                                 **kw))
            row = dict(B=B, dtype=dtype_name, picked=picked,
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


# the kernels' tableau types (ops/_build.py's generated header), by name
TABLEAU_TYPES = {"Rk4": "rk4", "CashKarp": "cash_karp", "Rkf45": "rkf45",
                 "Dopri5": "dopri5", "Fehlberg78": "fehlberg78"}


def kernel_key(name):
    """``(kernel, dtype, tableau)`` of a mangled SEPAIHRD kernel name, e.g.
    ``("K1 wide", "float32", "dopri5")`` or ``("K3 sweep", "float64",
    "rkf45")``; ``tableau`` is None for K3's compose kernel and ``"S=7"``
    for a build templated on the stage count (before the tableau types).
    None for any other name."""
    import re
    m = re.search(r"sepaihrd_(forward_wide|forward_split|adjoint_[a-z]+)"
                  r"_kernelI([fd])(\w*)", name)
    if not m:
        return None
    rest = m.group(3)
    tab = re.match(r"N\w*?Tab([A-Za-z0-9]+?)E", rest)
    stages = re.match(r"Li(\d+)E", rest)
    tableau = (TABLEAU_TYPES.get(tab.group(1), tab.group(1)) if tab
               else f"S={stages.group(1)}" if stages else None)
    kind = m.group(1)
    if kind.startswith("forward"):
        ckpt = re.search(r"Lb([01])E", rest)
        kind = f"{'K2' if ckpt and ckpt.group(1) == '1' else 'K1'} {kind[8:]}"
    else:
        kind = f"K3 {kind[8:]}"
    return kind, "float32" if m.group(2) == "f" else "float64", tableau


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
                    k = kernel_key(ln)
                    key = k and k[0][:2] in ("K1", "K2") and " ".join(k)
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
    """What the card runs: for the dopri5 forward kernels (both
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
            k = kernel_key(blk.split("\n", 1)[0].strip())
            if k and k[0][:2] in ("K1", "K2") and k[2] == "dopri5":
                kind = f"{k[0]} {k[1]}"
                out[kind] = _sass_kernel(kind, blk,
                                         4 if k[1] == "float32" else 8, out_dir)
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


def chain_bound_ms(tableau, substeps, n_intervals, elem, clock_mhz):
    """The forward's chain bound: dependent RK stages x the cycles a stage
    of the recurrence's longest dependency cycle / the SM clock."""
    from mmidv1_tpu_torch.ops import sepaihrd_fused as sf
    return (sf.dependent_stages(tableau, substeps, n_intervals)
            * sf.chain_cycles(elem) / (clock_mhz * 1e3))


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
    chain = chain_bound_ms(kw["tableau"], kw["substeps"], n_intervals, elem,
                           clock_mhz)
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
        ll1, ran1 = regime_of("k1", lambda: fused_objective(*args, **kw,
                                                            regime=regime))
        (ll2, ck), ran2 = regime_of("k2", lambda: fused_forward_ckpt(
            *args, **kw, regime=regime))
        torch.cuda.synchronize()
        if ran1 != regime or ran2 != regime:
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
    """Forget every kernel's launch count (the program's tracer), just
    before a path is driven."""
    from mmidv1_tpu_torch.utils import trace
    trace.reset()


def _launches(kernel):
    """``{(regime, tableau, chains): n}``: the tracer's count of the
    launches of ``kernel`` (``"k1"``, ``"k2"`` or ``"k3"``)."""
    from mmidv1_tpu_torch.utils import trace
    return trace.counts("launches", (kernel,))


def regime_of(kernel, fn):
    """``(fn(), regime)``: the one regime ``kernel`` ran in during ``fn``,
    from the change of its launch count (fails on none or on two)."""
    before = _launches(kernel)
    out = fn()
    regimes = {key[0] for key, n in _launches(kernel).items()
               if n != before.get(key, 0)}
    if len(regimes) != 1:
        fail(f"{kernel} ran in regimes {sorted(regimes)}, expected one")
    return out, regimes.pop()


def launch_counts():
    """Every kernel's launches since ``zero_counts``, by regime and by chain
    count, then regime (K3: by regime, and its ``__global__`` launches)."""
    from mmidv1_tpu_torch.utils import trace
    out = {}
    for kernel in ("k1", "k2", "k3"):
        by_regime, by_batch = {1: 0, 2: 0}, {}
        for (regime, _tableau, B), n in _launches(kernel).items():
            by_regime[regime] += n
            by_batch.setdefault(B, {})
            by_batch[B][regime] = by_batch[B].get(regime, 0) + n
        out[kernel] = sum(by_regime.values())
        out[f"{kernel}_regime_calls"] = by_regime
        if kernel == "k3":
            out["k3_kernels"] = trace.total("k3.kernels")
        else:
            out[f"{kernel}_batch_calls"] = by_batch
    # the objective's prep and mask kernels, by chain count
    for kernel in ("prep", "mask"):
        by_batch = {}
        for key, n in _launches(kernel).items():
            by_batch[key[-1]] = by_batch.get(key[-1], 0) + n
        out[kernel] = sum(by_batch.values())
        out[f"{kernel}_batch_calls"] = by_batch
    return out


def pick_counts(*keys):
    """``keys`` of :func:`launch_counts`."""
    c = launch_counts()
    return {k: c[k] for k in keys}


# every driven path's prep and mask launches, by label (the kernels line)
OBJECTIVE_PATHS = {}
OBJECTIVE_KEYS = ("prep", "mask", "prep_batch_calls", "mask_batch_calls")


def objective_launches(label, counts):
    """Fails unless every objective call of the path just driven (counted
    from 0 into ``counts``, :func:`launch_counts`) launched the prep kernel
    and the mask kernel once beside its K1 or K2 launch, at each chain
    count; records the path's prep and mask launches."""
    want = {}
    for kernel in ("k1", "k2"):
        for B, by_regime in counts[f"{kernel}_batch_calls"].items():
            want[B] = want.get(B, 0) + sum(by_regime.values())
    if counts["prep_batch_calls"] != want or \
            counts["mask_batch_calls"] != want:
        fail(f"{label}: prep / mask launches by chain count "
             f"{counts['prep_batch_calls']} / {counts['mask_batch_calls']}, "
             f"expected one each a K1 or K2 launch: {want}")
    OBJECTIVE_PATHS[label] = {k: counts[k] for k in OBJECTIVE_KEYS}
    return counts


def path_counts(label, *keys):
    """``keys`` of :func:`launch_counts` and the prep and mask launches of
    the path ``label`` just driven, checked by :func:`objective_launches`."""
    c = objective_launches(label, launch_counts())
    return {k: c[k] for k in keys + OBJECTIVE_KEYS}


def read_counts(path, B, crossover):
    """The launch counts of the path just driven with ``B`` float32 chains.
    Fails unless every K3 call ran in the one regime that the rule picks at
    ``B`` and launched that regime's kernels (both from the crossover row of
    ``B``, whose forced calls do not count here)."""
    row = next(r for r in crossover if r["B"] == B and r["dtype"] == "float32")
    regime = row["picked"]
    counts = dict(path_counts(path, "k1", "k2", "k1_regime_calls",
                              "k2_regime_calls",
                              "k3", "k3_kernels", "k3_regime_calls"),
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
    ptxas report: ``{stage: {"float32 dopri5": {registers, spill_stores,
    spill_loads, stack}}}``; printed one line a stage and type."""
    import re
    out = {}
    key = None
    with open(report) as f:
        for ln in f:
            if "Function properties for" in ln:
                k = kernel_key(ln)
                key = k and k[0].startswith("K3") and (
                    k[0][3:], " ".join(x for x in k[1:] if x))
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
    # one tableau a type (phase 30 holds every tableau and type at 5
    # chains): the plain K3 at 512 chains takes tens of seconds a case
    k3_cases = []
    for dtype_name, tol, tableau, substeps in (
            ("float64", 1e-9, "dopri5", 4), ("float32", 1e-3, "cash_karp", 3)):
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
    kernels = launch_counts()["k3_kernels"]
    _grads, regime = regime_of("k3", lambda: fused_adjoint(
        agevec, scal, beff, obs, valid, ck, torch.ones_like(ll), M, **kw))
    torch.cuda.synchronize()
    return dict(B=B, dtype="float32", picked=regime, **{
        f"regime{regime}_kernels": launch_counts()["k3_kernels"] - kernels})


def primary_executable(cache, card):
    """Phase 12: ``sepaihrd_main`` with hillmcmc (K1 counted by chain count
    and regime) and with nuts (K2 / K3 counted)."""
    import torch
    from mmidv1_tpu_torch.cli import sepaihrd_main
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
    counts = path_counts("hillmcmc (sepaihrd_main)", "k1", "k1_regime_calls",
                         "k1_batch_calls")
    by_batch = counts["k1_batch_calls"]
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
    batch, iterations, repeats = 4096, 20, 5
    zero_counts()
    t0 = time.perf_counter()
    res = benchmark_main.run(
        ["--mode", "all", "--batch", str(batch), "--iterations",
         str(iterations), "--repeats", str(repeats), "--json", "--device",
         "cuda", "--project-root", HERE])
    wall = time.perf_counter() - t0
    counts = path_counts("bench (benchmark_main --mode all)", "k1",
                         "k1_regime_calls", "k1_batch_calls")
    by_batch = counts["k1_batch_calls"]
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
    return dict(results=res, wall_seconds=wall, launches=counts)


CAMPAIGN_CHAINS = 8192


def drive_campaign(name, argv, card, expected):
    """One ``production_campaign`` run on the card, K1 counted from 0: every
    call at 8192 chains in the wide regime, ``expected`` of them (the start
    unless resumed, one a step, the float64 re-selection)."""
    from mmidv1_tpu_torch.cli import production_campaign
    zero_counts()
    t0 = time.perf_counter()
    meta = production_campaign.run(argv)
    wall = time.perf_counter() - t0
    counts = path_counts(f"campaign {name}", "k1", "k1_regime_calls",
                         "k1_batch_calls")
    by_batch = counts["k1_batch_calls"]
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
          f", K1 {counts['k1']} launches, all wide on {card}",
          flush=True)
    return dict(meta=meta, wall_seconds=wall, launches=counts)


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
SIR_DEMO_DAYS = 60       # phase 20's window (see the docstring)


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
    from mmidv1_tpu_torch.ops import build_objective_fused

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
        counts = path_counts(f"pso {variant.name}", "k1", "k1_regime_calls",
                             "k1_batch_calls")
        by_batch = counts["k1_batch_calls"]
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
                                  wall_seconds=wall, launches=counts)
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
    for label, counts in out["launches"].items():
        objective_launches(f"parallel {label}", counts)
    out["seconds"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    print(f"[parallel] phase 22: {out['seconds']:.1f} s on {card}",
          flush=True)
    return out


# ------------------------------------------------------------- phases 23-25
# The production NUTS recipe and its tools (mmidv1_tpu_torch/cli:
# nuts_campaign, map_polish, curvature_probe, make_capped_mass,
# energy_error_probe, serovalid_pipeline, serovalid_posterior_summary,
# refresh_artifact), each driven through its main() on the card into a
# temporary directory; nothing under results/ is written.
LOGITSEED = os.path.join(HERE, "results", "spain2020_nuts_logitseed",
                         "samples.npz")
SV_DIR = os.path.join(HERE, "results", "spain2020_serovalid")
POLISH_LL = 1432889.7909088247     # results/spain2020/laplace_mass.npz ll_map
# 5x the host's readings of the port's Hessian products against the same
# function driven by the JAX package's float64 gradient (3.7e-9 / 5.7e-9)
POLISH_STD_RTOL, POLISH_COV_RTOL = 2e-8, 3e-8
SV_REF_ROW = (1432889.790896839, 0.010137770903508477)  # serovalid_metadata
SV_MAP_LL = 1434295.2737713018     # results/spain2020_serovalid/run_metadata
SV_SERO_Q = {"q2.5": 0.03260142216458917, "q50": 0.03462892770767212,
             "q97.5": 0.03701111059635877}
SV_INSIDE = 0.0078125
# 5x the host's float32 replay against the committed quantiles (1.24e-6)
SV_SERO_RTOL = 6e-6
NUTS_DEPTH10 = ["--mass", "logit-dense", "--trace", LOGITSEED, "--warm",
                LOGITSEED, "--chains", "64", "--depth", "10", "--warmup", "1",
                "--iterations", "3", "--segments", "3"]


def drive_main(module, argv, label, expect_rc=0):
    """``module.main(argv)`` on the card, every kernel counted from 0:
    ``(seconds, launch counts)``; fails on another exit code."""
    import torch
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != expect_rc:
        fail(f"{label}: exit code {rc}, expected {expect_rc}")
    counts = objective_launches(label, launch_counts())
    print(f"[{label}] {seconds:.1f} s; K1 {counts['k1_batch_calls']}, K2 "
          f"{counts['k2_batch_calls']}, K3 {counts['k3']} calls "
          f"{counts['k3_regime_calls']}", flush=True)
    return seconds, counts


def expect_gradients(label, counts, B, k1_rows=None):
    """Every K2 call of a gradient path at ``B`` chains in the regime the
    rule picks, one K3 call for each; ``k1_rows``: one K1 call at that
    chain count (the float64 re-selection)."""
    reg = forward_pick(B)
    if counts["k2"] < 1 or counts["k3"] != counts["k2"] or \
            counts["k2_batch_calls"] != {B: {reg: counts["k2"]}}:
        fail(f"{label}: K2 / K3 launches {counts}, expected every K2 call at "
             f"B = {B} in the {REGIMES[reg]} regime and as many K3 calls")
    if k1_rows is not None and counts["k1_batch_calls"] != {
            k1_rows: {forward_pick(k1_rows): 1}}:
        fail(f"{label}: K1 launches {counts['k1_batch_calls']}, expected one "
             f"at B = {k1_rows}")


def rel_floor(a, b):
    """max |a - b| / (|b| + max |b|): rtol with a floor of rtol x max."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + np.abs(b).max())))


def same_npz(a, b, label):
    import numpy as np
    with np.load(a) as za, np.load(b) as zb:
        if za.files != zb.files:
            fail(f"{label}: {a} and {b} hold different fields")
        for k in za.files:
            nan = za[k].dtype.kind in "fc"
            if za[k].dtype != zb[k].dtype or \
                    not np.array_equal(za[k], zb[k], equal_nan=nan):
                fail(f"{label}: {os.path.basename(a)}[{k}] differs")


def polish_hessian_seconds(tmp):
    """Seconds of one ``map_polish.hessian_products`` on the card at the
    committed theta_map (float64, a warm call; the rows one K2 + K3
    batch)."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.cli import map_polish
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import build_objective_fused_grad
    pipe = load_spain_pipeline(HERE, dtype=torch.float64, device="cuda")
    vg = build_objective_fused_grad(pipe.space, pipe.params, pipe.data,
                                    pipe.ts, constraint_mode=REFLECT,
                                    device="cuda")
    rows, vg1 = map_polish.engine_rows(vg, "cuda")
    theta = np.load(os.path.join(tmp, "theta_map.npy"))
    box = [t.cpu().numpy() for t in (pipe.space.lower, pipe.space.upper,
                                     pipe.space.sigmas)]
    g = vg1(theta)[1]
    map_polish.hessian_products(rows, theta, g, *box)
    return map_polish.hessian_products(rows, theta, g, *box)[4]


def polish_phase(tmp, card, host):
    """23 (a): ``map_polish --rounds 0`` from the committed theta_map on the
    card, against the host's run of the same (``host_refs``)."""
    import numpy as np
    from mmidv1_tpu_torch.cli import map_polish
    lap = np.load(os.path.join(HERE, "results", "spain2020", "laplace_mass.npz"))
    secs, counts = drive_main(map_polish, ["--init", os.path.join(
        tmp, "theta_map.npy"), "--rounds", "0", "--out", os.path.join(
        tmp, "polish")], "polish")
    n_rows = max(counts["k2_batch_calls"], default=0)
    hess_s = polish_hessian_seconds(tmp)
    if counts["k2"] != 2 or counts["k3"] != 2 or \
            sorted(counts["k2_batch_calls"]) != [1, n_rows]:
        fail(f"polish: K2 / K3 launches {counts}, expected the start point "
             f"and one batch of Hessian rows")
    host_s = host.result()["polish_seconds"]
    c = np.load(os.path.join(tmp, "polish", "laplace_mass.npz"))
    h = np.load(os.path.join(tmp, "polish_host", "laplace_mass.npz"))
    rel_ll = abs(float(c["ll_map"]) - POLISH_LL) / POLISH_LL
    mask_host = bool(np.array_equal(c["free"], h["free"]))
    vs_committed = [str(n) for n, a, b in zip(lap["names"], c["free"],
                                              lap["free"]) if a != b]
    rel_std = float(np.max(np.abs(c["std"] / h["std"] - 1)))
    rel_cov = float(np.max(np.abs(c["cov_free"] - h["cov_free"]))
                    / np.abs(h["cov_free"]).max()) if mask_host else None
    print(f"[polish] ll_map {float(c['ll_map'])!r} vs committed {POLISH_LL!r} "
          f"(rel {rel_ll:.3e}, bar 1e-10); {int(c['free'].sum())} free, mask "
          f"{'equal to' if mask_host else 'DIFFERENT from'} the host's; vs the "
          f"committed mask: {vs_committed or 'equal'}; std card vs host "
          f"{rel_std:.3e} (bar {POLISH_STD_RTOL:.0e}), cov_free "
          f"{rel_cov if rel_cov is None else f'{rel_cov:.3e}'} (bar "
          f"{POLISH_COV_RTOL:.0e}); {secs:.1f} s on {card} (its Hessian of "
          f"{n_rows} gradient rows {hess_s * 1e3:.1f} ms), {host_s:.1f} s on "
          f"the host", flush=True)
    if not (rel_ll <= 1e-10 and mask_host and rel_std <= POLISH_STD_RTOL
            and rel_cov <= POLISH_COV_RTOL):
        fail("polish: the card's Laplace mass is off")
    return dict(seconds=secs, host_seconds=host_s, hessian_seconds=hess_s,
                ll_map=float(c["ll_map"]),
                rel_ll=rel_ll, n_free=int(c["free"].sum()),
                free_vs_committed=vs_committed, rel_std=rel_std,
                rel_cov=rel_cov, hessian_rows=n_rows, launches=counts)


def nuts_iteration_profile(out_dir):
    """The card's idle share over one more depth-10 iteration of the
    campaign in ``out_dir``, resumed from its checkpoint and mass (K2 + K3
    in float32 at 64 chains), from torch.profiler's kernel intervals."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mmidv1_tpu_torch.calibration.nuts import NUTSConfig, run_nuts_logit
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import build_objective_fused_grad
    from mmidv1_tpu_torch.utils.checkpoint import load_nuts_state
    pipe = load_spain_pipeline(HERE, dtype=torch.float32, device="cuda")
    vg = build_objective_fused_grad(pipe.space, pipe.params, pipe.data,
                                    pipe.ts, constraint_mode=REFLECT,
                                    device="cuda")
    state = load_nuts_state(os.path.join(out_dir, "nuts_state.npz"),
                            device="cuda")
    mass = np.load(os.path.join(out_dir, "active_mass.npz"))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    cfg = NUTSConfig(iterations=state.it + 1, adaptation_window=1,
                     max_tree_depth=10)
    calls = vg.calls
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_nuts_logit(None, pipe.space, cfg, mu=t(mass["mu"]),
                       scale=t(mass["scale"]), n_chains=64,
                       value_and_grad_batch=vg, initial_state=state,
                       power=t(mass["power"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    if not kernels:
        fail("torch.profiler reported no device time in phase 23")
    window = max(e for _s, e in kernels) - min(s for s, _e in kernels)
    busy = busy_ns(kernels)
    return dict(idle_share=1.0 - busy / window, busy_ms=busy / 1e6,
                window_ms=window / 1e6, wall_profiled=wall,
                calls=vg.calls - calls)


def sero_engines(dev, dtype):
    """``(K2 + K3 engine, sero penalty, their composed value_and_grad)`` of
    the serovalid problem (relaxed bounds, REFLECT)."""
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.calibration.serovalid import (add_sero_term,
                                                        make_sero_penalty,
                                                        relax_bounds)
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import build_objective_fused_grad
    pipe = load_spain_pipeline(HERE, dtype=dtype, device=dev)
    space, _ = relax_bounds(pipe.space)
    stream = build_objective_fused_grad(space, pipe.params, pipe.data,
                                        pipe.ts, constraint_mode=REFLECT,
                                        dtype=dtype, device=dev)
    pen = make_sero_penalty(space, pipe.params, pipe.data, pipe.ts,
                            constraint_mode=REFLECT, dtype=dtype, device=dev)
    return stream, pen, add_sero_term(stream, pen)


def sero_trace():
    import numpy as np
    return np.load(os.path.join(SV_DIR, "laplace_trace.npz"))["samples"][-1]


def host_refs(tmp, parts):
    """The host's side of phases 23-25 and 28, run in a process of its own
    while the card works (``--host-refs DIR PARTS``), into ``DIR``: for phase
    28 (``parts`` "probes" or "all", first) ``probe_host_refs``; for phases
    23-25 ("nuts" or "all") ``map_polish --rounds 0``, ``curvature_probe
    --points 1`` (only for "nuts": the whole script leaves phase 24's card
    run of it out), the composed serovalid value_and_grad at 4 float64
    chains, and ``make_capped_mass --points 1`` (its Hessian is
    ``curvature_probe``'s, held card against host in phase 24)."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.cli import (curvature_probe, make_capped_mass,
                                      map_polish)
    torch.set_num_threads(4)
    out = {}
    if parts in ("probes", "all"):
        out["probes"] = probe_host_refs(tmp)
    if parts not in ("nuts", "all"):
        with open(os.path.join(tmp, "host_refs.json"), "w") as f:
            json.dump(out, f)
        return
    t0 = time.perf_counter()
    map_polish.main(["--init", os.path.join(tmp, "theta_map.npy"),
                     "--rounds", "0", "--device", "cpu", "--out",
                     os.path.join(tmp, "polish_host")])
    out["polish_seconds"] = time.perf_counter() - t0
    if parts == "nuts":                   # phase 24's card vs host check
        curvature_probe.main(["--trace", LOGITSEED, "--points", "1",
                              "--device", "cpu", "--out",
                              os.path.join(tmp, "curvature_cpu.json")])
    vag = sero_engines("cpu", torch.float64)[2]
    v, g = vag(torch.as_tensor(sero_trace()[:4], dtype=torch.float64))
    np.savez(os.path.join(tmp, "sero_host.npz"), value=v.numpy(),
             grad=g.numpy())
    t0 = time.perf_counter()
    make_capped_mass.main(["--trace", LOGITSEED, "--points", "1", "--device",
                           "cpu", "--out", os.path.join(tmp, "capped.npz")])
    out["capped_seconds"] = time.perf_counter() - t0
    with open(os.path.join(tmp, "host_refs.json"), "w") as f:
        json.dump(out, f)


class HostRefs:
    """``host_refs`` in a child process started at once; ``result()`` waits
    for it and fails the phase with its log if it failed."""

    def __init__(self, tmp, parts):
        self.tmp = tmp
        self.log = open(os.path.join(tmp, "host_refs.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--host-refs", tmp,
             parts],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=HERE)
        self.t0 = time.perf_counter()

    def result(self):
        if self.proc.returncode is None:
            try:
                self.proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                self.stop()
                fail("the host references did not finish in 600 s")
        self.log.flush()
        if self.proc.returncode != 0:
            with open(os.path.join(self.tmp, "host_refs.log")) as f:
                fail("the host references failed:\n" + f.read()[-3000:])
        with open(os.path.join(self.tmp, "host_refs.json")) as f:
            return json.load(f)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


class SeroSplit:
    """While in a ``with`` block, ``calibration.serovalid.add_sero_term``
    times each composed call's two parts apart (the card synchronised
    around each): the K2 + K3 stream and the sero term, ms a call."""

    def __enter__(self):
        from types import SimpleNamespace
        import torch
        from mmidv1_tpu_torch.calibration import serovalid
        self.stream_ms, self.sero_ms = [], []
        self._saved = add = serovalid.add_sero_term

        def timed(fn, into):
            def call(x):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(x)
                torch.cuda.synchronize()
                into.append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        def add_timed(stream, pen):
            return add(timed(stream, self.stream_ms), SimpleNamespace(
                value_and_grad=timed(pen.value_and_grad, self.sero_ms)))

        serovalid.add_sero_term = add_timed
        return self

    def __exit__(self, *exc):
        from mmidv1_tpu_torch.calibration import serovalid
        serovalid.add_sero_term = self._saved


def sero_split(card, tmp, host, split):
    """The serovalid campaign's value_and_grad calls at 64 float32 chains,
    K2 + K3 and the sero term apart (the median of ``split``'s calls after
    the first); the composed value_and_grad in float64 at 4 chains, card
    against host (rtol 1e-9, floored)."""
    import numpy as np
    import torch
    trace = sero_trace()
    stream_ms = float(np.median(split.stream_ms[1:]))
    sero_ms = float(np.median(split.sero_ms[1:]))
    vag = sero_engines("cuda", torch.float64)[2]
    v, g = vag(torch.as_tensor(trace[:4], dtype=torch.float64, device="cuda"))
    host.result()
    h = np.load(os.path.join(tmp, "sero_host.npz"))
    got = {"cuda": (v.cpu().numpy(), g.cpu().numpy()),
           "cpu": (h["value"], h["grad"])}
    rel_v = float(np.max(np.abs(got["cuda"][0] - got["cpu"][0])
                         / np.abs(got["cpu"][0])))
    rel_g = rel_floor(got["cuda"][1], got["cpu"][1])
    print(f"[serovalid-nuts] a value_and_grad at 64 float32 chains (median "
          f"of {len(split.sero_ms) - 1}): K2 + K3 {stream_ms:.1f} ms, the sero "
          f"term {sero_ms:.1f} ms on {card}; "
          f"composed float64 card vs host at 4 chains: value {rel_v:.3e}, "
          f"gradient {rel_g:.3e} (bar 1e-9)", flush=True)
    if not (rel_v <= 1e-9 and rel_g <= 1e-9):
        fail("serovalid NUTS: the composed gradient differs card vs host")
    return dict(stream_ms=stream_ms, sero_ms=sero_ms,
                calls=len(split.sero_ms), rel_value=rel_v, rel_grad=rel_g)


def nuts_recipe_phase(tmp, card, host, grad_shapes):
    """Phase 23: the polish, the production recipe at depth 10 (and one
    more iteration profiled), a depth-4 campaign killed and resumed, the
    stage ladder, the serovalid campaign. K2 / K3 are held against their
    plain versions at ``grad_shapes`` ``(B, dtype, K3 tolerance)``."""
    import json as _json
    from mmidv1_tpu_torch.cli import nuts_campaign as nc
    t_phase = time.perf_counter()
    out = dict(k_compare=[compare("float64 dopri5@4 B=257 (NUTS MAP "
                                  "re-selection)", 257, "float64", "dopri5",
                                  4, FWD_TOL["float64"], {}, seed=230)])
    cache = {}
    for B, d, tol in grad_shapes:
        out["k_compare"].append(compare_k2(f"{d} dopri5@4 B={B}", B, d,
                                           "dopri5", 4, FWD_TOL[d], cache,
                                           seed=231))
        out["k_compare"].append(compare_k3(f"{d} dopri5@4 B={B}", B, d,
                                           "dopri5", 4, tol, cache, seed=232))
    paths = out["paths"] = {}

    d10 = os.path.join(tmp, "nuts_d10")
    secs, counts = drive_main(nc, NUTS_DEPTH10 + ["--out", d10],
                              "nuts depth 10")
    with open(os.path.join(d10, "campaign_metadata.json")) as f:
        meta = _json.load(f)
    expect_gradients("nuts depth 10", counts, 64, k1_rows=129)
    paths["nuts logit-dense depth 10 B=64"] = counts
    prof = nuts_iteration_profile(d10)
    out["depth10"] = dict(
        seconds=secs, grad_evals_per_s_incl_host=meta[
            "value_and_grads_per_sec_incl_host"],
        calls_per_s=counts["k2"] / secs, chain_grads_per_s=64 * counts["k2"]
        / secs, mean_accept=meta["mean_accept"],
        mean_tree_depth=meta["mean_tree_depth"],
        best_logl_float64=meta["best_logl_float64"], profile=prof)
    print(f"[nuts depth 10] 64 chains x 3 iterations: "
          f"{meta['value_and_grads_per_sec_incl_host']:.4e} grad-evals/s incl. "
          f"host (the campaign's own count), {counts['k2']} value_and_grad "
          f"calls = {64 * counts['k2'] / secs:.4e} chain-gradients/s; one more "
          f"iteration profiled: {prof['calls']} calls, card idle "
          f"{prof['idle_share']:.3f} of {prof['window_ms']:.0f} ms on {card}",
          flush=True)

    # depth 4: 8 iterations in 4 segments; the same killed after 2 segments
    # (the partial file of a third written, its state not) and resumed
    base = ["--mass", "logit-dense", "--trace", LOGITSEED, "--warm",
            LOGITSEED, "--chains", "64", "--depth", "4", "--warmup", "2"]
    full, killed = os.path.join(tmp, "d4_full"), os.path.join(tmp, "d4_kill")
    _s, c_full = drive_main(nc, base + ["--iterations", "8", "--segments", "4",
                                        "--out", full], "nuts depth 4")
    _s, c_kill = drive_main(nc, base + ["--iterations", "4", "--segments", "2",
                                        "--out", killed], "nuts depth 4 killed")
    shutil.copy(os.path.join(killed, "partial_samples_0001.npz"),
                os.path.join(killed, "partial_samples_0002.npz"))
    _s, c_res = drive_main(nc, base + ["--iterations", "8", "--segments", "4",
                                       "--resume", "--out", killed],
                           "nuts depth 4 resumed")
    for c, label in ((c_full, "full"), (c_kill, "killed"), (c_res, "resumed")):
        expect_gradients(f"nuts depth 4 {label}", c, 64)
        paths[f"nuts depth 4 {label} B=64"] = c
    for name in [f"partial_samples_{s:04d}.npz" for s in range(4)] + [
            "nuts_state.npz", "samples.npz", "active_mass.npz"]:
        same_npz(os.path.join(full, name), os.path.join(killed, name),
                 "nuts depth 4 resume")
    with open(os.path.join(full, "posterior_trace.csv"), "rb") as fa, \
            open(os.path.join(killed, "posterior_trace.csv"), "rb") as fb:
        if fa.read() != fb.read():
            fail("nuts depth 4 resume: posterior_trace.csv differs")
    print("[nuts depth 4] killed after 2 of 4 segments (a third partial "
          "without its state) and resumed: every partial file, the state, "
          "samples.npz and the trace equal the uninterrupted run's to the bit",
          flush=True)

    # the stage ladder with the Laplace dense mass
    secs, c = drive_main(nc, ["--mass", "laplace-dense", "--stages", "2",
                              "--stage-iterations", "4", "--warmup", "2",
                              "--iterations", "4", "--segments", "2",
                              "--chains", "64", "--depth", "3", "--out",
                              os.path.join(tmp, "stages")], "nuts stages")
    expect_gradients("nuts stages", c, 64)
    paths["nuts laplace-dense stages 2 depth 3 B=64"] = c

    # serovalid: the Laplace trace as mass and warm start
    lt = os.path.join(SV_DIR, "laplace_trace.npz")
    sv = os.path.join(tmp, "nuts_sv")
    with SeroSplit() as split:
        secs, c = drive_main(nc, ["--serovalid", "--mass", "logit-dense",
                                  "--trace", lt, "--warm", lt, "--chains",
                                  "64", "--depth", "1", "--warmup", "0",
                                  "--iterations", "2", "--segments", "1",
                                  "--out", sv], "nuts serovalid")
    expect_gradients("nuts serovalid", c, 64)
    paths["nuts serovalid depth 1 B=64"] = c
    with open(os.path.join(sv, "campaign_metadata.json")) as f:
        if _json.load(f)["serovalid"]["severity_floor_div"] != 10.0:
            fail("nuts serovalid: no serovalid block in the metadata")
    out["serovalid_seconds"] = secs
    # the host's references ran meanwhile
    out["polish"] = polish_phase(tmp, card, host)
    out["sero_split"] = sero_split(card, tmp, host, split)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[nuts] phase 23: {out['seconds']:.1f} s on {card}", flush=True)
    return out


def curvature_phase(tmp, card, host, alone):
    """Phase 24: ``curvature_probe`` card vs host (only under ``--nuts``,
    ``alone``: its exact Hessian is 50-144 s on the card), ``make_capped_mass``,
    a ``--mass logit-file`` campaign on the capped mass, and
    ``energy_error_probe`` at its defaults."""
    import json as _json
    import numpy as np
    from mmidv1_tpu_torch.cli import curvature_probe, energy_error_probe
    from mmidv1_tpu_torch.cli import nuts_campaign as nc
    t_phase = time.perf_counter()
    rep, rel = {}, None
    if alone:
        curvature_probe.main(["--trace", LOGITSEED, "--points", "1", "--out",
                              os.path.join(tmp, "curvature_cuda.json")])
        host.result()
        for dev in ("cuda", "cpu"):
            with open(os.path.join(tmp, f"curvature_{dev}.json")) as f:
                rep[dev] = _json.load(f)
        c, h = rep["cuda"], rep["cpu"]
        pairs = [(c["points"][0]["eig_max"], h["points"][0]["eig_max"])] + [
            (c["masses"][m]["eps_stable"], h["masses"][m]["eps_stable"])
            for m in c["masses"]]
        rel = max(abs(a - b) / abs(b) for a, b in pairs)
        print(f"[curvature] exact Hessian of the logit posterior at 1 point: "
              f"{c['hessian_seconds'][0]:.1f} s on {card}, "
              f"{h['hessian_seconds'][0]:.1f} s on the host; eig_max / "
              f"eps_stable card vs host {rel:.3e} (bar 1e-8)", flush=True)
        if not rel <= 1e-8:
            fail("curvature_probe: the card's curvature differs from the "
                 "host's")
    # make_capped_mass ran beside the card, on the host (host_refs)
    mass = os.path.join(tmp, "capped.npz")
    secs = host.result()["capped_seconds"]
    z = np.load(mass)
    if not (np.isfinite(z["scale"]).all() and np.isfinite(z["mu"]).all()):
        fail("make_capped_mass: non-finite mass")
    print(f"[make_capped_mass] --points 1 on the host beside the card: "
          f"{secs:.1f} s, a finite capped mass", flush=True)
    paths = {}
    _s, cnt = drive_main(nc, ["--mass", "logit-file", "--mass-file", mass,
                              "--warm", LOGITSEED, "--chains", "64",
                              "--depth", "3", "--warmup", "0", "--iterations",
                              "2", "--segments", "1", "--out",
                              os.path.join(tmp, "nuts_file")],
                         "nuts logit-file")
    expect_gradients("nuts logit-file", cnt, 64)
    paths["nuts logit-file depth 3 B=64"] = cnt
    zero_counts()
    t0 = time.perf_counter()
    rows = energy_error_probe.run(["--trace", LOGITSEED])
    e_secs = time.perf_counter() - t0
    cnt = objective_launches("energy_error_probe", launch_counts())
    expect_gradients("energy_error_probe", cnt, 64)
    if cnt["k2"] != 5 * 130 or any(r["finite"] < 1 for r in rows):
        fail(f"energy_error_probe: {cnt['k2']} K2 calls, rows {rows}")
    paths["energy_error_probe B=64"] = cnt
    accepts = ", ".join("%.0e: %.3f" % (r["eps"], r["accept"]) for r in rows)
    print(f"[energy] 5 step sizes x 128 leapfrogs at 64 chains in "
          f"{e_secs:.1f} s: E[accept] {accepts}", flush=True)
    out = dict(curvature=dict(rep, rel=rel),
               capped_seconds=secs, energy=rows, energy_seconds=e_secs,
               paths=paths, seconds=time.perf_counter() - t_phase)
    print(f"[curvature] phase 24: {out['seconds']:.1f} s on {card}", flush=True)
    return out


def serovalid_chain_phase(tmp, card, campaign_dirs):
    """Phase 25: ``serovalid_pipeline --maxiter 2``, the committed serovalid
    MAP through K1, ``serovalid_posterior_summary`` and
    ``refresh_artifact`` on temporary copies of the artifacts."""
    import json as _json
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.calibration.serovalid import relax_bounds
    from mmidv1_tpu_torch.cli import (refresh_artifact,
                                      serovalid_posterior_summary,
                                      serovalid_pipeline)
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.data import read_sepaihrd_parameters
    from mmidv1_tpu_torch.ops import build_objective_fused
    t_phase = time.perf_counter()
    zero_counts()
    t0 = time.perf_counter()
    # the Laplace's exact Hessian (86 s on the card) is left out here:
    # phase 24 runs the same Hessian code, tests/test_torch_serovalid_tools.py
    # holds the Laplace against the JAX script
    meta = serovalid_pipeline.run(["--maxiter", "2", "--skip-laplace",
                                   "--out", os.path.join(tmp,
                                                         "sv_pipeline")])
    secs = time.perf_counter() - t0
    cnt = objective_launches("serovalid_pipeline", launch_counts())
    if not (cnt["k1"] >= 1 and cnt["k2"] >= 1 and cnt["k3"] == cnt["k2"]):
        fail(f"serovalid_pipeline: launches {cnt}")
    row = meta["reference_bounds_map"]
    rel_ll = abs(row["ll_poisson_float64"] - SV_REF_ROW[0]) / SV_REF_ROW[0]
    rel_sero = abs(row["sero_day64"] - SV_REF_ROW[1]) / SV_REF_ROW[1]
    pipe = load_spain_pipeline(HERE, dtype=torch.float64, device="cuda")
    space, _ = relax_bounds(pipe.space)
    calib = read_sepaihrd_parameters(
        os.path.join(SV_DIR, "calibrated_parameters.txt"), 4,
        N=pipe.data.population_by_age,
        M_baseline=pipe.params.M_baseline.cpu().numpy(), dtype=torch.float64,
        device="cuda")
    ll = build_objective_fused(space, pipe.params, pipe.data, pipe.ts,
                               constraint_mode=REFLECT, device="cuda")
    sv_ll = float(ll(space.extract(calib)[None])[0])
    rel_map = abs(sv_ll - SV_MAP_LL) / SV_MAP_LL
    print(f"[serovalid_pipeline] --maxiter 2 --skip-laplace in {secs:.1f} s "
          f"on {card}: reference-bounds row LL {row['ll_poisson_float64']!r} (rel "
          f"{rel_ll:.3e}, bar 1e-10), sero {row['sero_day64']!r} (rel "
          f"{rel_sero:.3e}, bar 1e-9); the committed serovalid MAP through K1 "
          f"{sv_ll!r} (rel {rel_map:.3e}, bar 1e-10); launches K1 {cnt['k1']}, "
          f"K2 / K3 {cnt['k2']} / {cnt['k3']}", flush=True)
    if not (rel_ll <= 1e-10 and rel_sero <= 1e-9 and rel_map <= 1e-10):
        fail("serovalid_pipeline: an anchor is off")

    art = os.path.join(tmp, "sv_artifact")
    shutil.copytree(SV_DIR, art)
    t0 = time.perf_counter()
    summ = serovalid_posterior_summary.run(["--artifact", art])
    summ_s = time.perf_counter() - t0
    with open(os.path.join(SV_DIR, "run_metadata.json")) as f:
        committed = _json.load(f)["posterior_summary"]
    rel_q = max(abs(summ["sero_day64"][k] - v) / v
                for k, v in SV_SERO_Q.items())
    print(f"[serovalid_posterior_summary] {summ_s:.1f} s: sero quantiles rel "
          f"{rel_q:.3e} (bar {SV_SERO_RTOL:.0e}), inside-CI "
          f"{summ['sero_inside_ci_frac']} (committed {SV_INSIDE}), logl "
          f"quantiles {'equal' if summ['logl'] == committed['logl'] else 'DIFFER'}",
          flush=True)
    if not (rel_q <= SV_SERO_RTOL
            and abs(summ["sero_inside_ci_frac"] - SV_INSIDE) <= 1 / 512
            and summ["logl"] == committed["logl"]):
        fail("serovalid_posterior_summary: off the committed summary")

    ref_art = os.path.join(tmp, "ref_artifact")
    shutil.copytree(os.path.join(HERE, "results", "spain2020"), ref_art,
                    ignore=shutil.ignore_patterns("analysis"))
    with open(os.path.join(ref_art, "calibrated_parameters.txt"), "rb") as f:
        map_before = f.read()
    refresh_artifact.main([campaign_dirs["reference"], "--artifact", ref_art,
                           "--draws", "100"])
    with open(os.path.join(ref_art, "calibrated_parameters.txt"), "rb") as f:
        kept = f.read() == map_before
    with open(os.path.join(ref_art, "run_metadata.json")) as f:
        kept = kept and _json.load(f)["best_logl_float64"] == MAP_LL
    refused = False
    try:
        refresh_artifact.main([campaign_dirs["serovalid"], "--artifact",
                               ref_art])
    except SystemExit as e:
        refused = "serovalid" in str(e)
    print(f"[refresh_artifact] the depth-10 campaign into a copy of "
          f"results/spain2020: MAP {'kept' if kept else 'REPLACED'}; the "
          f"serovalid campaign {'refused' if refused else 'NOT refused'}",
          flush=True)
    if not (kept and refused):
        fail("refresh_artifact: the MAP was replaced or the serovalid "
             "campaign promoted")
    out = dict(pipeline_seconds=secs, reference_row=row, rel_ll=rel_ll, rel_sero=rel_sero,
               serovalid_map_ll=sv_ll, rel_map=rel_map, summary=summ,
               summary_rel=rel_q, summary_seconds=summ_s,
               paths={"serovalid_pipeline": cnt},
               seconds=time.perf_counter() - t_phase)
    print(f"[serovalid] phase 25: {out['seconds']:.1f} s on {card}", flush=True)
    return out


def nuts_phases(card, tmp, host, alone=True):
    """Phases 23-25 in the temporary directory ``tmp`` of ``HostSide``,
    whose child process ``host`` computes the host's references beside
    them. In the whole script (``alone`` False) phases 2b and 6-8 have held
    K2 / K3 in the regimes and dtypes of these paths already (64 chains in
    float32 and float64, regime 1, split), so only ``--nuts`` holds them
    again at the recipe's 64 float32 chains and the polish's 71 float64
    rows."""
    t0 = time.perf_counter()
    recipe = nuts_recipe_phase(
        tmp, card, host, [(64, "float32", 1e-3), (71, "float64", 1e-9)]
        if alone else [])
    curv = curvature_phase(tmp, card, host, alone)
    sero = serovalid_chain_phase(tmp, card, dict(
        reference=os.path.join(tmp, "nuts_d10"),
        serovalid=os.path.join(tmp, "nuts_sv")))
    out = dict(recipe=recipe, curvature=curv, serovalid=sero,
               seconds=time.perf_counter() - t0)
    print(f"[nuts] phases 23-25: {out['seconds']:.1f} s on {card}", flush=True)
    return out


class HostSide:
    """A temporary directory and, started in it at once, the host's
    references of ``parts`` ("nuts": phases 23-25, "probes": phase 28, "all":
    both) in a child process (``HostRefs``); on exit the child is stopped and
    the directory deleted."""

    def __init__(self, parts):
        self.parts = parts

    def __enter__(self):
        import tempfile
        import numpy as np
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
        np.save(os.path.join(self.tmp, "theta_map.npy"), np.load(os.path.join(
            HERE, "results", "spain2020", "laplace_mass.npz"))["theta_map"])
        self.host = HostRefs(self.tmp, self.parts)
        return self.tmp, self.host

    def __exit__(self, *exc):
        self.host.stop()
        shutil.rmtree(self.tmp, ignore_errors=True)


def nuts_paths(nuts):
    """Every kernel's launches on phases 23-25, by path."""
    paths = dict(nuts["recipe"]["paths"])
    paths.update(nuts["curvature"]["paths"])
    paths.update(nuts["serovalid"]["paths"])
    paths["map_polish"] = nuts["recipe"]["polish"]["launches"]
    return paths


# ------------------------------------------------------------- phases 26-28
# The last slice on the card: the native IO layer and the simulated
# dynamics (26), mala_rematch at its 2048 chains (27), the four
# seroprevalence probes at full width (28). Every main writes into a
# temporary directory; nothing under results/ is written.
TRACE_SHAPE = (6, 8192, 62)   # phase 16's AM campaign: 200 its, burn 50, thin 25
CKPT_ROWS = 5000              # the checkpoints' trace (utils/checkpoint)
# simulate_frame, float32, card vs host: the bar of
# tests/test_torch_dynamics.py (10x the host's JAX-vs-port reading, 1.12e-6)
DYN_RTOL = 1e-5
REMATCH_B, REMATCH_STEPS, REMATCH_BURN = 2048, 40, 10   # depth cut from 2000 / 500
K3_PLAIN_ROWS = 512           # the plain K3's saved tensors (phase 7)
PROBE_SE, PROBE_TARGET = 0.0028, 0.048
PROBE_BOXES = ("reference", "B", "C")
PROBE_MAINS = {            # depth cut: --maxiter 1 --rounds 1, one ladder rung
    "sero_profile_probe": ["--maxiter", "1", "--rounds", "1"],
    "sero_ridge_scan": ["--maxiter", "1"],
    "sero_sensitivity": ["--maxiter", "1", "--rounds", "1"],
    "sero_force_profile": ["--maxiter", "1", "--se-ladder", "0.01"],
}


class NativeOff:
    """While in a ``with`` block, ``MMIDV1_NO_NATIVE=1`` and the native
    library unloaded: every IO entry point takes its Python path."""

    def __enter__(self):
        from mmidv1_tpu_torch.utils import native
        self.saved = (native._lib, native._tried,
                      os.environ.get("MMIDV1_NO_NATIVE"))
        native._lib, native._tried = None, False
        os.environ["MMIDV1_NO_NATIVE"] = "1"
        if native.get_lib() is not None:
            fail("MMIDV1_NO_NATIVE=1 did not switch the native library off")
        return self

    def __exit__(self, *exc):
        from mmidv1_tpu_torch.utils import native
        native._lib, native._tried, env = self.saved
        if env is None:
            os.environ.pop("MMIDV1_NO_NATIVE", None)
        else:
            os.environ["MMIDV1_NO_NATIVE"] = env


def native_phase(card, tmp):
    """Phase 26: the native library loads; ``from_csv`` and
    ``write_posterior_trace`` give the same arrays and bytes with it and
    without; ``simulate_frame`` on the card against the host."""
    import numpy as np
    from mmidv1_tpu_torch.cli import data_visualization as dv
    from mmidv1_tpu_torch.data import CalibrationData, read_params_to_calibrate
    from mmidv1_tpu_torch.utils import native
    from mmidv1_tpu_torch.utils.checkpoint import write_posterior_trace
    t_phase = time.perf_counter()
    lib = native.get_lib()
    if lib is None:
        fail("the native IO library did not build or load")
    csv = os.path.join(HERE, "data", "processed", "processed_data.csv")
    read = {}
    for how in ("native", "python"):
        with NativeOff() if how == "python" else contextlib.nullcontext():
            t0 = time.perf_counter()
            read[how] = (CalibrationData.from_csv(csv, "2020-03-01",
                                                  "2020-12-31"),
                         time.perf_counter() - t0)
    a, b = read["native"][0], read["python"][0]
    for f in ("new_confirmed", "new_deaths", "new_hospitalizations",
              "new_icu", "cumulative_confirmed", "cumulative_deaths",
              "cumulative_hospitalizations", "cumulative_icu",
              "population_by_age"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            fail(f"from_csv: {f} differs between the native and Python reads")
    if a.dates != b.dates:
        fail("from_csv: the dates differ between the native and Python reads")
    names = read_params_to_calibrate(os.path.join(
        HERE, "data", "configuration", "params_to_calibrate.txt"))
    rng = np.random.default_rng(26)
    samples = rng.uniform(0.0, 1.0, TRACE_SHAPE) * 10.0 ** rng.integers(
        -6, 5, TRACE_SHAPE[-1])
    logps = 1.4e6 + rng.normal(size=TRACE_SHAPE[:2]) * 50.0
    traces = {}
    for label, max_rows in (("campaign", None), ("checkpoint", CKPT_ROWS)):
        secs = {}
        for how in ("native", "python"):
            path = os.path.join(tmp, f"trace_{label}_{how}.csv")
            with NativeOff() if how == "python" else contextlib.nullcontext():
                t0 = time.perf_counter()
                write_posterior_trace(path, samples, logps, names,
                                      max_rows=max_rows)
                secs[how] = time.perf_counter() - t0
        with open(os.path.join(tmp, f"trace_{label}_native.csv"), "rb") as f:
            nat = f.read()
        with open(os.path.join(tmp, f"trace_{label}_python.csv"), "rb") as f:
            py = f.read()
        rows = nat.count(b"\n") - 1
        if nat != py:
            fail(f"write_posterior_trace ({label}, {rows} rows): the native "
                 f"and Python files differ")
        traces[label] = dict(rows=rows, columns=TRACE_SHAPE[-1] + 1,
                             bytes=len(nat), native_s=secs["native"],
                             python_s=secs["python"])
        print(f"[native] write_posterior_trace {label}: {rows} rows x "
              f"{TRACE_SHAPE[-1] + 1} values, {len(nat)} bytes, equal; "
              f"native {secs['native']:.3f} s, Python {secs['python']:.3f} s "
              f"({secs['python'] / secs['native']:.1f}x) on the host of "
              f"{card}", flush=True)
    sim = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sim[dev] = dv.simulate_frame(device=dev)
        sim[f"{dev}_s"] = time.perf_counter() - t0
    (tc, fc), (th, fh) = sim["cuda"], sim["cpu"]
    rel = float(np.max(np.abs(fc.astype(np.float64) - fh)
                       / np.maximum(np.abs(fh.astype(np.float64)), 1e-300)))
    if not (np.array_equal(tc, th) and fc.shape == (306, 44)
            and np.isfinite(fc).all() and rel <= DYN_RTOL):
        fail(f"simulate_frame: card vs host rel err {rel:.3e} (bar "
             f"{DYN_RTOL:.0e}), shape {fc.shape}")
    out = dict(from_csv_native_s=read["native"][1],
               from_csv_python_s=read["python"][1], traces=traces,
               simulate_rel=rel, simulate_card_s=sim["cuda_s"],
               simulate_host_s=sim["cpu_s"])
    print(f"[native] library {native.library_path()}: from_csv equal in "
          f"every bit (native {read['native'][1]:.3f} s, Python "
          f"{read['python'][1]:.3f} s); simulate_frame (306 days, float32 "
          f"dopri5@4) card {sim['cuda_s']:.2f} s, host {sim['cpu_s']:.2f} s, "
          f"rel err {rel:.3e} (bar {DYN_RTOL:.0e})", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def k1_bound(B, dtype_name, args, kw, n_obs):
    """K1's roofline for the kernel inputs ``args`` of ``B`` chains: every
    input read once and the (B,) log-likelihoods written once, against
    ``op_count`` at the non-tensor peak."""
    from mmidv1_tpu_torch.ops.sepaihrd_fused import op_count
    elem = 8 if dtype_name == "float64" else 4
    nbytes = sum(a.numel() for a in args[:6]) * elem + B * elem
    flops = B * op_count(kw["tableau"], kw["substeps"], int(sum(kw["run_count"])),
                         n_obs)
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b > t_o else "operations")


def kernel_bounds(B, dtype_name, args, kw, n_obs, ck):
    """K1's bound (``k1_bound``) and K2's / K3's (``adjoint_bounds``) for
    the kernel inputs ``args`` of ``B`` chains."""
    adj = adjoint_bounds(B, dtype_name, kw, n_obs, args, ck)
    return dict(k1=k1_bound(B, dtype_name, args, kw, n_obs), k2=adj["fwd"],
                k3=adj["bwd"])


def rematch_grad_case(cache):
    """K2 at mala_rematch's 2048 float32 chains, cash_karp@3, REFLECT,
    against its plain version (rtol 5e-6); K3 on the same call (regime 2 by
    the rule) with rows 0-511 against the plain version on those rows
    (per-chain 2-norm 1e-3); both timed (CUDA events) beside their bounds."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_adjoint_reference,
                                      fused_forward_ckpt,
                                      fused_forward_ckpt_reference)
    B, tab, sub = REMATCH_B, "cash_karp", 3
    case = f"float32 {tab}@{sub} B={B} REFLECT (mala_rematch)"
    _vg, args, kw, _th = spain_case(cache, "float32", REFLECT, tab, sub, B, 271)
    y0, agevec, scal, beff, obs, valid, M = args
    (ll, ck), k2_regime = regime_of("k2", lambda: fused_forward_ckpt(*args,
                                                                     **kw))
    ref2, k2_plain_ms = cuda_once(lambda: fused_forward_ckpt_reference(*args,
                                                                       **kw))
    k2_check = check_k2(case, (ll, ck), ref2, FWD_TOL["float32"])
    g = torch.ones_like(ll)
    k3_args = (agevec, scal, beff, obs, valid, ck, g, M)
    grads, k3_regime = regime_of("k3", lambda: fused_adjoint(*k3_args, **kw))
    if k3_regime != 2:
        fail(f"K3 at {B} float32 chains ran regime {k3_regime}, not 2")
    n = K3_PLAIN_ROWS
    cut = lambda t: t[..., :n].contiguous()
    ref3, k3_plain_ms = cuda_once(lambda: fused_adjoint_reference(
        cut(agevec), cut(scal), cut(beff), obs, valid, cut(ck), cut(g), M,
        **kw))
    k3_check = check_k3(f"{case} rows 0-{n - 1}, regime 2", tuple(
        cut(t) for t in grads), ref3, "float32", 1e-3)
    k2_ms = cuda_ms(lambda: fused_forward_ckpt(*args, **kw), 10)
    k3_ms = cuda_ms(lambda: fused_adjoint(*k3_args, **kw), 10)
    bounds = kernel_bounds(B, "float32", args, kw, obs.shape[0], ck)
    print(f"[mala_rematch] {case}: K2 {k2_ms:.3f} ms ({REGIMES[k2_regime]}; "
          f"bound {bounds['k2']['bound_ms']:.4f}, {bounds['k2']['bound_by']}; "
          f"plain {k2_plain_ms:.1f} ms), K3 {k3_ms:.3f} ms (regime 2; bound "
          f"{bounds['k3']['bound_ms']:.4f}, {bounds['k3']['bound_by']}; plain "
          f"on {n} rows {k3_plain_ms:.1f} ms)", flush=True)
    return dict(case=case, k2_regime=k2_regime, k3_regime=k3_regime,
                k2_ms=k2_ms, k3_ms=k3_ms, k2_plain_ms=k2_plain_ms,
                k3_plain_ms=k3_plain_ms, k3_plain_rows=n, k2_check=k2_check,
                k3_check=k3_check, k2_bound=bounds["k2"],
                k3_bound=bounds["k3"])


def rematch_phase(card, tmp, cache):
    """Phase 27: K1 / K2 / K3 held at mala_rematch's shapes, then its
    ``main`` at 2048 float32 chains, depth cut to ``REMATCH_STEPS`` steps
    and one fixed eps, every kernel counted from 0."""
    import math
    from mmidv1_tpu_torch.cli import mala_rematch
    t_phase = time.perf_counter()
    k1 = compare(f"float32 cash_karp@3 B={REMATCH_B} (mala_rematch AM-MH)",
                 REMATCH_B, "float32", "cash_karp", 3, FWD_TOL["float32"],
                 cache, seed=270)
    grad = rematch_grad_case(cache)
    out_json = os.path.join(tmp, "mala_rematch.json")
    secs, counts = drive_main(mala_rematch, [
        "--chains", str(REMATCH_B), "--steps", str(REMATCH_STEPS), "--burn",
        str(REMATCH_BURN), "--fixed-eps", "0.15", "--out", out_json],
        "mala_rematch")
    B, n = REMATCH_B, REMATCH_STEPS + 1
    reg = forward_pick(B)
    if counts["k1_batch_calls"] != {B: {reg: n}}:
        fail(f"mala_rematch: K1 launches {counts['k1_batch_calls']}, expected "
             f"{n} at B = {B} in the {REGIMES[reg]} regime")
    expect_gradients("mala_rematch", counts, B)
    if counts["k2"] != 2 * n or counts["k3_regime_calls"] != {1: 0, 2: 2 * n}:
        fail(f"mala_rematch: K2 / K3 launches {counts}, expected {2 * n} "
             f"each, K3 all in regime 2")
    with open(out_json) as f:
        rows = json.load(f)["rows"]
    for r in rows:
        if not all(math.isfinite(v) for k, v in r.items() if k != "sampler"):
            fail(f"mala_rematch: a non-finite number in {r}")
        print(f"[mala_rematch] {r['sampler']}: {r['steps_per_sec']:.4e} "
              f"chain-steps/s, acceptance {r['acceptance']:.3f}, min-ESS "
              f"{r['min_ess']:.1f} in {r['wall_s']:.2f} s ({B} float32 "
              f"chains x {REMATCH_STEPS} steps) on {card}", flush=True)
    out = dict(k1_compare=k1, grad=grad, seconds_main=secs, launches=counts,
               rows=rows, seconds=time.perf_counter() - t_phase)
    print(f"[mala_rematch] phase 27: {out['seconds']:.1f} s on {card}",
          flush=True)
    return out


def probe_host_refs(tmp):
    """The host's side of phase 28: the composed joint value_and_grad at the
    MAP nudged into each box, float64, into ``DIR/probe_host.npz``."""
    import numpy as np
    from mmidv1_tpu_torch.cli import _sero_probe as sp
    t0 = time.perf_counter()
    pl = sp.Pipeline(device="cpu")
    theta_map = pl.theta_from_txt(sp.MAP_TXT)
    ref = {}
    for variant in PROBE_BOXES:
        box = pl.box(variant)
        v, g = box.joint_vg(PROBE_SE, PROBE_TARGET)(
            sp.nudge(theta_map, box.lo, box.hi))
        ref[f"{variant}_value"], ref[f"{variant}_grad"] = np.array(v), g
    np.savez(os.path.join(tmp, "probe_host.npz"), **ref)
    return dict(seconds=time.perf_counter() - t0)


def box_kernels(box, th, plain):
    """K1, K2 and K3 at B = 1, float64, dopri5@4 on the kernel inputs of
    ``th`` on ``box`` (REFLECT against its bounds): their times (CUDA
    events, 10 launches), regimes and bounds; with ``plain`` their plain
    versions' times (one run each)."""
    import torch
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_adjoint_reference,
                                      fused_forward_ckpt,
                                      fused_forward_ckpt_reference,
                                      fused_objective)
    from mmidv1_tpu_torch.ops.sepaihrd_fused import fused_objective_reference
    t = torch.as_tensor(th[None], dtype=torch.float64, device="cuda")
    args, kw, _inf = box.k1.prep.kernel_args(t)
    kw = dict(kw, substeps=4, tableau="dopri5")
    y0, agevec, scal, beff, obs, valid, M = args
    ll, ck = fused_forward_ckpt(*args, **kw)
    k3_args = (agevec, scal, beff, obs, valid, ck, torch.ones_like(ll), M)
    k1_ms, k1_regime = regime_of("k1", lambda: cuda_ms(
        lambda: fused_objective(*args, **kw), 10))
    k2_ms, k2_regime = regime_of("k2", lambda: cuda_ms(
        lambda: fused_forward_ckpt(*args, **kw), 10))
    k3_ms, k3_regime = regime_of("k3", lambda: cuda_ms(
        lambda: fused_adjoint(*k3_args, **kw), 10))
    out = dict(k1_ms=k1_ms, k1_regime=k1_regime,
               k2_ms=k2_ms, k2_regime=k2_regime,
               k3_ms=k3_ms, k3_regime=k3_regime,
               bounds=kernel_bounds(1, "float64", args, kw, obs.shape[0], ck))
    if plain:
        out["k1_plain_ms"] = cuda_once(
            lambda: fused_objective_reference(*args, **kw))[1]
        out["k2_plain_ms"] = cuda_once(
            lambda: fused_forward_ckpt_reference(*args, **kw))[1]
        out["k3_plain_ms"] = cuda_once(
            lambda: fused_adjoint_reference(*k3_args, **kw))[1]
    return out


def probe_anchors(got):
    """Each probe's fixed-point rows against the committed results/ files:
    ``[(label, value, anchor, bar or None for exact), ...]``."""
    def load(name):
        with open(os.path.join(HERE, "results", name)) as f:
            return json.load(f)
    rows = []
    pr, p = load("sero_probe.json"), got["sero_profile_probe"]
    for tag in ("committed MAP", "reference initial_guess"):
        rows += [(f"profile {tag} LL", p[tag]["ll"], pr[tag]["ll"], 1e-10),
                 (f"profile {tag} sero", p[tag]["sero_day64"],
                  pr[tag]["sero_day64"], 1e-9)]
    rr, r = load("sero_ridge.json"), got["sero_ridge_scan"]
    for a, b in zip(r["ridge"], rr["ridge"]):
        k = b["k"]
        rows += [(f"ridge k={k} k", a["k"], k, None),
                 (f"ridge k={k} LL", a["ll"], b["ll"], 1e-10),
                 (f"ridge k={k} sero", a["sero_day64"], b["sero_day64"], 1e-9),
                 (f"ridge k={k} clipped", a["clipped"], b["clipped"], None)]
    if len(r["ridge"]) != len(rr["ridge"]):
        fail(f"sero_ridge_scan: {len(r['ridge'])} ridge rows, the committed "
             f"file {len(rr['ridge'])}")
    sr, s = load("sero_sensitivity.json")["map"], got["sero_sensitivity"]["map"]
    rows += [("sensitivity MAP LL", s["ll"], sr["ll"], 1e-10),
             ("sensitivity MAP sero", s["sero_day64"], sr["sero_day64"], 1e-9),
             ("sensitivity grad_seed_exposed", s["grad_seed_exposed"],
              sr["grad_seed_exposed"], 1e-8),
             ("sensitivity grad_runup_days", s["grad_runup_days"], 0.0, None)]
    fr, fp = load("sero_force_profile.json"), got["sero_force_profile"]
    for v in ("B", "C"):
        a, b = fp[f"variant_{v}"]["path"][0], fr[f"variant_{v}"]["path"][0]
        rows += [(f"force {v} path[0] LL", a["ll"], b["ll"], 1e-10),
                 (f"force {v} path[0] sero", a["sero_day64"], b["sero_day64"],
                  1e-9)]
    return rows


def probe_mains(card, tmp):
    """The four probes' mains at full width, depth cut (``PROBE_MAINS``),
    each counted from 0: K1 at B = 1 in the regime the rule picks, K2 at B =
    1 with one K3 call each, K3 in regime 1. ``(JSON outputs, runs)``."""
    from mmidv1_tpu_torch.cli import (sero_force_profile, sero_profile_probe,
                                      sero_ridge_scan, sero_sensitivity)
    mods = dict(sero_profile_probe=sero_profile_probe,
                sero_ridge_scan=sero_ridge_scan,
                sero_sensitivity=sero_sensitivity,
                sero_force_profile=sero_force_profile)
    got, runs = {}, {}
    reg = forward_pick(1)
    for name, argv in PROBE_MAINS.items():
        path = os.path.join(tmp, f"{name}.json")
        secs, counts = drive_main(mods[name], argv + ["--out", path], name)
        with open(path) as f:
            got[name] = json.load(f)
        if counts["k1"] < 1 or counts["k1_batch_calls"] != {
                1: {reg: counts["k1"]}}:
            fail(f"{name}: K1 launches {counts['k1_batch_calls']}, expected "
                 f"all at B = 1 in the {REGIMES[reg]} regime")
        expect_gradients(name, counts, 1)
        if counts["k3_regime_calls"] != {1: counts["k3"], 2: 0}:
            fail(f"{name}: K3 by regime {counts['k3_regime_calls']}, "
                 f"expected all in regime 1")
        runs[name] = dict(seconds=secs, launches=counts)
    return got, runs


def probe_phase(card, tmp, host, plain):
    """Phase 28: on each box the composed joint value_and_grad at the MAP,
    card against host (rtol 1e-9, floored), K1 / K2 / K3 at B = 1 float64
    timed and the sero term's seconds; then the four probes' mains, each
    counted from 0, their fixed-point rows against the committed anchors."""
    import numpy as np
    from mmidv1_tpu_torch.cli import _sero_probe as sp
    t_phase = time.perf_counter()
    pl = sp.Pipeline(device="cuda")
    theta_map = pl.theta_from_txt(sp.MAP_TXT)
    boxes = {}
    split = SeroSplit().__enter__()
    try:
        for variant in PROBE_BOXES:
            box = pl.box(variant)
            th = sp.nudge(theta_map, box.lo, box.hi)
            v, g = box.joint_vg(PROBE_SE, PROBE_TARGET)(th)
            boxes[variant] = dict(value=v, grad=g, **box_kernels(
                box, th, plain and variant == "C"),
                stream_ms=split.stream_ms[-1], sero_s=split.sero_ms[-1] / 1e3)
        got, runs = probe_mains(card, tmp)
    finally:
        split.__exit__()
    host.result()
    h = np.load(os.path.join(tmp, "probe_host.npz"))
    for variant, b in boxes.items():
        hv, hg = float(h[f"{variant}_value"]), h[f"{variant}_grad"]
        b["rel_value"] = abs(b["value"] - hv) / abs(hv)
        b["rel_grad"] = rel_floor(b["grad"], hg)
        k = b["bounds"]
        print(f"[probes] box {variant}: composed value_and_grad card vs host "
              f"value {b['rel_value']:.3e}, gradient {b['rel_grad']:.3e} (bar "
              f"1e-9); B=1 float64: K1 {b['k1_ms']:.3f} ms (bound "
              f"{k['k1']['bound_ms']:.5f}), K2 {b['k2_ms']:.3f} ms (bound "
              f"{k['k2']['bound_ms']:.5f}), K3 {b['k3_ms']:.3f} ms in regime "
              f"{b['k3_regime']} (bound {k['k3']['bound_ms']:.5f}); one "
              f"composed call: K2 + K3 {b['stream_ms']:.1f} ms, the sero term "
              f"{b['sero_s']:.2f} s on {card}",
              flush=True)
        if not (b["rel_value"] <= 1e-9 and b["rel_grad"] <= 1e-9):
            fail(f"probes: the composed gradient on box {variant} differs "
                 f"card vs host")
        b["grad"] = None
    anchors = []
    for label, value, anchor, bar in probe_anchors(got):
        if bar is None:
            ok, err = value == anchor, None
        else:
            err = abs(value - anchor) / abs(anchor)
            ok = err <= bar
        anchors.append(dict(label=label, value=value, anchor=anchor,
                            rel_err=err, bar=bar))
        if not ok:
            fail(f"probes: {label} {value!r} vs the committed {anchor!r}"
                 + (f" (rel {err:.3e} > {bar:.0e})" if bar else ""))
    worst = max((a["rel_err"] / a["bar"], a["label"]) for a in anchors
                if a["bar"])
    print(f"[probes] {len(anchors)} anchors of results/sero_*.json held "
          f"(worst {worst[1]}: {worst[0]:.3g} of its bar); "
          + ", ".join(f"{k} {v['seconds']:.1f} s (K1 {v['launches']['k1']}, "
                      f"K2 / K3 {v['launches']['k2']})" for k, v in
                      runs.items()) + f" on {card}", flush=True)
    out = dict(boxes=boxes, runs=runs, anchors=anchors,
               sero_calls=len(split.sero_ms),
               sero_s_median=float(np.median(split.sero_ms)) / 1e3,
               stream_ms_median=float(np.median(split.stream_ms)),
               seconds=time.perf_counter() - t_phase)
    print(f"[probes] {out['sero_calls']} composed value_and_grad calls: K2 + "
          f"K3 {out['stream_ms_median']:.1f} ms, the sero term "
          f"{out['sero_s_median']:.2f} s a call (medians) on {card}",
          flush=True)
    print(f"[probes] phase 28: {out['seconds']:.1f} s on {card}", flush=True)
    return out


def probe_phases(card, tmp, host, cache, plain=False):
    """Phases 26-28 in ``HostSide``'s directory ``tmp``."""
    t0 = time.perf_counter()
    out = dict(native=native_phase(card, tmp),
               rematch=rematch_phase(card, tmp, cache),
               probes=probe_phase(card, tmp, host, plain))
    out["seconds"] = time.perf_counter() - t0
    print(f"[probes] phases 26-28: {out['seconds']:.1f} s on {card}",
          flush=True)
    return out


def probe_paths(probes):
    """Every kernel's launches on phases 27-28, by path."""
    paths = {f"mala_rematch B={REMATCH_B}": probes["rematch"]["launches"]}
    paths.update({f"{k} B=1": v["launches"]
                  for k, v in probes["probes"]["runs"].items()})
    return paths


# ------------------------------------------------------------------ phase 29
# The whole-run recovery tests on the real model through the kernels: R1
# (tests/test_sepaihrd_recovery.py, psomcmc) through K1 and R3
# (tests/test_gradients.py, NUTS) through K2 + K3, float64, with the JAX
# tests' settings and bars (tests/torch_recovery.py). The same runs on the
# host (tests/test_torch_sepaihrd_recovery.py, tests/test_torch_gradients.py,
# torch's CPU generator) gave these values; the card's generator draws other
# numbers, so they are printed beside the card's, not compared.
HOST_R1 = dict(best=[0.549920, 0.300878, 79.8490], median_beta_1=0.550508)
HOST_R3 = dict(best_logp=-266.808)


def recovery_kernels(case, engine, thetas, grad):
    """The kernels of one recovery run at its shape, float64 dopri5@2, on
    the inputs of ``thetas``: K1 (or K2 and K3 with ``grad``) held against
    the plain version (phases 3, 6, 7's bars) and timed (CUDA events, 10
    launches; the plain version one run) beside the roofline and the
    forward's chain bound (dependent stages x cycles a stage / the SM clock
    read under load here)."""
    import numpy as np
    import torch
    import torch_recovery as rec
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_adjoint_reference,
                                      fused_forward_ckpt,
                                      fused_forward_ckpt_reference,
                                      fused_objective)
    from mmidv1_tpu_torch.ops import sepaihrd_fused as sf
    B = thetas.shape[0]
    args, kw, _inf = engine.prep.kernel_args(thetas)
    kw = dict(kw, substeps=rec.SUBSTEPS, tableau="dopri5")
    n_obs = args[4].shape[0]
    clock, _top = sm_clock_mhz(lambda: fused_objective(*args, **kw))
    chain = chain_bound_ms("dopri5", rec.SUBSTEPS, int(sum(kw["run_count"])),
                           8, clock)
    if not grad:
        got, regime = regime_of("k1", lambda: fused_objective(*args, **kw))
        got = got.double().cpu().numpy()
        ref, plain_ms = cuda_once(
            lambda: sf.fused_objective_reference(*args, **kw))
        ref = ref.double().cpu().numpy()
        abs_err = np.abs(got - ref)
        rel = float((abs_err / np.abs(ref)).max())
        if not (np.isfinite(got).all() and rel <= FWD_TOL["float64"]):
            fail(f"K1 {case}: max rel err {rel:.3e} vs plain (bar "
                 f"{FWD_TOL['float64']:.0e})")
        print(f"[K1] {case}: max rel err {rel:.3e} (tol "
              f"{FWD_TOL['float64']:.0e})", flush=True)
        bound = k1_bound(B, "float64", args, kw, n_obs)
        out = {"k1": dict(case=case, regime=regime, max_rel_err=rel,
                          max_abs_err=float(abs_err.max()),
                          ms=cuda_ms(lambda: fused_objective(*args, **kw), 10),
                          plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                          bound_by=bound["bound_by"], chain_bound_ms=chain,
                          sm_clock_mhz=clock)}
    else:
        (ll, ck), k2_regime = regime_of("k2", lambda: fused_forward_ckpt(
            *args, **kw))
        ref2, k2_plain_ms = cuda_once(
            lambda: fused_forward_ckpt_reference(*args, **kw))
        k2_check = check_k2(case, (ll, ck), ref2, FWD_TOL["float64"])
        _y0, agevec, scal, beff, obs, valid, M = args
        k3_args = (agevec, scal, beff, obs, valid, ck, torch.ones_like(ll), M)
        grads, k3_regime = regime_of("k3", lambda: fused_adjoint(*k3_args,
                                                                 **kw))
        ref3, k3_plain_ms = cuda_once(
            lambda: fused_adjoint_reference(*k3_args, **kw))
        k3_check = check_k3(case, grads, ref3, "float64", 1e-9)
        bounds = kernel_bounds(B, "float64", args, kw, n_obs, ck)
        out = {"k2": dict(k2_check, regime=k2_regime, plain_ms=k2_plain_ms,
                          ms=cuda_ms(lambda: fused_forward_ckpt(*args, **kw),
                                     10),
                          bound_ms=bounds["k2"]["bound_ms"],
                          bound_by=bounds["k2"]["bound_by"],
                          chain_bound_ms=chain, sm_clock_mhz=clock),
               "k3": dict(k3_check, regime=k3_regime, plain_ms=k3_plain_ms,
                          ms=cuda_ms(lambda: fused_adjoint(*k3_args, **kw),
                                     10),
                          bound_ms=bounds["k3"]["bound_ms"],
                          bound_by=bounds["k3"]["bound_by"])}
    for k, c in out.items():
        print(f"[recovery] {k.upper()} {case}: {c['ms']:.3f} ms (regime "
              f"{c['regime']}), plain {c['plain_ms']:.1f} ms, bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']})"
              + (f", chain {c['chain_bound_ms']:.4f} ms at {clock:.0f} MHz"
                 if "chain_bound_ms" in c else ""), flush=True)
    return out


def recovery_phase(card):
    """Phase 29: R1 through K1 and R3 through K2 + K3 on the card."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_recovery as rec
    from mmidv1_tpu_torch.calibration import CLAMP, REFLECT
    from mmidv1_tpu_torch.ops import (build_objective_fused,
                                      build_objective_fused_grad)
    t_phase = time.perf_counter()
    f64 = torch.float64

    # R1: psomcmc through K1, float64 dopri5@2; the data made on the host
    p = rec.r1_problem(device="cuda", dtype=f64)
    ll_c, ll_r = (build_objective_fused(p["space"], p["params"], p["data"],
                                        p["ts"], substeps=rec.SUBSTEPS,
                                        tableau="dopri5", constraint_mode=m,
                                        dtype=f64, device="cuda")
                  for m in (CLAMP, REFLECT))
    S, B = rec.R1_PSO.swarm_size, rec.R1_CHAINS
    zero_counts()
    res = rec.r1_calibrate(ll_c, ll_r, p, torch.Generator(
        device="cuda").manual_seed(rec.R1_CALIBRATION_SEED))
    best = res.best_theta.cpu().numpy()
    best_logl = float(res.best_logl)
    r1_counts = path_counts("recovery R1", "k1", "k1_regime_calls",
                            "k1_batch_calls")
    ll_true = float(ll_c(p["theta_true"][None])[0])
    samples = res.samples.cpu().numpy()
    median = float(np.median(samples[-100:].reshape(-1, 3)[:, 0]))
    steps_per_s = B * rec.R1_MH.iterations / res.phase2_seconds
    by_batch = r1_counts["k1_batch_calls"]
    # PSO: the opposition start (2 calls) + one a step, + one a restart;
    # AM-MH: the start + one a step
    mh_calls = 1 + rec.R1_MH.iterations
    min_pso = 2 + rec.R1_PSO.iterations
    pso_calls = sum(by_batch.get(S, {}).values())
    ok_regimes = set(by_batch) == {S, B} and all(
        set(by_batch[b]) == {forward_pick(b)} for b in by_batch)
    print(f"[recovery] R1 psomcmc through K1 (float64 dopri5@{rec.SUBSTEPS}, "
          f"{rec.R1_DAYS} days): best (beta_1, theta, seed_exposed) = "
          f"{best.tolist()} (host test: {HOST_R1['best']}; truth "
          f"{list(rec.R1_TRUE.values())}), best logL {best_logl!r} vs "
          f"logL(truth) {ll_true!r}, posterior median beta_1 {median:.4f} "
          f"(host: {HOST_R1['median_beta_1']}); phase 1 "
          f"{res.phase1_seconds:.2f} s, phase 2 {res.phase2_seconds:.2f} s, "
          f"AM-MH {steps_per_s:.4e} chain-steps/s; K1 by chain count and "
          f"regime {by_batch} on {card}", flush=True)
    if not ok_regimes or sum(by_batch[B].values()) != mh_calls or \
            pso_calls < min_pso:
        fail(f"R1: K1 ran {by_batch}, expected {mh_calls} calls at {B} and "
             f">= {min_pso} at {S}, each in the regime the "
             f"rule picks ({REGIMES[forward_pick(S)]} / "
             f"{REGIMES[forward_pick(B)]})")
    missed = rec.r1_missed(best, best_logl, ll_true, samples)
    if missed:
        fail(f"R1 on the card missed its bars: {missed}")
    r1 = dict(best=best.tolist(), best_logl=best_logl, ll_true=ll_true,
              median_beta_1=median, phase1_seconds=res.phase1_seconds,
              phase2_seconds=res.phase2_seconds,
              chain_steps_per_s=steps_per_s, launches=r1_counts,
              host=HOST_R1,
              kernels=recovery_kernels(
                  f"float64 dopri5@{rec.SUBSTEPS} B={B} REFLECT (R1 AM-MH, "
                  f"{rec.R1_DAYS} days)", ll_r, res.samples[-1], grad=False))

    # R3: NUTS through K2 + K3, float64 dopri5@2, CLAMP
    q = rec.r3_problem(device="cuda", dtype=f64)
    vg = build_objective_fused_grad(q["space"], q["params"], q["data"],
                                    q["ts"], substeps=rec.SUBSTEPS,
                                    tableau="dopri5", constraint_mode=CLAMP,
                                    dtype=f64, device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    nres = rec.r3_nuts(None, q, value_and_grad_batch=vg)
    best_logp = float(nres.best_logp)
    seconds = time.perf_counter() - t0
    r3_counts = path_counts("recovery R3", "k1", "k2", "k2_regime_calls",
                            "k2_batch_calls", "k3", "k3_kernels",
                            "k3_regime_calls")
    calls = vg.calls
    ll0 = float(vg.value_batch(q["theta0"][None])[0])
    nb, cfg = rec.R3_CHAINS, rec.R3_NUTS
    rate = nb * calls / seconds
    print(f"[recovery] R3 NUTS through K2 + K3 (float64 dopri5@{rec.SUBSTEPS}, "
          f"{rec.R3_DAYS} days, {nb} chains, {cfg.iterations} iterations of "
          f"depth {cfg.max_tree_depth}): best logp {best_logp!r} vs "
          f"logL(theta0) {ll0!r} (host test: {HOST_R3['best_logp']}); "
          f"{calls} value_and_grad calls in {seconds:.2f} s, {rate:.4e} "
          f"grad-evals/s; K2 {r3_counts['k2_batch_calls']}, K3 "
          f"{r3_counts['k3']} calls by regime {r3_counts['k3_regime_calls']}, "
          f"{r3_counts['k3_kernels']} kernels on {card}", flush=True)
    split = forward_pick(nb)
    if r3_counts["k1"] or calls < 1 or r3_counts["k2"] != calls or \
            r3_counts["k3"] != calls or \
            r3_counts["k2_batch_calls"] != {nb: {split: calls}} or \
            r3_counts["k3_regime_calls"] != {1: calls, 2: 0}:
        fail(f"R3: {calls} value_and_grad calls launched {r3_counts}; "
             f"expected K2 and K3 once each a call at {nb} chains, K2 "
             f"{REGIMES[split]}, K3 in regime 1, K1 never")
    missed = rec.r3_missed(best_logp, nres.samples.cpu().numpy(),
                           q["space"].lower.cpu().numpy(),
                           q["space"].upper.cpu().numpy(), ll0)
    if missed:
        fail(f"R3 on the card missed its bars: {missed}")
    r3 = dict(best_logp=best_logp, ll_theta0=ll0, calls=calls,
              seconds=seconds, grad_evals_per_s=rate, launches=r3_counts,
              host=HOST_R3,
              kernels=recovery_kernels(
                  f"float64 dopri5@{rec.SUBSTEPS} B={nb} CLAMP (R3 NUTS, "
                  f"{rec.R3_DAYS} days)", vg.value_batch, nres.samples[-1],
                  grad=True))
    out = dict(r1=r1, r3=r3, seconds=time.perf_counter() - t_phase)
    print(f"[recovery] phase 29: {out['seconds']:.1f} s on {card}",
          flush=True)
    return out


# ------------------------------------------------------------------ phase 30
# Every kernel is built once per tableau, its zero pattern compiled in
# (csrc/sepaihrd_common.cuh): a zero coefficient emits no instruction, as
# the Pallas kernel and the plain version skip it. Phase 30 holds every
# instantiation against the plain version, also at the stiff input of
# tests/torch_stiff.py, reads the SASS for compares on a coefficient and
# counts the stage-axpy FMAs, and times K1 / K2 / K3 at PERF.md's shapes.
PHASE30_TABLEAUS = ("rk4", "cash_karp", "rkf45", "dopri5", "fehlberg78")
PHASE30_DAYS = 10        # 30 intervals with the run-up: 2 chunks, one ragged
PHASE30_B = 5
# one substep a day, two for dopri5, whose FSAL carries a stage inside a day
PHASE30_SUBSTEPS = {"dopri5": 2}
# tests/test_torch_kernels.py's bars at small sizes: LL and checkpoints
# (rtol, checkpoints floored at the row's largest entry), gradients (f64
# rtol floored at the chain's largest entry; f32 per-chain 2-norm)
SMALL_TOL = {"float64": 1e-10, "float32": 2e-5}
GRAD_TOL = {"float64": 1e-9, "float32": 1e-3}
# PERF.md's table shapes: (kernels, B, dtype, tableau, substeps, mode,
# observed days; None: the full grid of 325 intervals)
TABLE_SHAPES = (
    ("K1", 1024, "float32", "dopri5", 4, "reflect", None),
    ("K1", 512, "float32", "dopri5", 4, "reflect", None),
    ("K1", 4096, "float32", "dopri5", 4, "reflect", None),
    ("K1", 8192, "float32", "dopri5", 4, "reflect", None),
    ("K1", 8192, "float64", "dopri5", 4, "reflect", None),
    ("K1", 1, "float32", "dopri5", 4, "reflect", None),
    ("K1", 10, "float32", "dopri5", 4, "reflect", None),
    ("K1", 12, "float32", "dopri5", 4, "reflect", None),
    ("K1", 40, "float32", "dopri5", 4, "reflect", None),
    ("K1", 257, "float64", "dopri5", 4, "reflect", None),
    ("K1", 2048, "float32", "cash_karp", 3, "reflect", None),
    ("K1", 1, "float64", "dopri5", 4, "reflect", None),
    ("K1", 32, "float64", "dopri5", 2, "reflect", 60),
    ("K2K3", 64, "float32", "dopri5", 4, "clamp", None),
    ("K2K3", 64, "float64", "dopri5", 4, "clamp", None),
    ("K2K3", 8192, "float32", "dopri5", 4, "clamp", None),
    ("K2K3", 8192, "float64", "dopri5", 4, "clamp", None),
    ("K2K3", 2048, "float32", "cash_karp", 3, "reflect", None),
    ("K2K3", 1, "float64", "dopri5", 4, "reflect", None),
    ("K2K3", 4, "float64", "dopri5", 2, "clamp", 30),
)


def _rel(got, ref):
    """The largest |got - ref| / |ref|; inf where a value is not finite."""
    import numpy as np
    a, b = got.double().cpu().numpy(), ref.double().cpu().numpy()
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float((np.abs(a - b) / np.abs(b)).max())


def _rel_ckpt(got, ref):
    """Checkpoints against the plain version's: per compartment row, with a
    floor of the row's largest magnitude; inf where a value is not
    finite."""
    import numpy as np
    a, b = got.double().cpu().numpy(), ref.double().cpu().numpy()
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    scale = np.abs(b).max(axis=(0, 2, 3), keepdims=True)
    return float((np.abs(a - b) / np.maximum(np.abs(b) + scale, 1e-300)).max())


def _grad_err(got, ref, dtype_name):
    """K3's four outputs against its plain version's, every chain: f64 the
    largest |diff| / (|ref| + max|ref| of the chain), f32 the largest
    per-chain relative 2-norm; inf where a value is not finite."""
    import numpy as np
    err = 0.0
    for a, b in zip(got, ref):
        B = a.shape[-1]
        a = a.double().cpu().numpy().reshape(-1, B)
        b = b.double().cpu().numpy().reshape(-1, B)
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            return float("inf")
        if dtype_name == "float64":
            e = np.abs(a - b) / (np.abs(b) + np.abs(b).max(axis=0) + 1e-300)
        else:
            e = np.linalg.norm(a - b, axis=0) / (np.linalg.norm(b, axis=0) + 1e-300)
        err = max(err, float(e.max()))
    return err


def hold_all(case, dtype_name, args, kw):
    """K1 and K2 forced into each regime, and K3 in the regime its rule
    picks (counted) and in the other (forced), against their plain versions
    on one set of kernel inputs: ``{case, errors, failed, k3_picked}``."""
    import torch
    from mmidv1_tpu_torch.ops import (fused_adjoint, fused_adjoint_reference,
                                      fused_forward_ckpt,
                                      fused_forward_ckpt_reference,
                                      fused_objective)
    _y0, agevec, scal, beff, obs, valid, M = args
    ll_ref, ck_ref = fused_forward_ckpt_reference(*args, **kw)
    g = torch.ones_like(ll_ref)
    want = fused_adjoint_reference(agevec, scal, beff, obs, valid, ck_ref, g,
                                   M, **kw)
    err = {}
    for regime, name in REGIMES.items():
        ll1 = fused_objective(*args, **kw, regime=regime)
        ll2, ck = fused_forward_ckpt(*args, **kw, regime=regime)
        err[f"K1 {name}"] = _rel(ll1, ll_ref)
        err[f"K2 {name}"] = max(_rel(ll2, ll_ref), _rel_ckpt(ck, ck_ref))
    got, picked = regime_of("k3", lambda: fused_adjoint(
        agevec, scal, beff, obs, valid, ck_ref, g, M, **kw))
    other, _n = k3_forced(3 - picked, agevec, scal, beff, obs, valid, ck_ref,
                          g, M, kw)
    torch.cuda.synchronize()
    err[f"K3 regime {picked}"] = _grad_err(got, want, dtype_name)
    err[f"K3 regime {3 - picked}"] = _grad_err(other, want, dtype_name)
    failed = [k for k, e in err.items() if not e <= (
        GRAD_TOL if k.startswith("K3") else SMALL_TOL)[dtype_name]]
    print(f"[tableaus] {case}: " + ", ".join(f"{k} {e:.2e}" for k, e in
                                             err.items())
          + (f"; ABOVE THE BAR: {failed}" if failed else ""), flush=True)
    return dict(case=case, errors=err, failed=failed, k3_picked=picked)


def stiff_check(dtype_name):
    """``hold_all`` at the stiff input (tests/torch_stiff.py), and the
    objective there, which must be finite: a kernel that multiplied by a
    zero coefficient would give NaN and the objective ``finfo.min``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_stiff as stiff

    dtype = getattr(torch, dtype_name)
    ll, thetas = stiff.stiff_objective(dtype, "cuda")
    args, kw, _inf = ll.prep.kernel_args(thetas)
    kw = dict(kw, substeps=stiff.SUBSTEPS, tableau=stiff.TABLEAU)
    out = hold_all(f"{dtype_name} stiff input ({stiff.TABLEAU}@"
                   f"{stiff.SUBSTEPS}, gamma_ICU {stiff.STIFF_RATE[dtype_name]:g})",
                   dtype_name, args, kw)
    obj = ll(thetas).double().cpu().numpy()
    out["objective"] = obj.tolist()
    out["objective_finfo_min"] = int((obj == torch.finfo(dtype).min).sum())
    if out["objective_finfo_min"] or not np.isfinite(obj).all():
        out["failed"].append("objective")
    print(f"[tableaus] {dtype_name} stiff input: the objective through K1 "
          f"gives {obj.tolist()} ({out['objective_finfo_min']} of "
          f"{len(obj)} finfo.min)", flush=True)
    return out


def _sass_functions(lib_paths, out_dir):
    """``{(kernel, dtype, tableau): [(address, opcode, text)]}`` of every
    SEPAIHRD kernel in the libraries (cuobjdump; each library's SASS saved
    gzipped under ``out_dir``), or None without cuobjdump."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    import gzip
    out = {}
    for lib_path in lib_paths:
        text = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                              text=True, timeout=600, check=True).stdout
        os.makedirs(out_dir, exist_ok=True)
        name = os.path.basename(lib_path).split("_")[:-1]
        with gzip.open(os.path.join(out_dir, "_".join(name) + ".sass.gz"),
                       "wt") as f:
            f.write(text)
        for blk in re.split(r"\n\s*Function : ", text)[1:]:
            key = kernel_key(blk.split("\n", 1)[0].strip())
            if key is None:
                continue
            ins = []
            for ln in blk.splitlines():
                mm = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
                if mm:
                    body = mm.group(2)
                    if body.startswith("@"):
                        body = body.split(None, 1)[1]
                    ins.append((int(mm.group(1), 16), body.split()[0], body))
            out[key] = ins
    return out


# Where each kernel's tableau coefficients sit in constant bank 0: Consts<T>
# is every kernel's last parameter, after these bytes of pointers (8 each)
# and ints (4 each) (csrc/sepaihrd_forward.cuh, csrc/sepaihrd_adjoint.cu);
# kernel parameters start at 0x210 on sm_90. Consts starts with h*a (13 x
# 13) and h*b (13).
PARAM_BASE = 0x210
PARAMS_BEFORE_CONSTS = {"K1 wide": 84, "K1 split": 84, "K2 wide": 84,
                        "K2 split": 84, "K3 days": 64, "K3 stages": 64,
                        "K3 chunk": 108, "K3 sweep": 144}


def coefficient_at(kind, dtype_name, addr):
    """The tableau coefficient at byte ``addr`` of bank 0 in a kernel of
    ``kind``: ``("a", i, j)``, ``("b", i)`` or None."""
    if kind not in PARAMS_BEFORE_CONSTS:
        return None
    size = 8 if dtype_name == "float64" else 4
    before = PARAMS_BEFORE_CONSTS[kind]
    k = (addr - PARAM_BASE - (before + size - 1) // size * size) // size
    if 0 <= k < 169:
        return ("a", k // 13, k % 13)
    if 169 <= k < 182:
        return ("b", k - 169)
    return None


def coefficient_uses(kind, dtype_name, ins):
    """What one kernel does with its tableau coefficients, from its SASS:
    ``(read, compares, fmas)``: every coefficient some instruction reads
    from bank 0; the addresses of the float compares of a coefficient
    against zero (an FSETP / DSETP of RZ and a coefficient, read directly
    or through a register a move or a load filled with it); and, by
    coefficient, the FFMA / DFMA that take one as a multiplicand. The
    registers are followed in the order of the code, not of its branches,
    so the FMA counts are a reading, not a check."""
    import re
    const = re.compile(r"c\[0x0\]\[(0x[0-9a-f]+)\]")
    reg = re.compile(r"\b(U?R\d+)\b")
    held, read, compares, fmas = {}, set(), [], {}

    def coef_of(operand):
        m = const.search(operand)
        if m:
            return coefficient_at(kind, dtype_name, int(m.group(1), 16))
        return next((held[r] for r in reg.findall(operand) if r in held), None)

    for addr, op, body in ins:
        parts = body.split(None, 1)
        operands = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
        srcs = operands[1:]
        # a 64- or 128-bit load of float32 values reads two or four
        words = 4 if ".128" in op else 2 if ".64" in op else 1
        for m in const.finditer(body):
            for w in range(words if dtype_name == "float32" else 1):
                c = coefficient_at(kind, dtype_name, int(m.group(1), 16) + 4 * w)
                if c:
                    read.add(c)
        base = op.split(".")[0]
        if base in ("FSETP", "DSETP") and "RZ" in srcs and \
                any(coef_of(o) for o in srcs):
            compares.append(addr)
        if base in ("FFMA", "DFMA"):
            c = next((coef_of(o) for o in srcs[:2] if coef_of(o)), None)
            if c:
                fmas[c] = fmas.get(c, 0) + 1
        dest = reg.match(operands[0]) if operands else None
        if dest:
            moved = base in ("MOV", "UMOV", "LDC", "ULDC", "R2UR") or \
                op.startswith(("IMAD.MOV", "IMAD.U32"))
            c = next((coef_of(o) for o in srcs if coef_of(o)), None) \
                if moved else None
            r = dest.group(1)
            regs = [r]
            if ".64" in op or base.startswith("D"):
                regs.append(re.sub(r"\d+$", lambda x: str(int(x.group()) + 1), r))
            for x in regs:
                if c:
                    held[x] = c
                else:
                    held.pop(x, None)
    return read, compares, fmas


def expected_coefficients(kind, tableau):
    """The coefficients a kernel of ``kind`` must read, and no other: the
    non-zero ``a`` of the stages it evaluates (the forward kernels and K3's
    days: live or FSAL-carried; K3's other stages: live) and, but for K3's
    stages kernel, every non-zero ``b``."""
    from mmidv1_tpu_torch.ode.tableaus import get_tableau
    from mmidv1_tpu_torch.ops.sepaihrd_fused import stage_use
    tab = get_tableau(tableau)
    _feeds, live, evaluated = stage_use(tableau)
    stages = evaluated if kind.split()[0] in ("K1", "K2") or \
        kind == "K3 days" else live
    want = {("a", i, j) for i in range(tab.stages) if stages[i]
            for j in range(i) if float(tab.a[i, j]) != 0.0}
    if kind != "K3 stages":
        want |= {("b", i) for i in range(tab.stages) if float(tab.b[i]) != 0.0}
    return want


def sass_tableaus(lib_paths, out_dir):
    """Phase 30's SASS check of every SEPAIHRD kernel: no float compare of
    a tableau coefficient against zero, and the coefficients it reads from
    the parameter bank are exactly the non-zero ones of the stages it runs
    (a zero coefficient is never loaded, so no instruction can use it).
    Beside them, the coefficient FMAs a forward substep implies (rows the
    right-hand side reads x non-zero stage coefficients + rows x non-zero
    update coefficients: 7 and 10 a substep over the split regime's two
    warps as in the wide one) and those read from the SASS.
    ``({kernel: counts}, [misses])``; ``(None, [])`` without cuobjdump."""
    import numpy as np
    from mmidv1_tpu_torch.ode.tableaus import get_tableau
    funcs = _sass_functions(lib_paths, out_dir)
    if funcs is None:
        print("[sass-tableaus] no cuobjdump in the toolkit: not checked",
              flush=True)
        return None, []
    out, misses = {}, []
    for (kind, dtype_name, tableau), ins in sorted(funcs.items(),
                                                   key=lambda kv: str(kv[0])):
        name = " ".join(x for x in (kind, dtype_name, tableau) if x)
        read, compares, fmas = coefficient_uses(kind, dtype_name, ins)
        row = dict(instructions=len(ins), coefficient_compares=len(compares),
                   coefficients_read=len(read),
                   coefficient_fmas=sum(fmas.values()))
        if compares:
            misses.append(f"{name}: {len(compares)} compares of a "
                          f"coefficient against zero")
        if tableau in PHASE30_TABLEAUS:
            tab = get_tableau(tableau)
            want = expected_coefficients(kind, tableau)
            zero = sorted(c for c in read - want if (
                float(tab.a[c[1], c[2]]) if c[0] == "a" else float(tab.b[c[1]])) == 0.0)
            row.update(zero_read=[list(c) for c in zero],
                       unused=[list(c) for c in sorted(read - want) if c not in zero],
                       missing=[list(c) for c in sorted(want - read)])
            if zero or row["missing"]:
                misses.append(f"{name}: reads zero coefficients {zero}, "
                              f"misses non-zero {row['missing']}")
            if kind.split()[0] in ("K1", "K2"):
                n_a = sum(1 for c in want if c[0] == "a")
                row["fmas_a_substep"] = 7 * n_a + 10 * int(np.count_nonzero(tab.b))
        out[name] = row
    with open(os.path.join(out_dir, "tableaus.json"), "w") as f:
        json.dump(out, f, indent=1)
    n_cmp = sum(r["coefficient_compares"] for r in out.values())
    n_zero = sum(len(r.get("zero_read", ())) for r in out.values())
    print(f"[sass-tableaus] {len(out)} kernels: {n_cmp} compares of a "
          f"coefficient against zero, {n_zero} zero coefficients read",
          flush=True)
    for name, r in out.items():
        print(f"[sass-tableaus]   {name}: {r['coefficient_compares']} "
              f"compares, {r['coefficients_read']} coefficients read "
              f"(zero: {r.get('zero_read', '-')}), {r['coefficient_fmas']} "
              f"coefficient FMAs (a substep: {r.get('fmas_a_substep', '-')})",
              flush=True)
    return out, misses


def table_timings(cache):
    """K1, and K2 + K3, at each of PERF.md's table shapes (CUDA events, 10
    launches after a warm-up; K3 in the regime its rule picks): ms, regime,
    roofline bound, the forward's chain bound over the same grid
    (``chain_bound_ms``) and the time a dependent stage, at the SM clock
    read under load."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import CLAMP, REFLECT
    from mmidv1_tpu_torch.ops import (fused_forward_ckpt, fused_objective,
                                      sepaihrd_adjoint as adj)
    from mmidv1_tpu_torch.ops import sepaihrd_fused as sf

    rows = []
    clock = None
    for kern, B, dtype_name, tableau, substeps, mode, days in TABLE_SHAPES:
        _vg, args, kw, _th = spain_case(
            cache, dtype_name, CLAMP if mode == "clamp" else REFLECT, tableau,
            substeps, B, 40 + B, num_days=days)
        if clock is None:
            clock, _top = sm_clock_mhz(lambda: fused_objective(*args, **kw))
        n_int = int(sum(kw["run_count"]))
        elem = 8 if dtype_name == "float64" else 4
        stages = sf.dependent_stages(tableau, substeps, n_int)
        shape = dict(B=B, dtype=dtype_name, tableau=tableau, substeps=substeps,
                     mode=mode, n_intervals=n_int, dependent_stages=stages,
                     chain_bound_ms=chain_bound_ms(tableau, substeps, n_int,
                                                   elem, clock),
                     sm_clock_mhz=clock)
        found = []
        if kern == "K1":
            ms, regime = regime_of("k1", lambda: cuda_ms(
                lambda: fused_objective(*args, **kw), reps=10))
            found.append(dict(shape, kernel="K1", ms=ms,
                              regime=REGIMES[regime],
                              **k1_bound(B, dtype_name, args, kw,
                                         args[4].shape[0])))
        else:
            _y0, agevec, scal, beff, obs, valid, M = args
            ll, ck = fused_forward_ckpt(*args, **kw)
            g = torch.ones_like(ll)
            bounds = adjoint_bounds(B, dtype_name, kw, args[4].shape[0], args, ck)
            ms, regime = regime_of("k2", lambda: cuda_ms(
                lambda: fused_forward_ckpt(*args, **kw), reps=10))
            found.append(dict(shape, kernel="K2", ms=ms,
                              regime=REGIMES[regime],
                              **bounds["fwd"]))
            run3 = lambda: adj._launch_adjoint(agevec, scal, beff, obs, valid,
                                               ck, g, M, **kw)
            _out, regime, n_kernels = run3()
            ms = cuda_ms(run3, reps=10)
            found.append(dict(shape, kernel="K3", ms=ms,
                              regime=f"regime {regime}, {n_kernels} kernels",
                              **{k: v for k, v in bounds["bwd"].items()
                                 if k != "design_bound_ms"}))
        for r in found:
            ns = r["ms"] * 1e6 / stages
            r.update(ns_per_stage=ns, cycles_per_stage=ns * clock / 1e3)
            print(f"[table] {r['kernel']} B={B} {dtype_name} {tableau}@"
                  f"{substeps} {mode.upper()} {n_int} intervals: {r['ms']:.4f} "
                  f"ms ({r['regime']}); bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}), chain {r['chain_bound_ms']:.4f} ms; "
                  f"{ns:.1f} ns = {r['cycles_per_stage']:.0f} cycles a "
                  f"dependent stage at {clock:.0f} MHz", flush=True)
            rows.append(r)
    return rows


def tableau_phase(cache, strict=True):
    """Phase 30. ``strict``: fail on any miss; else list the misses and
    return them too (``--tableaus``, for a run against another build)."""
    import torch
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import _build
    t_phase = time.perf_counter()
    zero_counts()
    cases = []
    for dtype_name in ("float64", "float32"):
        for i, tableau in enumerate(PHASE30_TABLEAUS):
            substeps = PHASE30_SUBSTEPS.get(tableau, 1)
            _vg, args, kw, _th = spain_case(
                cache, dtype_name, REFLECT, tableau, substeps, PHASE30_B,
                300 + i, num_days=PHASE30_DAYS)
            cases.append(hold_all(
                f"{dtype_name} {tableau}@{substeps} B={PHASE30_B} "
                f"{PHASE30_DAYS} days", dtype_name, args, kw))
    stiff = [stiff_check(d) for d in ("float64", "float32")]
    counts = dict(pick_counts("k1", "k1_regime_calls", "k2",
                              "k2_regime_calls", "k3", "k3_kernels",
                              "k3_regime_calls"),
                  k3_forced_calls=len(cases) + len(stiff))
    checks_s = time.perf_counter() - t_phase
    sass, sass_misses = sass_tableaus(
        [_build.library_path("sepaihrd_fused"),
         _build.library_path("sepaihrd_adjoint")],
        os.path.join(HERE, "chiprun_out", "sass"))
    table = table_timings(cache)
    torch.cuda.synchronize()
    misses = [f"{c['case']}: {k}" for c in cases + stiff for k in c["failed"]]
    misses += sass_misses
    out = dict(cases=cases, stiff=stiff, launches=counts, sass=sass,
               table=table, misses=misses, checks_seconds=checks_s,
               seconds=time.perf_counter() - t_phase)
    print(f"[tableaus] phase 30: {out['seconds']:.1f} s ({checks_s:.1f} s of "
          f"checks); launches {counts}; {len(misses)} misses", flush=True)
    for m in misses:
        print(f"[tableaus] MISS {m}", flush=True)
    if misses and strict:
        fail("phase 30: " + "; ".join(misses))
    return out


# ---------------------------------------------------------------- phase 2c
# The objective's prep and mask kernels (csrc/sepaihrd_prep.cu) at the
# shapes the paths give them: (case, B, objective dtype, space dtype, mode)
PREP_CASES = (
    ("float32 B=1024 REFLECT (AM-MH, am1024-dopri5x4)", 1024, "float32",
     "float32", "reflect"),
    ("float32 B=8192 REFLECT (campaigns, am8192-cashkarp3)", 8192, "float32",
     "float32", "reflect"),
    ("float32 B=512 CLAMP (PSO)", 512, "float32", "float32", "clamp"),
    ("float32 B=64 CLAMP (NUTS, MALA)", 64, "float32", "float32", "clamp"),
    ("float64 B=257 REFLECT, float32 space (MAP re-selection)", 257,
     "float64", "float32", "reflect"),
)


def graph_ms(fn, launches=20, reps=10):
    """The card's time a call of ``fn`` in ms: ``launches`` calls captured
    in one CUDA graph, replayed ``reps`` times after a warm-up (CUDA
    events), so that no launch waits on the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def prep_thetas(space, theta0, B, dtype, seed):
    """``B`` thetas at 0.05 sigma around ``theta0``; rows 1-4 past the
    upper bounds by 0.37 and 3.2 widths, past the lower bounds by 2.6 and
    on them; ``beta_6`` NaN on row B // 2 and the last row all NaN."""
    import numpy as np
    import torch
    lo, hi, sig, t0 = (np.asarray(t.double().cpu()) for t in (
        space.lower, space.upper, space.sigmas, theta0))
    rng = np.random.default_rng(seed)
    x = t0[None, :] + 0.05 * sig[None, :] * rng.standard_normal((B, t0.size))
    width = hi - lo
    for row, v in ((1, hi + 0.37 * width), (2, hi + 3.2 * width),
                   (3, lo - 2.6 * width), (4, lo)):
        if row < B - 1:
            x[row] = v
    x[B // 2, 5] = np.nan
    x[B - 1] = np.nan
    return torch.as_tensor(x, dtype=dtype, device="cuda")


def prep_phase(cache):
    """Phase 2c: the prep kernel against its plain version at each of
    ``PREP_CASES`` (every output equal to the bit, NaN and reflected or
    clamped rows included; one ``prep`` launch counted a call), the mask
    kernel against ``torch.where`` on NaN, +-Inf and infeasible rows, both
    timed (CUDA graphs of 20 launches; the prep on the rows but the NaN
    ones, B of them, and on all; the plain versions eager and graphed, the
    mask's ``torch.where`` as its library time) beside their byte bounds."""
    import numpy as np
    import torch
    from mmidv1_tpu_torch.calibration.objective import lowest
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.ops import sepaihrd_fused as sf
    from mmidv1_tpu_torch.utils import trace

    def same_bits(a, b):
        if a.dtype == torch.bool:
            return bool(torch.equal(a, b))
        view = torch.int64 if a.element_size() == 8 else torch.int32
        return a.shape == b.shape and bool(torch.equal(a.view(view),
                                                       b.view(view)))

    prep_rows, mask_rows = [], []
    for i, (case, B, dtype_name, space_dtype, mode) in enumerate(PREP_CASES):
        dtype = getattr(torch, dtype_name)
        if space_dtype not in cache:
            cache[space_dtype] = load_spain_pipeline(
                HERE, dtype=getattr(torch, space_dtype), device="cuda")
        pipe = cache[space_dtype]
        prep = sf.FusedPrep(pipe.space, pipe.params.to("cuda", dtype),
                            pipe.data, pipe.ts, constraint_mode=mode,
                            dtype=dtype, device=torch.device("cuda"))
        x = prep_thetas(pipe.space, pipe.theta0, B, dtype, seed=500 + i)
        zero_counts()
        got_args, got_inf = prep._prep_kernel(x)
        if trace.counts("launches", ("prep",)) != {(mode, B): 1}:
            fail(f"prep {case}: launches {trace.counts('launches')}")
        want_args, want_inf = prep._prep_plain(x)
        torch.cuda.synchronize()
        for name, a, b in zip(("y0", "agevec", "scal", "beff", "infeasible"),
                              got_args + (got_inf,), want_args + (want_inf,)):
            if not (a.is_contiguous() and same_bits(a, b)):
                fail(f"prep {case}: {name} differs from the plain version")
        nan_rows = torch.isnan(got_args[2]).any(dim=0).nonzero().flatten()
        if nan_rows.tolist() != [B - 1]:
            fail(f"prep {case}: NaN scal on rows {nan_rows.tolist()}, "
                 f"expected the NaN row {B - 1} alone")
        elem = x.element_size()
        R = got_args[3].shape[0]
        nbytes = (x.numel() + sum(a.numel() for a in got_args)) * elem \
            + prep.table.numel() * 8 + B
        # timed on the same rows without the NaN ones (no sampler proposes
        # one, and a NaN row takes several times as long), and with them
        finite = x[~torch.isnan(x).any(dim=1)][torch.arange(B) % (B - 2)]
        row = dict(case=case, B=B, dtype=dtype_name, space_dtype=space_dtype,
                   mode=mode, n_runs=R, bit_equal=True,
                   ms=graph_ms(lambda: prep._prep_kernel(finite)),
                   nan_rows_ms=graph_ms(lambda: prep._prep_kernel(x)),
                   plain_ms=cuda_ms(lambda: prep._prep_plain(x), reps=10),
                   plain_graph_ms=graph_ms(lambda: prep._prep_plain(x)),
                   bytes=nbytes, bound_ms=nbytes / PEAK_BYTES * 1e3,
                   bound_by="bytes")
        print(f"[prep] {case}: y0, agevec, scal, beff and infeasible equal "
              f"to the bit; kernel {row['ms'] * 1e3:.2f} us (graphed; "
              f"{row['nan_rows_ms'] * 1e3:.2f} with the NaN rows), "
              f"plain {row['plain_ms']:.3f} ms eager, "
              f"{row['plain_graph_ms'] * 1e3:.1f} us graphed; bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({nbytes} bytes)", flush=True)
        prep_rows.append(row)

        ll = torch.as_tensor(-1e5 * np.random.default_rng(i).random(B),
                             dtype=dtype, device="cuda")
        inf = got_inf.clone()
        inf[:: 7] = True
        for r, v in ((2, float("nan")), (3, float("inf")), (5, -float("inf"))):
            if r < B:
                ll[r] = v
                inf[r] = False
        zero_counts()
        got = sf.mask_values(ll, inf)
        if trace.counts("launches", ("mask",)) != {(B,): 1}:
            fail(f"mask {case}: launches {trace.counts('launches')}")
        want = sf._mask_where(ll, inf)
        floor = lowest(dtype)
        bad = inf | torch.isnan(ll) | torch.isinf(ll)
        if not same_bits(got, want) or not bool((got[bad] == floor).all()):
            fail(f"mask {case}: differs from torch.where")
        nbytes = B * (2 * elem + 1)
        mrow = dict(case=case, B=B, dtype=dtype_name, masked=int(bad.sum()),
                    bit_equal=True,
                    ms=graph_ms(lambda: sf._mask_kernel(ll, inf)),
                    plain_ms=cuda_ms(lambda: sf._mask_where(ll, inf), reps=10),
                    library_ms=graph_ms(lambda: sf._mask_where(ll, inf)),
                    bytes=nbytes, bound_ms=nbytes / PEAK_BYTES * 1e3,
                    bound_by="bytes")
        print(f"[mask] {case}: {mrow['masked']} rows masked (NaN, +-Inf, "
              f"infeasible), equal to torch.where to the bit; kernel "
              f"{mrow['ms'] * 1e3:.2f} us (graphed), torch.where "
              f"{mrow['library_ms'] * 1e3:.2f} us graphed, "
              f"{mrow['plain_ms'] * 1e3:.1f} us eager; bound "
              f"{mrow['bound_ms'] * 1e3:.4f} us", flush=True)
        mask_rows.append(mrow)
    zero_counts()
    return dict(prep=prep_rows, mask=mask_rows)


def prep_kernels(p2c, paths=None):
    """The prep and mask kernels' entries of the kernels line: the
    numbers of the main path's shape (B = 1024 float32), every case under
    ``configs``, the launches of each driven path (``OBJECTIVE_PATHS``)."""
    paths = OBJECTIVE_PATHS if paths is None else paths
    out = []
    for name, kern, rows, lib in (
            ("sepaihrd_prep", "prep", p2c["prep"], False),
            ("sepaihrd_mask", "mask", p2c["mask"], True)):
        head = rows[0]
        out.append({
            "name": name, "route": "cuda",
            "source": "mmidv1_tpu_torch/csrc/sepaihrd_prep.cu",
            "replaces": None, "launches": sum(p[kern] for p in paths.values()),
            "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"] if lib else None,
            "kernels_per_call": 1, "shape": f"B={head['B']} {head['dtype']}",
            "paths": {label: {k: p[k] for k in (kern, f"{kern}_batch_calls")}
                      for label, p in paths.items()},
            "configs": rows})
    return out


def main():
    if "--host-refs" in sys.argv[1:]:
        sys.path.insert(0, HERE)
        i = sys.argv.index("--host-refs")
        host_refs(sys.argv[i + 1], sys.argv[i + 2])
        return 0
    k3_only = "--k3" in sys.argv[1:]
    main_only = "--main" in sys.argv[1:]
    fwd_only = "--fwd" in sys.argv[1:]
    campaign_only = "--campaign" in sys.argv[1:]
    sir_only = "--sir" in sys.argv[1:]
    parallel_only = "--parallel" in sys.argv[1:]
    nuts_only = "--nuts" in sys.argv[1:]
    probes_only = "--probes" in sys.argv[1:]
    recovery_only = "--recovery" in sys.argv[1:]
    tableaus_only = "--tableaus" in sys.argv[1:]
    prep_only = "--prep" in sys.argv[1:]
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
    secs = _build.build(["sepaihrd_fused", "sepaihrd_adjoint", "sepaihrd_prep"])
    results["build_seconds"] = secs
    print(f"[build] {secs} (wall {time.perf_counter() - t0:.1f}s)", flush=True)
    usage = []
    for src in ("sepaihrd_fused", "sepaihrd_adjoint", "sepaihrd_prep"):
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
    if prep_only:
        p2c = results["prep"] = prep_phase(cache)
        kernels = results["kernels"] = prep_kernels(p2c, {})
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_prep.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(json.dumps({"kernels": [
            {k: v for k, v in kern.items() if k not in ("configs", "paths")}
            for kern in kernels]}, separators=(",", ":")), flush=True)
        print("chip_smoke --prep: the prep and mask kernels held and timed; "
              "run without arguments for the whole check", flush=True)
        return 0
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

    if nuts_only:
        with HostSide("nuts") as (tmp, host):
            results["nuts"] = nuts_phases(card, tmp, host)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_nuts.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --nuts: the NUTS recipe, the polish, the curvature "
              "tools and the serovalid chain checked on the card; run without "
              "arguments for the whole check", flush=True)
        return 0

    if probes_only:
        with HostSide("probes") as (tmp, host):
            results["probes"] = probe_phases(card, tmp, host, cache,
                                             plain=True)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_probes.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --probes: the native IO layer, the dynamics, "
              "mala_rematch and the four seroprevalence probes checked on the "
              "card; run without arguments for the whole check", flush=True)
        return 0

    if tableaus_only:
        p30 = results["tableaus"] = tableau_phase(cache, strict=False)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out",
                               "chip_smoke_tableaus.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"chip_smoke --tableaus: {len(p30['misses'])} misses; run "
              "without arguments for the whole check", flush=True)
        return 1 if p30["misses"] else 0

    if recovery_only:
        results["recovery"] = recovery_phase(card)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out",
                               "chip_smoke_recovery.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)
        print("chip_smoke --recovery: the psomcmc and NUTS recovery runs on "
              "the real model met their bars through the kernels; run "
              "without arguments for the whole check", flush=True)
        return 0

    # 2b. the forward kernels in both regimes
    fwd = results["forward"] = forward_phases(cache, _build.BUILD_DIR)

    # 2c. the objective's prep and mask kernels
    p2c = results["prep"] = prep_phase(cache)

    # 3. kernel vs plain version on the card
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
    counts = path_counts("psomcmc (calibrate_spain) B=1024", "k1",
                         "k1_regime_calls")
    launches, k1_by_regime = counts["k1"], counts["k1_regime_calls"]
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

    # 23-25. the NUTS recipe, the polish, the curvature tools, serovalid;
    # 26-28. the native IO layer and the dynamics, mala_rematch, the probes
    # (one child process computes the host's references of both)
    with HostSide("all") as (tmp, host):
        nuts = results["nuts"] = nuts_phases(card, tmp, host, alone=False)
        probes = results["probes"] = probe_phases(card, tmp, host, cache)
    new_paths = probe_paths(probes)
    for k, c in list(nuts_paths(nuts).items()) + list(new_paths.items()):
        if c["k1"]:
            camp_paths[k] = {f: c[f] for f in ("k1", "k1_regime_calls",
                                               "k1_batch_calls")}
        if c["k2"]:
            grad_paths.append((k, c))
    new_k2 = sum(c["k2"] for c in new_paths.values())
    new_k3_kernels = sum(c["k3_kernels"] for c in new_paths.values())
    # the kernels at the new paths' shapes: mala_rematch's 2048 float32
    # chains (cash_karp@3) and the probes' one float64 chain on each box
    rg = probes["rematch"]["grad"]
    new_cfgs = {"k1": [probes["rematch"]["k1_compare"]],
                "k2": [dict(rg["k2_check"], ms=rg["k2_ms"],
                            plain_ms=rg["k2_plain_ms"], regime=rg["k2_regime"],
                            **rg["k2_bound"])],
                "k3": [dict(rg["k3_check"], ms=rg["k3_ms"],
                            plain_ms=rg["k3_plain_ms"],
                            plain_rows=rg["k3_plain_rows"],
                            regime=rg["k3_regime"], **rg["k3_bound"])]}
    for variant, b in probes["probes"]["boxes"].items():
        for k in new_cfgs:
            new_cfgs[k].append(dict(
                case=f"float64 dopri5@4 B=1 REFLECT box {variant} (probes)",
                ms=b[f"{k}_ms"], plain_ms=b.get(f"{k}_plain_ms"),
                regime=b[f"{k}_regime"], bound_ms=b["bounds"][k]["bound_ms"],
                bound_by=b["bounds"][k]["bound_by"]))
    # the forward kernels' chain bound at those shapes, as phase 2b's
    # (dependent stages x cycles a stage / the SM clock read under load)
    n_intervals = len(cache["float32"].ts) - 1
    for k in ("k1", "k2"):
        for c, (tab, sub, elem) in zip(new_cfgs[k], [("cash_karp", 3, 4)]
                                       + [("dopri5", 4, 8)] * 3):
            c["chain_bound_ms"] = chain_bound_ms(tab, sub, n_intervals, elem,
                                                 fwd["clock_mhz"])
            print(f"[chain] {k.upper()} {c['case']}: {c['ms']:.3f} ms, chain "
                  f"bound {c['chain_bound_ms']:.4f} ms at {fwd['clock_mhz']:.0f}"
                  f" MHz", flush=True)

    # 29. the recovery runs: R1 through K1, R3 through K2 + K3
    rec_run = results["recovery"] = recovery_phase(card)
    camp_paths["recovery R1 psomcmc B=128/32 f64"] = rec_run["r1"]["launches"]
    r3_counts = rec_run["r3"]["launches"]
    grad_paths.append(("recovery R3 nuts B=4 f64", r3_counts))
    new_k2 += r3_counts["k2"]
    new_k3_kernels += r3_counts["k3_kernels"]
    for k, c in list(rec_run["r1"]["kernels"].items()) + list(
            rec_run["r3"]["kernels"].items()):
        new_cfgs[k].append(c)

    # 30. the five tableaus, the stiff input, the SASS; the table's timings
    p30 = results["tableaus"] = tableau_phase(cache)
    p30_counts = p30["launches"]
    checked = "phase 30 (five tableaus and the stiff input, held against plain)"

    # 31. the kernels line, the card, the device line: each kernel's top-level
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
        "checked_launches": {checked: {k: p30_counts[k] for k in (
            "k1", "k1_regime_calls")}},
        "configs": [{k: c[k] for k in ("case", "max_rel_err", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms", "bound_by")}
                    for c in cases + main_run["primary"]["hillmcmc"][
                        "k1_compare"] + camp["k1_compare"]
                    + [sir_run["pso"]["k1_compare"]]] + new_cfgs["k1"]}, {
        "name": "sepaihrd_fwd_ckpt", "route": "cuda",
        "source": "mmidv1_tpu_torch/csrc/sepaihrd_adjoint.cu",
        "replaces": "mmidv1_tpu/ops/sepaihrd_adjoint.py:359",
        "launches": nuts_launches["k2"] + new_k2,
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
        "paths": {name: {k: c[k] for k in ("k2", "k2_regime_calls",
                                           "k2_batch_calls") if k in c}
                  for name, c in [("nuts B=64", nuts_launches),
                                  ("nuts (sepaihrd_main) B=64", main_nuts),
                                  ("mala B=64", mala),
                                  ("mala B=1024", mala_wide)] + grad_paths},
        "shape": "B=64 float32 dopri5@4 CLAMP",
        "checked_launches": {checked: {k: p30_counts[k] for k in (
            "k2", "k2_regime_calls")}},
        "configs": [main64["k2_check"]] + k2_cases + new_cfgs["k2"]}, {
        "name": "sepaihrd_adjoint", "route": "cuda",
        "source": "mmidv1_tpu_torch/csrc/sepaihrd_adjoint.cu",
        "replaces": "mmidv1_tpu/ops/sepaihrd_adjoint.py:397",
        "launches": nuts_launches["k3"] + new_k2,
        "max_abs_err": main32["k3_check"]["max_abs_err"],
        "grad_err": main32["k3_check"]["err"],
        "ms": main32["k3_ms"], "plain_ms": main32["k3_plain_ms"],
        "bound_ms": main32["k3_bound"]["bound_ms"],
        "bound_by": main32["k3_bound"]["bound_by"], "library_ms": None,
        "regime": k3_regime,
        "calls": nuts_launches["k3"] + new_k2,
        "kernel_launches": nuts_launches["k3_kernels"] + new_k3_kernels,
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
        "checked_launches": {checked: {k: p30_counts[k] for k in (
            "k3", "k3_kernels", "k3_regime_calls", "k3_forced_calls")}},
        "configs": [main64["k3_check"]] + k3_cases + new_cfgs["k3"]}]
    kernels += prep_kernels(p2c)
    results["kernels"] = kernels
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(card, flush=True)
    # compact: every path of K1, K2 and K3 is listed on this one line; the
    # per-configuration checks, regimes and crossovers, and the prep's and
    # the mask's paths (the same calls as K1's and K2's) are in the JSON file
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items()
         if k not in ("configs", "by_regime", "crossover")
         and not (k == "paths" and kern["name"] in ("sepaihrd_prep",
                                                    "sepaihrd_mask"))}
        for kern in kernels]}, separators=(",", ":")), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
