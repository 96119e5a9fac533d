#!/usr/bin/env python3
"""Drive the PyTorch port's Spain-2020 calibration on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernel(s) of ``mmidv1_tpu_torch/csrc`` from source;
  3. hold the fused SEPAIHRD objective kernel against its plain PyTorch
     version on the card, at the full Spain-2020 width (62 parameters,
     325 daily intervals, 7 schedule runs): B = 8192 chains in float64
     (rtol 1e-10) and float32 (rtol 2e-4, the float32 noise floor at
     LL ~1.4e6 is O(1e2)), dopri5@4 and cash_karp@3, plus the main path's
     own shape (1024 chains, float32, dopri5@4); a few chains carry a NaN
     parameter and must come out as NaN from both and as finfo.min from
     the objective; time the kernel (CUDA events) and the plain version;
  4. evaluate the committed float64 MAP through the kernel:
     1432889.7908967654 at rtol 1e-10;
  5. run the main path, ``mmidv1_tpu_torch.cli.calibrate_spain``, psomcmc in
     float32 (512 PSO particles x 5 iterations, then AM-MH with 1024 chains
     x 100 steps), with the kernel's launch count set to 0 just before and
     read just after;
  6. print the kernels line and, last, the device line.

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


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


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
    """Kernel vs plain version on the card for one configuration."""
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
    torch.cuda.synchronize()
    r = fused_objective_reference(*args, **kw)
    torch.cuda.synchronize()
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
    plain_ms = cuda_ms(lambda: fused_objective_reference(*args, **kw), reps=1,
                       warmup=0)
    objective_ms = cuda_ms(lambda: ll(thetas), reps=10)
    elem = torch.finfo(dtype).bits // 8
    nbytes = sum(a.numel() for a in args[:6]) * elem + B * elem
    n_intervals = int(sum(kw["run_count"]))
    flops = B * op_count(tableau, substeps, n_intervals, pipe.data.n_data_points)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype_name] * 1e3
    out = dict(case=case, B=B, dtype=dtype_name, tableau=tableau,
               substeps=substeps, tol_rel=tol, max_rel_err=max_rel,
               max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
               objective_ms=objective_ms, bytes=nbytes, flops=flops,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes > t_ops else "operations")
    print(f"[compare] {case}: max rel err {max_rel:.3e} (tol {tol:.0e}), "
          f"max abs err {max_abs:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"objective (prep + kernel) {objective_ms:.3f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']})", flush=True)
    return out


def main():
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
    secs = _build.build(["sepaihrd_fused"])
    results["build_seconds"] = secs
    print(f"[build] {secs} (wall {time.perf_counter() - t0:.1f}s)", flush=True)
    report = os.path.join(_build.BUILD_DIR, "sepaihrd_fused.ptxas.txt")
    if os.path.exists(report):
        usage, name = [], "?"
        with open(report) as f:
            for ln in f:
                if "Function properties for" in ln:
                    name = ln.split("for", 1)[1].strip()
                elif "spill" in ln or "registers" in ln:
                    usage.append(f"{name}: {ln.strip()}")
        results["ptxas"] = usage
        for ln in usage:
            print(f"[ptxas] {ln}", flush=True)

    # 3. kernel vs plain version on the card
    from mmidv1_tpu_torch.ops import fused_objective
    cache = {}
    cases = []
    for dtype_name, tol in (("float64", 1e-10), ("float32", 2e-4)):
        for tableau, substeps in (("dopri5", 4), ("cash_karp", 3)):
            cases.append(compare(f"{dtype_name} {tableau}@{substeps} B=8192",
                                 8192, dtype_name, tableau, substeps, tol,
                                 cache, seed=len(cases)))
    main_shape = compare("float32 dopri5@4 B=1024 (main-path MH shape)", 1024,
                         "float32", "dopri5", 4, 2e-4, cache, seed=99)
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

    # 5. the main path, counted
    from mmidv1_tpu_torch.cli.calibrate_spain import run_calibration
    fused_objective.launches = 0
    summary = run_calibration(
        algorithm="psomcmc", chains=1024, pso_particles=512, pso_iters=5,
        mcmc_iters=100, thinning=5, burn_in=20, substeps=4, tableau="dopri5",
        x64=False, seed=0, device="cuda", root=HERE,
        out=os.path.join(HERE, "chiprun_out", "chip_smoke_calibration"),
        log=lambda m: print(f"[main] {m}", flush=True))
    launches = fused_objective.launches
    results["main_path"] = dict(summary, launches=launches)
    # 1 initial + 2 opposition + 5 PSO + 1 MH init + 100 MH + 1 float64
    if launches < 5 + 100:
        fail(f"main path launched the kernel {launches} times")
    best, init = summary["best_logl"], summary["initial_logl"]
    if not (abs(best) < float("inf") and best >= init):
        fail(f"best log-likelihood {best} is not finite and >= initial {init}")
    if not abs(summary["best_logl_float64"]) < float("inf"):
        fail("float64 re-selection is not finite")
    print(f"[main] launches {launches}; best logL {best:.6e} >= initial "
          f"{init:.6e}; {summary['chain_steps_per_s']:.4e} chain-steps/s "
          f"(AM-MH, 1024 chains, float32) on {card}", flush=True)

    # 6. the kernels line, the card, the device line
    head = main_shape
    kernels = [{
        "name": "sepaihrd_fused", "route": "cuda",
        "source": "mmidv1_tpu_torch/csrc/sepaihrd_fused.cu",
        "replaces": "mmidv1_tpu/ops/sepaihrd_pallas.py:361",
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "max_rel_err_f64": max(c["max_rel_err"] for c in cases
                               if c["dtype"] == "float64"),
        "max_rel_err_f32": max(c["max_rel_err"] for c in cases + [main_shape]
                               if c["dtype"] == "float32"),
        "shape": "B=1024 float32 dopri5@4",
        "configs": [{k: c[k] for k in ("case", "max_rel_err", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms", "bound_by")}
                    for c in cases]}]
    results["kernels"] = kernels
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
