#!/usr/bin/env python3
"""Drive the PyTorch port's Spain-2020 calibration paths on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of ``mmidv1_tpu_torch/csrc`` from source, one
     nvcc per source, all at once (K1; K2 and K3);
  3. hold K1 (the fused SEPAIHRD objective) against its plain PyTorch
     version on the card, at the full Spain-2020 width (62 parameters,
     325 daily intervals, 7 schedule runs): B = 8192 chains in float64
     (rtol 1e-10) and float32 (rtol 2e-4, the float32 noise floor at
     LL ~1.4e6 is O(1e2)), dopri5@4 and cash_karp@3, plus the main path's
     own shape (1024 chains, float32, dopri5@4); a few chains carry a NaN
     parameter and must come out as NaN from both and as finfo.min from
     the objective; time the kernel (CUDA events) and the plain version;
  4. evaluate the committed float64 MAP through K1:
     1432889.7908967654 at rtol 1e-10;
  5. the PSO -> AM-MH path, ``mmidv1_tpu_torch.cli.calibrate_spain``,
     psomcmc in float32 (512 PSO particles x 5 iterations, then AM-MH with
     1024 chains x 100 steps), K1's launch count set to 0 just before and
     read just after;
  6. hold K2 (forward with checkpoints) against its plain version: LL and
     checkpoints at B = 8192, f64 rtol 1e-10 and f32 rtol 2e-4;
  7. hold K3 (the adjoint) against its plain version (autograd through the
     plain forward, whose saved tensors limit it to B = 512): all four
     gradient outputs, f64 rtol 1e-9 with an absolute floor of 1e-9 x the
     chain's largest entry, f32 per-chain relative 2-norm <= 1e-3; NaN
     chains come out NaN from both and finfo.min from value_and_grad;
  8. time K2 and K3 (CUDA events) at B = 8192 and at the NUTS path's
     B = 64, f32 and f64, beside their op-count bounds; at B = 64, on
     CLAMP-prepared inputs as NUTS gives them, also hold both against their
     plain versions with the tolerances of phases 6 and 7;
  9. the gradient anchor in float64: at the committed MAP + 0.05 sigma
     noise, value_and_grad against a central difference of K1 along a
     random sigma-scaled direction (step 1e-4 sigma, rtol 1e-4), and its
     value against K1's (rtol 1e-12);
 10. the NUTS path, ``calibrate_spain`` with ``--algorithm nuts --full``
     (64 chains, nuts_settings.txt: 25 iterations of depth 3), float32,
     with the K1/K2/K3 launch counts set to 0 just before and read after;
 11. a short MALA run (64 chains x 20 iterations, float32) through the
     same K2/K3 engine, its launches counted;
 12. print the kernels line and, last, the device line.

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
    least arithmetic ("bwd"), ``design_bound_ms`` from K3 as built."""
    from mmidv1_tpu_torch.ops.sepaihrd_adjoint import op_count_adjoint

    elem = 8 if dtype_name == "float64" else 4
    ops = op_count_adjoint(kw["tableau"], kw["substeps"], sum(kw["run_count"]),
                           n_obs)
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
    design = bound(n_bwd * elem, B * ops["bwd_design"])
    bwd.update(design_flops=design["flops"], design_bound_ms=design["bound_ms"])
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


def compare_k3(case, B, dtype_name, tableau, substeps, tol, cache, seed):
    """K3 vs its plain version, NaN chains included; the masked engine."""
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
    torch.cuda.synchronize()
    ref = fused_adjoint_reference(agevec, scal, beff, obs, valid, ck, g, M, **kw)
    torch.cuda.synchronize()
    out = check_k3(case, got, ref, dtype_name, tol, bad)
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
    as the NUTS path prepares them; with ``plain`` also their plain
    versions' (one run each), and the kernels' outputs held against them
    (LL and checkpoints at rtol 1e-10 f64 / 2e-4 f32, gradients at 1e-9 /
    1e-3 as in ``check_k3``)."""
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
    bwd = lambda: fused_adjoint(agevec, scal, beff, obs, valid, ck, g, M, **kw)
    grads = bwd()
    reps = 10 if B <= 1024 else 3
    out = dict(B=B, dtype=dtype_name,
               k2_ms=cuda_ms(lambda: fused_forward_ckpt(*args, **kw), reps),
               k3_ms=cuda_ms(bwd, reps),
               vag_ms=cuda_ms(lambda: vg(thetas), reps))
    bounds = adjoint_bounds(B, dtype_name, kw, obs.shape[0], args, ck)
    out["k2_bound"], out["k3_bound"] = bounds["fwd"], bounds["bwd"]
    print(f"[time] B={B} {dtype_name} dopri5@4: K2 {out['k2_ms']:.3f} ms "
          f"(bound {bounds['fwd']['bound_ms']:.4f}, {bounds['fwd']['bound_by']}), "
          f"K3 {out['k3_ms']:.3f} ms (bound {bounds['bwd']['bound_ms']:.4f}, "
          f"{bounds['bwd']['bound_by']}; as built "
          f"{bounds['bwd']['design_bound_ms']:.4f}), value_and_grad "
          f"{out['vag_ms']:.3f} ms", flush=True)
    if plain:
        ref2, out["k2_plain_ms"] = cuda_once(
            lambda: fused_forward_ckpt_reference(*args, **kw))
        ref3, out["k3_plain_ms"] = cuda_once(
            lambda: fused_adjoint_reference(agevec, scal, beff, obs, valid, ck,
                                            g, M, **kw))
        case = f"{dtype_name} dopri5@4 B={B} CLAMP (NUTS shape)"
        tol2, tol3 = (1e-10, 1e-9) if dtype_name == "float64" else (2e-4, 1e-3)
        out["k2_check"] = check_k2(case, (ll, ck), ref2, tol2)
        out["k3_check"] = check_k3(case, grads, ref3, dtype_name, tol3)
        print(f"[time] B={B} {dtype_name}: plain K2 {out['k2_plain_ms']:.1f} ms, "
              f"K3 {out['k3_plain_ms']:.1f} ms", flush=True)
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

    # 5. the PSO -> AM-MH path, counted
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

    # 6. K2 vs its plain version
    from mmidv1_tpu_torch.ops import fused_adjoint, fused_forward_ckpt
    k2_cases, k3_cases = [], []
    for dtype_name, tol in (("float64", 1e-10), ("float32", 2e-4)):
        for tableau, substeps in (("dopri5", 4), ("cash_karp", 3)):
            k2_cases.append(compare_k2(f"{dtype_name} {tableau}@{substeps} B=8192",
                                       8192, dtype_name, tableau, substeps, tol,
                                       cache, seed=20 + len(k2_cases)))
    results["k2_compare"] = k2_cases

    # 7. K3 vs its plain version
    for dtype_name, tol in (("float64", 1e-9), ("float32", 1e-3)):
        for tableau, substeps in (("dopri5", 4), ("cash_karp", 3)):
            k3_cases.append(compare_k3(f"{dtype_name} {tableau}@{substeps} B=512",
                                       512, dtype_name, tableau, substeps, tol,
                                       cache, seed=30 + len(k3_cases)))
    results["k3_compare"] = k3_cases

    # 8. K2 / K3 times beside their bounds
    timings = [time_adjoint(B, dtype_name, cache, plain=B <= 64)
               for B in (8192, 64) for dtype_name in ("float32", "float64")]
    results["adjoint_timings"] = timings

    # 9. the float64 gradient anchor
    results["gradient_anchor"] = gradient_anchor(cache)

    # 10. the NUTS path, counted
    fused_objective.launches = 0
    fused_forward_ckpt.launches = 0
    fused_adjoint.launches = 0
    nuts = run_calibration(
        algorithm="nuts", chains=64, full=True, x64=False, tableau="dopri5",
        substeps=4, seed=0, device="cuda", root=HERE,
        out=os.path.join(HERE, "chiprun_out", "chip_smoke_nuts"),
        log=lambda m: print(f"[nuts] {m}", flush=True))
    nuts_launches = dict(k1=fused_objective.launches,
                         k2=fused_forward_ckpt.launches,
                         k3=fused_adjoint.launches)
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

    # 11. MALA through the same engine, counted
    import torch as _t
    from mmidv1_tpu_torch.calibration.mala import MALAConfig, run_mala
    from mmidv1_tpu_torch.calibration.param_space import REFLECT as _R
    from mmidv1_tpu_torch.ops import build_objective_fused_grad
    pipe32 = cache["float32"]
    vg = build_objective_fused_grad(pipe32.space, pipe32.params, pipe32.data,
                                    pipe32.ts, substeps=4, constraint_mode=_R,
                                    device="cuda")
    fused_forward_ckpt.launches = 0
    fused_adjoint.launches = 0
    t0 = time.perf_counter()
    mres = run_mala(None, pipe32.space, pipe32.theta0,
                    MALAConfig(iterations=20, burn_in=10, adaptation_period=10,
                               initial_step_size=0.02),
                    generator=_t.Generator(device="cuda").manual_seed(0),
                    n_chains=64, jitter=0.05, value_and_grad_batch=vg)
    mala_best = float(mres.best_logp)
    mala_s = time.perf_counter() - t0
    mala = dict(k2=fused_forward_ckpt.launches, k3=fused_adjoint.launches,
                best_logp=mala_best, seconds=mala_s,
                acceptance=float(mres.acceptance_rate.mean()),
                grad_evals_per_s=64 * vg.calls / mala_s)
    results["mala"] = mala
    if mala["k2"] != 21 or mala["k3"] != 21 or not abs(mala_best) < float("inf") \
            or not bool(_t.isfinite(mres.samples).all()):
        fail(f"MALA run: {mala}")
    print(f"[mala] 64 chains x 20 iterations: K2/K3 launches {mala['k2']}/"
          f"{mala['k3']}, best logL {mala_best:.6e}, acceptance "
          f"{mala['acceptance']:.3f}, {mala['grad_evals_per_s']:.4e} grad-evals/s",
          flush=True)

    # 12. the kernels line, the card, the device line: each kernel's top-level
    # numbers at its main path's shape, every other comparison under configs
    head = main_shape
    main32, main64 = (next(t for t in timings if t["B"] == 64
                           and t["dtype"] == d) for d in ("float32", "float64"))
    kernels = [{
        "name": "sepaihrd_fused", "route": "cuda",
        "source": "mmidv1_tpu_torch/csrc/sepaihrd_fused.cu",
        "replaces": "mmidv1_tpu/ops/sepaihrd_pallas.py:364",
        "launches": launches,
        "max_abs_err": head["max_abs_err"], "max_rel_err": head["max_rel_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": "B=1024 float32 dopri5@4",
        "configs": [{k: c[k] for k in ("case", "max_rel_err", "max_abs_err",
                                       "ms", "plain_ms", "bound_ms", "bound_by")}
                    for c in cases]}, {
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
        "design_bound_ms": main32["k3_bound"]["design_bound_ms"],
        "shape": "B=64 float32 dopri5@4 CLAMP",
        "configs": [main64["k3_check"]] + k3_cases}]
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
