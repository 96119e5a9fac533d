"""Full post-calibration report: a batched posterior replay.

Port of ``mmidv1_tpu/analysis/report.py`` (:56-225), re-design of
``PostCalibrationAnalyser::generateFullReport`` (reference:
``src/model/PostCalibrationAnalyser.cpp:53-148``). The selected draws replay
in batches of ``batch_size`` as one batched solve each, on the device of the
base parameters (eager PyTorch under ``torch.inference_mode``: the JAX package
jit-compiles the same replay with ``jax.vmap``); metrics and trajectories come back to the host, where the
quantile bands, the pooled summaries and the CSV emission run in NumPy
exactly as in the JAX package (the batching is the same, so the pooled
per-batch statistics are too). The eager replay is launch-bound, so one
solve takes ``REPLAY_GROUP`` batches at once and is split into batches of
``batch_size`` on the host.

Produces the reference's full output tree (see
:mod:`mmidv1_tpu_torch.analysis.writers`): posterior-predictive bands,
per-batch + pooled metric summaries, parameter posteriors, Rt /
seroprevalence trajectory bands, ENE-COVID day-64 validation, and the
+/-10%-kappa scenario comparison.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..calibration.objective import build_incidence_fn
from ..calibration.param_space import REFLECT, ParameterSpace
from ..data.calibration_data import CalibrationData
from ..models import sepaihrd
from ..params import SEPAIHRDParams
from . import aggregate, writers
from .metrics import essential_metrics, seroprevalence_trajectory
from .reproduction import rt_trajectory

# batches replayed by one solve: each solve costs about the same number of
# launches whatever its width, and 8 x 1024 draws of the Spain grid hold
# about 2 GB of float32 trajectory
REPLAY_GROUP = 8


def _replay_fn(space: ParameterSpace, base_params: SEPAIHRDParams,
               base_y0: torch.Tensor, ts: torch.Tensor, substeps: int,
               use_scalar_beta: bool, tableau: str = "dopri5"):
    """thetas (B, d) -> (metrics dict, rt (B, T), sero (B, T))."""

    def replay(thetas):
        theta = space.constrain(thetas, REFLECT)
        params = space.apply(base_params, theta)
        y0, _inf = sepaihrd.initial_state_for_params(params, base_y0)
        y0 = y0.expand((theta.shape[0],) + y0.shape[-2:])
        traj = sepaihrd.solve(params, y0, ts, method="fixed",
                              substeps=substeps, tableau=tableau)
        m = essential_metrics(params, traj, ts, y0,
                              use_scalar_beta=use_scalar_beta)
        rt = rt_trajectory(params, traj, ts)
        sero = seroprevalence_trajectory(params, traj)
        return m, rt.movedim(0, -1), sero.movedim(0, -1)

    return replay


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def generate_full_report(
    samples,
    space: ParameterSpace,
    base_params: SEPAIHRDParams,
    data: CalibrationData,
    ts: Sequence[float],
    output_dir: str,
    *,
    num_samples_for_ppc: int = 100,
    burn_in: int = 0,
    thinning: int = 1,
    batch_size: int = 256,
    substeps: int = 4,
    tableau: str = "dopri5",
    seed: int = 12345,
    use_scalar_beta: bool = False,
    scenario_kappa_delta: float = 0.1,
    async_io: bool = True,
    base_initial_state: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """Run the complete analysis and write the reference-shaped output tree.

    ``samples``: (n, d) or (n_stored, B, d) posterior draws (NumPy or a
    tensor on any device), flattened after burn-in / thinning. The replay
    runs on the base parameters' device in their dtype. Returns the in-memory
    results (summary dict, PPC bands, trajectory bands, scenario rows) for
    programmatic use.
    """
    with torch.inference_mode():
        return _report(samples, space, base_params, data, ts, output_dir,
                       num_samples_for_ppc=num_samples_for_ppc,
                       burn_in=burn_in, thinning=thinning,
                       batch_size=batch_size, substeps=substeps,
                       tableau=tableau, seed=seed,
                       use_scalar_beta=use_scalar_beta,
                       scenario_kappa_delta=scenario_kappa_delta,
                       async_io=async_io,
                       base_initial_state=base_initial_state)


def _report(samples, space, base_params, data, ts, output_dir, *,
            num_samples_for_ppc, burn_in, thinning, batch_size, substeps,
            tableau, seed, use_scalar_beta, scenario_kappa_delta, async_io,
            base_initial_state):
    dtype, dev = base_params.dtype, base_params.device
    ts = np.asarray(ts, dtype=np.float64)
    ts_t = torch.as_tensor(ts, dtype=dtype, device=dev)
    runup_offset = int(np.searchsorted(ts, 0.0, side="left"))
    ts_obs = ts[runup_offset:]
    n_ages = base_params.n_ages

    if isinstance(samples, torch.Tensor):
        samples = _host(samples)
    samples = np.asarray(samples)
    if samples.ndim == 3:
        # burn-in/thinning are ITERATION counts: apply them on the stored-
        # iteration axis BEFORE flattening the (n_stored, B, d) ensemble
        samples = samples[burn_in::max(1, thinning)]
        sel = samples.reshape(-1, samples.shape[-1])
    else:
        sel = samples[burn_in::max(1, thinning)]
    if sel.size == 0:
        raise ValueError("no posterior samples left after burn-in/thinning")

    if base_initial_state is None:
        base_initial_state = data.initial_sepaihrd_state(
            sigma=base_params.sigma, gamma_p=base_params.gamma_p,
            gamma_A=base_params.gamma_A, gamma_I=base_params.gamma_I,
            p=base_params.p, h=base_params.h)
    base_initial_state = np.asarray(base_initial_state, dtype=np.float64)
    base_y0 = torch.as_tensor(base_initial_state, dtype=dtype, device=dev)
    on_device = lambda a: torch.as_tensor(a, device=dev).to(dtype)

    writer = writers.AsyncWriter() if async_io else None

    def emit(fn, *args, **kwargs):
        if writer is not None:
            writer.submit(fn, *args, **kwargs)
        else:
            fn(*args, **kwargs)

    # ------------------------------------------------------------------
    # 1) Posterior predictive checks (random subsample, batched incidence)
    # ------------------------------------------------------------------
    idx = aggregate.select_ppc_draws(len(sel), num_samples_for_ppc, seed)
    incidence = build_incidence_fn(space, base_params, data, ts,
                                   base_initial_state=base_initial_state,
                                   substeps=substeps, tableau=tableau,
                                   constraint_mode=REFLECT, dtype=dtype,
                                   device=dev)
    daily = []
    for start in range(0, len(idx), batch_size):
        chunk = on_device(sel[idx[start:start + batch_size]])
        daily.append(_host(incidence(chunk)[1]))
    daily = np.concatenate(daily, axis=0)            # (m, 3, T_obs, A)
    ppc = aggregate.posterior_predictive(daily, data, ts_obs)
    emit(writers.write_posterior_predictive,
         os.path.join(output_dir, "posterior_predictive"), ppc)

    # ------------------------------------------------------------------
    # 2) Batched metric replay over ALL selected draws
    # ------------------------------------------------------------------
    replay = _replay_fn(space, base_params, base_y0, ts_t, substeps,
                        use_scalar_beta, tableau)

    all_batch_stats = []
    rt_all, sero_all = [], []
    bi = 0
    for start in range(0, len(sel), batch_size * REPLAY_GROUP):
        m, rt, sero = replay(on_device(
            sel[start:start + batch_size * REPLAY_GROUP]))
        m = {k: _host(v) for k, v in m.items()}
        for sub in range(0, rt.shape[0], batch_size):
            cols = aggregate.metric_table(
                {k: v[sub:sub + batch_size] for k, v in m.items()}, n_ages)
            emit(writers.write_batch_metrics,
                 os.path.join(output_dir, "mcmc_batches", f"batch_{bi}.csv"),
                 cols, n_ages)
            all_batch_stats.append(aggregate.aggregate_batch_metrics(cols))
            bi += 1
        rt_all.append(_host(rt))
        sero_all.append(_host(sero))

    summary = aggregate.aggregate_all_batches(all_batch_stats)
    emit(writers.write_aggregated_summary,
         os.path.join(output_dir, "mcmc_aggregated", "metrics_summary.csv"),
         summary)

    rt_bands = aggregate.trajectory_bands(np.concatenate(rt_all), ts)
    sero_bands = aggregate.trajectory_bands(np.concatenate(sero_all), ts)
    emit(writers.write_aggregated_trajectory,
         os.path.join(output_dir, "rt_trajectories",
                      "Rt_aggregated_with_uncertainty.csv"), rt_bands)
    emit(writers.write_aggregated_trajectory,
         os.path.join(output_dir, "seroprevalence",
                      "seroprevalence_trajectory.csv"), sero_bands)

    ene = aggregate.ene_covid_validation(summary)
    emit(writers.write_ene_covid_validation,
         os.path.join(output_dir, "seroprevalence", "ene_covid_validation.csv"),
         ene)

    # ------------------------------------------------------------------
    # 3) Parameter posteriors
    # ------------------------------------------------------------------
    emit(writers.write_parameter_posteriors,
         os.path.join(output_dir, "parameter_posteriors"), sel,
         list(space.names))

    # ------------------------------------------------------------------
    # 4) Scenario analysis around the posterior mean: +/-10% on the first
    #    calibratable kappa (reference PostCalibrationAnalyser.cpp:110-140;
    #    baseline kappa_1 is fixed, so index 1)
    # ------------------------------------------------------------------
    scenario_rows = []
    # the three scenarios as one batch of three: the posterior mean, then its
    # kappa_1 times each factor
    names = ("baseline", "stricter_lockdown", "weaker_lockdown")
    factors = (1.0 - scenario_kappa_delta, 1.0 + scenario_kappa_delta)
    mean_theta = on_device(sel.mean(axis=0))
    params = space.apply(base_params, space.constrain(
        mean_theta.expand(len(names), -1), REFLECT))
    if int(params.kappa_values.shape[-1]) > 1:
        k_idx = 1
        kv = params.kappa_values.clone()
        for row, f in enumerate(factors, start=1):
            kv[row, k_idx] = kv[row, k_idx] * f
        params = params.replace(kappa_values=kv)
        y0, _ = sepaihrd.initial_state_for_params(params, base_y0)
        y0 = y0.expand((len(names),) + y0.shape[-2:])
        traj = sepaihrd.solve(params, y0, ts_t, method="fixed",
                              substeps=substeps, tableau=tableau)
        cols = aggregate.metric_table(
            {k: _host(v) for k, v in essential_metrics(
                params, traj, ts_t, y0,
                use_scalar_beta=use_scalar_beta).items()}, n_ages)
        for row, name in enumerate(names):
            scenario_rows.append((name, {k: float(v[row]) for k, v in
                                         cols.items()}))
        emit(writers.write_scenario_comparison,
             os.path.join(output_dir, "scenarios", "scenario_comparison.csv"),
             scenario_rows)

    if writer is not None:
        writer.wait_for_completion()
        writer.close()

    return {"summary": summary, "ppc": ppc, "rt_bands": rt_bands,
            "sero_bands": sero_bands, "ene_covid": ene,
            "scenarios": scenario_rows, "n_draws": len(sel)}
