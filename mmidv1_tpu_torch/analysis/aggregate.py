"""Posterior aggregation: PPC quantile bands, batch stats, ENE-COVID check.

A copy of ``mmidv1_tpu/analysis/aggregate.py`` (NumPy on the host; the
quantiles stay NumPy's, so both packages pool the same way).

Re-design of ``ResultAggregator``
(reference: ``src/model/ResultAggregator.cpp``). The reference streams every
posterior draw through a memoized sequential simulator into Boost.Accumulators
approximate (extended-P^2) quantile estimators; here the whole posterior
ensemble replays as batched solves and the bands are exact
``quantile`` reductions along the sample axis — the cache, the batching
machinery, and the streaming estimators all collapse (SURVEY.md section 3.5).

Quantile semantics: exact order statistics with linear interpolation (the
reference's quadratic extended-P^2 accumulator is an APPROXIMATION whose error
depends on arrival order; exact quantiles are a strict upgrade, documented
deviation).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.calibration_data import CalibrationData

PPC_PROBS = (0.025, 0.05, 0.5, 0.95, 0.975)
BAND_KEYS = ("lower95", "lower90", "median", "upper90", "upper95")

# ENE-COVID round-1 seroprevalence study (reference
# PostCalibrationAnalyser.cpp:289-295): day 64 = 2020-05-04, 4.8% [4.3, 5.4].
ENE_COVID_TARGET_DAY = 64.0
ENE_COVID_MEAN = 0.048
ENE_COVID_LOWER = 0.043
ENE_COVID_UPPER = 0.054


def quantile_bands(values: np.ndarray, axis: int = 0) -> Dict[str, np.ndarray]:
    """{lower95, lower90, median, upper90, upper95} along ``axis``."""
    qs = np.quantile(values, PPC_PROBS, axis=axis)
    return dict(zip(BAND_KEYS, qs))


def posterior_predictive(
    daily: np.ndarray,
    data: CalibrationData,
    ts_obs: Sequence[float],
) -> Dict[str, Dict[str, np.ndarray]]:
    """PPC bands for the 6 observation streams.

    ``daily``: (n_draws, 3, T_obs, A) simulated daily (hosp, icu, deaths)
    incidence on the observation window (from
    :func:`mmidv1_tpu_torch.calibration.objective.build_incidence_fn`, whose
    anchoring matches ``ResultAggregator.cpp:296-336``: first observed day
    differs against the end-of-run-up state, flows clamped >= 0).

    Returns ``{stream: {median, lower90, upper90, lower95, upper95, observed,
    time}}`` for daily_* and cumulative_* hospitalizations / icu_admissions /
    deaths (cumulatives are running sums of the daily flows, ``:341-356``;
    observed cumulatives come from the data as in ``:215-220``).
    """
    daily = np.asarray(daily)
    cum = np.cumsum(daily, axis=2)
    ts_obs = np.asarray(ts_obs)

    streams = {
        "daily_hospitalizations": (daily[:, 0], data.new_hospitalizations),
        "daily_icu_admissions": (daily[:, 1], data.new_icu),
        "daily_deaths": (daily[:, 2], data.new_deaths),
        "cumulative_hospitalizations": (cum[:, 0],
                                        data.cumulative_hospitalizations),
        "cumulative_icu_admissions": (cum[:, 1], data.cumulative_icu),
        "cumulative_deaths": (cum[:, 2], data.cumulative_deaths),
    }
    out = {}
    for name, (sim, observed) in streams.items():
        bands = quantile_bands(sim, axis=0)          # each (T_obs, A)
        bands["observed"] = np.asarray(observed)
        bands["time"] = ts_obs
        out[name] = bands
    return out


def select_ppc_draws(n_available: int, num_samples: int,
                     seed: int = 0) -> np.ndarray:
    """Random subsample of posterior draw indices (reference ``:259-275``:
    with-replacement uniform draws when a subsample is requested, the full set
    otherwise; seed 0 means nondeterministic there, deterministic here)."""
    if num_samples <= 0 or num_samples >= n_available:
        return np.arange(n_available)
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_available, size=num_samples)


# ---------------------------------------------------------------------------
# Batch metric aggregation (reference ResultAggregator.cpp:35-172)
# ---------------------------------------------------------------------------

def metric_table(metrics: Dict[str, np.ndarray], n_ages: int) -> Dict[str, np.ndarray]:
    """Flatten a (possibly batched) EssentialMetrics dict into named scalar
    columns matching the reference's CSV schema
    (``AnalysisWriter.cpp:360-377``)."""
    m = {k: np.asarray(v) for k, v in metrics.items()}
    cols = {
        "R0": m["R0"], "overall_IFR": m["overall_IFR"],
        "overall_attack_rate": m["overall_attack_rate"],
        "peak_hospital": m["peak_hospital"], "peak_ICU": m["peak_ICU"],
        "time_to_peak_hospital": m["time_to_peak_hospital"],
        "time_to_peak_ICU": m["time_to_peak_ICU"],
        "total_deaths": m["total_deaths"],
        "max_Rt": m["max_Rt"], "min_Rt": m["min_Rt"], "final_Rt": m["final_Rt"],
        "seroprevalence_day64": m["seroprevalence_day64"],
    }
    for age in range(n_ages):
        cols[f"IFR_age_{age}"] = m["IFR_age"][..., age]
        cols[f"IHR_age_{age}"] = m["IHR_age"][..., age]
        cols[f"IICUR_age_{age}"] = m["IICUR_age"][..., age]
        cols[f"AttackRate_age_{age}"] = m["AttackRate_age"][..., age]
    kv = m.get("kappa_values")
    if kv is not None and kv.size:
        for i in range(kv.shape[-1]):
            cols[f"kappa_{i + 1}"] = kv[..., i]
    return cols


def aggregate_batch_metrics(batch_cols: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    """Per-batch mean / median / std / q025 / q975 per metric
    (reference ``aggregateBatchMetrics``, :35-85; exact quantiles here)."""
    out = {}
    for name, v in batch_cols.items():
        if name.startswith("kappa_"):
            continue   # aggregated summary covers the 12+16 metric columns
        v = np.asarray(v, dtype=np.float64).ravel()
        if v.size == 0:
            continue
        out[name] = {
            "mean": float(np.mean(v)),
            "median": float(np.median(v)),
            "std_dev": float(np.std(v)),
            "q025": float(np.quantile(v, 0.025)),
            "q975": float(np.quantile(v, 0.975)),
        }
    return out


def aggregate_all_batches(all_batch_stats: List[Dict[str, Dict[str, float]]]
                          ) -> Dict[str, Dict[str, float]]:
    """Cross-batch pooling (reference ``aggregateAllBatches``, :87-172):
    pooled mean; pooled variance via the law of total variance
    (mean of batch variances + variance of batch means); median of batch
    medians; conservative CI envelope (min of lowers, max of uppers)."""
    if not all_batch_stats:
        return {}
    final = {}
    for name in all_batch_stats[0]:
        means = np.array([b[name]["mean"] for b in all_batch_stats if name in b])
        sds = np.array([b[name]["std_dev"] for b in all_batch_stats if name in b])
        medians = np.array([b[name]["median"] for b in all_batch_stats if name in b])
        q025 = np.array([b[name]["q025"] for b in all_batch_stats if name in b])
        q975 = np.array([b[name]["q975"] for b in all_batch_stats if name in b])
        pooled_mean = float(np.mean(means))
        pooled_var = float(np.mean(sds ** 2) + np.mean((means - pooled_mean) ** 2))
        final[name] = {
            "mean": pooled_mean,
            "std_dev": float(np.sqrt(pooled_var)),
            "median": float(np.median(medians)),
            "q025": float(np.min(q025)),
            "q975": float(np.max(q975)),
        }
    return final


def ene_covid_validation(summary: Dict[str, Dict[str, float]],
                         target_day: float = ENE_COVID_TARGET_DAY,
                         mean: float = ENE_COVID_MEAN,
                         lower: float = ENE_COVID_LOWER,
                         upper: float = ENE_COVID_UPPER) -> Dict[str, float]:
    """Model-vs-ENE-COVID seroprevalence comparison record
    (reference ``performENECOVIDValidation``, :485-518)."""
    out = {"enecovid_mean": mean, "enecovid_lower_ci": lower,
           "enecovid_upper_ci": upper, "target_day": target_day}
    sero = summary.get("seroprevalence_day64")
    if sero:
        out["model_median"] = sero["median"]
        out["model_q025"] = sero["q025"]
        out["model_q975"] = sero["q975"]
        out["within_ci"] = float(lower <= sero["median"] <= upper)
    return out


def trajectory_bands(trajectories: np.ndarray, ts: Sequence[float]
                     ) -> Dict[str, np.ndarray]:
    """Quantile bands of an (n_draws, T) trajectory ensemble
    (reference ``PostCalibrationAnalyser.cpp:303-343``)."""
    qs = np.quantile(np.asarray(trajectories), [0.5, 0.025, 0.975, 0.05, 0.95],
                     axis=0)
    return {"time": np.asarray(ts), "median": qs[0], "q025": qs[1],
            "q975": qs[2], "q05": qs[3], "q95": qs[4]}
