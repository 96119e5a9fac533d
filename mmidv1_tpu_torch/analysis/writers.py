"""Analysis output tree writers — format-compatible with the reference.

A copy of ``mmidv1_tpu/analysis/writers.py``: every format string is the
same, so both packages write the same bytes for the same numbers.

Re-design of ``AnalysisWriter`` (reference: ``src/model/AnalysisWriter.cpp``).
File names, directory layout, headers, and column orders match the reference's
output tree exactly, so ``scripts/model/PostCalibrationAnalysis.py`` (the
reference's plotting layer) can consume these outputs unchanged:

    <out>/posterior_predictive/{stream}_{median,lower90,upper90,lower95,upper95,observed}.csv
    <out>/parameter_posteriors/{posterior_samples,posterior_summary}.csv
    <out>/mcmc_batches/batch_<i>.csv
    <out>/mcmc_aggregated/metrics_summary.csv
    <out>/rt_trajectories/Rt_aggregated_with_uncertainty.csv
    <out>/seroprevalence/{ene_covid_validation,seroprevalence_trajectory}.csv
    <out>/scenarios/scenario_comparison.csv

The reference runs a dedicated I/O worker thread with a task queue
(``AnalysisWriter.cpp:13-98``); :class:`AsyncWriter` keeps that capability (a
daemon thread + queue so CSV emission never blocks device work), with a
synchronous default for simple use.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Sequence

import numpy as np


def _ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def write_matrix_csv(path: str, time_points: Sequence[float],
                     matrix: np.ndarray, col_prefix: str = "age_") -> None:
    """``time,age_0,age_1,...`` rows (reference ``:284-330``)."""
    matrix = np.asarray(matrix)
    _ensure_dir(os.path.dirname(os.path.abspath(path)))
    with open(path, "w") as f:
        f.write("time" + "".join(f",{col_prefix}{a}"
                                 for a in range(matrix.shape[1])) + "\n")
        for t, row in zip(time_points, matrix):
            f.write(f"{t:g}" + "".join(f",{v:.6f}" for v in row) + "\n")


def write_posterior_predictive(out_dir: str,
                               ppc: Dict[str, Dict[str, np.ndarray]]) -> None:
    """One CSV per (stream, band) as in ``writePosteriorPredictiveData``."""
    _ensure_dir(out_dir)
    for stream, bands in ppc.items():
        ts = bands["time"]
        for band in ("median", "lower90", "upper90", "lower95", "upper95",
                     "observed"):
            write_matrix_csv(os.path.join(out_dir, f"{stream}_{band}.csv"),
                             ts, bands[band])


def write_parameter_posteriors(out_dir: str, samples: np.ndarray,
                               names: Sequence[str], burn_in: int = 0,
                               thinning: int = 1) -> None:
    """posterior_samples.csv + posterior_summary.csv
    (reference ``writeParameterPosteriors``, :201-282)."""
    _ensure_dir(out_dir)
    samples = np.asarray(samples)
    if samples.ndim == 3:                     # (n_stored, B, d) ensemble
        # iteration-axis burn-in/thinning BEFORE flattening (afterwards the
        # stride would select a fixed chain subset whenever it shares a
        # factor with B)
        samples = samples[burn_in::max(1, thinning)]
        sel = samples.reshape(-1, samples.shape[-1])
    else:
        sel = samples[burn_in::max(1, thinning)]

    with open(os.path.join(out_dir, "posterior_samples.csv"), "w") as f:
        f.write("sample_index," + ",".join(names) + "\n")
        for i, row in enumerate(sel):
            f.write(str(i) + "".join(f",{v:.8e}" for v in row) + "\n")

    with open(os.path.join(out_dir, "posterior_summary.csv"), "w") as f:
        f.write("parameter,mean,median,std_dev,lower_95_ci,upper_95_ci\n")
        for j, name in enumerate(names):
            v = sel[:, j]
            f.write(f"{name},{np.mean(v):.8f},{np.median(v):.8f},"
                    f"{np.std(v):.8f},{np.quantile(v, 0.025):.8f},"
                    f"{np.quantile(v, 0.975):.8f}\n")


_METRIC_ORDER = ["R0", "overall_IFR", "overall_attack_rate", "peak_hospital",
                 "peak_ICU", "time_to_peak_hospital", "time_to_peak_ICU",
                 "total_deaths", "max_Rt", "min_Rt", "final_Rt",
                 "seroprevalence_day64"]


def write_batch_metrics(path: str, cols: Dict[str, np.ndarray],
                        n_ages: int) -> None:
    """One row per posterior sample (reference ``writeBatchMetrics``,
    :348-404). ``cols`` is the output of
    :func:`mmidv1_tpu_torch.analysis.aggregate.metric_table` with batched values."""
    _ensure_dir(os.path.dirname(os.path.abspath(path)))
    names = list(_METRIC_ORDER)
    for age in range(n_ages):
        names += [f"IFR_age_{age}", f"IHR_age_{age}", f"IICUR_age_{age}",
                  f"AttackRate_age_{age}"]
    names += sorted((k for k in cols if k.startswith("kappa_")),
                    key=lambda s: int(s.split("_")[1]))
    n = len(np.atleast_1d(cols[names[0]]))
    with open(path, "w") as f:
        f.write("sample_idx," + ",".join(names) + "\n")
        for i in range(n):
            f.write(str(i) + "".join(
                f",{float(np.atleast_1d(cols[k])[i]):g}" for k in names) + "\n")


def write_aggregated_summary(path: str,
                             summary: Dict[str, Dict[str, float]]) -> None:
    """metric,mean,median,std_dev,q025,q975 (reference :407-444)."""
    _ensure_dir(os.path.dirname(os.path.abspath(path)))
    with open(path, "w") as f:
        f.write("metric,mean,median,std_dev,q025,q975\n")
        for name in sorted(summary):
            s = summary[name]
            f.write(f"{name},{s['mean']:.8f},{s['median']:.8f},"
                    f"{s['std_dev']:.8f},{s['q025']:.8f},{s['q975']:.8f}\n")


def write_scenario_comparison(path: str,
                              scenarios: List[tuple]) -> None:
    """scenario rows (reference ``writeScenarioComparison``, :447-489).
    ``scenarios``: list of (name, metric_cols) with scalar values."""
    _ensure_dir(os.path.dirname(os.path.abspath(path)))
    base = ["R0", "overall_IFR", "overall_attack_rate", "peak_hospital",
            "peak_ICU", "time_to_peak_hospital", "time_to_peak_ICU",
            "total_deaths", "seroprevalence_day64"]
    kappa_names = []
    if scenarios:
        kappa_names = sorted((k for k in scenarios[0][1] if
                              k.startswith("kappa_")),
                             key=lambda s: int(s.split("_")[1]))
    with open(path, "w") as f:
        f.write("scenario," + ",".join(base + kappa_names) + "\n")
        for name, cols in scenarios:
            f.write(name + "".join(f",{float(cols[k]):g}"
                                   for k in base + kappa_names) + "\n")


def write_ene_covid_validation(path: str, data: Dict[str, float]) -> None:
    """Model-vs-study rows (reference ``writeEneCovidValidation``, :492-523)."""
    _ensure_dir(os.path.dirname(os.path.abspath(path)))
    with open(path, "w") as f:
        f.write("source,median_seroprevalence,lower_95ci,upper_95ci,target_day\n")
        if "model_median" in data:
            f.write(f"Model,{data['model_median']:.5f},{data['model_q025']:.5f},"
                    f"{data['model_q975']:.5f},{data['target_day']:g}\n")
        f.write(f"ENE_COVID,{data['enecovid_mean']:.5f},"
                f"{data['enecovid_lower_ci']:.5f},"
                f"{data['enecovid_upper_ci']:.5f},{data['target_day']:g}\n")


def write_aggregated_trajectory(path: str, bands: Dict[str, np.ndarray]) -> None:
    """time,median,q025,q975,q05,q95 (reference :526-540)."""
    _ensure_dir(os.path.dirname(os.path.abspath(path)))
    with open(path, "w") as f:
        f.write("time,median,q025,q975,q05,q95\n")
        for i, t in enumerate(bands["time"]):
            f.write(f"{t:g},{bands['median'][i]:.6f},{bands['q025'][i]:.6f},"
                    f"{bands['q975'][i]:.6f},{bands['q05'][i]:.6f},"
                    f"{bands['q95'][i]:.6f}\n")


class AsyncWriter:
    """Queue + worker-thread writer (the reference's async I/O design,
    ``AnalysisWriter.cpp:13-98``): ``submit`` enqueues any of the module's
    write functions; ``wait_for_completion`` is the barrier."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @property
    def errors(self) -> list:
        """Exceptions raised by failed write tasks (empty on success)."""
        return list(self._errors)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                break
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — a failed write must not
                # kill the worker (wait_for_completion would hang forever);
                # record and keep draining, mirroring the reference's
                # log-and-continue error handling (AnalysisWriter.cpp:68-80).
                self._errors.append(e)
                from ..utils.logging import get_logger

                get_logger("AsyncWriter").error(
                    f"write task failed: {type(e).__name__}: {e}")
            finally:
                self._q.task_done()

    def submit(self, fn, *args, **kwargs) -> None:
        self._q.put((fn, args, kwargs))

    def wait_for_completion(self) -> None:
        self._q.join()

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()
