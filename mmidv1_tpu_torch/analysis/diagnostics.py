"""MCMC convergence diagnostics: split-R-hat and effective sample size.

A copy of ``mmidv1_tpu/analysis/diagnostics.py`` (NumPy and SciPy).

The reference ships NO convergence diagnostics (its single chain is assessed
by eye from the trace CSVs); a production multi-chain framework needs them.
Implementations follow Gelman et al., *Bayesian Data Analysis* 3rd ed.
(split-R-hat, §11.4) and Geyer's initial-monotone-sequence ESS estimator as
used by Stan/ArviZ. Pure NumPy — diagnostics are post-hoc host work.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-R-hat per parameter.

    ``samples``: (n_draws, n_chains, d). Each chain is split in half (2m
    half-chains of length n/2); R-hat = sqrt(((n-1)/n * W + B/n) / W).
    Values near 1.0 (< 1.01 strict, < 1.05 lenient) indicate convergence.
    """
    x = np.asarray(samples, dtype=np.float64)
    n, m, d = x.shape
    half = n // 2
    x = np.concatenate([x[:half], x[half:2 * half]], axis=1)  # (half, 2m, d)
    n, m = x.shape[0], x.shape[1]
    chain_mean = x.mean(axis=0)                    # (2m, d)
    chain_var = x.var(axis=0, ddof=1)              # (2m, d)
    B = n * chain_mean.var(axis=0, ddof=1)         # (d,)
    W = chain_var.mean(axis=0)                     # (d,)
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / W)
    # Chains frozen at distinct (near-)constants drive W to the float-noise
    # floor (~1e-34: the one-ulp error of the mean of n identical values)
    # while B stays finite, producing astronomical ratios that read as bugs
    # in reports. Clip to a ceiling that still says "hugely non-converged";
    # exactly-constant parameters (W == 0 bitwise) report 1.0.
    return np.where(W > 0, np.minimum(rhat, 1e6), 1.0)


def effective_sample_size(samples: np.ndarray, max_lag: int = 200) -> np.ndarray:
    """ESS per parameter — the Stan/ArviZ multi-chain estimator (Vehtari et
    al. 2021 §3.2): rho_t = 1 - (W - s_t) / var_plus with Geyer's initial
    positive + monotone sequence over paired sums. The var_plus coupling
    (between-chain-inflated variance, same quantity as split-R-hat's
    numerator) is what makes chains FROZEN AT DIFFERENT POINTS report a
    small ESS — per-chain-centered autocorrelation alone reads that
    pathology as white noise and returns ~n*m.

    ``samples``: (n_draws, n_chains, d). Returns (d,).
    """
    x = np.asarray(samples, dtype=np.float64)
    n, m, d = x.shape
    max_lag = min(max_lag, n - 1)
    xc = x - x.mean(axis=0, keepdims=True)
    W = x.var(axis=0, ddof=1).mean(axis=0)              # (d,)
    b_over_n = (x.mean(axis=0).var(axis=0, ddof=1)      # (d,) = B/n
                if m > 1 else np.zeros(d))
    var_plus = (n - 1) / n * W + b_over_n
    ess = np.empty(d)
    ess_cap = n * m * np.log10(max(n * m, 10.0))        # Stan's antithetic cap
    for j in range(d):
        if var_plus[j] <= 0:
            ess[j] = n * m
            continue
        # mean within-chain autocovariance, biased (/n) as in Stan
        s = np.empty(max_lag + 1)
        s[0] = (n - 1) / n * W[j]
        for lag in range(1, max_lag + 1):
            s[lag] = np.mean(xc[:-lag, :, j] * xc[lag:, :, j]) * (n - lag) / n
        rho = 1.0 - (W[j] - s) / var_plus[j]
        # Geyer pairs: sum (rho_{2t} + rho_{2t+1}) while positive, monotone
        tau = -1.0
        prev_pair = np.inf
        for t in range(0, max_lag, 2):
            pair = rho[t] + rho[t + 1]
            if pair <= 0:
                break
            pair = min(pair, prev_pair)
            tau += 2.0 * pair
            prev_pair = pair
        ess[j] = min(n * m / max(tau, 1e-12), ess_cap)
    return ess


def _rank_normalize(samples: np.ndarray) -> np.ndarray:
    """Fractional ranks over ALL draws -> inverse-normal transform
    (Vehtari, Gelman, Simpson, Carpenter & Bürkner 2021, eq. 14: z =
    Phi^-1((r - 3/8) / (S + 1/4))). Shape-preserving over (n, m, d)."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    x = np.asarray(samples, dtype=np.float64)
    n, m, d = x.shape
    flat = x.reshape(n * m, d)
    # AVERAGE ranks for ties (eq. 14 uses fractional ranks; MCMC traces are
    # full of exact ties — every rejected proposal repeats the previous draw
    # verbatim — and ordinal ranks would z-score tied draws differently by
    # position)
    ranks = rankdata(flat, method="average", axis=0)
    z = ndtri((ranks - 0.375) / (n * m + 0.25))
    return z.reshape(n, m, d)


def rank_normalized_rhat(samples: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat (Vehtari et al. 2021): max of the bulk
    statistic (split-R-hat of the rank-normal-transformed draws) and the
    tail statistic (same transform of the folded draws |x - median|),
    robust to heavy tails and scale differences that break the classical
    statistic. The production posterior here is a curved heavy-tailed ridge
    (PARITY.md round-2 addendum), exactly the regime the rank version is
    for. Convergence bar: < 1.01 strict / < 1.05 lenient, applied to BOTH
    bulk and tail via the returned max."""
    x = np.asarray(samples, dtype=np.float64)
    bulk = split_rhat(_rank_normalize(x))
    folded = np.abs(x - np.median(x.reshape(-1, x.shape[-1]), axis=0))
    tail = split_rhat(_rank_normalize(folded))
    return np.maximum(bulk, tail)


def summarize(samples: np.ndarray,
              names: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """Per-parameter convergence summary:
    {name: {rhat, rank_rhat, ess, ess_per_draw}} — ``rhat`` is the classical
    split statistic, ``rank_rhat`` the rank-normalized bulk/tail max."""
    rhat = split_rhat(samples)
    rrhat = rank_normalized_rhat(samples)
    ess = effective_sample_size(samples)
    n_total = samples.shape[0] * samples.shape[1]
    return {name: {"rhat": float(rhat[j]), "rank_rhat": float(rrhat[j]),
                   "ess": float(ess[j]),
                   "ess_per_draw": float(ess[j] / n_total)}
            for j, name in enumerate(names)}
