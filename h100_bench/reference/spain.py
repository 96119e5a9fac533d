"""The plain reference of the Spain-2020 SEPAIHRD objective.

Written from the model's equations and the data files alone, in plain
PyTorch (any device, float64 by default), with no import of the measured
program: it parses the configuration tree itself, applies the calibrated
parameters, builds the run-up seeded (or multiplier-scaled) initial state,
integrates every day on the fixed grid with the stated tableau (the
accumulator rows D, CumH, CumICU reset at the start of each day) and sums
the three Poisson streams (deaths, hospital and ICU admissions, 4 age
groups). Gradients come from ``torch.autograd`` through all of it.

``bounds_dtype`` rounds the parameter box to the configuration's type.
``tf32=True`` is the control: the same arithmetic in float32 with the
contact product's inputs rounded to TF32 (10 explicit mantissa bits), as a
TF32 matrix product would round them.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

POISSON_EPSILON = 1e-10
MIN_POPULATION = 1e-9
AGE_BANDS = ("0_30", "30_60", "60_80", "80_plus")

# Butcher tableaus (c is not needed: the right-hand side is autonomous
# within a day, whose schedule factor is frozen at the day's midpoint)
TABLEAUS = {
    "dopri5": (
        [[], [1 / 5], [3 / 40, 9 / 40], [44 / 45, -56 / 15, 32 / 9],
         [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
         [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
         [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]],
        [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]),
    "cash_karp": (
        [[], [1 / 5], [3 / 40, 9 / 40], [3 / 10, -9 / 10, 6 / 5],
         [-11 / 54, 5 / 2, -70 / 27, 35 / 27],
         [1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096]],
        [37 / 378, 0, 250 / 621, 125 / 594, 0, 512 / 1771]),
    "rk4": ([[], [1 / 2], [0, 1 / 2], [0, 0, 1]], [1 / 6, 1 / 3, 1 / 3, 1 / 6]),
}

SCALARS = ("beta", "theta", "sigma", "gamma_p", "gamma_A", "gamma_I",
           "gamma_H", "gamma_ICU", "E0_multiplier", "P0_multiplier",
           "A0_multiplier", "I0_multiplier", "H0_multiplier",
           "ICU0_multiplier", "R0_multiplier", "D0_multiplier",
           "seed_exposed", "runup_days")
VECTORS = ("a", "h_infec", "p", "h", "icu", "d_H", "d_ICU", "d_community")
# compartments of the state (B, 11, 4)
S, E, P, A, I, H, ICU, R, D, CUMH, CUMICU = range(11)
DAY_ROWS = [D, CUMH, CUMICU]          # reset each day; their value is the incidence


def _lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                yield line.split()


def read_params(path: str) -> dict:
    """A parameter file (``name v1 [v2 ...]`` per line) as a dict; indexed
    ``beta_i`` / ``kappa_i`` entries assembled into schedules."""
    out: dict = {n: 0.0 for n in SCALARS}
    out.update({n: np.zeros(4) for n in VECTORS})
    out.update(runup_days=30.0, seed_exposed=10.0, beta_end_times=[],
               kappa_end_times=[])
    sched: Dict[str, Dict[int, float]] = {"beta": {}, "kappa": {}}
    for tok in _lines(path):
        name, vals = tok[0], [float(v) for v in tok[1:]]
        if not vals:
            continue
        if name in ("beta_end_times", "kappa_end_times"):
            out[name] = vals
        elif name.split("_")[0] in sched and name[len(name.split("_")[0]) + 1:].isdigit():
            sched[name.split("_")[0]][int(name.split("_")[1])] = vals[0]
        elif name in SCALARS:
            out[name] = vals[0]
        elif name in VECTORS:
            out[name] = np.asarray(vals)
    for key, m in sched.items():
        dense = [0.0] * (max(m) if m else 0)
        for i, v in m.items():
            dense[i - 1] = v
        out[f"{key}_values"] = dense
    return out


def read_data(path: str, start: str, end: str) -> dict:
    """``processed_data.csv``: the three observed streams and day-0
    cumulative rows by age over ``[start, end]``, population by age."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = [ln.strip().split(",") for ln in f if ln.strip()]
    col = {n: i for i, n in enumerate(header)}
    rows = [r for r in rows if start <= r[col["date"]] <= end]
    mat = lambda prefix: np.array([[float(r[col[f"{prefix}_{b}"]]) for b in AGE_BANDS]
                                   for r in rows])
    return dict(deaths=mat("new_deceased"), hosp=mat("new_hospitalized_patients"),
                icu=mat("new_intensive_care_patients"),
                cum_confirmed=mat("cumulative_confirmed")[0],
                cum_deaths=mat("cumulative_deceased")[0],
                cum_hosp=mat("cumulative_hospitalized_patients")[0],
                cum_icu=mat("cumulative_intensive_care_patients")[0],
                N=mat("population")[0])


def inferred_state(data: dict, prm: dict) -> np.ndarray:
    """The data-inferred day-0 state ``(11, 4)`` the multiplier branch
    scales (quasi-steady state back from day-0 cumulative counts, with the
    population budget clamped in the order D, ICU, H, I, R)."""
    N = data["N"]
    pos = lambda x: np.maximum(x, 0.0)
    D0, H0, ICU0 = pos(data["cum_deaths"]), pos(data["cum_hosp"]), pos(data["cum_icu"])
    CumH0, CumICU0 = H0.copy(), ICU0.copy()
    I0 = pos(data["cum_confirmed"] - D0)
    p = np.clip(prm["p"], 0.0, 1.0)
    gp, gA, gI, sg = prm["gamma_p"], prm["gamma_A"], prm["gamma_I"], prm["sigma"]
    P0 = I0 * gI / ((1 - p) * gp) if gp > 1e-9 else I0.copy()
    P0 = np.where(1 - p > 1e-9, P0, I0)
    A0 = P0 * p * gp / gA if gA > 1e-9 else P0 * p
    E0 = P0 * gp / sg if sg > 1e-9 else P0.copy()
    E0, P0, A0 = pos(E0), pos(P0), pos(A0)
    R0 = np.zeros(4)
    D0 = np.minimum(D0, N)
    ICU0 = np.minimum(ICU0, pos(N - D0))
    H0 = np.minimum(H0, pos(N - D0 - ICU0))
    I0 = np.minimum(I0, pos(N - D0 - ICU0 - H0))
    R0 = np.minimum(R0, pos(N - D0 - ICU0 - H0 - I0))
    avail = pos(N - (I0 + H0 + ICU0 + R0 + D0))
    tot = E0 + P0 + A0
    scale = np.where(tot > avail, np.where(tot > 1e-9, avail / np.where(tot > 1e-9, tot, 1.0), 0.0), 1.0)
    E0, P0, A0 = E0 * scale, P0 * scale, A0 * scale
    S0 = pos(N - (E0 + P0 + A0 + I0 + H0 + ICU0 + R0 + D0))
    return np.stack([S0, E0, P0, A0, I0, H0, ICU0, R0, D0, CumH0, CumICU0])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest (ties away), as the tensor cores read a TF32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class SpainReference:
    """The objective ``loglik(theta (B, d)) -> (B,)`` of a configuration
    tree, in ``dtype`` on ``device``; ``tf32`` makes it the control."""

    def __init__(self, root: str, *, tableau: str, substeps: int,
                 num_days: int = None, dtype=torch.float64, device="cpu",
                 tf32: bool = False, bounds_dtype=np.float64,
                 start_date: str = "2020-03-01", end_date: str = "2020-12-31"):
        cfg = os.path.join(root, "configuration")
        self.base = read_params(os.path.join(cfg, "initial_guess.txt"))
        self.names: List[str] = [t[0] for t in _lines(
            os.path.join(cfg, "params_to_calibrate.txt"))]
        bounds = {t[0]: (float(t[1]), float(t[2]))
                  for t in _lines(os.path.join(cfg, "param_bounds.txt"))}
        # the box as the configuration's type holds it: a state on a bound
        # is on the same side of it as in the program
        lo = np.array([bounds[n][0] for n in self.names]).astype(bounds_dtype)
        hi = np.array([bounds[n][1] for n in self.names]).astype(bounds_dtype)
        self.data = read_data(os.path.join(root, "processed", "processed_data.csv"),
                              start_date, end_date)
        if num_days is not None:
            for k in ("deaths", "hosp", "icu"):
                self.data[k] = self.data[k][:num_days]
        self.M = np.array([[float(v) for v in ln.split(",")]
                           for ln in open(os.path.join(root, "contacts.csv"))
                           if ln.strip()])[:4, :4]
        self.dtype, self.device, self.tf32 = dtype, torch.device(device), tf32
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            self.device, dtype)
        self.lo, self.hi = t(np.minimum(lo, hi)), t(np.maximum(lo, hi))
        self.tableau, self.substeps = TABLEAUS[tableau], int(substeps)
        self.n_obs = self.data["deaths"].shape[0]
        self.runup = int(self.base["runup_days"])     # the grid's fixed run-up
        self.n_days = self.runup + self.n_obs - 1     # daily intervals of the grid
        obs = np.stack([self.data["deaths"], self.data["hosp"], self.data["icu"]], 1)
        valid = np.isfinite(obs) & (obs >= 0)
        self.obs, self.valid = t(np.where(valid, obs, 0.0)), t(valid)
        self.N, self.Mt = t(self.data["N"]), t(self.M)
        self.base_y0 = t(inferred_state(self.data, self.base))
        self.t = t

    # ------------------------------------------------------------------
    def reflect(self, theta):
        lo, hi = self.lo, self.hi
        w = hi - lo
        deg = w <= 0
        w = torch.where(deg, torch.ones_like(w), w)
        y = torch.remainder(theta - lo, 2.0 * w)
        y = torch.where(y < 0, y + 2.0 * w, y)
        return torch.where(deg, lo, torch.where(y <= w, lo + y, hi - (y - w)))

    def apply(self, theta) -> dict:
        """Per-chain parameters: scalars ``(B,)``, age vectors ``(B, 4)``,
        schedules ``(B, K)``."""
        B = theta.shape[0]
        prm = {}
        for n in SCALARS:
            prm[n] = self.t(self.base[n]).expand(B).clone()
        for n in VECTORS:
            prm[n] = self.t(self.base[n]).expand(B, 4).clone()
        for n in ("beta_values", "kappa_values"):
            prm[n] = self.t(self.base[n]).expand(B, len(self.base[n])).clone()
        for j, name in enumerate(self.names):
            col = theta[:, j]
            head, _, tail = name.rpartition("_")
            if name in SCALARS:
                prm[name] = col
            elif head in ("beta", "kappa") and tail.isdigit():
                v = prm[f"{head}_values"].clone()
                v[:, int(tail) - 1] = col
                prm[f"{head}_values"] = v
            elif head in VECTORS and tail.isdigit():
                v = prm[head].clone()
                v[:, int(tail)] = col
                prm[head] = v
            else:
                raise ValueError(f"unknown calibrated name {name!r}")
        return prm

    def initial_state(self, prm):
        """``(y0 (B, 11, 4), infeasible (B,))``."""
        N = self.N
        B = prm["seed_exposed"].shape[0]
        frac = N / N.sum()
        E0 = prm["seed_exposed"][:, None] * frac
        seeded = torch.zeros(B, 11, 4, dtype=self.dtype, device=self.device)
        seeded = seeded.index_copy(1, torch.tensor([S, E], device=self.device),
                                   torch.stack([N - E0, E0], 1))
        mult = torch.stack([prm[f"{c}0_multiplier"] for c in
                            ("E", "P", "A", "I", "H", "ICU", "R", "D")], 1)
        scaled_rows = self.base_y0[E:D + 1] * mult[:, :, None]
        non_s = scaled_rows.sum(1)
        scaled = torch.cat([(N - non_s)[:, None], scaled_rows,
                            self.base_y0[D + 1:].expand(B, 2, 4)], 1)
        use_seed = (prm["runup_days"] > 0) & (prm["seed_exposed"] > 0)
        y0 = torch.where(use_seed[:, None, None], seeded, scaled)
        bad_seed = torch.any(seeded[:, E:D + 1].sum(1) > N, -1)
        bad_mult = torch.any(non_s > N, -1)
        return y0, torch.where(use_seed, bad_seed, bad_mult)

    def day_beta(self, prm):
        """``beta(t) kappa(t)`` of every day at its midpoint, ``(n_days, B)``:
        the first schedule period whose end is at or after it, the last one
        past every end."""
        mids = np.arange(self.n_days) - self.runup + 0.5
        cols = []
        for key in ("beta", "kappa"):
            ends = np.asarray(self.base[f"{key}_end_times"], dtype=np.float64)
            vals = prm[f"{key}_values"]
            K = vals.shape[1]
            if K == 0:
                cols.append(prm["beta"][None, :].expand(self.n_days, -1)
                            if key == "beta" else torch.ones_like(prm["beta"])[None, :])
                continue
            idx = np.minimum(np.searchsorted(ends, mids, side="left"), K - 1)
            cols.append(vals[:, torch.as_tensor(idx, device=self.device)].T)
        return cols[0] * cols[1]

    def rhs(self, y, prm, beta):
        """d/dt of the state ``(B, 11, 4)`` at the frozen ``beta (B,)``."""
        Sx, Ex, Px, Ax, Ix, Hx, Ux = (y[:, k] for k in range(7))
        col = lambda n: prm[n][:, None]
        inv_n = torch.where(self.N > MIN_POPULATION, 1.0 / self.N, torch.zeros_like(self.N))
        press = (Px + Ax + col("theta") * Ix) * prm["h_infec"] * inv_n
        M = self.Mt
        if self.tf32:
            press, M = _tf32(press), _tf32(M)
        lam = torch.clamp_min(beta[:, None] * prm["a"] * (press @ M.T), 0.0)
        fSE, fEP, fP = lam * Sx, col("sigma") * Ex, col("gamma_p") * Px
        fPA = prm["p"] * fP
        fIH, fHU = prm["h"] * Ix, prm["icu"] * Hx
        fHD, fUD, fID = prm["d_H"] * Hx, prm["d_ICU"] * Ux, prm["d_community"] * Ix
        return torch.stack([
            -fSE, fSE - fEP, fEP - fP, fPA - col("gamma_A") * Ax,
            fP - fPA - (col("gamma_I") + prm["h"] + prm["d_community"]) * Ix,
            fIH - (col("gamma_H") * Hx + fHD + fHU),
            fHU - (col("gamma_ICU") * Ux + fUD),
            col("gamma_A") * Ax + col("gamma_I") * Ix + col("gamma_H") * Hx
            + col("gamma_ICU") * Ux,
            fHD + fUD + fID, fIH, fHU], 1)

    def loglik(self, theta: torch.Tensor) -> torch.Tensor:
        """``(B,)`` log-likelihoods of raw (unreflected) parameters; NaN
        where the initial state is infeasible or the solve is not finite."""
        theta = self.reflect(theta.to(self.device, self.dtype))
        prm = self.apply(theta)
        y, bad = self.initial_state(prm)
        beff = self.day_beta(prm)
        a_rows, b = self.tableau
        h = 1.0 / self.substeps
        ll = torch.zeros(theta.shape[0], dtype=self.dtype, device=self.device)
        keep = torch.ones(11, 1, dtype=self.dtype, device=self.device)
        keep[DAY_ROWS] = 0.0
        if self.runup == 0:
            ll = ll + self._poisson(0, torch.zeros_like(y[:, DAY_ROWS]))
        for day in range(self.n_days):
            y = y * keep
            for _ in range(self.substeps):
                ks = []
                for row in a_rows:
                    yi = y
                    for aij, kj in zip(row, ks):
                        if aij:
                            yi = yi + (h * aij) * kj
                    ks.append(self.rhs(yi, prm, beff[day]))
                y = y + sum((h * bi) * ki for bi, ki in zip(b, ks) if bi)
            j = day + 1 - self.runup
            if 0 <= j < self.n_obs:
                ll = ll + self._poisson(j, torch.clamp_min(y[:, DAY_ROWS], 0.0))
        nan = torch.full_like(ll, math.nan)
        return torch.where(bad | ~torch.isfinite(ll), nan, ll)

    def _poisson(self, j, inc):
        inc = inc + POISSON_EPSILON
        return torch.sum(self.obs[j] * torch.log(inc) - self.valid[j] * inc, (1, 2))
