"""What the four seroprevalence probes share (``cli/sero_*.py``).

The probes (ports of ``scripts/sero_profile_probe.py``,
``sero_ridge_scan.py``, ``sero_sensitivity.py`` and
``sero_force_profile.py``) ask what ENE-COVID-consistent day-64
seroprevalence costs the Poisson fit of the Spain-2020 streams, and which of
the reference's bounds forbid it. Each evaluates, in float64 and REFLECT on
one box of bounds:

- the Poisson log-likelihood of one point through K1
  (``ops.build_objective_fused``);
- the day-64 seroprevalence, ``calibration/serovalid.make_sero_penalty``'s
  ``sero_of`` (the eager fixed-grid solve);
- the value and gradient of the stream log-likelihood through K2 + K3
  (``ops.build_objective_fused_grad``), alone or plus the ENE-COVID Gaussian
  term (``serovalid.add_sero_term``, autograd through the eager solve), as
  ``cli/serovalid_pipeline.py`` composes them;

and polishes with L-BFGS-B (scipy) in Laplace-whitened coordinates. The
engines are built per box: REFLECT reflects against the box's own bounds.
Boxes: the reference bounds, "B" (the seed amplitude relaxed:
``seed_exposed`` cap 50 -> ``--seed-cap``, ``runup_days`` floor 15 ->
``--runup-lo``) and "C" (B plus the severity floors divided by
``--severity-floor-div``), both from ``serovalid.relax_bounds``.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .common import REPO_ROOT

MAP_TXT = os.path.join(REPO_ROOT, "results", "spain2020",
                       "calibrated_parameters.txt")
LAPLACE = os.path.join(REPO_ROOT, "results", "spain2020", "laplace_mass.npz")


def add_common_args(p: argparse.ArgumentParser, out_name: str) -> None:
    """The arguments every probe has (``--map``, ``--laplace``, the sero
    target, the integrator, ``--out``), and the port's ``--device``."""
    p.add_argument("--map", dest="map_path", default=MAP_TXT)
    p.add_argument("--laplace", default=LAPLACE)
    p.add_argument("--sero-target", type=float, default=0.048)
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5")
    p.add_argument("--out", default=os.path.join(REPO_ROOT, "results",
                                                 out_name))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


class Pipeline:
    """The float64 Spain-2020 pipeline of the probes on ``device``
    (``num_days`` cuts the observation window, for checks; the sero day 64
    must stay inside it)."""

    def __init__(self, *, device="cuda", substeps: int = 4,
                 tableau: str = "dopri5", num_days: Optional[int] = None):
        from ..utils.device import resolve_device
        from .common import load_spain_pipeline

        self.device = resolve_device(device)
        self.pipe = load_spain_pipeline(REPO_ROOT, dtype=torch.float64,
                                        device=self.device, num_days=num_days)
        self.substeps, self.tableau = substeps, tableau
        self.space0 = self.pipe.space
        self.names: List[str] = list(self.space0.names)

    def theta_from_txt(self, path: str) -> np.ndarray:
        """A ``calibrated_parameters.txt``-format file as a float64 theta of
        the calibrated names."""
        from ..data import read_sepaihrd_parameters

        data, base = self.pipe.data, self.pipe.params
        prm = read_sepaihrd_parameters(
            path, 4, N=data.population_by_age,
            M_baseline=base.M_baseline.cpu().numpy(), dtype=torch.float64,
            device=self.device)
        return self.space0.extract(prm).cpu().numpy().astype(np.float64)

    def box(self, variant: str = "reference", *, seed_cap: float = 50000.0,
            runup_lo: float = 5.0, severity_floor_div: float = 10.0) -> "Box":
        """The engines on the reference bounds, or on box "B" / "C"."""
        from ..calibration.serovalid import relax_bounds

        if variant == "reference":
            return Box(self, self.space0)
        div = {"B": 1.0, "C": severity_floor_div}[variant]
        space, _ = relax_bounds(self.space0, seed_cap=seed_cap,
                                runup_lo=runup_lo, severity_floor_div=div)
        return Box(self, space)


class Box:
    """K1, K2 + K3 and the sero term of the pipeline on one box of bounds,
    each on one float64 point given as a NumPy vector."""

    def __init__(self, pl: Pipeline, space):
        from ..calibration.param_space import REFLECT
        from ..ops import build_objective_fused, build_objective_fused_grad

        self.pl, self.space = pl, space
        p = pl.pipe
        self.kw = dict(substeps=pl.substeps, tableau=pl.tableau,
                       constraint_mode=REFLECT, dtype=torch.float64,
                       device=pl.device)
        self.k1 = build_objective_fused(space, p.params, p.data, p.ts,
                                        **self.kw)
        self.stream_vag = build_objective_fused_grad(space, p.params, p.data,
                                                     p.ts, **self.kw)
        self.lo = space.lower.cpu().numpy().astype(np.float64)
        self.hi = space.upper.cpu().numpy().astype(np.float64)
        self._pens: Dict[tuple, Callable] = {}

    def _t(self, th) -> torch.Tensor:
        return torch.as_tensor(np.asarray(th, np.float64),
                               device=self.pl.device)[None]

    def penalty(self, se: float, mean: float):
        """``serovalid.make_sero_penalty`` on this box, one per (se, mean)."""
        from ..calibration.serovalid import make_sero_penalty

        key = (se, mean)
        if key not in self._pens:
            p = self.pl.pipe
            self._pens[key] = make_sero_penalty(
                self.space, p.params, p.data, p.ts, se=se, mean=mean,
                **self.kw)
        return self._pens[key]

    def ll(self, th) -> float:
        """The Poisson log-likelihood through K1."""
        return float(self.k1(self._t(th))[0])

    def sero(self, th) -> float:
        """Day-64 seroprevalence (the fraction ever infected)."""
        with torch.no_grad():
            return float(self.penalty(1.0, 0.0).sero_of(self._t(th))[0])

    def stream_vg(self, th):
        """Value and gradient of the stream log-likelihood (K2 + K3)."""
        v, g = self.stream_vag(self._t(th))
        return float(v[0]), g[0].cpu().numpy()

    def joint_vg(self, se: float, mean: float):
        """``th -> (value, gradient)`` of the streams plus the ENE-COVID
        Gaussian term ``-(sero - mean)^2 / (2 se^2)``."""
        from ..calibration.serovalid import add_sero_term

        vag = add_sero_term(self.stream_vag, self.penalty(se, mean))

        def vg(th):
            v, g = vag(self._t(th))
            return float(v[0]), g[0].cpu().numpy()
        return vg


def laplace_std(path: str) -> np.ndarray:
    """The committed Laplace mass's standard deviations, floored at 1e-12:
    the probes' whitening scale."""
    lap = np.load(path)
    return np.maximum(lap["std"].astype(np.float64), 1e-12)


def polish(vg, th0: np.ndarray, std: np.ndarray, lo: np.ndarray,
           hi: np.ndarray, *, rounds: int = 1, maxiter: int = 200,
           ftol: float = 1e-12, gtol: float = 1e-10, on_round=None):
    """L-BFGS-B on ``-vg`` in the coordinates ``z = (theta - th0) / std``,
    bounded by the box, ``rounds`` restarts each from the last round's ``z``
    (a restart re-seeds the Hessian memory). ``on_round(r, res, theta)`` is
    called after each round; returns ``[(res, theta), ...]``, one a round."""
    from scipy.optimize import minimize

    def neg(z):
        v, g = vg(th0 + z * std)
        return -v, -g * std

    zb = list(zip((lo - th0) / std, (hi - th0) / std))
    z = np.zeros_like(th0)
    out = []
    for r in range(rounds):
        res = minimize(neg, z, jac=True, method="L-BFGS-B", bounds=zb,
                       options={"maxiter": maxiter, "maxcor": 40,
                                "ftol": ftol, "gtol": gtol})
        z = res.x
        th = th0 + z * std
        out.append((res, th))
        if on_round is not None:
            on_round(r, res, th)
    return out


def nudge(th: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``th`` moved 1e-9 of the box's width off any wall, so REFLECT's
    derivative there is clean."""
    width = hi - lo
    return np.clip(th, lo + 1e-9 * width, hi - 1e-9 * width)


def write_json(path: str, results: dict) -> None:
    import json

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
