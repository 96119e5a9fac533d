"""Readers/writers for the reference-compatible on-disk configuration formats.

Port of ``mmidv1_tpu/data/config_io.py``. Format-exact re-implementations of ``src/utils/ReadCalibrationConfiguration.cpp``
so the Spain-2020 configuration tree (``data/configuration/*`` in the reference)
runs unchanged:

- :func:`read_sepaihrd_parameters`  <- ``readSEPAIHRDParameters`` (:164-271)
- :func:`read_param_bounds`         <- ``readParamBounds`` (:273-304)
- :func:`read_proposal_sigmas`      <- ``readProposalSigmas`` (:307-338)
- :func:`read_params_to_calibrate`  <- ``readParamsToCalibrate`` (:341-370)
- :func:`read_settings`             <- ``readSettingsFile`` (:373-405) and its four
  wrappers (MCMC / hill climbing / PSO / NUTS)
- :func:`save_calibration_results`  <- ``saveCalibrationResults`` (:51-162), whose
  output round-trips through :func:`read_sepaihrd_parameters` (calibrated params
  carry a trailing ``# [C]`` marker which the reader tolerates).
- :func:`read_scalar_sir_parameters` <- ``loadModelParameters`` of the scalar
  SIR mains (``src/base/main/ModelParameters.cpp:5-36``)
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..params import SEPAIHRDParams, make_params
from ..utils.exceptions import DataFormatException, FileIOException
from ..utils.logging import get_logger


def _clean_lines(path: str, where: str):
    """Yield (line_number, stripped_line) skipping blanks and '#'-led comments."""
    try:
        f = open(path, "r")
    except OSError as e:
        raise FileIOException(where, f"Error opening file: {path}: {e}")
    with f:
        for i, raw in enumerate(f, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            yield i, line


def _parse_values(tokens: List[str]) -> List[float]:
    """Read doubles until the first non-numeric token (istringstream semantics:
    trailing '# [C]' markers terminate parsing silently)."""
    vals: List[float] = []
    for tok in tokens:
        try:
            vals.append(float(tok))
        except ValueError:
            break
    return vals


_SCALAR_FIELDS = {
    "beta", "theta", "sigma", "gamma_p", "gamma_A", "gamma_I", "gamma_H",
    "gamma_ICU", "E0_multiplier", "P0_multiplier", "A0_multiplier",
    "I0_multiplier", "H0_multiplier", "ICU0_multiplier", "R0_multiplier",
    "D0_multiplier", "runup_days", "seed_exposed",
}
_AGE_VECTOR_FIELDS = {"a", "h_infec", "p", "h", "icu", "d_H", "d_ICU", "d_community"}


def read_sepaihrd_parameters_dict(path: str, num_age_classes: int) -> dict:
    """Parse an ``initial_guess.txt``-format file into a plain dict of host values.

    Unknown parameter names are skipped with the same leniency as the reference
    (warning-level, not fatal). ``beta_i``/``kappa_i`` indexed entries are
    assembled into dense schedules by index.
    """
    out: dict = {
        name: np.zeros(num_age_classes) for name in _AGE_VECTOR_FIELDS
    }
    out.update({name: 0.0 for name in _SCALAR_FIELDS})
    out["runup_days"] = 30.0
    out["seed_exposed"] = 10.0
    out["beta_end_times"] = []
    out["kappa_end_times"] = []
    beta_map: Dict[int, float] = {}
    kappa_map: Dict[int, float] = {}

    for ln, line in _clean_lines(path, "read_sepaihrd_parameters"):
        tokens = line.split()
        name, rest = tokens[0], tokens[1:]
        vals = _parse_values(rest)
        if not vals:
            continue
        if name.startswith("beta_") and name != "beta_end_times":
            try:
                beta_map[int(name[5:])] = vals[0]
            except ValueError:
                continue
        elif name.startswith("kappa_") and name != "kappa_end_times":
            try:
                kappa_map[int(name[6:])] = vals[0]
            except ValueError:
                continue
        elif name in ("beta_end_times", "kappa_end_times"):
            out[name] = vals
        elif name in _SCALAR_FIELDS:
            out[name] = vals[0]
        elif name in _AGE_VECTOR_FIELDS:
            if len(vals) != num_age_classes:
                raise DataFormatException(
                    "read_sepaihrd_parameters",
                    f"Incorrect number of values for {name}. Expected "
                    f"{num_age_classes}, got {len(vals)} (line {ln})")
            out[name] = np.asarray(vals)
        # else: unrecognized name, skipped (reference logs a warning)

    def assemble(m: Dict[int, float]) -> list:
        # schedule names are 1-based (beta_1..beta_8); a stray beta_0 /
        # kappa_0 must be skipped with a warning (reference leniency), not
        # written to dense[-1] where it would silently overwrite the LAST
        # schedule value
        bad = [i for i in m if i < 1]
        for i in bad:
            get_logger("config_io").warning(
                f"ignoring schedule index {i} (schedule names are 1-based)")
            m.pop(i)
        if not m:
            return []
        dense = [0.0] * max(m)
        for idx, v in m.items():
            dense[idx - 1] = v
        return dense

    out["beta_values"] = assemble(beta_map)
    out["kappa_values"] = assemble(kappa_map)
    return out


def read_sepaihrd_parameters(path: str, num_age_classes: int, *, N=None,
                             M_baseline=None, dtype=torch.float64,
                             device="cuda") -> SEPAIHRDParams:
    """Read an initial-guess file directly into :class:`SEPAIHRDParams`.

    ``N`` / ``M_baseline`` are not part of the file format (the reference fills
    them from CalibrationData / contacts.csv after parsing, ``main.cpp:218-220``);
    placeholders of ones are used when not supplied.
    """
    d = read_sepaihrd_parameters_dict(path, num_age_classes)
    if N is None:
        N = np.ones(num_age_classes)
    if M_baseline is None:
        M_baseline = np.eye(num_age_classes)
    return make_params(
        N=N, M_baseline=M_baseline, beta=d["beta"],
        beta_end_times=d["beta_end_times"], beta_values=d["beta_values"],
        kappa_end_times=d["kappa_end_times"], kappa_values=d["kappa_values"],
        a=d["a"], h_infec=d["h_infec"], theta=d["theta"], sigma=d["sigma"],
        gamma_p=d["gamma_p"], gamma_A=d["gamma_A"], gamma_I=d["gamma_I"],
        gamma_H=d["gamma_H"], gamma_ICU=d["gamma_ICU"], p=d["p"], h=d["h"],
        icu=d["icu"], d_H=d["d_H"], d_ICU=d["d_ICU"],
        d_community=d["d_community"],
        E0_multiplier=d["E0_multiplier"], P0_multiplier=d["P0_multiplier"],
        A0_multiplier=d["A0_multiplier"], I0_multiplier=d["I0_multiplier"],
        H0_multiplier=d["H0_multiplier"], ICU0_multiplier=d["ICU0_multiplier"],
        R0_multiplier=d["R0_multiplier"], D0_multiplier=d["D0_multiplier"],
        runup_days=d["runup_days"], seed_exposed=d["seed_exposed"], dtype=dtype,
        device=device)


def read_param_bounds(path: str) -> Dict[str, Tuple[float, float]]:
    """``name low high`` per line; strict 3-token format."""
    bounds: Dict[str, Tuple[float, float]] = {}
    for ln, line in _clean_lines(path, "read_param_bounds"):
        tokens = line.split()
        if len(tokens) != 3:
            raise DataFormatException("read_param_bounds",
                                      f"Invalid line in bounds file (line {ln}): {line}")
        try:
            bounds[tokens[0]] = (float(tokens[1]), float(tokens[2]))
        except ValueError:
            raise DataFormatException("read_param_bounds",
                                      f"Invalid line in bounds file (line {ln}): {line}")
    return bounds


def read_proposal_sigmas(path: str) -> Dict[str, float]:
    """``name sigma`` per line; strict 2-token format."""
    sigmas: Dict[str, float] = {}
    for ln, line in _clean_lines(path, "read_proposal_sigmas"):
        tokens = line.split()
        if len(tokens) != 2:
            raise DataFormatException(
                "read_proposal_sigmas",
                f"Invalid line in proposal sigmas file (line {ln}): {line}")
        try:
            sigmas[tokens[0]] = float(tokens[1])
        except ValueError:
            raise DataFormatException(
                "read_proposal_sigmas",
                f"Invalid line in proposal sigmas file (line {ln}): {line}")
    return sigmas


def read_params_to_calibrate(path: str) -> List[str]:
    """One parameter name per line (extra tokens ignored with a warning upstream)."""
    names: List[str] = []
    for _ln, line in _clean_lines(path, "read_params_to_calibrate"):
        names.append(line.split()[0])
    return names


def read_settings(path: str) -> Dict[str, float]:
    """``name value`` per line; booleans are 0.0/1.0 (reference convention)."""
    settings: Dict[str, float] = {}
    for ln, line in _clean_lines(path, "read_settings"):
        tokens = line.split()
        if len(tokens) != 2:
            raise DataFormatException("read_settings",
                                      f"Invalid line in settings file (line {ln}): {line}")
        try:
            settings[tokens[0]] = float(tokens[1])
        except ValueError:
            raise DataFormatException("read_settings",
                                      f"Invalid line in settings file (line {ln}): {line}")
    return settings


# Wrappers retaining the reference's four entry points
read_metropolis_hastings_settings = read_settings
read_hill_climbing_settings = read_settings
read_particle_swarm_settings = read_settings
read_nuts_settings = read_settings


def save_calibration_results(path: str, params: SEPAIHRDParams,
                             calibrated_names: List[str], obj_value: float,
                             timestamp: str = "") -> None:
    """Write calibrated parameters in the re-loadable initial-guess format
    (reference ``saveCalibrationResults``); this doubles as the manual
    checkpoint/resume path, matching SURVEY.md section 5."""
    if not timestamp:
        timestamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    cal = set(calibrated_names)
    p = params.to_numpy()

    lines: List[str] = []
    lines.append("# Calibrated SEPAIHRD Model Parameters")
    lines.append(f"# Calibration completed: {timestamp}")
    lines.append(f"# Best objective function value: {obj_value:.8e}")
    lines.append("# Calibrated parameters are marked with [C] if they were part of the calibration set.")
    lines.append("")
    lines.append("# --- Transmission Parameters ---")

    def scalar(name: str, value: float):
        mark = " # [C]" if name in cal else ""
        lines.append(f"{name} {float(value):.8e}{mark}")

    if p["beta_end_times"].size:
        lines.append("beta_end_times " + " ".join(f"{t:.1f}" for t in p["beta_end_times"]))
        for i, v in enumerate(p["beta_values"]):
            scalar(f"beta_{i + 1}", v)
    scalar("beta", p["beta"])
    scalar("theta", p["theta"])

    lines.append("")
    lines.append("# --- Disease Progression Rates ---")
    for name in ("sigma", "gamma_p", "gamma_A", "gamma_I", "gamma_H", "gamma_ICU"):
        scalar(name, p[name])

    lines.append("")
    lines.append("# --- Age-specific Parameters ---")

    def age_vector(name: str, values: np.ndarray):
        body = " ".join(f"{v:.8e}" for v in values)
        any_cal = any(f"{name}_{i}" in cal for i in range(values.size))
        mark = " # [C]" if any_cal else ""
        lines.append(f"{name} {body}{mark}")

    for name in ("p", "a", "h_infec", "h", "icu", "d_H", "d_ICU", "d_community"):
        age_vector(name, p[name])

    lines.append("")
    lines.append("# --- Initial State Multipliers ---")
    for name in ("E0_multiplier", "P0_multiplier", "A0_multiplier", "I0_multiplier",
                 "H0_multiplier", "ICU0_multiplier", "R0_multiplier", "D0_multiplier",
                 "runup_days", "seed_exposed"):
        scalar(name, p[name])

    lines.append("")
    lines.append("# --- NPI Strategy Parameters ---")
    if p["kappa_end_times"].size:
        lines.append("kappa_end_times " + " ".join(f"{t:.1f}" for t in p["kappa_end_times"]))
        for i, v in enumerate(p["kappa_values"]):
            scalar(f"kappa_{i + 1}", v)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_scalar_sir_parameters(path: str) -> Dict[str, float]:
    """``input_parameters.txt`` loader for the scalar SIR mains.

    Reference: ``loadModelParameters`` (``src/base/main/ModelParameters.cpp:5-36``):
    ``key value`` lines, '#' and '//' comments skipped, unknown keys ignored.
    Returns the reference's defaults overlaid with the file's values.
    """
    out: Dict[str, float] = {
        "N": 1000.0, "beta": 0.4, "gamma": 0.04, "S0": 999.0, "I0": 1.0,
        "R0": 0.0, "t_start": 0.0, "t_end": 360.0, "h": 0.01, "eps": 1e-6,
        "numSimulations": 100.0, "B": 0.02, "mu": 0.01,
    }
    try:
        f = open(path, "r")
    except OSError as e:
        raise FileIOException("read_scalar_sir_parameters",
                              f"Could not load model parameters from {path}: {e}")
    with f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            tokens = line.split()
            if len(tokens) < 2 or tokens[0] not in out:
                continue
            try:
                out[tokens[0]] = float(tokens[1])
            except ValueError:
                continue
    return out
