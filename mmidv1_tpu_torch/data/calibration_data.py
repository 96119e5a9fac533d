"""Observed epidemic data loader (processed_data.csv) + synthetic constructor.

Port of ``mmidv1_tpu/data/calibration_data.py``: an immutable host-side
container of NumPy matrices (reference ``include/utils/GetCalibrationData.hpp:30``,
``src/utils/GetCalibrationData.cpp``):

- :meth:`CalibrationData.from_csv`  <- the file constructor (:15-21, :236-401):
  date-range filtering (inclusive string comparison), the hard-coded 4-age-band
  column names, population from the first row. The numbers are parsed in
  bulk by the native C++ IO layer (``utils/native.py``) when it is available,
  by Python otherwise, with the same results.
- :meth:`CalibrationData.from_arrays` <- the in-memory constructor used as the
  test fixture / fake data backend (:24-89): reconstructs cumulative matrices from
  daily incidence + an initial cumulative row.
- :meth:`CalibrationData.initial_sepaihrd_state` delegates to
  :func:`mmidv1_tpu_torch.models.sepaihrd.infer_initial_state` (the
  quasi-steady-state back-inference of :107-234), evaluated on the host in
  float64.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..utils.exceptions import (DataFormatException, FileIOException,
                                ModelException)

AGE_BANDS = ("0_30", "30_60", "60_80", "80_plus")


def _age_cols(prefix: str) -> List[str]:
    return [f"{prefix}_{band}" for band in AGE_BANDS]


@dataclasses.dataclass(frozen=True)
class CalibrationData:
    """Observed daily incidence and cumulative series per age group.

    All matrices have shape ``(T, n_ages)``; rows are days in the selected range.
    """

    new_confirmed: np.ndarray
    new_deaths: np.ndarray
    new_hospitalizations: np.ndarray
    new_icu: np.ndarray
    cumulative_confirmed: np.ndarray
    cumulative_deaths: np.ndarray
    cumulative_hospitalizations: np.ndarray
    cumulative_icu: np.ndarray
    population_by_age: np.ndarray
    dates: tuple

    @property
    def n_data_points(self) -> int:
        return self.new_confirmed.shape[0]

    @property
    def num_age_classes(self) -> int:
        return int(self.population_by_age.size)

    # --- constructors -----------------------------------------------------

    @classmethod
    def from_csv(cls, path: str, start_date: str = "", end_date: str = "",
                 num_age_classes: int = 4) -> "CalibrationData":
        if num_age_classes != len(AGE_BANDS):
            raise DataFormatException(
                "CalibrationData.from_csv",
                f"CSV schema is hard-coded for {len(AGE_BANDS)} age bands")
        try:
            with open(path, "r") as f:
                header = f.readline().strip().split(",")
                rows = [line.strip().split(",") for line in f if line.strip()]
        except OSError as e:
            raise FileIOException("CalibrationData.from_csv",
                                  f"Unable to open file {path}: {e}")

        col = {name: i for i, name in enumerate(header)}

        def idx(name: str) -> int:
            if name not in col:
                raise DataFormatException("CalibrationData.from_csv",
                                          f"Missing required column: {name}")
            return col[name]

        groups = {
            "new_confirmed": [idx(c) for c in _age_cols("new_confirmed")],
            "new_deaths": [idx(c) for c in _age_cols("new_deceased")],
            "new_hosp": [idx(c) for c in _age_cols("new_hospitalized_patients")],
            "new_icu": [idx(c) for c in _age_cols("new_intensive_care_patients")],
            "cum_confirmed": [idx(c) for c in _age_cols("cumulative_confirmed")],
            "cum_deaths": [idx(c) for c in _age_cols("cumulative_deceased")],
            "cum_hosp": [idx(c) for c in _age_cols("cumulative_hospitalized_patients")],
            "cum_icu": [idx(c) for c in _age_cols("cumulative_intensive_care_patients")],
            "population": [idx(c) for c in _age_cols("population")],
        }
        date_idx = idx("date")

        def in_range(date: str) -> bool:
            if start_date and date < start_date:
                return False
            if end_date and date > end_date:
                return False
            return True

        selected = [r for r in rows if in_range(r[date_idx])]
        if not selected:
            raise DataFormatException("CalibrationData.from_csv",
                                      "No data points found in specified date range.")

        # bulk numeric parse through the native C++ IO layer when available
        # (utils/native.py), the pure-Python parse otherwise
        from ..utils import native

        all_cols = sorted({c for cols in groups.values() for c in cols})
        try:
            table = native.read_csv_table(path, all_cols, skip_header=1)
        except ModelException:
            # the native parse reads EVERY row of the file: an error in a row
            # outside the date range must not fail the load (the Python parse
            # below reads only the selected rows)
            table = None
        if table is not None and table.shape[0] == len(rows):
            table = table[np.array([in_range(r[date_idx]) for r in rows])]
            if np.isnan(table).any():
                # the native parser is lenient (a malformed or empty cell is
                # NaN); a selected row must parse strictly, so the Python
                # parse decides (and raises DataFormatException)
                table = None
        else:
            table = None

        def mat(key: str) -> np.ndarray:
            cols = groups[key]
            if table is not None:
                return np.ascontiguousarray(
                    table[:, [all_cols.index(c) for c in cols]])
            try:
                return np.array([[float(r[c]) for c in cols]
                                 for r in selected])
            except (ValueError, IndexError) as e:
                raise DataFormatException(
                    "CalibrationData.from_csv",
                    f"Failed to parse column group {key}: {e}")

        population = np.array([float(selected[0][c]) for c in groups["population"]])
        return cls(
            new_confirmed=mat("new_confirmed"),
            new_deaths=mat("new_deaths"),
            new_hospitalizations=mat("new_hosp"),
            new_icu=mat("new_icu"),
            cumulative_confirmed=mat("cum_confirmed"),
            cumulative_deaths=mat("cum_deaths"),
            cumulative_hospitalizations=mat("cum_hosp"),
            cumulative_icu=mat("cum_icu"),
            population_by_age=population,
            dates=tuple(r[date_idx] for r in selected),
        )

    @classmethod
    def from_arrays(cls, *, new_confirmed, new_hospitalizations, new_icu,
                    new_deaths, population_by_age,
                    initial_cumulative_confirmed=None,
                    initial_cumulative_deaths=None,
                    initial_cumulative_hospitalizations=None,
                    initial_cumulative_icu=None) -> "CalibrationData":
        """Synthetic in-memory constructor (the reference's test fixture,
        ``GetCalibrationData.cpp:24-89``): cumulative series are reconstructed as
        ``cum[0] = initial_row``, ``cum[i] = cum[i-1] + new[i-1]``."""
        new_confirmed = np.asarray(new_confirmed, dtype=np.float64)
        T, A = new_confirmed.shape
        population_by_age = np.asarray(population_by_age, dtype=np.float64)
        if population_by_age.size != A:
            raise DataFormatException("CalibrationData.from_arrays",
                                      "Population vector size mismatch.")

        def check(m, name):
            m = np.asarray(m, dtype=np.float64)
            if m.shape != (T, A):
                raise DataFormatException("CalibrationData.from_arrays",
                                          f"{name} shape mismatch: {m.shape}")
            return m

        new_hospitalizations = check(new_hospitalizations, "new_hospitalizations")
        new_icu = check(new_icu, "new_icu")
        new_deaths = check(new_deaths, "new_deaths")

        def row0(x):
            return (np.zeros(A) if x is None else np.asarray(x, dtype=np.float64))

        def cumulate(new_mat, initial_row):
            cum = np.zeros((T, A))
            cum[0] = initial_row
            for i in range(1, T):
                cum[i] = cum[i - 1] + new_mat[i - 1]
            return cum

        return cls(
            new_confirmed=new_confirmed,
            new_deaths=new_deaths,
            new_hospitalizations=new_hospitalizations,
            new_icu=new_icu,
            cumulative_confirmed=cumulate(new_confirmed, row0(initial_cumulative_confirmed)),
            cumulative_deaths=cumulate(new_deaths, row0(initial_cumulative_deaths)),
            cumulative_hospitalizations=cumulate(
                new_hospitalizations, row0(initial_cumulative_hospitalizations)),
            cumulative_icu=cumulate(new_icu, row0(initial_cumulative_icu)),
            population_by_age=population_by_age,
            dates=tuple(f"mock_date_{i}" for i in range(T)),
        )

    # --- derived quantities ----------------------------------------------

    def initial_active_cases(self) -> np.ndarray:
        if self.cumulative_confirmed.shape[0] == 0:
            raise DataFormatException("CalibrationData.initial_active_cases",
                                      "cumulative_confirmed data is empty")
        return self.cumulative_confirmed[0]

    def initial_sepaihrd_state(self, *, sigma, gamma_p, gamma_A, gamma_I, p, h):
        """Day-0 (11, A) state via quasi-steady-state inference
        (``GetCalibrationData::getInitialSEPAIHRDState``), as float64 NumPy."""
        import torch

        from ..models.sepaihrd import infer_initial_state

        f = lambda x: torch.as_tensor(np.asarray(
            x.detach().cpu() if isinstance(x, torch.Tensor) else x,
            dtype=np.float64))
        state = infer_initial_state(
            N=f(self.population_by_age),
            cumulative_confirmed_day0=f(self.cumulative_confirmed[0]),
            cumulative_deaths_day0=f(self.cumulative_deaths[0]),
            cumulative_hosp_day0=f(self.cumulative_hospitalizations[0]),
            cumulative_icu_day0=f(self.cumulative_icu[0]),
            sigma=f(sigma), gamma_p=f(gamma_p), gamma_A=f(gamma_A),
            gamma_I=f(gamma_I), p=f(p), h=f(h))
        return state.numpy()

    def observed_streams(self):
        """The three observation streams of the SEPAIHRD objective as a stacked
        (3, T, A) array ordered (hospitalizations, icu, deaths)."""
        return np.stack([self.new_hospitalizations, self.new_icu, self.new_deaths])
