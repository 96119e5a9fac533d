"""Contact-matrix CSV reader with the reference's strict error taxonomy.

Re-implements ``epidemic::readMatrixFromCSV``
(reference: ``src/utils/ReadContactMatrix.cpp:8-83``): an R x C matrix of doubles,
``//``-prefixed leading comment lines skipped, empty interior lines skipped,
typed errors for missing file / too few rows / too few columns / bad numbers.
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import CSVReadError, CSVReadException

_WHERE = "read_matrix_from_csv"


def read_matrix_from_csv(path: str, rows: int, cols: int) -> np.ndarray:
    try:
        f = open(path, "r")
    except OSError:
        raise CSVReadException(CSVReadError.FILE_OPEN, _WHERE, path)

    with f:
        lines = f.read().splitlines()

    # Skip leading '//' comment lines (reference :22-29)
    idx = 0
    while idx < len(lines) and lines[idx].startswith("//"):
        idx += 1
    data_lines = []
    for line in lines[idx:]:
        if line == "":
            continue  # empty interior lines skipped (reference :53-56)
        data_lines.append(line)
        if len(data_lines) == rows:
            break

    if len(data_lines) < rows:
        raise CSVReadException(
            CSVReadError.NOT_ENOUGH_ROWS, _WHERE,
            f"expected {rows} rows, found {len(data_lines)} in {path}")

    mat = np.empty((rows, cols), dtype=np.float64)
    for i, line in enumerate(data_lines):
        cells = line.split(",")
        if len(cells) < cols:
            raise CSVReadException(CSVReadError.NOT_ENOUGH_COLUMNS, _WHERE,
                                   f"row {i + 1} in {path}")
        for j in range(cols):
            try:
                mat[i, j] = float(cells[j])
            except ValueError:
                raise CSVReadException(
                    CSVReadError.INVALID_NUMBER_FORMAT, _WHERE,
                    f"row {i + 1}, column {j + 1}: '{cells[j]}' in {path}")
    return mat
