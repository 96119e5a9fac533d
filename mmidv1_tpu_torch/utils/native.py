"""ctypes bindings for the native C++ IO layer (``native/mmidv1_io.cpp``).

Port of ``mmidv1_tpu/utils/native.py``. The reference's data layer and trace
writers are C++ (``src/utils/ReadContactMatrix.cpp``,
``GetCalibrationData.cpp``, ``MetropolisHastingsSampler.cpp:380-469``); the
same C++ source serves both packages. It is host code: bulk CSV parsing and
posterior-trace writing, never a device kernel.

The shared library is built with g++ at first use into this package's own
build directory, ``mmidv1_tpu_torch/build/native/libmmidv1_io_<hash>.so``,
named by a hash of the source and the flags (as ``ops/_build.py`` names the
CUDA libraries), so an edited source is rebuilt and the JAX package's
``native/build/`` is never touched. ``MMIDV1_NO_NATIVE=1`` disables it. Every
entry point has a pure-Python fallback with the same results (one warning is
logged when the library is unavailable): the native path is a throughput
optimisation, never a correctness dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from .logging import get_logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "native", "mmidv1_io.cpp")
LIB_DIR = os.path.join(_PKG, "build", "native")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_ERROR_NAMES = {1: "FILE_NOT_OPEN", 2: "WRONG_ROW_COUNT",
                3: "WRONG_COL_COUNT", 4: "PARSE_ERROR", 5: "WRITE_ERROR"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library of the current source lives (built or not)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(LIB_DIR, f"libmmidv1_io_{digest.hexdigest()[:16]}.so")


def _build(lib_path: str) -> bool:
    """g++ into a per-pid temp file, then ``os.replace``: a process racing a
    build never loads a half-written library."""
    os.makedirs(LIB_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    try:
        subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        get_logger("native").warning(f"native IO build failed ({e})")
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c, i64 = ctypes.c_char_p, ctypes.c_int64
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.mmidv1_read_csv_matrix.argtypes = [c, i64, i64, pd]
    lib.mmidv1_read_csv_matrix.restype = ctypes.c_int32
    lib.mmidv1_count_csv.argtypes = [c, ctypes.POINTER(i64),
                                     ctypes.POINTER(i64)]
    lib.mmidv1_count_csv.restype = ctypes.c_int32
    lib.mmidv1_read_csv_table.argtypes = [c, pi, i64, i64, pd, i64,
                                          ctypes.POINTER(i64)]
    lib.mmidv1_read_csv_table.restype = ctypes.c_int32
    lib.mmidv1_write_trace_csv.argtypes = [c, c, pd, i64, i64]
    lib.mmidv1_write_trace_csv.restype = ctypes.c_int32
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded shared library, built on first use; None if it is
    unavailable or ``MMIDV1_NO_NATIVE`` is set (the fallbacks apply)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MMIDV1_NO_NATIVE"):
            return None
        log = get_logger("native")
        if not os.path.exists(SRC):
            log.warning(f"native IO source {SRC} missing; using the "
                        "pure-Python IO paths")
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            log.warning("native IO unavailable; using the pure-Python IO paths")
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError as e:
            log.warning(f"native IO load failed ({e}); using the pure-Python "
                        "IO paths")
        return _lib


def _check(code: int, where: str, path: str) -> None:
    if code == 0:
        return
    from .exceptions import CSVReadError, CSVReadException, FileIOException

    if code == 5:
        # an IO failure (disk full, permissions), not a parse problem
        raise FileIOException(where, f"WRITE_ERROR: {path}")
    kind = {1: CSVReadError.FILE_OPEN, 2: CSVReadError.NOT_ENOUGH_ROWS,
            3: CSVReadError.NOT_ENOUGH_COLUMNS,
            4: CSVReadError.INVALID_NUMBER_FORMAT}.get(
                code, CSVReadError.INVALID_NUMBER_FORMAT)
    raise CSVReadException(kind, where,
                           f"{_ERROR_NAMES.get(code, code)}: {path}")


def read_csv_matrix(path: str, rows: int, cols: int) -> Optional[np.ndarray]:
    """Native R x C numeric CSV read (``//`` comment lines skipped, strict
    dimensions); None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((rows, cols), dtype=np.float64)
    _check(lib.mmidv1_read_csv_matrix(path.encode(), rows, cols, out),
           "read_csv_matrix", path)
    return out


def read_csv_table(path: str, col_indices: Sequence[int],
                   skip_header: int = 1) -> Optional[np.ndarray]:
    """The columns ``col_indices`` of a header'd CSV as float64, one row per
    data line (an empty or non-numeric cell is NaN); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    _check(lib.mmidv1_count_csv(path.encode(), ctypes.byref(rows),
                                ctypes.byref(cols)), "read_csv_table", path)
    idx = np.asarray(col_indices, dtype=np.int64)
    out = np.empty((rows.value, len(idx)), dtype=np.float64)
    got = ctypes.c_int64()
    _check(lib.mmidv1_read_csv_table(path.encode(), idx, len(idx), skip_header,
                                     out, rows.value, ctypes.byref(got)),
           "read_csv_table", path)
    return out[:got.value]


def write_trace_csv(path: str, header: str, data: np.ndarray) -> bool:
    """Native posterior-trace write (``sample,<header>`` then one ``%.8e``
    row per sample); False if the library is unavailable (the caller falls
    back to the Python writer)."""
    lib = get_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError(f"expected 2-D trace, got {data.shape}")
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    _check(lib.mmidv1_write_trace_csv(path.encode(), header.encode(), data,
                                      data.shape[0], data.shape[1]),
           "write_trace_csv", path)
    return True
