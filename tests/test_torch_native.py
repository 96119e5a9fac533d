"""The port's native C++ IO layer (``mmidv1_tpu_torch/utils/native.py``)
against its pure-Python fallbacks and against the JAX package's binding of
the same source:

- the seven cases of ``tests/test_native.py``, run against the port;
- ``read_csv_table`` gives the JAX binding's arrays and ``write_trace_csv``
  its bytes;
- ``CalibrationData.from_csv``: native == fallback == the JAX package's,
  every array equal;
- the library is built into the port's own build directory, named by a hash
  of the source, and ``MMIDV1_NO_NATIVE=1`` switches it off.
"""

import os

import numpy as np
import pytest

from mmidv1_tpu.utils import native as jnative
from mmidv1_tpu_torch.utils import native
from mmidv1_tpu_torch.utils.exceptions import (CSVReadException,
                                               DataFormatException,
                                               FileIOException)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "processed", "processed_data.csv")
FIELDS = ("new_confirmed", "new_deaths", "new_hospitalizations", "new_icu",
          "cumulative_confirmed", "cumulative_deaths",
          "cumulative_hospitalizations", "cumulative_icu",
          "population_by_age")

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="native toolchain unavailable")


@needs_native
def test_native_matrix_read_matches_python():
    from mmidv1_tpu_torch.data.contact_matrix import read_matrix_from_csv

    path = os.path.join(REPO, "data", "contacts.csv")
    np.testing.assert_array_equal(native.read_csv_matrix(path, 4, 4),
                                  read_matrix_from_csv(path, 4, 4))


@needs_native
def test_native_matrix_errors(tmp_path):
    f = tmp_path / "m.csv"
    f.write_text("// comment\n1,2\n3,4\n")
    np.testing.assert_array_equal(native.read_csv_matrix(str(f), 2, 2),
                                  [[1, 2], [3, 4]])
    with pytest.raises(CSVReadException):
        native.read_csv_matrix(str(tmp_path / "missing.csv"), 2, 2)
    with pytest.raises(CSVReadException):
        native.read_csv_matrix(str(f), 3, 2)     # not enough rows
    with pytest.raises(CSVReadException):
        native.read_csv_matrix(str(f), 2, 3)     # not enough columns
    g = tmp_path / "bad.csv"
    g.write_text("1,x\n3,4\n")
    with pytest.raises(CSVReadException):
        native.read_csv_matrix(str(g), 2, 2)


@needs_native
def test_native_table_read(tmp_path):
    f = tmp_path / "t.csv"
    f.write_text("date,a,b,c\n2020-01-01,1,2,3\n2020-01-02,4,,x\n")
    out = native.read_csv_table(str(f), [1, 3], skip_header=1)
    assert out.shape == (2, 2)
    np.testing.assert_array_equal(out[0], [1.0, 3.0])
    assert out[1, 0] == 4.0 and np.isnan(out[1, 1])


def test_calibration_data_native_matches_fallback(monkeypatch):
    from mmidv1_tpu_torch.data import CalibrationData

    with_native = CalibrationData.from_csv(DATA, "2020-03-01", "2020-06-30")
    monkeypatch.setattr(native, "read_csv_table", lambda *a, **k: None)
    without = CalibrationData.from_csv(DATA, "2020-03-01", "2020-06-30")
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(with_native, field),
                                      getattr(without, field), err_msg=field)


def test_trace_writer_native_matches_fallback(tmp_path, monkeypatch):
    from mmidv1_tpu_torch.utils.checkpoint import write_posterior_trace

    rng = np.random.default_rng(0)
    samples = rng.normal(size=(50, 3))
    logps = rng.normal(size=(50,))
    p1, p2 = tmp_path / "native.csv", tmp_path / "python.csv"
    write_posterior_trace(str(p1), samples, logps, ["a", "b", "c"])
    monkeypatch.setattr(native, "write_trace_csv", lambda *a, **k: False)
    write_posterior_trace(str(p2), samples, logps, ["a", "b", "c"])
    assert p1.read_bytes() == p2.read_bytes()


def test_calibration_data_out_of_range_malformed_rows_ignored(tmp_path):
    """A malformed cell in a row outside [start_date, end_date] must not
    fail the load; inside the range it raises the data-format taxonomy."""
    from mmidv1_tpu_torch.data import CalibrationData

    with open(DATA) as f:
        lines = f.read().splitlines()
    age_col = lines[0].split(",").index("new_confirmed_0_30")
    bad_tail = lines[-1].split(",")
    bad_tail[0] = "2021-06-01"
    bad_tail[age_col] = ""
    p = tmp_path / "data.csv"
    p.write_text("\n".join(lines + [",".join(bad_tail)]) + "\n")
    data = CalibrationData.from_csv(str(p), "2020-03-01", "2020-06-30")
    assert data.n_data_points > 0

    k = next(i for i, ln in enumerate(lines) if ln.startswith("2020-04-15"))
    bad_in = lines[k].split(",")
    bad_in[age_col] = "not_a_number"
    p2 = tmp_path / "bad.csv"
    p2.write_text("\n".join(lines[:k] + [",".join(bad_in)] + lines[k + 1:])
                  + "\n")
    with pytest.raises(DataFormatException):
        CalibrationData.from_csv(str(p2), "2020-03-01", "2020-06-30")


@needs_native
def test_table_reader_skips_comment_lines(tmp_path):
    p = tmp_path / "c.csv"
    p.write_text("// provenance comment\na,b\n1,2\n3,4\n")
    t = native.read_csv_table(str(p), [0, 1], skip_header=1)
    np.testing.assert_array_equal(t, [[1.0, 2.0], [3.0, 4.0]])


@needs_native
@pytest.mark.parametrize("rows", [1, 5000])
def test_port_and_jax_bindings_agree(tmp_path, rows):
    """The same source behind two bindings: equal arrays, equal bytes."""
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native build is unavailable")
    cols = [3, 1, 7, 40]
    np.testing.assert_array_equal(native.read_csv_table(DATA, cols),
                                  jnative.read_csv_table(DATA, cols))
    rng = np.random.default_rng(rows)
    data = rng.normal(size=(rows, 63)) * 10.0 ** rng.integers(-8, 8, (rows, 63))
    header = ",".join(["logp"] + [f"p{j}" for j in range(62)])
    a, b = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert native.write_trace_csv(str(a), header, data)
    assert jnative.write_trace_csv(str(b), header, data)
    assert a.read_bytes() == b.read_bytes()


def test_from_csv_native_fallback_and_jax_agree(monkeypatch):
    from mmidv1_tpu.data import CalibrationData as JaxData
    from mmidv1_tpu_torch.data import CalibrationData

    jax_data = JaxData.from_csv(DATA, "2020-03-01", "2020-12-31")
    got = {"native": CalibrationData.from_csv(DATA, "2020-03-01",
                                              "2020-12-31")}
    monkeypatch.setattr(native, "read_csv_table", lambda *a, **k: None)
    got["fallback"] = CalibrationData.from_csv(DATA, "2020-03-01",
                                               "2020-12-31")
    for how, d in got.items():
        assert d.dates == jax_data.dates, how
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(d, field),
                                          getattr(jax_data, field),
                                          err_msg=f"{how} {field}")
            assert getattr(d, field).flags.c_contiguous, (how, field)


@needs_native
def test_library_lives_in_the_port_build_dir(monkeypatch):
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "mmidv1_tpu_torch",
                                                 "build", "native")
    assert os.path.basename(path).startswith("libmmidv1_io_")
    assert os.path.exists(path)
    assert native.get_lib()._name == path
    assert path != os.path.join(REPO, "native", "build", "libmmidv1_io.so")
    # MMIDV1_NO_NATIVE=1 turns the library off: every entry point falls back
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("MMIDV1_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert native.read_csv_table(DATA, [1]) is None
    assert native.write_trace_csv(os.devnull, "a", np.zeros((1, 1))) is False


@needs_native
def test_write_error_is_a_file_io_exception(tmp_path):
    with pytest.raises(CSVReadException):
        native.read_csv_table(str(tmp_path / "missing.csv"), [0])
    with pytest.raises(FileIOException):
        native._check(5, "write_trace_csv", "x.csv")
