"""The port's SEPAIHRD dynamics mode (``cli/data_visualization.py``) and the
model functions it needs, against the JAX package, on the host:

- ``simulate_frame`` equals ``scripts/data_visualization.simulate_frame``
  (the JAX model) at rtol ``SIM_RTOL``, float32, on the full 306-day window:
  the same time column, the same column names;
- ``plot-dynamics --simulate`` draws one panel per compartment, and a frame
  written by ``models/results.save_results_csv`` reads back to the bit and
  plots through ``--csv``;
- ``sepaihrd.state_names`` and ``sepaihrd.force_of_infection`` equal the JAX
  package's (float64, 1e-12), at seeded states and at times on both sides
  of a schedule breakpoint.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.cli.common import load_spain_pipeline as load_jax_pipeline
from mmidv1_tpu.models import sepaihrd as jsep
from mmidv1_tpu_torch import constants as C
from mmidv1_tpu_torch.cli import data_visualization as dv
from mmidv1_tpu_torch.cli.common import load_spain_pipeline
from mmidv1_tpu_torch.models import sepaihrd
from mmidv1_tpu_torch.models.results import save_results_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
# float32 on the host: the eager solve and XLA's differ by at most 1.12e-6
# of an entry over the 306 days (the largest relative difference of any
# entry); 10x that reading
SIM_RTOL = 1e-5


@pytest.fixture(scope="module")
def frame():
    return dv.simulate_frame(device="cpu")


def test_simulate_frame_matches_the_jax_script(frame):
    sys.path.insert(0, SCRIPTS)
    try:
        import data_visualization as jdv
    finally:
        sys.path.remove(SCRIPTS)
    ref = jdv.simulate_frame()
    time, flat = frame
    assert flat.dtype == np.float32 and flat.shape == (306, 44)
    assert list(ref.columns) == ["Time"] + sepaihrd.state_names(4)
    np.testing.assert_array_equal(time, ref["Time"].to_numpy())
    np.testing.assert_allclose(flat, ref.drop(columns="Time").to_numpy(),
                               rtol=SIM_RTOL)


def test_plot_dynamics_simulate_draws_a_panel_per_compartment(tmp_path):
    assert dv.main(["plot-dynamics", "--simulate", "--device", "cpu",
                    "--out", str(tmp_path), "--prefix", "t_", "--log"]) == 0
    made = sorted(os.listdir(tmp_path))
    assert made == sorted(f"t_sepaihrd_{c}_log.png" for c in dv.COMPARTMENTS)
    assert dv.main(["plot-dynamics", "--out", str(tmp_path)]) == 1


def test_save_results_csv_round_trip(frame, tmp_path):
    time, flat = frame
    path = tmp_path / "sim.csv"
    save_results_csv(str(path), time, flat.reshape(len(time), 11, 4),
                     C.COMPARTMENTS)
    back = dv.read_frame_csv(str(path))
    assert list(back) == ["Time"] + sepaihrd.state_names(4)
    np.testing.assert_array_equal(back["Time"], time)
    got = np.stack([back[n] for n in sepaihrd.state_names(4)], axis=1)
    np.testing.assert_array_equal(got.astype(np.float32), flat)
    out = tmp_path / "figs"
    assert dv.main(["plot-dynamics", "--csv", str(path), "--out", str(out),
                    "--formats", "png"]) == 0
    assert len(os.listdir(out)) == len(dv.COMPARTMENTS)


def test_state_names_match_jax():
    assert sepaihrd.state_names(4) == jsep.state_names(4)
    assert sepaihrd.state_names(2)[:4] == ["S0", "S1", "E0", "E1"]
    assert len(sepaihrd.state_names(4)) == 44


def test_force_of_infection_matches_jax():
    tp = load_spain_pipeline(REPO, dtype=torch.float64, device="cpu")
    jp = load_jax_pipeline(REPO, dtype=jnp.float64)
    rng = np.random.default_rng(4)
    ys = rng.uniform(0.0, 5e5, size=(5, 11, 4))
    edge = float(tp.params.beta_end_times[1])
    times = [edge - 0.5, edge, edge + 1e-9, edge + 0.5, -3.0, 200.25]
    for y in ys:
        for t in times:
            got = sepaihrd.force_of_infection(tp.params, torch.as_tensor(y), t)
            want = np.asarray(jsep.force_of_infection(jp.params,
                                                      jnp.asarray(y), t))
            assert got.shape == (4,)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=0)
    # batched states: one lambda per row
    got = sepaihrd.force_of_infection(tp.params, torch.as_tensor(ys), edge)
    assert got.shape == (5, 4)
    for k in range(5):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(jsep.force_of_infection(
                jp.params, jnp.asarray(ys[k]), edge)), rtol=1e-12, atol=0)
