"""The float64 reference agrees with the port's plain path on the host at a
small size (both configurations' solvers), and the control reads far from
it."""

import os

import pytest
import torch

from h100_bench.reference.spain import SpainReference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(HERE, "data", "spain2020")
DAYS = 25


@pytest.fixture(scope="module")
def pipe():
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.data import read_sepaihrd_parameters

    p = load_spain_pipeline(TREE, dtype=torch.float64, device="cpu", num_days=DAYS)
    init = read_sepaihrd_parameters(
        os.path.join(TREE, "calibrated_parameters.txt"), 4,
        N=p.data.population_by_age, M_baseline=p.params.M_baseline.numpy(),
        dtype=torch.float64, device="cpu")
    theta0 = p.space.extract(init)
    g = torch.Generator().manual_seed(3)
    # some rows outside the box: the reflection is part of the objective
    thetas = theta0[None] + 0.7 * p.space.sigmas * torch.randn(
        5, theta0.shape[0], generator=g, dtype=torch.float64)
    return p, thetas


@pytest.mark.parametrize("tableau,substeps", [("cash_karp", 3), ("dopri5", 4)])
def test_value(pipe, tableau, substeps):
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import build_objective_fused

    p, thetas = pipe
    obj = build_objective_fused(p.space, p.params, p.data, p.ts,
                                substeps=substeps, tableau=tableau,
                                constraint_mode=REFLECT,
                                dtype=torch.float64, device="cpu")
    ref = SpainReference(os.path.join(TREE, "data"), tableau=tableau,
                         substeps=substeps, num_days=DAYS)
    assert list(ref.names) == list(p.space.names)
    assert torch.allclose(obj(thetas), ref.loglik(thetas), rtol=1e-12, atol=0)


def test_control_differs(pipe):
    """The control (float32, TF32 contact product) reads far from the
    reference, and plain float32 does not."""
    p, thetas = pipe
    kw = dict(tableau="cash_karp", substeps=3, num_days=DAYS)
    ref = SpainReference(os.path.join(TREE, "data"), **kw)
    f32 = SpainReference(os.path.join(TREE, "data"), dtype=torch.float32, **kw)
    ctl = SpainReference(os.path.join(TREE, "data"), dtype=torch.float32, tf32=True, **kw)
    th = thetas.float().double()
    lr = ref.loglik(th)
    gap = lambda v: float(((v.double() - lr).abs() / lr.abs()).max())
    assert gap(ctl.loglik(th.float())) > 20 * gap(f32.loglik(th.float()))

