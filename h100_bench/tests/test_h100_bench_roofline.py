"""The frozen operation counts equal the program's own at each
configuration's shapes, and the roofline arithmetic keeps to its
definitions."""

import json
import os

import pytest

from h100_bench import roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.listdir(os.path.join(HERE, "configs")))


def _config(name):
    with open(os.path.join(HERE, "configs", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_equal_the_programs(name):
    from mmidv1_tpu_torch.ops.sepaihrd_fused import op_count

    cfg = _config(name)
    sh = roofline.shapes(cfg)
    tab, sub = cfg["tableau"], cfg["substeps"]
    assert sh["n_intervals"] == 325 and sh["n_obs"] == 306
    assert roofline.fwd_ops(tab, sub, sh["n_intervals"], sh["n_obs"]) == \
        op_count(tab, sub, sh["n_intervals"], sh["n_obs"])


@pytest.mark.parametrize("tableau", ["dopri5", "cash_karp", "rk4"])
@pytest.mark.parametrize("substeps", [1, 3, 4])
def test_counts_at_other_shapes(tableau, substeps):
    from mmidv1_tpu_torch.ops.sepaihrd_fused import op_count

    assert roofline.fwd_ops(tableau, substeps, 49, 30) == op_count(tableau, substeps, 49, 30)


def test_least_time():
    cfg = _config("spain2020-dopri5x4-f32.json")
    k1 = roofline.call_cost("k1", cfg, 8192)
    t, by = roofline.least_seconds(k1, "float32")
    assert by == "ops" and t == pytest.approx(k1["ops"] / 67e12)
    assert roofline.call_cost("k1", cfg, 64)["ops"] == k1["ops"] // 128
    with pytest.raises(ValueError):
        roofline.call_cost("k2", cfg, 1)
