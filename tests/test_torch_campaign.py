"""The port's ``production_campaign`` on the host at a tiny size (30 days,
rk4@1, 8 chains): a campaign killed after one segment and resumed equals the
uninterrupted one (segment files, checkpoint, trace to the byte), for AM-MH
and for replica exchange; DE-MC and the Laplace warm start run; the
stale-segment and already-covered rules hold."""

import glob
import json
import os

import numpy as np
import pytest

from mmidv1_tpu_torch.cli import production_campaign as pc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--num-days", "30", "--tableau", "rk4",
        "--substeps", "1", "--chains", "8", "--thinning", "5", "--burn-in",
        "10", "--skip-report"]
# 4 stored draws a segment; PT drops its first 2 (burn-in)
FULL = ["--iterations", "40", "--segments", "2"]
KILLED = ["--iterations", "20", "--segments", "1"]


def _run(out, *extra):
    return pc.run(TINY + list(extra) + ["--out", str(out)])


def _assert_same_files(a, b, prefix, segments):
    ckpt = "campaign_checkpoint" + ("_pt" if prefix == "pt" else "") + ".npz"
    for name in [f"{prefix}_segment_{s:04d}.npz" for s in range(segments)] \
            + [ckpt]:
        with np.load(os.path.join(a, name)) as za, \
                np.load(os.path.join(b, name)) as zb:
            assert za.files == zb.files, name
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (name, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=name + k)
    with open(os.path.join(a, "posterior_trace.csv"), "rb") as fa, \
            open(os.path.join(b, "posterior_trace.csv"), "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("extra,prefix", [([], "mh"),
                                          (["--rungs", "4"], "pt")])
def test_killed_and_resumed_campaign_equals_uninterrupted(tmp_path, extra,
                                                          prefix):
    full = _run(tmp_path / "full", *extra, *FULL)
    killed = tmp_path / "killed"
    _run(killed, *extra, *KILLED)
    assert sorted(os.listdir(killed)) == sorted(
        [f"{prefix}_segment_0000.npz", "campaign_checkpoint"
         + ("_pt" if prefix == "pt" else "") + ".npz", "posterior_trace.csv",
         "calibrated_parameters.txt", "campaign_metadata.json"])
    resumed = _run(killed, *extra, *FULL)
    _assert_same_files(tmp_path / "full", killed, prefix, 2)
    for k in ("best_logl_float64", "mean_acceptance", "stored_samples",
              "swap_rate", "final_ladder", "diagnostics"):
        assert resumed[k] == full[k], k
    with open(killed / "campaign_metadata.json") as f:
        meta = json.load(f)
    assert meta["segments"] == 2 and meta["rungs"] == (4 if extra else 1)
    if extra:
        betas = np.asarray(meta["final_ladder"])
        assert betas[0] == 1.0 and (np.diff(betas) < 0).all()
        assert np.isfinite(meta["swap_rate"]).all()


def test_already_covered_checkpoint_raises(tmp_path):
    _run(tmp_path / "mh", *KILLED)
    with pytest.raises(ValueError, match="already covers"):
        _run(tmp_path / "mh", *KILLED)
    _run(tmp_path / "pt", "--rungs", "2", *KILLED)
    with pytest.raises(SystemExit, match="already covers"):
        _run(tmp_path / "pt", "--rungs", "2", *KILLED)


def test_stale_segment_files(tmp_path, capsys):
    """A fresh MH campaign removes segment files of an older run; a resumed
    one missing a pre-resume segment file raises; a PT campaign leaves out
    (and reports) segment files beyond ``--segments``."""
    out = tmp_path / "mh"
    os.makedirs(out)
    stale = out / "mh_segment_0007.npz"
    np.savez(stale, samples=np.zeros((1, 8, 62)), sample_logps=np.zeros((1, 8)))
    _run(out, *KILLED)
    assert not stale.exists()
    os.remove(out / "mh_segment_0000.npz")
    with pytest.raises(SystemExit, match="missing"):
        _run(out, *FULL)

    pt = tmp_path / "pt"
    _run(pt, "--rungs", "2", *KILLED)
    np.savez(pt / "pt_segment_0005.npz", samples=np.full((1, 4, 62), 7.0),
             sample_logps=np.zeros((1, 4)))
    os.remove(pt / "campaign_checkpoint_pt.npz")
    capsys.readouterr()
    meta = _run(pt, "--rungs", "2", *KILLED)
    assert "ignoring 1 stale pt_segment" in capsys.readouterr().out
    assert meta["stored_samples"] == (4 - 2) * 4
    assert len(glob.glob(str(pt / "pt_segment_*.npz"))) == 2


def test_de_campaign_with_laplace_warm_start(tmp_path, capsys):
    meta = _run(tmp_path, "--proposal", "de", "--laplace",
                os.path.join(REPO, "results", "spain2020", "laplace_mass.npz"),
                *FULL)
    assert "Laplace warm start" in capsys.readouterr().out
    assert meta["proposal"] == "de" and 0.0 <= meta["mean_acceptance"] <= 1.0
    assert np.isfinite(meta["best_logl_float64"])
    with open(tmp_path / "calibrated_parameters.txt") as f:
        assert f"{meta['best_logl_float64']:.8e}" in f.read()
