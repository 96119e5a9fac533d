"""The port's multi-process initialization (``parallel/multihost.py``).

The counterpart of ``tests/test_multihost.py``: two ``gloo`` processes on
the host call ``multihost.initialize(coordinator, 2, rank)``, see a group of
two with only rank 0 primary, and run a tiny sharded AM ensemble whose MAP
equals the unsharded run's (``tests/torch_ranks.py``). Without a launcher's
environment ``initialize`` is a no-op; where the environment asks for
several processes and the init fails it raises (the JAX module carries on
alone there), and ``nccl`` asked for without a card raises.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmidv1_tpu_torch.parallel import multihost

sys.path.insert(0, os.path.dirname(__file__))
import torch_ranks as R  # noqa: E402

LAUNCHER_VARS = [v for names in multihost._LAUNCHERS for v in names] + [
    "MASTER_ADDR", "MASTER_PORT"]


@pytest.fixture
def no_launcher(monkeypatch):
    for v in LAUNCHER_VARS:
        monkeypatch.delenv(v, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    assert not dist.is_initialized()


def test_initialize_is_a_noop_without_a_launcher(no_launcher):
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    assert multihost.is_primary()


def test_launcher_environment_is_read(no_launcher):
    no_launcher.setenv("SLURM_PROCID", "3")
    no_launcher.setenv("SLURM_NTASKS", "4")
    no_launcher.setenv("SLURM_LOCALID", "1")
    assert multihost._from_environment() == (3, 4, 1)
    no_launcher.setenv("RANK", "0")          # torchrun's come first
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        multihost._from_environment()


def test_failed_init_raises(no_launcher):
    """A launch that asks for two processes and cannot rendezvous raises
    instead of carrying on as a lone primary."""
    no_launcher.setenv("RANK", "0")
    no_launcher.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize(device="cpu")
    assert not dist.is_initialized()


def test_nccl_without_a_card_raises(no_launcher, tmp_path):
    no_launcher.setattr(torch.cuda, "is_available", lambda: False)
    no_launcher.setattr(torch.cuda, "device_count", lambda: 0)
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.initialize(store, 1, 0)            # nccl by default
    with pytest.raises(RuntimeError, match="needs device='cuda'"):
        multihost.initialize(store, 1, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="go together"):
        multihost.initialize(store, 1)
    assert not dist.is_initialized()


def test_two_process_distributed_mh(tmp_path):
    """Two processes: initialize returns True in each, is_primary only on
    rank 0, the mesh spans both, and the sharded MAP is the unsharded
    one."""
    ranks = R.spawn(2, [(R.task_multihost, {})], str(tmp_path),
                    init="multihost")
    want = R.task_mh(None, iterations=20, n_chains=8)["best_logp"]
    for rank, (initialized, got) in enumerate(ranks):
        assert initialized is True
        assert (got["rank"], got["world"], got["mesh_world"]) == (rank, 2, 2)
        assert got["primary"] == (rank == 0)
        assert got["backend"] == "gloo"
        np.testing.assert_allclose(got["best_logp"], want, rtol=1e-12)
