"""Sampler checkpoint/resume + MCMC trace CSVs.

Port of ``mmidv1_tpu/utils/checkpoint.py``. The reference writes trace
checkpoints every ``report_interval`` (``MetropolisHastingsSampler.cpp:
353-411``) but has no resume path; here the sampler state is a NamedTuple
of tensors, so a checkpoint is one structured save and resume is exact:
``run_mh(..., initial_state=load_mh_state(path, device=...))`` continues the
run bit for bit.

The files are the JAX package's: the same field names, the same dtypes on
disk (``int32`` for ``step`` / ``it`` and the counters), so a checkpoint
written by one package loads in the other. Loaders return the port's types
on ``device``, with ``step`` / ``it`` as Python ints.

A campaign on a mesh of W > 1 processes checkpoints one shard a rank, each
rank's rows of the state in a file of its own (:func:`shard_path`), written
and read by that rank (:func:`load_mh_shard`).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

from ..calibration.mh import MHState
from .trace import count, span

# the host-side step counters, stored as the JAX package's int32 scalars
_INT_FIELDS = ("step", "it")


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, int):
        return np.asarray(v, dtype=np.int32)
    return np.asarray(v)


def _save_state_npz(path: str, state) -> None:
    """Atomic NamedTuple-of-tensors save: write a tmp npz, then rename. One
    routine for the MH/PT/NUTS savers. The npz is stored, not deflated:
    float32 state hardly compresses (under 10 %), and deflating an
    8192-chain state held an H100 idle for about a quarter of each
    1000-step campaign segment. ``np.load`` reads stored and deflated
    members alike, so the JAX package's (deflated) files still load here
    and these load there. The tracer's spans ``checkpoint.to_host`` (every
    field to NumPy) and ``checkpoint.write`` (write, rename); the file's
    size counts in ``checkpoint.bytes``."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp.npz"
    with span("checkpoint.to_host"):
        arrays = {k: _to_numpy(v) for k, v in state._asdict().items()}
    with span("checkpoint.write"):
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    count("checkpoint.bytes", n=os.path.getsize(path))


def _fields(z, names, device) -> dict:
    return {k: (int(z[k]) if k in _INT_FIELDS
                else torch.as_tensor(z[k]).to(device))
            for k in names if k in z.files}


def _load_state_npz(path: str, cls, device):
    with np.load(path) as z:
        return cls(**_fields(z, cls._fields, device))


def save_mh_state(path: str, state: MHState) -> None:
    """Save an MHState (atomically: write + rename) as an .npz archive."""
    _save_state_npz(path, state)


def load_mh_state(path: str, device="cpu") -> MHState:
    """Load an MHState written by :func:`save_mh_state` (or by the JAX
    package) onto ``device``."""
    return _load_state_npz(path, MHState, device)


def shard_path(path: str, mesh) -> str:
    """This rank's file of the checkpoint ``path`` on ``mesh`` (an
    :class:`~mmidv1_tpu_torch.parallel.mesh.EnsembleMesh`): ``path`` itself
    on a mesh of one, else ``<root>.rank<r>-of-<W><ext>``."""
    if mesh.world_size == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{mesh.rank}-of-{mesh.world_size}{ext}"


def checkpoint_worlds(path: str) -> set:
    """The numbers of processes whose checkpoints of ``path`` are on disk
    (1 for ``path`` itself, W for a shard ``<root>.rank<r>-of-<W><ext>``):
    empty for a campaign that has none."""
    root, ext = os.path.splitext(path)
    worlds = {1} if os.path.exists(path) else set()
    for f in glob.glob(glob.escape(root) + ".rank*-of-*" + glob.escape(ext)):
        m = re.fullmatch(r"\.rank\d+-of-(\d+)", f[len(root):len(f) - len(ext)])
        if m:
            worlds.add(int(m.group(1)))
    return worlds


def load_mh_shard(path: str, mesh, n_chains: int,
                  device="cpu") -> Optional[MHState]:
    """This rank's :class:`MHState` of the campaign checkpoint ``path``
    (its :func:`shard_path`), or None where no rank finds its shard and no
    checkpoint of the campaign is on disk. On a mesh of more than one
    process every rank calls this (its checks are collectives). Raises
    ``ValueError`` where the checkpoint was written by another number of
    processes, where only some ranks find their shard, where the shards
    stand at different steps, or where the rows do not make ``n_chains``."""
    own = shard_path(path, mesh)
    world = mesh.world_size
    have = os.path.exists(own)
    if mesh.distributed:
        found = int(mesh.psum(torch.tensor([int(have)], device=device)).item())
    else:
        found = int(have)
    if found == 0:
        others = checkpoint_worlds(path) - {world}
        if others:
            raise ValueError(
                f"the checkpoint {path} was written by {sorted(others)} "
                f"process(es); resume it on as many (this run has {world})")
        return None
    if found != world:
        raise ValueError(f"{found} of {world} ranks find their shard of the "
                         f"checkpoint {path}")
    state = load_mh_state(own, device=device)
    if state.x.shape[0] * world != n_chains:
        raise ValueError(f"{own} holds {state.x.shape[0]} chains a rank; "
                         f"{n_chains} over {world} rank(s) asked for")
    if mesh.distributed:
        step = torch.tensor([state.step], device=device)
        if int(mesh.pmax(step).item()) != int(mesh.pmin(step).item()):
            raise ValueError(f"the shards of {path} stand at different steps")
    return state


def save_pt_state(path: str, state) -> None:
    """Save a tempering :class:`~mmidv1_tpu_torch.calibration.tempering.
    PTState` (same atomic npz as :func:`save_mh_state`)."""
    _save_state_npz(path, state)


def load_pt_state(path: str, device="cpu"):
    from ..calibration.tempering import PTState, _spacings_from_betas

    with np.load(path) as z:
        fields = _fields(z, PTState._fields, device)
    # pre-ladder-adaptation checkpoints: synthesize the ladder fields
    # (geometric beta_min=0.05 was the only ladder those runs had)
    if "betas" not in fields:
        x = fields["x"]
        K = int(x.shape[0])
        expo = np.arange(K) / max(K - 1, 1)
        betas = np.asarray(0.05 ** expo)
        t = lambda a: torch.as_tensor(a).to(device=device, dtype=x.dtype)
        fields["betas"] = t(betas)
        fields["ladder_s"] = t(_spacings_from_betas(betas))
        fields["swap_prob"] = torch.zeros((max(K - 1, 1),), dtype=x.dtype,
                                          device=device)
    return PTState(**fields)


def save_nuts_state(path: str, state) -> None:
    """Save a :class:`~mmidv1_tpu_torch.calibration.nuts.NUTSState` (atomic
    npz). For ``run_nuts_dense`` runs the state is in whitened
    z-coordinates: valid to resume only with the same ``mu`` / ``scale``."""
    _save_state_npz(path, state)


def load_nuts_state(path: str, device="cpu"):
    from ..calibration.nuts import NUTSState

    return _load_state_npz(path, NUTSState, device)


def write_posterior_trace(path: str, samples, logps=None,
                          names: Optional[Sequence[str]] = None,
                          max_rows: Optional[int] = None) -> None:
    """Reference-format posterior trace CSV
    (``MetropolisHastingsSampler.cpp:440-469``): one row per stored sample,
    ``sample,logp,<param values...>``; ``max_rows`` keeps the last N rows
    (the checkpoint files keep 5000, :380-382). Arrays or tensors on any
    device; written to a tmp file and renamed, so a kill mid-write never
    truncates the previous trace."""
    samples = _to_numpy(samples)
    if logps is not None:
        logps = _to_numpy(logps)
    if samples.ndim == 3:                      # (n_stored, B, d) ensemble
        if logps is not None:
            logps = logps.reshape(-1)
        samples = samples.reshape(-1, samples.shape[-1])
    if max_rows is not None and len(samples) > max_rows:
        samples = samples[-max_rows:]
        if logps is not None:
            logps = logps[-max_rows:]
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    col_names = (list(names) if names is not None
                 else [f"p{j}" for j in range(samples.shape[1])])
    if logps is not None:
        data = np.concatenate([logps[:, None], samples], axis=1)
        cols = ["logp"] + col_names
    else:
        data, cols = samples, col_names

    # the native C++ writer when available, the same bytes either way
    from . import native

    tmp = f"{path}.tmp.{os.getpid()}"
    if native.write_trace_csv(tmp, ",".join(cols), data):
        os.replace(tmp, path)
        return
    # "%.8e" of a Python float is the ".8e" format of the value itself
    row = "%d" + ",%.8e" * data.shape[1] + "\n"
    with open(tmp, "w") as f:
        f.write("sample," + ",".join(cols) + "\n")
        for i, vals in enumerate(data.tolist()):
            f.write(row % (i, *vals))
    os.replace(tmp, path)


def make_checkpoint_progress_fn(out_dir: str, names: Sequence[str],
                                every: int = 1):
    """A ``progress_fn`` for :func:`~mmidv1_tpu_torch.calibration.mh.run_mh`
    that mirrors the reference's console progress line; pair it with
    :func:`save_mh_state` calls from the driver loop for checkpoints."""
    from .logging import get_logger

    log = get_logger("mh")
    count = [0]

    def progress(step, accept_rate, best_logp, mean_scale):
        count[0] += 1
        if count[0] % max(1, every) == 0:
            log.info(f"step {int(step)}: acceptance {float(accept_rate):.3f}, "
                     f"best logL {float(best_logp):.6e}, "
                     f"scale {float(mean_scale):.4f}")

    return progress
