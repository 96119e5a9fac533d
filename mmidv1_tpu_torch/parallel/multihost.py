"""Multi-process initialization for runs over several cards or hosts.

Port of ``mmidv1_tpu/parallel/multihost.py``. One call per process before
any collective:

    from mmidv1_tpu_torch.parallel import ensemble_mesh, multihost
    multihost.initialize()           # reads the launcher's environment
    mesh = ensemble_mesh()           # spans every rank

started, for example, as ``torchrun --nproc_per_node N script.py``. The
process group's collectives then carry the ensemble's reductions
(:mod:`.mesh`). Checkpoints and CSV trees are written by rank 0 alone
(:func:`is_primary`).

With no launcher in the environment ``initialize`` is a no-op that returns
False, so code can call it unconditionally.

**One deliberate difference from the JAX package:** JAX's ``initialize``
catches a failed init and carries on alone (``multihost.py:62-64``). Every
process of a multi-process launch would then run a duplicate campaign and
call itself primary, as that module's own comment warns. Here a failed init
raises.

The backend is the caller's choice and is never swapped: ``nccl`` (the
default on CUDA) takes one rank a card and raises where a node has more
ranks than cards or no card; ``gloo`` runs on the host and lets several
ranks share a card (it reduces CUDA tensors by way of host copies).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

# (rank, world size, local rank) variables of the launchers: torchrun, then
# the list the JAX module auto-detects (SLURM, Open MPI, MPICH / Intel MPI)
_LAUNCHERS = (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
              ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
               "OMPI_COMM_WORLD_LOCAL_RANK"),
              ("PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID"))


def _from_environment():
    """``(rank, world, local_rank)`` from the first launcher whose rank
    variable is set, or None."""
    for rank_var, size_var, local_var in _LAUNCHERS:
        if rank_var in os.environ:
            if size_var not in os.environ:
                raise RuntimeError(f"{rank_var} is set but {size_var} is not")
            rank = int(os.environ[rank_var])
            return (rank, int(os.environ[size_var]),
                    int(os.environ.get(local_var, rank)))
    return None


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device: str = "cuda",
               timeout: Optional[datetime.timedelta] = None) -> bool:
    """Initialize the default ``torch.distributed`` process group.

    With no arguments it reads the launcher's environment (torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` with ``MASTER_ADDR`` /
    ``MASTER_PORT``; ``SLURM_PROCID``, ``OMPI_COMM_WORLD_RANK`` or
    ``PMI_RANK`` with ``MASTER_ADDR`` / ``MASTER_PORT`` set by the job) and
    returns False where there is none. Otherwise ``coordinator_address``
    (``host:port``, or a ``tcp://`` / ``file://`` URL), ``num_processes``
    and ``process_id`` name the group.

    ``backend`` defaults to ``nccl`` for ``device="cuda"`` and ``gloo`` for
    ``"cpu"``. On CUDA each rank is placed on ``cuda:LOCAL_RANK`` (the
    local rank from the launcher, else ``process_id``); ``nccl`` raises
    where there are more local ranks than cards, ``gloo`` wraps them round
    the cards. Returns True if the group has more than one process. A failed
    init raises.
    """
    log = get_logger("multihost")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        found = _from_environment()
        if found is None:
            return False          # one process, nothing to do
        rank, world, local_rank = found
        init_method = "env://"
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id go together")
        rank, world = int(process_id), int(num_processes)
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = _init_method(coordinator_address)
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError(f"device 'cuda' asked for with backend "
                               f"{backend!r}, but there is no CUDA card")
        if backend == "nccl" and local_rank >= n_cards:
            raise RuntimeError(
                f"nccl takes one rank a card: local rank {local_rank} on a "
                f"node with {n_cards} card(s); start fewer ranks a node, or "
                f"pass backend='gloo' to share cards")
        torch.cuda.set_device(local_rank % n_cards)
    elif backend == "nccl":
        raise RuntimeError("backend 'nccl' needs device='cuda'")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    log.info(f"distributed runtime: {world} processes, backend {backend}, "
             f"rank {rank} on {device}"
             + (f":{torch.cuda.current_device()}" if device == "cuda" else ""))
    return world > 1


def is_primary() -> bool:
    """True on the process that owns file IO (checkpoints, CSV trees)."""
    return not dist.is_initialized() or dist.get_rank() == 0
