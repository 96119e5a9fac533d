"""Process-group helpers for the ensemble (``chains``) axis.

Port of ``mmidv1_tpu/parallel/mesh.py``. The JAX package shards the leading
batch axis of an ensemble over a 1-D device mesh and lets ``psum`` /
``all_gather`` (or GSPMD) carry the cross-chain reductions. Here the axis is
split over the ranks of a ``torch.distributed`` process group, one process a
rank (as ``torchrun`` starts them, or :func:`.multihost.initialize`): rank
``r`` of ``W`` holds the global chains ``[r n, (r + 1) n)`` of ``n W``, and
the samplers call the collectives below at the places where the JAX package
reduces across the mesh.

:class:`EnsembleMesh` is that axis: the world size, this rank, its
``torch.device`` and the group's backend. Without a process group it is a
mesh of one, whose
collectives return their input, so one code path serves the sharded and the
unsharded run.

On ``nccl`` (one rank a card) ``all_gather`` is
``dist.all_gather_into_tensor``: every rank's rows copied in rank order into
one buffer, which the caller may own (``out``), so that a CUDA graph can
read it step after step. Every other collective, and every collective on
other backends, is built on ``dist.all_reduce``: with ``broadcast`` it is
all the ``gloo`` backend takes with CUDA tensors (PyTorch's table of
backends), and two ranks that share one card cannot use ``nccl``. On an
NVIDIA H100 with PyTorch 2.11.0 (CUDA 12.8), ``gloo`` ran every reduction
below on CUDA tensors of float64, float32 and int64, with SUM, MAX and MIN
(``chip_smoke.py`` phase 22). So:

- ``all_gather`` off ``nccl`` is a zero-filled global buffer with this
  rank's rows written in, summed by ``all_reduce``: exact, since ``x + 0 ==
  x`` (a ``-0.0`` comes back as ``+0.0``);
- the first maximum across ranks (``mmidv1_tpu/calibration/mh.py:333-342``)
  is an ``all_reduce(MAX)`` of the value, then an ``all_reduce(MIN)`` of the
  global index that reaches it, so ties resolve to the lowest global index,
  as ``argmax`` over the unsharded ensemble does; the winning row is then
  summed in from its owner.

Each collective of a mesh of more than one process is a span of the
port's tracer, ``mesh.all_gather`` or ``mesh.all_reduce`` (under ``psum``,
``pmax``, ``pmin`` and ``mean``), and adds the bytes of its result to the
counter ``mesh.bytes`` by ``(op, dtype, numel)``, spans on or off.

The JAX module's ``batch_sharding`` / ``replicated_sharding`` build GSPMD
placement objects; a rank here holds its rows as plain tensors, so they have
no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.trace import count, span

CHAINS_AXIS = "chains"


@dataclasses.dataclass(frozen=True)
class EnsembleMesh:
    """The ensemble axis over the default process group (``backend`` None:
    no group, one rank, collectives are the identity)."""

    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    axis_name: str = CHAINS_AXIS

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def n_local(self, n_total: int) -> int:
        return check_divisible(n_total, self)

    def offset(self, n_total: int) -> int:
        """Global index of this rank's first row of ``n_total``."""
        return self.rank * self.n_local(n_total)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if not self.distributed:
            return t
        t = t.clone(memory_format=torch.contiguous_format)
        with span("mesh.all_reduce"):
            _count_bytes("all_reduce", t)
            dist.all_reduce(t, op=op)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (``lax.psum``)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of every element of every rank's ``t`` (equal shapes)."""
        return self.psum(torch.sum(t)) / (t.numel() * self.world_size)

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order
        (``lax.all_gather(..., tiled=True)``), written into ``out`` where
        given (contiguous, of the result's shape: a buffer the caller keeps)
        and returned. On a mesh of one, ``t`` itself (copied into ``out``)."""
        if not self.distributed:
            return t if out is None else out.copy_(t)
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * self.world_size
        buf = t.new_empty(shape) if out is None else out
        if buf.numel() == 0:
            return buf
        with span("mesh.all_gather"):
            _count_bytes("all_gather", buf)
            if self.backend != "nccl":
                buf.zero_()
                buf.narrow(dim, self.rank * n, n).copy_(t)
                dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            elif dim == 0:
                dist.all_gather_into_tensor(buf, t.contiguous())
            else:
                # the collective stacks along dim 0: gather with ``dim``
                # moved there, and move it back
                rows = t.movedim(dim, 0).contiguous()
                tmp = rows.new_empty((n * self.world_size,) + rows.shape[1:])
                dist.all_gather_into_tensor(tmp, rows)
                buf.copy_(tmp.movedim(0, dim))
        return buf

    def first_max(self, values: torch.Tensor, rows: torch.Tensor,
                  global_index: torch.Tensor):
        """``(rows[i], values[i])`` at the first global maximum of
        ``values`` (1-D, this rank's entries, whose global indices are
        ``global_index``, increasing), the same on every rank."""
        i = torch.argmax(values)
        value = values[i]
        if not self.distributed:
            return rows[i], value
        top = self.pmax(value)
        big = torch.iinfo(torch.int64).max
        mine = global_index[i].to(torch.int64)
        win = self.pmin(torch.where(value == top, mine,
                                    torch.full_like(mine, big)))
        row = torch.where(mine == win, rows[i], torch.zeros_like(rows[i]))
        return self.psum(row), top


def ensemble_mesh(n_devices: Optional[int] = None, *,
                  device=None) -> EnsembleMesh:
    """The ensemble axis over every rank of the default process group, if
    one is initialized (:func:`.multihost.initialize`); else a mesh of one.

    ``n_devices`` must not exceed the ranks there are (``ValueError``, as
    the JAX function raises for more devices than exist); a rank is a
    process, so a mesh spans every rank: start as many ranks as the mesh
    needs. ``device`` is this rank's device (default: the current
    CUDA device, ``cuda`` resolved; pass ``"cpu"`` for a ``gloo`` run on the
    host)."""
    from ..utils.device import resolve_device

    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if n_devices is not None:
        if n_devices > world:
            raise ValueError(
                f"requested {n_devices} devices but only {world} available")
        if n_devices != world:
            raise ValueError(
                f"a mesh spans every rank: requested {n_devices} of "
                f"{world}; start {n_devices} ranks")
    if device is None:
        device = "cuda"
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            device = f"cuda:{torch.cuda.current_device()}"
    return EnsembleMesh(world_size=world, rank=rank,
                        device=resolve_device(device), backend=backend)


def _count_bytes(op: str, result: torch.Tensor) -> None:
    count("mesh.bytes", (op, str(result.dtype), result.numel()),
          result.numel() * result.element_size())


LOCAL = EnsembleMesh(world_size=1, rank=0, device=torch.device("cpu"))
"""A mesh of one: what the samplers use when no mesh is given."""


def check_divisible(n: int, mesh: EnsembleMesh, what: str = "batch") -> int:
    """``n // world_size``; raises ``ValueError`` on a remainder."""
    if n % mesh.world_size != 0:
        raise ValueError(f"{what} size {n} is not divisible by the mesh's "
                         f"{mesh.world_size} devices")
    return n // mesh.world_size


def _rows(t: torch.Tensor, mesh: EnsembleMesh, dim: int) -> torch.Tensor:
    n = mesh.n_local(t.shape[dim])
    return t.narrow(dim, mesh.rank * n, n)


def shard_ensemble_pytree(tree, mesh: EnsembleMesh, batch_size: int):
    """This rank's rows of every tensor leaf of ``tree`` (dicts, lists,
    tuples and NamedTuples) whose leading dim equals ``batch_size``; every
    other leaf whole. Shape decides here: use :func:`shard_state_fields`
    for a state whose ``(d, d)`` leaves could match the chain count."""
    if isinstance(tree, dict):
        return {k: shard_ensemble_pytree(v, mesh, batch_size)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_ensemble_pytree(v, mesh, batch_size)
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_ensemble_pytree(v, mesh, batch_size)
                          for v in tree)
    if torch.is_tensor(tree) and tree.dim() >= 1 and \
            tree.shape[0] == batch_size:
        return _rows(tree, mesh, 0)
    return tree


def _check_fields(state, batch_fields: Sequence[str]) -> set:
    batch_fields = set(batch_fields)
    unknown = batch_fields - set(state._fields)
    if unknown:
        raise ValueError(f"unknown state fields: {sorted(unknown)}")
    return batch_fields


def shard_state_fields(state, mesh: EnsembleMesh, batch_fields: Sequence[str],
                       batch_dim: int = 0):
    """This rank's rows, along ``batch_dim``, of the NAMED fields of a
    NamedTuple state; every other field whole. Naming the fields keeps a
    ``(d, d)`` covariance whole when ``d`` equals the chain count."""
    fields = _check_fields(state, batch_fields)
    return state._replace(**{name: _rows(getattr(state, name), mesh, batch_dim)
                             for name in fields})


def gather_fields(state, mesh: EnsembleMesh, batch_fields: Sequence[str],
                  batch_dim: int = 0):
    """The inverse of :func:`shard_state_fields`: every rank's rows of the
    named fields, in rank order, on every rank (a collective)."""
    fields = _check_fields(state, batch_fields)
    return state._replace(**{
        name: mesh.all_gather(getattr(state, name), dim=batch_dim)
        for name in sorted(fields)})
