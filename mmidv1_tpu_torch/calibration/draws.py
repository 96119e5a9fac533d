"""Draw sources for the ensemble samplers (AM / DE-MC and parallel tempering).

The step functions of :mod:`.mh` and :mod:`.tempering` take every random
draw as a tensor; a runner asks a draw source for them, step by step:

- ``init() -> (n, d)`` standard normals, the start's jitter;
- ``step(i) -> (z (n, d), u (n,))``, the Gaussian proposals and the accept
  uniforms of the run's ``i``-th step;
- ``partners(i) -> (j, k, g_u)``, DE-MC's partner rows (int64 in
  ``[0, n/2)``) and its gamma uniforms ``(n,)``;
- ``swap(i, shape) -> u``, the replica-exchange uniforms of step ``i``.

:class:`SeededRunDraws` makes each of them from a ``torch.Generator`` seeded
by a pure function of ``(seed, purpose, segment, step)``: a campaign resumed
at segment ``s`` draws exactly what the uninterrupted one drew there, as the
JAX package's ``fold_in(key, s)`` does. :class:`GeneratorDraws` reads one
generator in call order. The tests hand the runners a third source that
makes the JAX package's own draws from its keys.

:class:`ShardDraws` hands one rank of a sharded run its rows of any source
made at the GLOBAL chain count (the counterpart of
``mmidv1_tpu/calibration/mh.py:160-174``): draws made at the local count
would differ from the global table's rows, so a chain would see another
stream on 1 rank than on W.
"""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(seed: int, words, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``(seed, *words)`` through NumPy's
    ``SeedSequence``: the same words give the same stream on every run."""
    seed = int(seed)
    s = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, *words]) \
        .generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(s[0]) << 31) ^ int(s[1]))
    return g


class _Draws:
    """The draws of an ensemble of ``n`` chains in ``d`` dimensions, each
    from the generator :meth:`_gen` gives for its purpose and step."""

    def __init__(self, n: int, d: int, dtype: torch.dtype, device):
        self.n, self.d = n, d
        self.dtype, self.device = dtype, torch.device(device)

    def _gen(self, purpose: int, i: int = 0) -> torch.Generator:
        raise NotImplementedError

    def _normal(self, g, shape):
        return torch.randn(shape, generator=g, dtype=self.dtype,
                           device=self.device)

    def _uniform(self, g, shape):
        return torch.rand(shape, generator=g, dtype=self.dtype,
                          device=self.device)

    def init(self) -> torch.Tensor:
        return self._normal(self._gen(0), (self.n, self.d))

    def step(self, i: int):
        g = self._gen(1, i)
        return self._normal(g, (self.n, self.d)), self._uniform(g, (self.n,))

    def partners(self, i: int):
        g = self._gen(2, i)
        half = self.n // 2
        j = torch.randint(0, half, (self.n,), generator=g, device=self.device)
        k = torch.randint(0, half, (self.n,), generator=g, device=self.device)
        return j, k, self._uniform(g, (self.n,))

    def swap(self, i: int, shape) -> torch.Tensor:
        return self._uniform(self._gen(3, i), shape)


class SeededRunDraws(_Draws):
    """Every draw of segment ``segment`` of a run seeded with ``seed``, from a
    generator per ``(purpose, segment, step)``."""

    def __init__(self, seed: int, segment: int, n: int, d: int,
                 dtype: torch.dtype, device):
        super().__init__(n, d, dtype, device)
        self.seed, self.segment = int(seed), int(segment)

    def _gen(self, purpose, i=0):
        return seeded_generator(self.seed, (purpose, self.segment, i),
                                self.device)


class GeneratorDraws(_Draws):
    """Every draw from one ``torch.Generator``, in the order they are asked
    for."""

    def __init__(self, generator: torch.Generator, n: int, d: int,
                 dtype: torch.dtype, device):
        super().__init__(n, d, dtype, device)
        self.generator = generator

    def _gen(self, purpose, i=0):
        return self.generator


class ShardDraws:
    """Rows ``[offset, offset + n_local)`` of a draw source made for
    ``n_total`` chains a rung (``rungs`` rungs, rung-major, as parallel
    tempering lays its ``(K, N)`` rows out): ``init``, ``step``,
    ``partners`` and ``swap`` of :class:`_Draws`, and ``jitter``,
    ``eps_momentum`` and ``iteration`` of NUTS's ``SeededDraws``. DE-MC's
    partner draws ``j, k`` stay global row indices."""

    def __init__(self, source, n_total: int, offset: int, n_local: int,
                 rungs: int = 1):
        self.source, self.n_total = source, n_total
        self.offset, self.n_local, self.rungs = offset, n_local, rungs

    def _rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's chains of ``t``, whose ``dim`` holds ``rungs *
        n_total`` rows."""
        shape = t.shape
        t = t.reshape(shape[:dim] + (self.rungs, self.n_total) + shape[dim + 1:])
        t = t.narrow(dim + 1, self.offset, self.n_local)
        return t.reshape(shape[:dim] + (self.rungs * self.n_local,)
                         + shape[dim + 1:])

    def init(self) -> torch.Tensor:
        return self._rows(self.source.init())

    def step(self, i: int):
        return tuple(self._rows(t) for t in self.source.step(i))

    def partners(self, i: int):
        return tuple(self._rows(t) for t in self.source.partners(i))

    def swap(self, i: int, shape) -> torch.Tensor:
        shape = tuple(shape)
        u = self.source.swap(i, shape[:-1] + (self.n_total,))
        return u.narrow(len(shape) - 1, self.offset, self.n_local)

    def jitter(self) -> torch.Tensor:
        return self._rows(self.source.jitter())

    def eps_momentum(self) -> torch.Tensor:
        return self._rows(self.source.eps_momentum())

    def iteration(self, it: int):
        d = self.source.iteration(it)
        return d._replace(r0=self._rows(d.r0), u=self._rows(d.u),
                          v=self._rows(d.v, 1),
                          leaf_u=tuple(self._rows(t, 1) for t in d.leaf_u),
                          accept_u=self._rows(d.accept_u, 1))


def shard_draws(source, mesh, n_total: int, rungs: int = 1):
    """``source`` itself on a mesh of one, else its :class:`ShardDraws`
    for this rank of ``mesh`` (an :class:`~mmidv1_tpu_torch.parallel.mesh.
    EnsembleMesh`)."""
    if mesh.world_size == 1:
        return source
    return ShardDraws(source, n_total, mesh.offset(n_total),
                      mesh.n_local(n_total), rungs)
