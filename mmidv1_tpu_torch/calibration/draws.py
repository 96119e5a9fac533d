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
