"""The plain reference of the differential-evolution MCMC sampler (DE-MC).

Written from the published description alone, in plain PyTorch (any device,
float64 by default), with no import of the measured program: an ensemble of
N walkers in which a walker proposes a move along the difference of two
other walkers, ``y = x_i + gamma (x_j - x_k) + e``, ``gamma = 2.38 /
sqrt(2 d)`` (ter Braak 2006, Stat. Comput. 16:239, §2.2), accepted by the
Metropolis rule on the log-density, which the move leaves symmetric. It is
written chain by chain; the objective is any callable ``loglik(x (B, d)) ->
(B,)``, called once a step over every walker, and every random number comes
from a draw source the caller gives (``init() -> (N, d)``, ``step(i) -> (z
(N, d), u (N,))`` and ``partners(i) -> (j (N,), k (N,), g_u (N,))``), so
that the measured program and this reference can be fed the same draws.

One step, the ``s``-th of the run (``s`` from 0), with parity ``p = s mod
2``:

1. walker ``i`` moves if ``i mod 2 = p`` (the active half); each other
   walker is frozen this step;
2. an active walker's partners are the frozen walkers ``2 j_i + (1 - p)``
   and ``2 k_i + (1 - p)``; ``gamma`` is 1 where ``g_u < gamma1_prob``, else
   ``2.38 / sqrt(2 d)``;
3. ``y = reflect(x_i + exp(log_scale_i) gamma (x_j - x_k) + noise sigma
   z_i)`` into the box ``[lower, upper]``;
4. the walker accepts when ``log u_i < logp(y) - logp(x_i)`` (``u``
   clamped to 1e-12) or the difference is not negative;
5. its log scale moves by the Robbins-Monro gain ``min(1 / sqrt(s + 2),
   0.1)`` times ``accepted - 0.234``, clamped to ``[-6.9, 2.3]``.

Departures from the paper, all as the production campaign runs them:

- ter Braak updates the walkers one after another, each against the
  current population. Here the update is red-black: half the walkers move
  at once, against the other half frozen (as the parallel stretch move of
  Foreman-Mackey et al. 2013 §3), so that the joint kernel keeps detailed
  balance; a walker moves every second step. Its two partners are drawn
  with replacement from the frozen half, so ``j = k`` may happen (the move
  is then the jitter alone); ter Braak asks for three distinct walkers.
- ter Braak takes ``gamma = 1`` on every tenth generation to jump between
  modes; here each walker takes it with probability ``gamma1_prob`` every
  move.
- ter Braak's ``e`` is a small Gaussian of one scale; here it is ``noise``
  times the proposal sigmas of each parameter.
- The proposal is reflected into the box of the parameters' bounds, which
  keeps the move symmetric.
- The step is scaled by a per-walker Robbins-Monro factor ``exp(log_scale)``
  toward the acceptance 0.234 (Andrieu & Thoms 2008), adapted on the
  walker's own moves.
- A value that is not finite reads ``-1e18`` (the campaign's floor for an
  infeasible state), as does any value below it.
"""

from __future__ import annotations

import math

import torch

from .tempering import TARGET_ACCEPTANCE, floored, reflect


class DEReference:
    """The sampler's settings; :meth:`init` makes a state (a dict of tensors
    and the step count), :meth:`run` a segment of it."""

    def __init__(self, loglik, lower, upper, sigmas, *, thinning: int,
                 gamma1_prob: float = 0.1, noise: float = 1e-6):
        self.loglik, self.lower, self.upper = loglik, lower, upper
        self.sigmas, self.thinning = sigmas, max(1, thinning)
        self.gamma1_prob, self.noise = gamma1_prob, noise

    def value(self, x):
        return floored(self.loglik(x).to(x.dtype))

    def init(self, theta0, z, jitter: float = 1.0) -> dict:
        """Every walker at ``theta0 + jitter * sigmas * z``, reflected,
        walker 0 exactly at ``theta0``."""
        x = theta0[None, :] + jitter * self.sigmas * z
        x[0] = theta0
        x = reflect(x, self.lower, self.upper)
        N = x.shape[0]
        return dict(x=x, logp=self.value(x),
                    log_scale=torch.zeros(N, dtype=x.dtype, device=x.device),
                    accept_count=torch.zeros(N, dtype=torch.int64,
                                             device=x.device),
                    step=0)

    def step(self, st: dict, z, u, j, k, g_u) -> torch.Tensor:
        """Steps 1-5 in place, walker by walker; returns the accept mask."""
        x, logp, log_scale = st["x"], st["logp"], st["log_scale"]
        N, d = x.shape
        p = st["step"] % 2
        gamma0 = 2.38 / math.sqrt(2 * d)
        y = x.clone()                      # a frozen walker proposes itself
        for i in range(p, N, 2):
            a, b = 2 * int(j[i]) + (1 - p), 2 * int(k[i]) + (1 - p)
            gamma = 1.0 if float(g_u[i]) < self.gamma1_prob else gamma0
            y[i] = (x[i] + math.exp(float(log_scale[i])) * gamma * (x[a] - x[b])
                    + self.noise * self.sigmas * z[i])
        y = reflect(y, self.lower, self.upper)
        lp_y = self.value(y)
        accept = torch.zeros(N, dtype=torch.bool, device=x.device)
        st["step"] += 1
        gain = min(1.0 / math.sqrt(st["step"] + 1.0), 0.1)
        for i in range(p, N, 2):
            ratio = float(lp_y[i] - logp[i])
            ok = ratio >= 0 or math.log(max(float(u[i]), 1e-12)) < ratio
            accept[i] = ok
            if ok:
                x[i], logp[i] = y[i], lp_y[i]
            log_scale[i] = min(max(float(log_scale[i])
                                   + gain * (float(ok) - TARGET_ACCEPTANCE),
                                   -6.9), 2.3)
        st["accept_count"] += accept.to(torch.int64)
        return accept

    def run(self, st: dict, draws, steps: int, decisions: list = None):
        """``ceil(steps / thinning)`` blocks of the state ``st`` (changed in
        place), step ``i`` of the run taking ``draws.step(i)`` and
        ``draws.partners(i)``; returns ``(x, logp)`` at every block's end.
        ``decisions`` collects each step's accept mask."""
        blocks = -(-steps // self.thinning)
        out = []
        for b in range(blocks):
            for t in range(self.thinning):
                i = b * self.thinning + t
                acc = self.step(st, *draws.step(i), *draws.partners(i))
                if decisions is not None:
                    decisions.append(acc)
            out.append((st["x"].clone(), st["logp"].clone()))
        return out
