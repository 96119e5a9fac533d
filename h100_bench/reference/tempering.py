"""The plain reference of the replica-exchange (parallel tempering) sampler.

Written from the published description alone, in plain PyTorch (any
device, float64 by default), with no import of the measured program: K
rungs of N chains on an inverse-temperature ladder ``beta_0 = 1 > ... >
beta_{K-1} = beta_min`` (Swendsen & Wang 1986; Geyer 1991; Earl & Deem
2005), each rung an adaptive-Metropolis ensemble (Haario, Saksman &
Tamminen 2001, with the Robbins-Monro scale of Andrieu & Thoms 2008), the
ladder adapted during burn-in after Vousden, Farr & Mandel 2016 (MNRAS
455:1919). It is written rung by rung and pair by pair; the objective is
any callable ``loglik(x (B, d)) -> (B,)``, called once a step over every
rung's chains, and every random number comes from a draw source the
caller gives (``step(i) -> (z (K*N, d), u (K*N,))`` and ``swap(i, (K-1,
N)) -> u``), so that the measured program and this reference can be fed
the same draws.

One step ``i``:

1. every rung k proposes ``y = reflect(x + exp(log_scale) * (z L_k^T))``
   into the box ``[lower, upper]`` and accepts on its TEMPERED ratio
   ``beta_k (logp(y) - logp(x))`` (``logp`` is kept untempered);
2. every chain's log scale moves by the Robbins-Monro gain
   ``min(1 / sqrt(step + 1), 0.1)`` times ``accepted - 0.234``, clamped to
   ``[-6.9, 2.3]``;
3. every ``swap_every`` steps, a swap sweep: on sweep ``j`` each pair
   ``(k, k+1)`` with ``k = j (mod 2)`` exchanges chain ``i`` of rung ``k``
   with chain ``i`` of rung ``k+1`` with probability ``min(1, alpha)``,
   ``log alpha = (beta_k - beta_{k+1}) (logp_{k+1} - logp_k)``, moving
   ``(x, logp)`` together;
4. in burn-in, after each sweep, the ladder moves;
5. at the end of every ``adaptation_period // thinning`` blocks of
   ``thinning`` steps, every rung's proposal covariance is re-estimated.

Departures from the papers, all as the production campaign runs them:

- Haario et al. estimate the covariance from one chain's history; here from
  the rung's ensemble cross-section at a block boundary, ``(2.38^2 / d)
  Sigma + eps I``, factored as ``Sigma' + eps I`` (eps added twice), and a
  rung whose factorization fails keeps its previous factor. The
  re-estimation runs from step 0, not only after burn-in.
- The Robbins-Monro scale is one per chain, not one per rung.
- Vousden et al. move the log spacings ``S_k = log(T_{k+1} - T_k)`` by
  ``kappa(t) (A_k - A_{k+1})`` with the empirical swap acceptance ``A``
  and the hottest temperature free or fixed; here by ``kappa(t) (A_k -
  mean A)``, ``A`` the per-pair exponential moving average (weight
  ``ladder_ema``, updated on the sweeps that try the pair) of the analytic
  ``min(1, alpha)`` averaged over the chains, and the spacings are
  normalised by a softmax so both ends stay pinned: ``T_0 = 1``, ``T_{K-1}
  = 1 / beta_{K-1}``. ``kappa(t) = kappa t0 / (t + t0)`` in sweeps ``t``,
  and the gain is held at 0 for the first two sweeps (until both parities
  have been tried).
- A value that is not finite reads ``-1e18`` (the campaign's floor for an
  infeasible state), as does any value below it.
"""

from __future__ import annotations

import math

import torch

FLOOR = -1e18
TARGET_ACCEPTANCE = 0.234


def reflect(x, lower, upper):
    """``x`` folded into ``[lower, upper]`` by reflection off the bounds (a
    degenerate bound holds its lower value)."""
    w = upper - lower
    deg = w <= 0
    w = torch.where(deg, torch.ones_like(w), w)
    y = torch.remainder(x - lower, 2.0 * w)
    y = torch.where(y < 0, y + 2.0 * w, y)
    return torch.where(deg, lower, torch.where(y <= w, lower + y, upper - (y - w)))


def floored(v):
    return torch.where(torch.isfinite(v), torch.clamp_min(v, FLOOR),
                       torch.full_like(v, FLOOR))


class PTReference:
    """The sampler's settings; :meth:`init` makes a state (a dict of
    tensors and the step count), :meth:`run` a segment of it."""

    def __init__(self, loglik, lower, upper, *, burn_in: int,
                 adaptation_period: int, thinning: int, swap_every: int = 1,
                 adapt_ladder: bool = True, ladder_kappa: float = 0.3,
                 ladder_t0: float = 1000.0, ladder_ema: float = 0.1,
                 reg_eps: float = 1e-6):
        self.loglik, self.lower, self.upper = loglik, lower, upper
        self.burn_in, self.thinning = burn_in, max(1, thinning)
        self.adaptation_period = adaptation_period
        self.swap_every = max(1, swap_every)
        self.adapt_ladder, self.kappa, self.t0 = adapt_ladder, ladder_kappa, ladder_t0
        self.ema, self.eps = ladder_ema, reg_eps

    def value(self, x):
        """The floored objective of ``x (K, N, d)``, one call over every row."""
        K, N, d = x.shape
        return floored(self.loglik(x.reshape(K * N, d)).to(x.dtype)).reshape(K, N)

    # ---------------------------------------------------------------- start
    def init(self, theta0, sigmas, z, cov0, betas, K: int, N: int,
             jitter: float = 1.0) -> dict:
        """Every chain at ``theta0 + jitter * sigmas * z`` (``z`` (K*N, d)),
        reflected, rung 0's chain 0 exactly at ``theta0``; every rung's
        covariance ``cov0 + eps I`` and its Cholesky factor."""
        d = theta0.shape[0]
        x = theta0[None, :] + jitter * sigmas * z
        x[0] = theta0
        x = reflect(x, self.lower, self.upper).reshape(K, N, d)
        logp = self.value(x)
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        cov = cov0.to(x.dtype) + self.eps * eye
        L = torch.linalg.cholesky(cov)
        zeros = lambda *s, dt=x.dtype: torch.zeros(s, dtype=dt, device=x.device)
        betas = betas.to(x.dtype)
        T = 1.0 / betas
        return dict(x=x, logp=logp, log_scale=zeros(K, N),
                    chol=torch.stack([L] * K), cov=torch.stack([cov] * K),
                    accept_count=zeros(K, N, dt=torch.int64),
                    swap_accept=zeros(max(K - 1, 1), dt=torch.int64),
                    swap_tries=zeros(max(K - 1, 1), dt=torch.int64),
                    betas=betas,
                    spacings=torch.log(torch.clamp_min(T[1:] - T[:-1], 1e-30))
                    if K > 1 else zeros(1),
                    swap_prob=zeros(max(K - 1, 1)), step=0)

    # ---------------------------------------------------------------- moves
    def mh_step(self, st: dict, z, u) -> torch.Tensor:
        """Step 1 and 2 in place; returns the accept mask ``(K, N)``."""
        x, K = st["x"], st["x"].shape[0]
        prop = torch.empty_like(x)
        for k in range(K):
            step = (z[k] @ st["chol"][k].T) * torch.exp(st["log_scale"][k])[:, None]
            prop[k] = reflect(x[k] + step, self.lower, self.upper)
        lp_prop = self.value(prop)
        accept = torch.zeros_like(st["logp"], dtype=torch.bool)
        for k in range(K):
            log_ratio = st["betas"][k] * (lp_prop[k] - st["logp"][k])
            accept[k] = (log_ratio >= 0) | (torch.log(torch.clamp_min(u[k], 1e-12))
                                            < log_ratio)
            st["x"][k] = torch.where(accept[k][:, None], prop[k], x[k])
            st["logp"][k] = torch.where(accept[k], lp_prop[k], st["logp"][k])
        st["accept_count"] += accept.to(torch.int64)
        st["step"] += 1
        gain = min(1.0 / math.sqrt(st["step"] + 1.0), 0.1)
        st["log_scale"] = torch.clamp(
            st["log_scale"] + gain * (accept.to(x.dtype) - TARGET_ACCEPTANCE),
            -6.9, 2.3)
        return accept

    def swap(self, st: dict, u, parity: int) -> torch.Tensor:
        """Step 3 in place, pair by pair; returns the exchange mask
        ``(K-1, N)``."""
        x, logp, betas = st["x"], st["logp"], st["betas"]
        K, N = logp.shape
        done = torch.zeros((max(K - 1, 1), N), dtype=torch.bool, device=x.device)
        for k in range(K - 1):
            if k % 2 != parity % 2:
                continue
            log_alpha = (betas[k] - betas[k + 1]) * (logp[k + 1] - logp[k])
            p = torch.exp(torch.clamp_max(log_alpha, 0.0)).sum() / N
            st["swap_prob"][k] = (1.0 - self.ema) * st["swap_prob"][k] + self.ema * p
            acc = (log_alpha >= 0) | (torch.log(torch.clamp_min(u[k], 1e-12))
                                      < log_alpha)
            x_lo, x_hi = x[k].clone(), x[k + 1].clone()
            lp_lo, lp_hi = logp[k].clone(), logp[k + 1].clone()
            x[k] = torch.where(acc[:, None], x_hi, x_lo)
            x[k + 1] = torch.where(acc[:, None], x_lo, x_hi)
            logp[k] = torch.where(acc, lp_hi, lp_lo)
            logp[k + 1] = torch.where(acc, lp_lo, lp_hi)
            st["swap_accept"][k] += int(acc.sum())
            st["swap_tries"][k] += N
            done[k] = acc
        return done

    def move_ladder(self, st: dict):
        """Step 4 in place."""
        K = st["betas"].shape[0]
        if K < 3:
            return
        t = float(st["step"] // self.swap_every)
        gain = self.kappa * self.t0 / (t + self.t0) if t >= 2.0 else 0.0
        A = st["swap_prob"]
        s = st["spacings"] + gain * (A - A.mean())
        t_max = 1.0 / st["betas"][-1]
        w = torch.exp(s - s.max())
        cum = torch.cumsum(w / w.sum(), 0)
        T = torch.cat([torch.ones_like(t_max)[None], 1.0 + (t_max - 1.0) * cum])
        st["spacings"], st["betas"] = s, 1.0 / T

    def adapt_cov(self, st: dict):
        """Step 5 in place, rung by rung."""
        x = st["x"]
        K, N, d = x.shape
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        for k in range(K):
            c = x[k] - x[k].sum(0) / N
            cov = (c.T @ c) / max(N - 1, 1)
            cov = (2.38 ** 2 / d) * cov + self.eps * eye
            L, info = torch.linalg.cholesky_ex(cov + self.eps * eye)
            st["cov"][k] = cov
            if int(info) == 0 and bool(torch.isfinite(L).all()):
                st["chol"][k] = L

    # ------------------------------------------------------------------ run
    def run(self, st: dict, draws, steps: int, decisions: list = None):
        """``ceil(steps / thinning)`` blocks of the state ``st`` (changed in
        place), step ``i`` taking ``draws.step(i)`` and, on a sweep,
        ``draws.swap(i, (K-1, N))``; returns the cold rung's ``(x, logp)``
        at every block's end. ``decisions`` collects ``(step accepts, swap
        exchanges or None)`` a step."""
        K, N, d = st["x"].shape
        blocks = -(-steps // self.thinning)
        adapt_every = max(1, self.adaptation_period // self.thinning)
        cold = []
        for b in range(blocks):
            for t in range(self.thinning):
                i = b * self.thinning + t
                z, u = draws.step(i)
                acc = self.mh_step(st, z.reshape(K, N, d), u.reshape(K, N))
                ex = None
                if st["step"] % self.swap_every == 0:
                    ex = self.swap(st, draws.swap(i, (K - 1, N)),
                                   st["step"] // self.swap_every)
                    if self.adapt_ladder and st["step"] <= self.burn_in:
                        self.move_ladder(st)
                if decisions is not None:
                    decisions.append((acc, ex))
            if (st["step"] // self.thinning) % adapt_every == 0:
                self.adapt_cov(st)
            cold.append((st["x"][0].clone(), st["logp"][0].clone()))
        return cold
