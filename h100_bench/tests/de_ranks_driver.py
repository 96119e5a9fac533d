"""A sampler driver for the harness's tests of one process a rank: DE-MC
(``MHConfig(proposal="de")``) through the program's sharded runner
``parallel.run_mh_sharded`` on ``setup.mesh``.

A unit is one call of the runner of ``segment_steps`` steps, resumed from
the previous call's final state, with the draws of ``(seed, unit)`` made
for the cell's global chains (each rank takes its rows). The first
``warm_units`` units are set-up. ``final()`` returns this rank's rows.

Test hooks, from the cell's overrides:

- ``fault``: ``{"rank": r, "unit": u, "kind": k}``: rank ``r`` in its unit
  ``u`` (0 is the first) raises (``raise``), puts a ``jax`` module in
  ``sys.modules`` (``jax``: what the import check reads), kills itself
  (``kill``) or hangs (``hang``);
- on a mesh of more than one rank the last rank's window clock stands
  still, so that only rank 0's shared decision can close its window at the
  same unit as the others'.

``extra`` puts the gathered final rows and accept counts under the line's
``extra``, so that a test can compare runs at different rank counts.
"""

from __future__ import annotations

import os
import signal
import sys
import time
import types

from h100_bench import window as bench_window

KERNEL_LIBS = ("sepaihrd_fused",)


def _stop_clock():
    bench_window.time = types.SimpleNamespace(perf_counter=lambda: 0.0)


def _fail(kind: str):
    if kind == "raise":
        raise RuntimeError("a planted fault in a rank's unit")
    if kind == "jax":
        sys.modules["jax"] = types.ModuleType("jax")
    elif kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "hang":
        while True:
            time.sleep(60)


class Driver:
    def __init__(self, setup, cell: dict, seed: int, window, tmpdir: str):
        self.s, self.cell, self.seed, self.win = setup, cell, int(seed), window
        self.mesh = setup.mesh
        self.chains = int(cell["chains"])            # global
        self.unit_iterations = int(cell["segment_steps"])
        self.fault = cell.get("fault")
        self.state = None
        self.x_start = None
        if self.mesh.world_size > 1 and self.mesh.rank == self.mesh.world_size - 1:
            _stop_clock()

    def run(self):
        from mmidv1_tpu_torch.calibration.calibrator import condition_covariance
        from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
        from mmidv1_tpu_torch.calibration.mh import MHConfig
        from mmidv1_tpu_torch.parallel import run_mh_sharded

        s, win = self.s, self.win
        obj = win.wrap(s.objective())
        cov = condition_covariance(s.as_t(s.post_cov), s.space.sigmas)
        cfg = MHConfig(iterations=self.unit_iterations, burn_in=0,
                       thinning=self.unit_iterations, proposal="de",
                       store_samples=False)
        warm = int(self.cell["warm_units"])
        k = 0
        while True:
            if self.fault and self.fault["rank"] == self.mesh.rank \
                    and self.fault["unit"] == k:
                _fail(self.fault["kind"])
            if k == warm:
                win.start()
                self.x_start = self.state.x.clone()
            draws = SeededRunDraws(self.seed, k, self.chains, s.space.dim,
                                   s.dtype, s.device)
            result = run_mh_sharded(obj, s.space, s.theta_map, cfg,
                                    n_chains=self.chains, mesh=self.mesh,
                                    draws=draws, initial_state=self.state,
                                    initial_cov=cov, jitter=1.0)
            self.state = result.final_state
            k += 1
            if k > warm and win.unit_done(self.unit_iterations):
                return

    def final(self) -> dict:
        st = self.state
        return dict(kind="theta", x=st.x.detach(), logp=st.logp.detach(),
                    x_start=self.x_start, accept=st.accept_count.detach())

    def free(self):
        self.state = None


def extra(final, config, cell, device, num_days):
    return {"x": final["x"].double().cpu().tolist(),
            "logp": final["logp"].double().cpu().tolist(),
            "accept": final["accept"].cpu().tolist()}

