"""Parallel tempering through the program's campaign driver.

The window drives ``calibration.tempering.run_pt_checkpointed`` as the
production campaign does (``cli/production_campaign --rungs K``): segments
of the segment program (``make_pt_runner``: the tempered step, a swap sweep
every ``swap_every`` steps, the per-rung covariances, the ladder adapted in
burn-in) on K1 (``build_objective_fused``, REFLECT) over every rung's
chains, the cold rung's thinned samples moved to the host after each, and
with ``checkpoint`` the state saved (``utils.checkpoint.save_pt_state``)
into ``$TMPDIR``. The configuration gives the ladder (``n_rungs``,
``beta_min``); the cell's ``chains`` counts every slot of every rung. The
warm covariance is the committed posterior's, conditioned by the program
(``calibrator.condition_covariance``); the chains start at the committed
MAP jittered by draws of the seed. The first ``warm_units`` segments (the
burn-in, and so all of the ladder's adaptation) are set-up; the window
counts whole segments after them.

In traced runs the program's own tracer is on, without ``record_function``
ranges, over the timed window only: its snapshot is kept on the timed
phase (``Phase.program``, which ``metrics/_program.py`` reads) when the
window closes, and the tracer is off again before the profiled window. A
window that switches the tracer itself (``program_trace.ProgramWindow``)
is left to do so.
"""

from __future__ import annotations

import os

from h100_bench.window import WindowClosed

KERNEL_LIBS = ("sepaihrd_fused",)


class Driver:
    def __init__(self, setup, cell: dict, seed: int, window, tmpdir: str):
        self.s, self.cell, self.seed, self.win = setup, cell, int(seed), window
        self.tmpdir = tmpdir
        self.chains = int(cell["chains"])
        self.rungs = int(setup.config["n_rungs"])
        if self.chains % self.rungs:
            raise ValueError("the cell's chains must divide evenly by the rungs")
        if int(cell["swap_every"]) != int(setup.config["swap_every"]):
            raise ValueError("the cell's swap_every is not its configuration's")
        self.unit_iterations = int(cell["segment_steps"])
        self.state = None
        self.x_start = None
        # a window that switches the tracer itself (program_trace.ProgramWindow,
        # which also stands in for window.Window while it runs) is left to do so
        owner = next(c for c in type(window).__mro__ if "start" in vars(c))
        self.own_tracer = window.trace and owner.__module__ == "h100_bench.window"
        self.tracing = False

    def _tracer(self, on: bool):
        from mmidv1_tpu_torch.utils import trace
        if on:
            trace.reset()
            trace.enable()
        else:
            if self.win.timed.t1 and not hasattr(self.win.timed, "program"):
                self.win.timed.program = trace.snapshot()
            trace.disable()
        self.tracing = on

    def run(self):
        from mmidv1_tpu_torch.calibration.calibrator import condition_covariance
        from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
        from mmidv1_tpu_torch.calibration.tempering import (PTConfig,
                                                            run_pt_checkpointed)

        s, c, cfg, win = self.s, self.cell, self.s.config, self.win
        obj = win.wrap(s.objective())
        cov = condition_covariance(s.as_t(s.post_cov), s.space.sigmas)
        seg = self.unit_iterations
        segments = 10 ** 6            # the window, not the count, ends the run
        K = self.rungs
        pt_cfg = PTConfig(iterations=seg * segments, burn_in=int(c["burn_in"]),
                          adaptation_period=int(c["adaptation_period"]),
                          thinning=int(c["thinning"]), n_rungs=K,
                          beta_min=float(cfg["beta_min"]),
                          swap_every=int(c["swap_every"]),
                          adapt_ladder=cfg["adapt_ladder"] == "burn_in")
        warm = int(c["warm_units"])
        ckpt = None
        if c.get("checkpoint"):
            ckpt = os.path.join(self.tmpdir, "campaign_checkpoint_pt.npz")
            if os.path.exists(ckpt):
                os.remove(ckpt)

        def draws_for_segment(k):
            win.end()                               # the previous segment's I/O
            if k == warm:
                if self.own_tracer:
                    self._tracer(True)
                win.start()
                self.x_start = self._flat(self.state)[0].clone()
            elif k > warm:
                if win.unit_done(seg):
                    raise WindowClosed
                if self.tracing and win.timed.t1:   # the timed window closed
                    self._tracer(False)
            return SeededRunDraws(self.seed, k, self.chains, s.space.dim,
                                  s.dtype, s.device)

        def on_segment(k, result):
            # the samples are on the host (a synchronising copy); what
            # follows until the next segment is the checkpoint's I/O
            self.state = result.final_state
            win.begin("campaign_io")

        try:
            run_pt_checkpointed(obj, s.space, s.theta_map, pt_cfg, seed=self.seed,
                                n_chains=self.chains // K, segments=segments,
                                checkpoint_path=ckpt, resume=False,
                                initial_cov=cov, jitter=1.0,
                                on_segment=on_segment,
                                draws_for_segment=draws_for_segment)
        except WindowClosed:
            pass
        finally:
            if self.tracing:
                self._tracer(False)
        if ckpt and os.path.exists(ckpt):
            os.remove(ckpt)

    @staticmethod
    def _flat(st):
        """``(x, logp)`` of every slot, rung-major: ``(K*N, d)``, ``(K*N,)``."""
        K, N, d = st.x.shape
        return st.x.reshape(K * N, d), st.logp.reshape(K * N)

    def final(self) -> dict:
        """What the window produced: every slot's final position and the
        objective value the program holds for it (a swap moves both)."""
        x, logp = self._flat(self.state)
        return dict(kind="theta", x=x.detach(), logp=logp.detach(),
                    x_start=self.x_start)

    def free(self):
        self.state = None
