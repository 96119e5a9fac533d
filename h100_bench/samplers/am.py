"""Adaptive-Metropolis ensemble through the program's campaign driver.

The window drives ``calibration.mh.run_mh_checkpointed`` as the production
campaign does (``cli/production_campaign``'s AM path): segments of the
segment program (``make_mh_runner``) on K1 (``build_objective_fused``,
REFLECT), the thinned samples moved to the host after each, and with
``checkpoint`` the state saved (``utils.checkpoint.save_mh_state``) into
``$TMPDIR``. The warm covariance is the committed posterior's, conditioned
by the program (``calibrator.condition_covariance``); the chains start at
the committed MAP jittered by draws of the seed. The first ``warm_units``
segments are set-up; the window counts whole segments after them.
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
        self.unit_iterations = int(cell["segment_steps"])
        self.state = None
        self.x_start = None

    def run(self):
        from mmidv1_tpu_torch.calibration.calibrator import condition_covariance
        from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
        from mmidv1_tpu_torch.calibration.mh import MHConfig, run_mh_checkpointed

        s, c, win = self.s, self.cell, self.win
        obj = win.wrap(s.objective())
        cov = condition_covariance(s.as_t(s.post_cov), s.space.sigmas)
        seg = self.unit_iterations
        segments = 10 ** 6            # the window, not the count, ends the run
        cfg = MHConfig(iterations=seg * segments, burn_in=int(c["burn_in"]),
                       adaptation_period=int(c["adaptation_period"]),
                       thinning=int(c["thinning"]), proposal="am")
        warm = int(c["warm_units"])
        ckpt = None
        if c.get("checkpoint"):
            ckpt = os.path.join(self.tmpdir, "campaign_checkpoint.npz")
            if os.path.exists(ckpt):
                os.remove(ckpt)

        def draws_for_segment(k):
            win.end()                               # the previous segment's I/O
            if k == warm:
                win.start()
                self.x_start = self.state.x.clone()
            elif k > warm and win.unit_done(seg):
                raise WindowClosed
            return SeededRunDraws(self.seed, k, self.chains, s.space.dim,
                                  s.dtype, s.device)

        def on_segment(k, result):
            # the samples are on the host (a synchronising copy); what
            # follows until the next segment is the checkpoint's I/O
            self.state = result.final_state
            win.begin("campaign_io")

        try:
            run_mh_checkpointed(obj, s.space, s.theta_map, cfg, seed=self.seed,
                                n_chains=self.chains, segments=segments,
                                checkpoint_path=ckpt, resume=False,
                                initial_cov=cov, jitter=1.0,
                                on_segment=on_segment,
                                draws_for_segment=draws_for_segment)
        except WindowClosed:
            pass
        if ckpt and os.path.exists(ckpt):
            os.remove(ckpt)

    def final(self) -> dict:
        """What the window produced: the final positions and the objective
        values the program holds for them."""
        st = self.state
        return dict(kind="theta", x=st.x.detach(), logp=st.logp.detach(),
                    x_start=self.x_start)

    def free(self):
        self.state = None
