"""DE-MC over the ranks of ``setup.mesh`` through the program's campaign driver.

The window drives ``calibration.mh.run_mh_checkpointed(..., mesh=setup.mesh)``
as the production campaign does under a launcher (``torchrun ...
cli/production_campaign --proposal de``): segments of the segment program
(``make_mh_runner``: DE-MC's red-black step, its walker table gathered from
every rank once a step) on K1 (``build_objective_fused``, REFLECT), each
rank on its ``chains / W`` rows of the global draws of ``(seed, segment)``,
the gathered thinned samples moved to the host after each segment, and with
``checkpoint`` each rank's shard of the state saved
(``utils.checkpoint.save_mh_state``) into its ``$TMPDIR``. The warm
covariance is the committed posterior's, conditioned by the program
(``calibrator.condition_covariance``); the chains start at the committed
MAP jittered by draws of the seed. The first ``warm_units`` segments are
set-up; the window counts whole segments after them.

In traced runs the program's own tracer is on, without ``record_function``
ranges, over the timed window only: its snapshot is kept on the timed
phase (``Phase.program``, which ``metrics/_program.py`` reads) when the
window closes, and the tracer is off again before the profiled window.
``final()`` returns this rank's rows.

The objective check at the final states (``check.py``) cannot see the walker
exchange: a chain that took its partners from the wrong rows still holds
the value of its own position. So once the window has closed the runner
goes on for two steps of the next segment, on the timed path's graphs: the
first is the step checked, from the window's final state; the second's
frozen half is what the first left of its moving chains. ``final()`` adds
what the objective saw in both (its inputs, and its values in the first)
to this rank's rows, and :func:`extra`, on rank 0 with every rank's rows
gathered, recomputes the first step over the whole ensemble with the plain
reference (``reference/de.py``) and the program's values at its proposals:
the proposals and each moving chain's outcome must be the reference's, or
the run fails (:func:`step_check`).
"""

from __future__ import annotations

import os

from h100_bench.window import WindowClosed

KERNEL_LIBS = ("sepaihrd_fused",)
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _CheckSteps:
    """A segment's draws whose runner stops before its third step: the two
    steps that :func:`step_check` reads."""

    def __init__(self, draws):
        self.draws = draws

    def init(self):
        return self.draws.init()

    def partners(self, i):
        return self.draws.partners(i)

    def step(self, i):
        if i == 2:
            raise WindowClosed
        return self.draws.step(i)


class Driver:
    def __init__(self, setup, cell: dict, seed: int, window, tmpdir: str):
        self.s, self.cell, self.seed, self.win = setup, cell, int(seed), window
        self.tmpdir = tmpdir
        self.chains = int(cell["chains"])            # global
        self.unit_iterations = int(cell["segment_steps"])
        self.state = None
        self.x_start = None
        self.tracing = False
        self.check_segment = None
        self.seen = None        # (input, values) of the objective's calls

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
        from mmidv1_tpu_torch.calibration.mh import MHConfig, run_mh_checkpointed

        s, c, cfg, win = self.s, self.cell, self.s.config, self.win
        timed = win.wrap(s.objective())

        def obj(x):
            v = timed(x)
            if self.seen is not None:
                self.seen.append((x.clone(), v.clone()))
            return v

        cov = condition_covariance(s.as_t(s.post_cov), s.space.sigmas)
        seg = self.unit_iterations
        segments = 10 ** 6            # the window, not the count, ends the run
        mh_cfg = MHConfig(iterations=seg * segments, burn_in=int(c["burn_in"]),
                          thinning=int(c["thinning"]), proposal="de",
                          de_gamma1_prob=float(cfg["de_gamma1_prob"]),
                          de_noise=float(cfg["de_noise"]))
        warm = int(c["warm_units"])
        ckpt = None
        if c.get("checkpoint"):
            ckpt = os.path.join(self.tmpdir, "campaign_checkpoint.npz")

        def draws_for_segment(k):
            win.end()                               # the previous segment's I/O
            if k == warm:
                if win.trace:
                    self._tracer(True)
                win.start()
                self.x_start = self.state.x.clone()
            elif k > warm:
                if self.check_segment is None and win.unit_done(seg):
                    # every window closed: the two steps the check reads
                    self.check_segment, self.seen = k, []
                    return _CheckSteps(SeededRunDraws(
                        self.seed, k, self.chains, s.space.dim, s.dtype,
                        s.device))
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
            run_mh_checkpointed(obj, s.space, s.theta_map, mh_cfg, seed=self.seed,
                                n_chains=self.chains, segments=segments,
                                checkpoint_path=ckpt, resume=False,
                                initial_cov=cov, jitter=1.0,
                                on_segment=on_segment,
                                draws_for_segment=draws_for_segment,
                                mesh=s.mesh)
        except WindowClosed:
            pass
        finally:
            if self.tracing:
                self._tracer(False)

    def final(self) -> dict:
        """What the window produced on this rank: its final positions, the
        objective values the program holds for them and their scales; and
        for :func:`step_check` the objective's inputs at the two steps
        after the window (``check_y``, ``check_next``), its values at the
        first (``check_v``), and where their draws come from."""
        st = self.state
        out = dict(kind="theta", x=st.x.detach(), logp=st.logp.detach(),
                   x_start=self.x_start, log_scale=st.log_scale.detach(),
                   step=int(st.step), seed=self.seed,
                   check_segment=self.check_segment)
        if self.seen is not None and len(self.seen) == 2:
            (y, v), (y_next, _) = self.seen
            out.update(check_y=y, check_v=v, check_next=y_next)
        return out

    def free(self):
        self.state = None
        self.seen = None


def _sigmas(config: dict, names) -> list:
    """The proposal sigmas of the configuration's tree, in ``names``'
    order."""
    path = os.path.join(HERE, config["data"], "data", "configuration",
                        "proposal_sigmas.txt")
    sig = {}
    with open(path) as f:
        for line in f:
            tok = line.split("#", 1)[0].split()
            if tok:
                sig[tok[0]] = float(tok[1])
    return [sig[n] for n in names]


def step_check(final: dict, config: dict, device, num_days=None) -> dict:
    """The first step after the window, over every chain, recomputed by the
    plain reference (``reference/de.py``, float64 on the host) from the
    window's final state and the global draws of its segment, with the
    program's objective values at its proposals. With ``eps`` the program's
    dtype's and ``tol = 16 eps (|x| + |y| + |lower| + |upper|)`` an
    element's rounding room:

    - ``proposal_gap``: the largest ``|program - reference|`` of a proposal
      over its ``tol``, every chain (a frozen one proposes its position);
    - each moving chain's outcome, read from the next step's frozen half
      (its position then, within ``tol``, is its proposal or its old
      position): ``outcome_unread`` counts those whose position is neither,
      ``decisions_differ`` those decided otherwise than by the reference,
      leaving out ``ties``, where ``log u`` and the log ratio lie within
      ``8 eps`` of their sizes, and those whose proposal is its old position.

    Raises where a proposal is beyond its room, no chain moved, or an
    outcome is unread or different; else returns the numbers, with ``moved`` and ``accepted``
    (moving chains whose proposal left their position, and those the
    reference accepts) to show the check is not vacuous."""
    import torch

    from h100_bench.check import reference_for
    from h100_bench.reference.de import DEReference
    from h100_bench.reference.tempering import floored
    from mmidv1_tpu_torch.calibration.draws import SeededRunDraws

    if "check_y" not in final:
        raise RuntimeError("DE step check: the runner left no step after the "
                           "window to check")
    f64 = torch.float64
    host = lambda t: t.detach().to("cpu", f64)
    x0, lp0, ls0 = host(final["x"]), host(final["logp"]), host(final["log_scale"])
    y, v, y_next = (host(final[k]) for k in ("check_y", "check_v", "check_next"))
    N, d = x0.shape
    eps = torch.finfo(final["x"].dtype).eps
    box = reference_for(config, os.path.join(HERE, config["data"]),
                        device="cpu", num_days=num_days)
    lo, hi = box.lo.double(), box.hi.double()
    sig = torch.tensor(_sigmas(config, box.names), dtype=f64)
    draws = SeededRunDraws(final["seed"], final["check_segment"], N, d,
                           final["x"].dtype, device)
    z, u = (host(t) for t in draws.step(0))
    j, k, g_u = draws.partners(0)
    seen = []

    def program_values(q):
        seen.append(q.clone())
        return v

    ref = DEReference(program_values, lo, hi, sig, thinning=1,
                      gamma1_prob=float(config["de_gamma1_prob"]),
                      noise=float(config["de_noise"]))
    st = dict(x=x0.clone(), logp=lp0.clone(), log_scale=ls0.clone(),
              accept_count=torch.zeros(N, dtype=torch.int64),
              step=int(final["step"]))
    acc_ref = ref.step(st, z, u, j.cpu(), k.cpu(), host(g_u))
    y_ref = seen[0]
    tol = 16 * eps * (x0.abs() + y_ref.abs() + lo.abs() + hi.abs())
    gap = float(((y - y_ref).abs() / tol).max())

    active = torch.arange(N) % 2 == int(final["step"]) % 2
    near = lambda a, b: ((a - b).abs() <= tol).all(dim=1)
    took, kept = near(y_next, y), near(y_next, x0)
    moved = active & ~near(y, x0)
    plain = moved & (took ^ kept)
    vr = floored(v)
    # the program's log ratio of two close values of its dtype is exact
    # (Sterbenz), so only the rounding of log u and of a far difference
    # can turn a decision
    ratio = vr - lp0
    log_u = torch.log(torch.clamp_min(u, 1e-12))
    tie = (ratio - log_u).abs() <= 8 * eps * (ratio.abs() + log_u.abs())
    compared = plain & ~tie
    out = {"proposal_gap": gap, "moved": int(moved.sum()),
           "accepted": int(acc_ref.sum()),
           "outcome_unread": int((moved & ~took & ~kept).sum()),
           "decisions_compared": int(compared.sum()),
           "decisions_differ": int((compared & (took != acc_ref)).sum()),
           "ties": int((plain & tie).sum())}
    if not (gap <= 1 and out["moved"] > 0 and out["outcome_unread"] == 0
            and out["decisions_differ"] == 0):
        raise RuntimeError(f"DE step check failed: {out}")
    return out


def extra(final, config, cell, device, num_days):
    """The line's ``extra``: :func:`step_check`'s numbers."""
    return {"step_check": step_check(final, config, device, num_days)}
