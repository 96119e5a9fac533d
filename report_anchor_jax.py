#!/usr/bin/env python3
"""The JAX package's own reading of the report anchor (``report_anchor.py``).

    python3 report_anchor_jax.py            # float32 on the host CPU

Runs the JAX package's ``generate_full_report`` on the committed 50 000-draw
posterior with the arguments that wrote ``results/spain2020/analysis/``,
into ``chiprun_out/report_anchor_jax_cpu`` (or ``--out``), and compares it
with the committed tree by ``report_anchor.py``'s functions. It needs JAX;
the port and ``chip_smoke.py`` never import this file.
"""

import argparse
import os
import sys
import time

import report_anchor as ra


def run_jax(out):
    """The JAX package's report on the host, float32."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from mmidv1_tpu.analysis import generate_full_report
    from mmidv1_tpu.cli.common import load_spain_pipeline
    pipe = load_spain_pipeline(ra.HERE)
    samples = ra.load_posterior()
    t0 = time.perf_counter()
    rep = generate_full_report(samples, pipe.space, pipe.params, pipe.data,
                               pipe.ts, out, **ra.REPORT_ARGS)
    return time.perf_counter() - t0, rep["n_draws"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ra.HERE, "chiprun_out",
                                                 "report_anchor_jax_cpu"))
    p.add_argument("--check", action="store_true",
                   help="exit 1 when a group is above its bar")
    a = p.parse_args(argv)
    return ra.run_and_compare("jax cpu float32", run_jax, a.out, a.check)


if __name__ == "__main__":
    sys.exit(main())
