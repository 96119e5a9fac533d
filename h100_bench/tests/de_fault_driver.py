"""The DE-MC cell's driver (``samplers/de.py``) with a fault planted in the
program in every rank's process, named by the cell's override ``fault``:

- ``local``: each rank takes a moving chain's partners from its own rows
  (the walker exchange left out: the table is this rank's rows, repeated);
- ``parity``: the proposals move the other half of the chains than the
  step's parity names;
- ``order``: the walker table gathered out of rank order (rolled by one
  rank's rows).

Each leaves every chain with the value of its own position, which the
objective check at the final states reads as correct; the driver's step
check has to fail the run:

    python3 h100_bench/run.py --workload de32768-x4-cashkarp3 --seed <n> \\
        --seconds 5 --driver h100_bench/tests/de_fault_driver.py \\
        --overrides '{"fault": "local"}'
"""

from __future__ import annotations

import os

from h100_bench.run import load_module

_de = load_module(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "samplers", "de.py"), "h100_bench.samplers.de")
KERNEL_LIBS = _de.KERNEL_LIBS
extra = _de.extra
FAULTS = ("local", "parity", "order")


def plant(fault: str):
    from mmidv1_tpu_torch.calibration import mh
    from mmidv1_tpu_torch.parallel.mesh import EnsembleMesh

    move, gather = mh._de_move, EnsembleMesh.all_gather
    if fault == "local":
        def local(x, *args):
            *args, x_all = args
            return move(x, *args, x.repeat(x_all.shape[0] // x.shape[0], 1))
        mh._de_move = local
    elif fault == "parity":
        def flipped(x, scale, z, space, cfg, j, k, g_u, parity, active, x_all):
            return move(x, scale, z, space, cfg, j, k, g_u, 1 - parity,
                        ~active, x_all)
        mh._de_move = flipped
    elif fault == "order":
        def rolled(self, t, dim=0, out=None):
            res = gather(self, t, dim, out)
            if self.distributed:
                res.copy_(res.roll(t.shape[dim], dim))
            return res
        EnsembleMesh.all_gather = rolled
    else:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")


class Driver(_de.Driver):
    def __init__(self, setup, cell, seed, window, tmpdir):
        super().__init__(setup, cell, seed, window, tmpdir)
        plant(cell["fault"])
