"""What the harness takes from the program: its entry points, built on the
configuration a cell names.

Everything here calls ``mmidv1_tpu_torch``; nothing here computes a result
of its own. The inputs are the benchmark's frozen copy of the Spain-2020
tree (``data/spain2020``), so a change to the repository's data does not
move a cell.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


class Setup:
    """The Spain-2020 pipeline of a configuration on ``device``: data,
    parameters, space and grid, the committed MAP and the posterior
    covariance, and the objectives of the configuration's solver.

    ``device`` is this rank's card, and ``mesh`` this rank's
    ``parallel.mesh.EnsembleMesh`` over every rank of the process group (a
    mesh of one where there is none). A cell's ``chains`` is the global
    count: a driver runs its rank's ``chains / mesh.world_size`` rows
    through the program's sharded runners and returns those rows."""

    def __init__(self, config: dict, device: torch.device,
                 num_days: Optional[int] = None):
        from mmidv1_tpu_torch.cli.common import load_spain_pipeline
        from mmidv1_tpu_torch.data import read_sepaihrd_parameters
        from mmidv1_tpu_torch.parallel import ensemble_mesh

        self.config = config
        self.root = os.path.join(HERE, config["data"])
        self.dtype = getattr(torch, config["dtype"])
        self.device = device
        self.mesh = ensemble_mesh(device=device)
        self.tableau, self.substeps = config["tableau"], int(config["substeps"])
        # load_spain_pipeline reads <root>/data/{configuration,processed,
        # contacts.csv}, as the frozen tree is laid out
        pipe = load_spain_pipeline(self.root, dtype=self.dtype, device=device,
                                   num_days=num_days)
        self.pipe = pipe
        self.space = pipe.space
        init = read_sepaihrd_parameters(
            os.path.join(self.root, config["map"]), 4,
            N=pipe.data.population_by_age,
            M_baseline=pipe.params.M_baseline.cpu().numpy(),
            dtype=self.dtype, device=device)
        self.theta_map = self.space.extract(init).to(self.dtype)
        with np.load(os.path.join(self.root, config["posterior_cov"])) as z:
            if [str(n) for n in z["names"]] != list(self.space.names):
                raise ValueError("posterior covariance names differ from the space's")
            self.post_cov = z["cov"].astype(np.float64)

    def kw(self):
        from mmidv1_tpu_torch.calibration.param_space import REFLECT
        return dict(substeps=self.substeps, tableau=self.tableau,
                    constraint_mode=REFLECT, dtype=self.dtype,
                    device=self.device)

    def objective(self):
        """K1's batched log-likelihood (``build_objective_fused``)."""
        from mmidv1_tpu_torch.ops import build_objective_fused
        p = self.pipe
        return build_objective_fused(p.space, p.params, p.data, p.ts, **self.kw())

    def as_t(self, a):
        return torch.as_tensor(np.asarray(a)).to(device=self.device,
                                                 dtype=self.dtype)


def build_kernels(names):
    """Build the program's CUDA libraries ``names`` at once (nvcc in
    parallel; nothing to do when they are already in the checkout's
    build directory)."""
    from mmidv1_tpu_torch.ops import _build
    return _build.build(list(names))

