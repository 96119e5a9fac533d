"""``setup_s``: process start (before ``import torch``) to the window's
start: imports, CUDA context, the tree, the kernels' build or load, the
cell's warm-up."""


def read(rec):
    return rec.setup_s
