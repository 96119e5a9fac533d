"""Device selection shared by every entry point of the port.

Entry points default to ``device="cuda"`` and run on the host only when the
caller passes ``device="cpu"``: a run that asked for the card and silently got
the CPU would report host numbers as device numbers.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and missing.

    On CUDA it also switches TF32 off for matmuls and cuDNN. TF32 keeps ~10
    mantissa bits: a TF32 proposal product ``z @ chol.T`` or covariance
    ``xc.T @ xc`` would distort the adapted MH kernel, and any contraction on
    the likelihood path would inject ~1e-3 relative noise into the force of
    infection — tens to hundreds of log-likelihood units over a year, enough
    to break MCMC acceptance. It is the same trap the bf16 default matmul was
    for the JAX package (``mmidv1_tpu/calibration/param_space.py:188-190``).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
