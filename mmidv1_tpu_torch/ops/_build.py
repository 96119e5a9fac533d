"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>_<hash>.so`` inside the package
(a directory ``.gitignore`` lists). The hash covers the source, every header
of ``csrc/`` (``*.cuh``, which the sources include) and the flags, so an
edited source or header is rebuilt at its next use and an unchanged one is
not.
Sources are compiled in parallel, one ``nvcc`` process each. Nothing is
built when this module is imported: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# no --use_fast_math: the objective needs the accurate log and IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every source in ``names`` that is missing or stale, all at
    once; returns ``{name: seconds}`` (0.0 for an up-to-date library). The
    compiler's register and spill report goes to ``build/<name>.ptxas.txt``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                         log, tmp, so, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, so, t0) in started.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, so)
    if failed:
        msgs = []
        for name in failed:
            with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt")) as f:
                msgs.append(f"--- {name} ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
