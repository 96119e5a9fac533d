"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>_<hash>.so`` inside the package
(a directory ``.gitignore`` lists). Two headers are generated rather than
written, into ``build/gen/``: ``sepaihrd_tableaus.cuh``
(:func:`tableau_header`), the zero pattern of every tableau of
:data:`KERNEL_TABLEAUS`, read from ``ode/tableaus.py`` at each build, so the
kernels hold no second copy of the tables; and ``sepaihrd_prep_layout.cuh``
(:func:`prep_layout_header`), the prep kernel's view of the gather table
whose format ``ops/sepaihrd_fused.py`` defines. The hash covers the source,
every header of ``csrc/`` (``*.cuh``, which the sources include), the
generated headers and the flags, so an edited source, header, tableau or
table format is rebuilt at its next use and an unchanged one is not.
Sources are compiled in parallel, one ``nvcc`` process each. Nothing is
built when this module is imported: the first kernel launch builds.

Every kernel is called through this module: :func:`bind` sets a C entry
point's types once, and :func:`launch` calls one on the current stream of
its device and raises with the library's ``<name>_error_string`` on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

import torch

from ..ode.tableaus import get_tableau

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
GEN_DIR = os.path.join(BUILD_DIR, "gen")
# no --use_fast_math: the objective needs the accurate log and IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The tableaus the SEPAIHRD kernels are built for; a tableau's id in the
# kernels' C interface is its index here.
KERNEL_TABLEAUS = ("rk4", "cash_karp", "rkf45", "dopri5", "fehlberg78")
# the suffix of a kernel's C entry point by the size of its values
SUFFIX = {4: "f32", 8: "f64"}
TABLEAU_HEADER = "sepaihrd_tableaus.cuh"
PREP_LAYOUT_HEADER = "sepaihrd_prep_layout.cuh"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from source at first use")
    return path


def tableau_id(tableau: str) -> int:
    """The kernels' id of ``tableau`` (its index in :data:`KERNEL_TABLEAUS`)."""
    name = get_tableau(tableau).name
    if name not in KERNEL_TABLEAUS:
        raise ValueError(f"the kernels are built for {KERNEL_TABLEAUS}, "
                         f"not {name!r}")
    return KERNEL_TABLEAUS.index(name)


def _type_name(tableau: str) -> str:
    return "Tab" + "".join(w[:1].upper() + w[1:] for w in tableau.split("_"))


def tableau_header() -> str:
    """The text of ``sepaihrd_tableaus.cuh``: one type per tableau of
    :data:`KERNEL_TABLEAUS` with its stage count ``S``, ``fsal``, the
    non-zero mask of each row of ``a`` below the diagonal (``a_row(i)``, bit
    j for ``a[i, j] != 0``) and of ``b`` (``b_bits``), and
    ``SEPAIHRD_TABLEAUS(X, A)``, which applies ``X(id, type, A)`` to each. The
    coefficient values are not in it: the kernels take them at run time."""
    lines = ["// Generated by mmidv1_tpu_torch/ops/_build.py from",
             "// mmidv1_tpu_torch/ode/tableaus.py at build time; not edited by hand.",
             "#pragma once", "", "namespace sepaihrd {", ""]
    for i, name in enumerate(KERNEL_TABLEAUS):
        tab = get_tableau(name)
        S = tab.stages
        rows = [sum(1 << j for j in range(r) if float(tab.a[r, j]) != 0.0)
                for r in range(S)]
        b_bits = sum(1 << j for j in range(S) if float(tab.b[j]) != 0.0)
        cases = " ".join(f"case {r}: return {m:#x}u;"
                         for r, m in enumerate(rows) if m)
        lines += [f"struct {_type_name(name)} {{   // {name}",
                  f"  static constexpr int id = {i};",
                  f"  static constexpr int S = {S};",
                  f"  static constexpr bool fsal = {str(tab.fsal).lower()};",
                  f"  static constexpr unsigned b_bits = {b_bits:#x}u;",
                  "  __host__ __device__ static constexpr unsigned a_row(int i) {",
                  f"    switch (i) {{ {cases} default: return 0u; }}",
                  "  }", "};", ""]
    applied = [f"X({i}, {_type_name(n)}, A)" for i, n in enumerate(KERNEL_TABLEAUS)]
    lines += ["#define SEPAIHRD_TABLEAUS(X, A) " + " ".join(applied), "",
              "}  // namespace sepaihrd", ""]
    return "\n".join(lines)


def prep_layout_header() -> str:
    """The text of ``sepaihrd_prep_layout.cuh``: one ``constexpr int`` for
    each of :func:`.sepaihrd_fused.prep_layout_constants` (the index of each
    table section in the prep kernel's ``head``, the slots it reads by
    position, K1's input shape)."""
    from .sepaihrd_fused import prep_layout_constants
    lines = ["// Generated by mmidv1_tpu_torch/ops/_build.py from",
             "// mmidv1_tpu_torch/ops/sepaihrd_fused.py at build time; not edited by hand.",
             "#pragma once", "", "namespace sepaihrd_prep {", ""]
    lines += [f"constexpr int {k} = {v};"
              for k, v in prep_layout_constants().items()]
    lines += ["", "}  // namespace sepaihrd_prep", ""]
    return "\n".join(lines)


def _generated():
    return {TABLEAU_HEADER: tableau_header(),
            PREP_LAYOUT_HEADER: prep_layout_header()}


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    for fname, text in _generated().items():
        digest.update(fname.encode() + b"\0" + text.encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _write_headers():
    os.makedirs(GEN_DIR, exist_ok=True)
    for fname, text in _generated().items():
        path = os.path.join(GEN_DIR, fname)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every source in ``names`` that is missing or stale, all at
    once; returns ``{name: seconds}`` (0.0 for an up-to-date library). The
    compiler's register and spill report goes to ``build/<name>.ptxas.txt``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    _write_headers()
    started = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", GEN_DIR, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
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


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """The C function ``symbol`` of library ``name`` (loaded, built first
    if needed), its argument and result types set; once for each set."""
    fn = getattr(load(name), symbol)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def launch(what: str, device: torch.device, name: str, symbol: str,
           argtypes: tuple, *args) -> None:
    """Call the kernel entry ``symbol`` of library ``name`` on ``device``:
    ``args`` (of ``argtypes``) and the device's current stream, appended,
    under its device guard. A non-zero code raises ``RuntimeError``
    naming ``what`` and the library's message for the code."""
    fn = bind(name, symbol, argtypes + (ctypes.c_void_p,))
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = bind(name, f"{name}_error_string", (ctypes.c_int,),
                   ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")
