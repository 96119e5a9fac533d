"""Filesystem helpers: project-root discovery, output paths.

A copy of ``mmidv1_tpu/utils/fileutils.py``; the root marker is this
package.

Re-design of ``FileUtils`` (reference: ``src/utils/FileUtils.cpp:13-73``).
The legacy SEPAIHRD parameter parser lives in
:mod:`mmidv1_tpu_torch.data.config_io` (it is a data-format concern here).
"""

from __future__ import annotations

import os
from typing import Optional

from .exceptions import FileIOException

_ROOT_MARKERS = ("data", "mmidv1_tpu_torch")   # reference: data/ + include/ + src/ (:25-46)


def get_project_root(start: Optional[str] = None, max_up: int = 5) -> str:
    """Walk up at most ``max_up`` directories looking for the marker dirs
    (reference ``FileUtils::getProjectRoot``, :25-46)."""
    cur = os.path.abspath(start or os.getcwd())
    for _ in range(max_up + 1):
        if all(os.path.isdir(os.path.join(cur, m)) for m in _ROOT_MARKERS):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            break
        cur = parent
    # Fall back to the package's own repository (installed-layout case).
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if all(os.path.isdir(os.path.join(pkg_root, m)) for m in _ROOT_MARKERS):
        return pkg_root
    raise FileIOException("get_project_root",
                          f"Could not locate project root from {start or os.getcwd()} "
                          f"(looked for {_ROOT_MARKERS} up to {max_up} levels up)")


def join_paths(*parts: str) -> str:
    """``FileUtils::joinPaths`` (:48-52)."""
    return os.path.join(*parts)


def ensure_directory_exists(path: str) -> str:
    """``FileUtils::ensureDirectoryExists`` (:54-62)."""
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        raise FileIOException("ensure_directory_exists",
                              f"Failed to create directory {path}: {e}")
    return path


def get_output_path(filename: str, subdir: str = "data/output",
                    root: Optional[str] = None) -> str:
    """Output-file path under the project's output tree, creating directories
    (``FileUtils::getOutputPath``, :64-73)."""
    root = root or get_project_root()
    out_dir = ensure_directory_exists(join_paths(root, subdir))
    return join_paths(out_dir, filename)
