"""One process a rank: how ``run.py`` runs a cell whose ``chips`` is W > 1.

``run.py`` plays the launcher's part, as ``torchrun`` does for users. The
process started as ``run.py`` is rank 0: it builds the kernels, then starts
ranks 1 … W−1 (:class:`Launch`) as children running ``run.py`` with the
same arguments, each with the environment that
``parallel.multihost.initialize()`` reads with no arguments (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Every
rank then starts its process group the way users start it.

A child's standard output goes to rank 0's standard error, so that only
rank 0 prints the result line. While the ranks run, a thread of rank 0
watches its children: one that exits with another code than 0 (a raise,
the import check's 3, a kill) ends the run at once, its siblings killed
and reaped. A child whose parent is gone exits (:func:`watch_parent`).
A rank that hangs is ended by the process group's timeout.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

PARENT = "H100_BENCH_PARENT"      # rank 0's pid, in each child's environment
POLL_S = 0.2


def timeout_s(seconds: float) -> float:
    """The process group's timeout: a few times a run's length, so that a
    rank that hangs ends the run instead of holding it."""
    return 60.0 + 4.0 * float(seconds)


def child_rank() -> Optional[int]:
    """This process's rank where rank 0 started it, else None."""
    if PARENT not in os.environ:
        return None
    return int(os.environ["RANK"])


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


class Launch:
    """Rank 0's children, from ``with`` to its end: started on entry (and
    rank 0's own launcher variables set), watched while the ranks run,
    killed and reaped on every way out."""

    def __init__(self, world: int, script: str, argv: List[str]):
        self.world, self.script, self.argv = world, script, list(argv)
        self.procs: List[subprocess.Popen] = []
        self._stop = threading.Event()
        self._watch = None

    def __enter__(self):
        port = free_port()
        os.environ.update(rank_env(0, self.world, port))
        for r in range(1, self.world):
            env = dict(os.environ, **rank_env(r, self.world, port))
            env[PARENT] = str(os.getpid())
            self.procs.append(subprocess.Popen(
                [sys.executable, self.script, *self.argv], env=env,
                stdin=subprocess.DEVNULL, stdout=sys.stderr))
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()
        return self

    def _watcher(self):
        while not self._stop.wait(POLL_S):
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code not in (None, 0):
                    print(f"h100_bench: rank {r} exited with {code}; ending the run",
                          file=sys.stderr, flush=True)
                    self._kill()
                    os._exit(1)

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self, timeout: float) -> List[int]:
        """Every child's exit code, waited for up to ``timeout`` seconds in
        all (None for a child still running then, which the ``with``'s end
        kills). The watch ends here."""
        self._stop.set()
        self._watch.join()
        end = time.monotonic() + timeout
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(max(0.0, end - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        return codes

    def __exit__(self, *exc):
        self._stop.set()
        if self._watch is not None:
            self._watch.join()
        self._kill()
        return False


def watch_parent():
    """In a child: exit once rank 0 is gone (ended by a timeout or a
    signal before it could reap its children)."""
    parent = int(os.environ[PARENT])

    def watch():
        while os.getppid() == parent:
            time.sleep(POLL_S * 2.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def gather(final: dict, info: dict):
    """Every rank's ``final`` rows (each tensor entry whose leading size is
    this rank's row count, concatenated in rank order) and ``info`` (a
    small dict each) on every rank, by the harness's own collectives:
    ``(final, [info of rank 0, 1, ...])``."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    infos = [None] * world
    dist.all_gather_object(infos, info)
    n = int(final["x"].shape[0])
    out = dict(final)
    for k, v in final.items():
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == n:
            v = v.contiguous()
            parts = [torch.empty_like(v) for _ in range(world)]
            dist.all_gather(parts, v)
            out[k] = torch.cat(parts)
    return out, infos
