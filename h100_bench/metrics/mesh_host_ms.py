"""``mesh_host_ms``: host ms a sampler iteration spends inside the program's
collective spans (``mesh.all_gather``, ``mesh.all_reduce``: the walker
table's gather a step, a segment's gathers and reductions, the window's
barriers), rank 0's, over the timed window of a traced run. None where the
program has no such span (one rank, or a program whose collectives hold
none)."""

from h100_bench.metrics._program import per_iteration_ms, spans


def read(rec):
    found = [s["total_s"] for name, s in (spans(rec) or {}).items()
             if name.startswith("mesh.")]
    return per_iteration_ms(rec, sum(found)) if found else None
