"""idle_ms_per_spp.traversal: the card's idle ms per traced sample while
the host was in a cast (the program's `dcrt.traversal.*` spans: closest,
any-hit, slab-marched, alpha recast and sorted casts, and the wrappers
under them), charged as `idle_ms_per_spp.integrator` says
(`spans.py`). Traced-run milliseconds, which sum with the other two to
the traced idle, not to `device_idle` times the untraced pass. Layer:
traversal."""

from ..spans import idle_ms_per_spp


def read(run):
    return idle_ms_per_spp(run, "traversal")
