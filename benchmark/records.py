"""The program's span records of a traced run, for the per-layer metrics.

While a profiler runs, the program keeps a record of each span it opens
(`utils/trace.py` `records()`: name, counts such as a cast's `rays` and
`items` or a pool pass's `iterations`), beside the profiler's range of
the same name among the trace's host ops. A traced run may trace more
than once (`run.TRACE_TRIES`); the records of its last trace are the
newest ones, as many of a name as the trace holds ranges of that name.
This file is the benchmark's own reading of them; a program without
`utils/trace.py` or without spans leaves it nothing to read.
"""

import importlib

from . import spans


def traced_records(run, names):
    """The program's records named one of names that belong to the run's
    last trace, oldest first, or None without a trace, without such a
    range in it, or without as many records as ranges."""
    t = run.trace
    if not t:
        return None
    try:
        recs = importlib.import_module(spans.PROGRAM_TRACE).records()
    except (ImportError, AttributeError):
        return None
    out = []
    for name in names:
        k = sum(1 for n, _, _ in t["host_ops"] if n == name)
        mine = [r for r in recs if r.name == name]
        if len(mine) < k:
            return None
        out += mine[len(mine) - k:] if k else []
    if not out:
        return None
    return sorted(out, key=lambda r: r.id)

