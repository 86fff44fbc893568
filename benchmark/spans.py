"""The program's spans and set-up records, read for the per-layer metrics.

The program names its spans `dcrt.<layer>.<what>` and, while a profiler
runs, opens each as a profiler range, so they lie among a traced run's
host events (`run.trace["host_ops"]`) on the device ops' clock. It keeps
set-up records (`dcrt.setup.<what>`: the flatten, the LUTs, each library
load, each renderer's first pass) in its `utils/trace.py`. This file is
the benchmark's own arithmetic over both; the program never imports it,
so a program change cannot move the yardstick. A program without spans
or without `utils/trace.py` leaves every reader here nothing to read.
"""

from .yardstick import idle_gaps

PROGRAM_TRACE = "directcomputeraytracing_tpu_torch.utils.trace"
LAYERS = ("renderer", "integrator", "traversal")


def layer_of(name):
    """The layer of a span named `dcrt.<layer>.<what>`, one of LAYERS, or
    None for any other name (an aten op, an unknown layer)."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[0] == "dcrt" and parts[1] in LAYERS:
        return parts[1]
    return None


def idle_by_layer(trace):
    """{layer: seconds} of the device's idle gaps (`yardstick.idle_gaps`
    over the trace's device ops) charged by layer: each gap goes to the
    innermost span of LAYERS that holds its midpoint, the rule
    `run.breakdown` charges host ops by, with aten ops and other names
    skipped up the stack; a gap under no such span goes to no layer.
    None where the trace holds no such span."""
    spans = sorted(((s, e, layer) for name, s, e in trace["host_ops"]
                    if (layer := layer_of(name)) is not None),
                   key=lambda sp: (sp[0], -sp[1]))
    if not spans:
        return None
    out = dict.fromkeys(LAYERS, 0.0)
    stack, i = [], 0
    gaps = idle_gaps([(s, e) for _, s, e in trace["device_ops"]])
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while i < len(spans) and spans[i][0] <= mid:
            stack.append(spans[i])
            i += 1
        stack = [sp for sp in stack if sp[1] >= mid]
        if stack:
            out[stack[-1][2]] += (g1 - g0) / 1e6
    return out


def idle_ms_per_spp(run, layer):
    """The traced passes' idle ms per sample charged to layer, or None
    without a trace or without the program's spans."""
    t = run.trace
    if not t or not t["samples"]:
        return None
    by = idle_by_layer(t)
    return None if by is None else 1000.0 * by[layer] / t["samples"]


def setup_records(name):
    """The program's set-up records named name, in order, or None where
    the program keeps none (no `utils/trace.py`)."""
    import importlib

    try:
        recs = importlib.import_module(PROGRAM_TRACE).setup_records()
    except (ImportError, AttributeError):
        return None
    return [r for r in recs if r.name == name]
