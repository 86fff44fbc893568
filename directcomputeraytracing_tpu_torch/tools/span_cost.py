"""What the port's spans (`utils.trace`) cost, and where a traced pass's
idle card lies under them, on one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.span_cost [turns]

Renders `cornell_box("area", "glossy")` at 1024x1024, max_bounce 4, one
sample a pass through the megakernel, after a warm-up pass. Needs a CUDA
device; with none it exits non-zero. Prints the card's name and power
limit and JSON lines:

- `off`: µs per span entered and left with no profiler running (the
  flag check), over 10^6 spans, and per turn of the bare loop;
- `on`: µs per span under the profiler (the range and the record),
  over 10^4 spans;
- `turn` (turns x 4 of them, default 2 x 4): one traced pass
  (`torch.profiler`, CPU and CUDA) with the spans (`spans` true) or with
  their gate held shut, in the order on, off, off, on: the traced window
  (host clock around `render(1)` and `torch.cuda.synchronize()`),
  device ops, busy and idle ms (the union of the device ops and the gaps
  between them), and the spans recorded; with the spans, the idle ms
  charged to the innermost renderer, integrator or traversal span that
  holds each gap's midpoint, by span name from the program's own
  records on the profiler's clock, and the idle under none of them. A
  traced pass before the turns is not reported (the profiler's first
  use).
"""

import json
import subprocess
import sys
import time
import types
from contextlib import contextmanager

import torch

from ..integrator.renderer import Renderer
from ..scene.presets import cornell_box
from ..utils import trace

LAYERS = ("renderer", "integrator", "traversal")


@contextmanager
def _gate_shut():
    """The spans' gate reads False while the profiler runs."""
    real = trace._profiler
    trace._profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    try:
        yield
    finally:
        trace._profiler = real


def _per_call_us(fn, n):
    t0 = time.perf_counter()
    fn(n)
    return 1e6 * (time.perf_counter() - t0) / n


def _spans(n):
    for _ in range(n):
        with trace.span("dcrt.integrator.cost"):
            pass


def _bare(n):
    for _ in range(n):
        pass


def _gaps(spans):
    out, end = [], None
    for s, e in sorted(spans):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def _charge(gaps, records):
    """{span name: idle ms} of gaps ((start ns, end ns)), each under the
    innermost record of LAYERS holding its midpoint, or "none"."""
    spans = sorted(((r.start_ns, r.end_ns, r.name) for r in records
                    if r.name.split(".")[1] in LAYERS),
                   key=lambda s: (s[0], -s[1]))
    out = {"none": 0.0}
    stack, i = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while i < len(spans) and spans[i][0] <= mid:
            stack.append(spans[i])
            i += 1
        stack = [s for s in stack if s[1] >= mid]
        key = stack[-1][2] if stack else "none"
        out[key] = out.get(key, 0.0) + (g1 - g0) / 1e6
    return out


def _turn(r, spans_on):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if spans_on:
            r.render(1)
        else:
            with _gate_shut():
                r.render(1)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    recs = trace.records()
    base = prof.profiler.kineto_results.trace_start_ns()
    dev = [(base + 1e3 * e.time_range.start, base + 1e3 * e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    gaps = _gaps(dev)
    busy = (max(e for _, e in dev) - min(s for s, _ in dev)
            - sum(g1 - g0 for g0, g1 in gaps))
    out = {"kind": "turn", "spans": spans_on, "window_ms": 1e3 * window,
           "device_ops": len(dev), "busy_ms": busy / 1e6,
           "idle_ms": sum(g1 - g0 for g0, g1 in gaps) / 1e6,
           "records": len(recs),
           "span_events": sum(e.name.startswith("dcrt.")
                              for e in prof.events())}
    if spans_on:
        out["idle_ms_by_span"] = _charge(gaps, recs)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    turns = int(argv[0]) if argv else 2
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"kind": "off",
                      "span_us": _per_call_us(_spans, 10**6),
                      "bare_loop_us": _per_call_us(_bare, 10**6)}),
          flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on_us = _per_call_us(_spans, 10**4)
    print(json.dumps({"kind": "on", "span_us": on_us}), flush=True)
    r = Renderer(*cornell_box("area", "glossy"), 1024, 1024, max_bounce=4,
                 device=torch.device("cuda"))
    r.render(1)
    _turn(r, True)      # the profiler's first use, not reported
    for _ in range(turns):
        for spans_on in (True, False, False, True):
            print(json.dumps(_turn(r, spans_on)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
