"""inst_sweep_roofline: the instanced sweeps' share of their roofline, in
%: `inst_bound.inst_sweep_bound` summed over the traced launches of
`closest_ray_kernel<..., true>` and `any_ray_kernel<..., true>` over
their profiler time. A launch is a work-list cast span of the traced
passes whose cull left items (`records.py`), with the span's `rays`; the
scene's mesh-local triangles and instances are the fields of the
program's `dcrt.setup.flatten` record. Layer: kernels. Read only where
each kernel left as many spans as its launch counter, and the cast spans
with items as many as the launches; nothing to read on scenes without
instanced tables."""

import sys

from ..inst_bound import inst_sweep_bound
from ..records import traced_records
from ..spans import setup_records
from ..yardstick import caught_spans, span_shortfall

KERNELS = {"closest": ("worklist.cu closest_ray_kernel (instanced)",
                       "sweep_closest_inst", "dcrt.traversal.closest"),
           "any": ("worklist.cu any_ray_kernel (instanced)",
                   "sweep_any_inst", "dcrt.traversal.any")}


def read(run):
    t = run.trace
    if not t:
        return None
    got = caught_spans(t)
    keys = [k for k, _, _ in KERNELS.values()]
    kernel_s = sum(got.get(k, (0, 0.0))[1] for k in keys)
    if not kernel_s or span_shortfall(t, keys, "inst_sweep_roofline"):
        return None
    flat = setup_records("dcrt.setup.flatten")
    if not flat or not {"local_tris", "instances"} <= set(flat[-1].fields):
        return None
    local_tris = flat[-1].fields["local_tris"]
    instances = flat[-1].fields["instances"]
    bound_s = 0.0
    for kind, (_, counter, span) in KERNELS.items():
        casts = [r for r in traced_records(run, (span,)) or ()
                 if r.counts.get("backend") == "wl"
                 and r.counts.get("items", 0) > 0]
        if len(casts) != t["launches"].get(counter, 0):
            print(f"inst_sweep_roofline: {len(casts)} {kind} casts with "
                  f"items against {t['launches'].get(counter, 0)} "
                  "launches; left out", file=sys.stderr)
            return None
        bound_s += sum(inst_sweep_bound(kind, r.counts["rays"], local_tris,
                                        instances)[0] for r in casts)
    return 100.0 * bound_s / kernel_s
