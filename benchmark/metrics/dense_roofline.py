"""dense_roofline: the dense sweep's share of its roofline, in %:
`dense_bound(kind, rays handed, soup triangles)` summed over the traced
casts (rays counted at the wrapper by the benchmark, `run._DenseRays`)
over the dense kernels' profiler time. Layer: kernels. Read only where
each dense kernel left as many spans as launches, and nothing to read
on scenes that never take the dense sweep."""

from ..yardstick import (
    DENSE_KERNELS,
    caught_spans,
    dense_bound,
    span_shortfall,
)


def read(run):
    t = run.trace
    if not t or not t["dense_rays"]:
        return None
    if span_shortfall(t, DENSE_KERNELS, "dense_roofline"):
        return None
    kernel_s = sum(s for k, (_, s) in caught_spans(t).items()
                   if k in DENSE_KERNELS)
    if not kernel_s:
        return None
    bound_s = sum(dense_bound(kind, rays, t["soup_tris"])[0]
                  for kind, rays in t["dense_rays"])
    return 100.0 * bound_s / kernel_s
