"""The benchmark's own arithmetic: peaks, bounds and trace reductions.

Frozen copies, taken when the benchmark was defined, of the port's
`tools/common.py` (`bound`, `dense_bound` and the H100 peaks) and of
`tools/profile_render.py` (device busy time as the union of the device's
kernel and copy intervals, and the table that tells the port's ctypes
kernels apart by name), with the launch counter that each kernel's
wrapper keeps beside it. Later changes to the port's tools do not move
the yardstick.
"""

PEAK_FLOPS = 67e12          # H100 SXM float32, no tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
FLOPS_MOELLER = 45          # one Moeller ray-triangle test

# the port's kernels, told apart by entry point and template or parameter
# types in the demangled names the profiler reports; a kernel counts under
# the first key it matches. Each key's value ends with the wrapper's
# launch counter (`launch_counts`) that counts its launches.
PORT_KERNELS = {
    "prep.cu prep_kernel": (("prep_kernel",), "prep_rays"),
    "pairsweep.cu emit_kernel": (("emit_kernel",), "pair_emit"),
    "pairsweep.cu pair_closest_kernel": (("pair_closest_kernel",),
                                         "pair_sweep_closest"),
    "pairsweep.cu pair_any_kernel": (("pair_any_kernel",), "pair_sweep_any"),
    "clustered.cu cull_kernel": (("cull_kernel", "Reach"), "cluster_cull"),
    "clustered.cu closest_kernel": (("closest_kernel",
                                     "unsigned char const*"),
                                    "cluster_closest"),
    "clustered.cu any_kernel": (("any_kernel", "unsigned char const*"),
                                "cluster_any"),
    "worklist.cu cull_kernel": (("cull_kernel",), "cull_boxes"),
    "worklist.cu refine_kernel": (("refine_kernel",), "refine"),
    "worklist.cu closest_ray_kernel": (("closest_ray_kernel", "false>"),
                                       "sweep_closest"),
    "worklist.cu any_ray_kernel": (("any_ray_kernel", "false>"),
                                   "sweep_any"),
    "worklist.cu closest_grouped_kernel": (("closest_grouped_kernel",),
                                           "sweep_closest_grouped"),
    "worklist.cu any_grouped_kernel": (("any_grouped_kernel",),
                                       "sweep_any_grouped"),
    "worklist.cu closest_ray_kernel (instanced)": (
        ("closest_ray_kernel", "true>"), "sweep_closest_inst"),
    "worklist.cu any_ray_kernel (instanced)": (("any_ray_kernel", "true>"),
                                               "sweep_any_inst"),
    "brute_sweep.cu closest_kernel": (("closest_kernel", "Moeller",
                                       "Watertight"), "brute_closest"),
    "brute_sweep.cu any_kernel": (("any_kernel", "Moeller", "Watertight"),
                                  "brute_any"),
}
DENSE_KERNELS = ("brute_sweep.cu closest_kernel", "brute_sweep.cu any_kernel")


def bound(flops, nbytes):
    """(bound_s, bound_by) of work of `flops` operations moving `nbytes`
    on an H100 SXM: the larger of the two times at the card's peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def dense_bound(kind, rays, tris):
    """The bound of a dense cast ("closest" or "any") of rays against a
    table of tris rows: FLOPS_MOELLER per pair; each ray (24 bytes, and
    t_max for any-hit), output (21 bytes closest, 1 any-hit) and row (48)
    moved once."""
    per_ray = 45 if kind == "closest" else 29
    return bound(FLOPS_MOELLER * rays * tris, per_ray * rays + 48 * tris)


def busy_union(spans):
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(spans):
    """The gaps between the union of (start, end) intervals: (start, end)
    pairs, in order."""
    gaps, end = [], None
    for s, e in sorted(spans):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def port_kernel(name):
    """The `PORT_KERNELS` key of a device op's name, or None."""
    for key, ((entry, *args), _) in PORT_KERNELS.items():
        if entry in name and (not args or any(a in name for a in args)):
            return key
    return None


def caught_spans(trace):
    """{kernel key: (spans caught, device seconds)} over a trace's device
    ops."""
    out = {}
    for name, s, e in trace["device_ops"]:
        key = port_kernel(name)
        if key is not None:
            n, t = out.get(key, (0, 0.0))
            out[key] = (n + 1, t + (e - s) / 1e6)
    return out


def span_shortfall(trace, keys, metric):
    """True where a kernel of keys left another number of spans in the
    trace than its wrapper counted launches, with a line on standard
    error for each: its share is then not read, since a mean over the
    spans caught would stand in for the ones lost."""
    import sys

    got = caught_spans(trace)
    short = False
    for key in keys:
        launched = trace["launches"].get(PORT_KERNELS[key][1], 0)
        spans = got.get(key, (0, 0.0))[0]
        if spans != launched:
            print(f"{metric}: the profiler caught {spans} spans of {key} "
                  f"against {launched} launches; left out", file=sys.stderr)
            short = True
    return short
