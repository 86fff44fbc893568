"""device_idle: the share of a pass the card is idle, in %: 1 minus the
traced passes' device busy time per pass (the union of kernel and copy
intervals) over the same run's untraced median pass time. The profiler
slows the host, not the kernels, so the untraced pass is the nearer
wall time. Layer: device."""

import statistics


def read(run):
    t = run.trace
    if not t or not t["busy_s"]:
        return None
    busy_per_pass = t["busy_s"] * run.spp_per_pass / t["samples"]
    return 100.0 * (1.0 - busy_per_pass / statistics.median(run.pass_s))
