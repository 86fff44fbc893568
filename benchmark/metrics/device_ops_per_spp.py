"""device_ops_per_spp: the device kernels and copies the profiler saw
in the traced passes, per traced sample: what the host issues, the
host-dispatch lever. Layer: integrator."""


def read(run):
    if not run.trace or not run.trace["device_ops"]:
        return None
    return len(run.trace["device_ops"]) / run.trace["samples"]
