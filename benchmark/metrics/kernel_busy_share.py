"""kernel_busy_share: the port's own CUDA kernels' device time (the
ctypes launches no PyTorch operator holds) over device busy time in the
traced passes, in %. Layer: kernels. Read only where the profiler caught
as many spans of each kernel as its wrapper counted launches
(`yardstick.span_shortfall`)."""

from ..yardstick import PORT_KERNELS, caught_spans, span_shortfall


def read(run):
    t = run.trace
    if not t or not t["busy_s"]:
        return None
    got = caught_spans(t)
    if not got or span_shortfall(t, PORT_KERNELS, "kernel_busy_share"):
        return None
    return 100.0 * sum(s for _, s in got.values()) / t["busy_s"]
