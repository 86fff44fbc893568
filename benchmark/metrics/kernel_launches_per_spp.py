"""kernel_launches_per_spp: the launches that the port's traversal
wrappers count (dense sweep, work list, clustered and pair sweeps) over
the window, per sample. Layer: traversal."""


def read(run):
    if not run.samples:
        return None
    return sum(run.launches.values()) / run.samples
