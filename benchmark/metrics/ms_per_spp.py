"""ms_per_spp: the window's whole time over the samples its passes
completed, in ms (host clock; the pass in flight at the window's close
counts whole, and the window runs to its end)."""


def read(run):
    return 1000.0 * run.window_s / run.samples
