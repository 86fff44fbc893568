"""idle_ms_per_spp.integrator: the card's idle ms per traced sample
while the host was in the integrator: each idle gap between the traced
passes' device ops goes to the innermost of the program's renderer,
integrator and traversal spans that holds its midpoint (`spans.py`), and
this is the integrator's sum (camera rays, next-event estimation, BSDF
sampling, shading, emission and the pixel chunk around them) over the
traced samples. Traced-run milliseconds: the profiler slows the host, so
the three `idle_ms_per_spp.*` sum to the traced idle, not to
`device_idle` times the untraced pass. Layer: integrator."""

from ..spans import idle_ms_per_spp


def read(run):
    return idle_ms_per_spp(run, "integrator")
