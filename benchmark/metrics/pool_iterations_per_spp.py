"""pool_iterations_per_spp: the wavefront pool's iterations in the traced
passes per traced sample, the `dcrt.integrator.wavefront` spans'
`iterations` (`records.py`): each iteration is one closest cast, one
shadow cast and one round of shading over the whole pool, so the host
launches about as many operations for each. Layer: integrator. Nothing to
read without the spans."""

from ..records import traced_records


def read(run):
    recs = traced_records(run, ("dcrt.integrator.wavefront",))
    if not recs or any("iterations" not in r.counts for r in recs):
        return None
    return sum(r.counts["iterations"] for r in recs) / run.trace["samples"]
