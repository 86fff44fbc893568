"""mk_graph_replay_share: the share of the megakernel's pass segments
that the traced passes ran as replayed CUDA graphs, in %: the
`dcrt.integrator.segment` spans (`records.py`) whose count `replayed` is
1, over all of them. A segment is the shading between two casts; the
rest run eagerly, one host-issued op at a time. Layer: integrator.
Nothing to read without the spans."""

from ..records import traced_records

SEGMENT = "dcrt.integrator.segment"


def read(run):
    recs = traced_records(run, (SEGMENT,))
    if not recs:
        return None
    return 100.0 * sum(r.counts.get("replayed") == 1
                       for r in recs) / len(recs)
