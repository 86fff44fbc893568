"""pool_occupancy: the share of the wavefront pool's lanes that held a
live path, over the traced passes' pool iterations, in %: the
`dcrt.integrator.wavefront` spans' `busy_lane_iterations` (each
iteration's lanes that cast: the paths carried in and the lanes the
cursor refilled) over their `cast_lane_iterations` (the lanes the pool
held at each iteration's closest cast, idle ones included;
`records.py`). Idle lanes at refill, and in the drain after the last
item a pool that has not shed its idle lanes, lower it. Layer:
integrator. Nothing to read without the spans or their counts."""

from ..records import traced_records

KEYS = ("busy_lane_iterations", "cast_lane_iterations")


def read(run):
    recs = traced_records(run, ("dcrt.integrator.wavefront",))
    if not recs or any(k not in r.counts for r in recs for k in KEYS):
        return None
    lanes = sum(r.counts["cast_lane_iterations"] for r in recs)
    if not lanes:
        return None
    return 100.0 * sum(r.counts["busy_lane_iterations"]
                       for r in recs) / lanes
