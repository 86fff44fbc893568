"""worklist_items_per_ray: the work list's (ray block, super) items per
live ray of the wavefront pool's closest casts in the traced passes: the
`items` that the cull put on the program's `dcrt.traversal.closest`
spans of the work list ("wl", "wlg"), summed, over the
`dcrt.integrator.wavefront` spans' `closest_live_rays` (`records.py`).
A ray's block walks each of its block's items, so fewer items a ray is
less sweep work. The pool's parked lanes cast rays that enter nothing
and add no item; they count in no denominator, so a pool that stops
casting them leaves the reading as it is (`pool_occupancy` reads them).
The shadow casts are left out: the loop does not know their live count.
A cast whose cull entered nothing left no `items` and counts 0. Layer:
traversal. Nothing to read without work-list casts or without the
pool's count of live rays."""

from ..records import traced_records

WORKLIST = ("wl", "wlg")


def read(run):
    pools = traced_records(run, ("dcrt.integrator.wavefront",))
    if not pools or any("closest_live_rays" not in r.counts for r in pools):
        return None
    rays = sum(r.counts["closest_live_rays"] for r in pools)
    casts = traced_records(run, ("dcrt.traversal.closest",))
    casts = [r for r in casts or () if r.counts.get("backend") in WORKLIST]
    if not rays or not casts:
        return None
    return sum(r.counts.get("items", 0) for r in casts) / rays
