"""The bound of an instanced sweep launch: the bytes that no
implementation of the same cast can skip, at the H100's 3.35 TB/s.

A cast of rays over instanced tables reads each ray once and writes its
answer once: origin and direction (24 bytes) in, and for a closest cast
t, u, v, triangle and instance (4 bytes each) and the back-face flag out
(45 bytes a ray), for an occlusion cast its t_max in and one flag out (29
bytes a ray), as `yardstick.dense_bound` counts a ray. It reads the
scene's geometry at least once a launch: each mesh-local triangle's
three corners (36 bytes) and each instance's 4x3 transform (48 bytes).
No operations are counted (a closest walk over sorted items may stop
early, and what it tests depends on the rays), and no table bytes per
item: the whole of a scene's BLAS sits in the card's 50 MB L2. Frozen
when the `weekend-1200x800-wf` cell was added; the program never
imports it.
"""

from .yardstick import bound

RAY_BYTES = {"closest": 45, "any": 29}
TRIANGLE_BYTES = 36
INSTANCE_BYTES = 48


def scene_bytes(local_tris, instances):
    """The bytes of the geometry a launch reads at least once."""
    return TRIANGLE_BYTES * local_tris + INSTANCE_BYTES * instances


def inst_sweep_bound(kind, rays, local_tris, instances):
    """(bound_s, bound_by) of one instanced sweep launch of kind
    ("closest" or "any") over rays rays."""
    return bound(0, RAY_BYTES[kind] * rays
                 + scene_bytes(local_tris, instances))
