"""Host-side (numpy) debug ray tracer with traversal counters.

The port's copy of `directcomputeraytracing_tpu.utils.debug_trace` (the
reference's "Ray Tracing Tool": a scalar CPU duplicate of the two-level
traversal that returns the counters {triangleTests, boxTests,
BLASEnterings, BLASLeafTests}). It reads a scene's walker tables
(`accel.traverse.node_tables`) and its instances' inverse transforms
(`SceneTensors.inst_rows`) into numpy and walks one ray in float64, in
the walker's visit order: an independent oracle for
`accel.traverse.walk` and a per-ray cost probe.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..core.constants import (
    BVHNODE_MISC_COUNT_SHIFT,
    BVHNODE_MISC_HAS_BLAS,
)


@dataclass
class TraversalCounters:
    triangle_tests: int = 0
    box_tests: int = 0
    blas_enterings: int = 0
    blas_leaf_tests: int = 0


@dataclass
class DebugHit:
    hit: bool
    t: float
    u: float
    v: float
    triangle: int
    instance: int
    backface: bool
    counters: TraversalCounters


def _ray_aabb(o, inv_d, t_min, t_max, bmin, bmax):
    ta = (bmin - o) * inv_d
    tb = (bmax - o) * inv_d
    t0 = np.minimum(ta, tb).max()
    t1 = np.maximum(ta, tb).min()
    return (t1 >= t0) and (t0 < t_max) and (t1 >= t_min)


def _ray_tri(o, d, t_min, t_max, v0, v1, v2):
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(d, e2)
    det = float(e1 @ pvec)
    if abs(det) < 1e-10:
        return None
    inv_det = 1.0 / det
    tvec = o - v0
    u = float(tvec @ pvec) * inv_det
    if u < 0.0 or u > 1.0:
        return None
    qvec = np.cross(tvec, e1)
    v = float(d @ qvec) * inv_det
    if v < 0.0 or u + v > 1.0:
        return None
    t = float(e2 @ qvec) * inv_det
    if t < t_min or t >= t_max:
        return None
    return t, u, v, det > -1e-10


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def trace_ray(arrays, origin, direction, t_min=0.0, t_max=np.inf):
    """Scalar two-level traversal of one ray over the flattened scene,
    with per-ray counters, in the walker's visit order."""
    from ..accel.traverse import node_tables

    tables = node_tables(arrays)
    node_table = _host(tables.node_table)
    tri_verts = _host(tables.tri_verts)
    rows = _host(arrays.inst_rows)
    inv_tf = np.concatenate([rows[:, 0:9], rows[:, 9:12]],
                            axis=1).reshape(-1, 4, 3)

    o_w = np.asarray(_host(origin), np.float64)
    d_w = np.asarray(_host(direction), np.float64)
    o, d = o_w.copy(), d_w.copy()
    counters = TraversalCounters()
    best = None
    stack = []
    node = 0
    is_blas = False
    instance = -1
    t_best = t_max

    def inv(dv):
        return 1.0 / np.where(np.abs(dv) < 1e-30,
                              np.where(dv >= 0, 1e-30, -1e-30), dv)

    while True:
        row = node_table[node]
        bmin, bmax = row[0:3], row[3:6]
        rop = int(row[6])
        misc = int(row[7])
        counters.box_tests += 1
        if _ray_aabb(o, inv(d), t_min, t_best, bmin, bmax):
            if misc & BVHNODE_MISC_HAS_BLAS:
                instance = misc >> BVHNODE_MISC_COUNT_SHIFT
                counters.blas_enterings += 1
                m = inv_tf[instance].astype(np.float64)
                o = o_w @ m[:3] + m[3]
                d = d_w @ m[:3]
                node = rop
                is_blas = True
                continue
            count = misc >> BVHNODE_MISC_COUNT_SHIFT
            if count == 0:
                axis = misc & 0x3
                left = node + 1
                if d[axis] < 0.0:
                    stack.append((left, is_blas))
                    node = rop
                else:
                    stack.append((rop, is_blas))
                    node = left
                continue
            counters.blas_leaf_tests += 1
            for k in range(count):
                counters.triangle_tests += 1
                tv = tri_verts[rop + k].astype(np.float64)
                r = _ray_tri(o, d, t_min, t_best, tv[0:3], tv[3:6],
                             tv[6:9])
                if r is not None:
                    t, u, v, back = r
                    t_best = t
                    best = DebugHit(True, t, u, v, rop + k, instance,
                                    back, counters)
        if not stack:
            break
        (node, was_blas) = stack.pop()
        if is_blas and not was_blas:
            o, d = o_w.copy(), d_w.copy()
        is_blas = was_blas

    if best is None:
        return DebugHit(False, np.inf, 0.0, 0.0, -1, -1, False, counters)
    return best


def screen_to_camera_ray(cam, cfg, x, y):
    """The camera ray through the centre of pixel (x, y), as numpy
    (origin, direction), by the camera's own `generate_ray`."""
    from ..camera.camera import generate_ray

    dev = cam.transform.device
    film = torch.tensor([[(x + 0.5) / cfg.width, (y + 0.5) / cfg.height]],
                        dtype=torch.float32, device=dev)
    o, d = generate_ray(cam, film, torch.zeros((1, 3), device=dev))
    return o[0].cpu().numpy(), d[0].cpu().numpy()
