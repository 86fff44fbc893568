"""Ray-triangle tests and the intersection entry points.

PyTorch counterpart of the part of `directcomputeraytracing_tpu.accel.
traverse` that the port's traversals use: the Moeller and watertight
tests, `HitInfo`, and `intersect_closest` / `intersect_any` with a
port-side backend resolution. The port has no stack traversal, so the
reference's `stack_size` argument is gone.

Backend "auto", as the reference resolves it on its accelerator: scenes
with cluster tables (more than 2048 world triangles) go to the work-list
traversal (`accel.worklist`), the others to the dense sweep
(`accel.brute`). Both launch their CUDA kernels for CUDA tensors and run
their PyTorch twins for CPU tensors. Instanced work-list tables,
alpha-tested casts and every other backend name raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from typing import NamedTuple

import torch

from ..sampling.montecarlo import cross, dot


class HitInfo(NamedTuple):
    t: torch.Tensor          # (R,) f32, inf on miss
    u: torch.Tensor          # (R,) f32 barycentric
    v: torch.Tensor          # (R,) f32
    triangle: torch.Tensor   # (R,) i32 global triangle id
    instance: torch.Tensor   # (R,) i32
    backface: torch.Tensor   # (R,) bool
    hit: torch.Tensor        # (R,) bool
    iterations: torch.Tensor  # (R,) i32 clusters swept (0: dense sweep)


def ray_triangle_moeller(o, d, t_min, t_max, v0, v1, v2):
    """Moeller-Trumbore over broadcastable (..., 3) rays and triangles.
    Returns (t, u, v, backface, hit)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    det_ok = torch.abs(det) >= 1e-10
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    backface = det > -1e-10
    hit = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= t_min) & (t < t_max))
    return t, u, v, backface, hit


def _pick(vec, k):
    return torch.where(k == 0, vec[..., 0],
                       torch.where(k == 1, vec[..., 1], vec[..., 2]))


def ray_triangle_watertight(o, d, t_min, t_max, v0, v1, v2):
    """PBRT permute+shear watertight test over broadcastable (..., 3) rays
    and triangles. Returns (t, u, v, backface, hit)."""
    ad = torch.abs(d)
    ax, ay, az = ad[..., 0], ad[..., 1], ad[..., 2]
    kz = torch.where((ax >= ay) & (ax >= az), 0,
                     torch.where(ay >= az, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    d_z = _pick(d, kz)
    inv_z = 1.0 / torch.where(torch.abs(d_z) < 1e-30, 1e-30, d_z)
    sx = -_pick(d, kx) * inv_z
    sy = -_pick(d, ky) * inv_z

    def shear(vtx):
        p = vtx - o
        pz = _pick(p, kz)
        return _pick(p, kx) + sx * pz, _pick(p, ky) + sy * pz, pz

    p0x, p0y, p0z = shear(v0)
    p1x, p1y, p1z = shear(v1)
    p2x, p2y, p2z = shear(v2)
    e0 = p1x * p2y - p2x * p1y
    e1 = p2x * p0y - p0x * p2y
    e2 = p0x * p1y - p1x * p0y
    mixed = (((e0 < 0.0) | (e1 < 0.0) | (e2 < 0.0))
             & ((e0 > 0.0) | (e1 > 0.0) | (e2 > 0.0)))
    det = e0 + e1 + e2
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    t = (e0 * p0z + e1 * p1z + e2 * p2z) * inv_z * inv_det
    u = e1 * inv_det
    v = e2 * inv_det
    backface = torch.sign(inv_z) * det < 0.0
    c = cross(v1 - v0, v2 - v0)
    degenerate = dot(c, c) == 0.0
    hit = ~mixed & det_ok & ~degenerate & (t >= t_min) & (t < t_max)
    return t, u, v, backface, hit


def _clustered(scene, backend):
    """True for the work-list traversal, False for the dense sweep; raise
    for what the port cannot cast yet (see the module docstring)."""
    if scene.isup_inst.shape[0] > 1:
        raise NotImplementedError(
            "scene carries instanced work-list tables: the instanced "
            "kernels are ROADMAP queue 2, rows 13-14")
    if backend != "auto":
        raise NotImplementedError(
            f"traversal backend {backend!r}: the port resolves only 'auto' "
            "(dense sweep or work list); the stack traversal is ROADMAP "
            "queue 1, item 11, the other kernel backends queue 2")
    return scene.cluster_bbox.shape[0] > 1


def _no_alpha(opacity_u):
    if opacity_u is not None:
        raise NotImplementedError(
            "alpha-tested casts (opacity_u): ROADMAP queue 1, item 11")


def intersect_closest(scene, origin, direction, t_min=0.0, backend="auto",
                      watertight=False, opacity_u=None):
    """Closest hit over the scene; origin/direction (R, 3) f32."""
    _no_alpha(opacity_u)
    if _clustered(scene, backend):
        from .worklist import worklist_closest

        t, u, v, tri, inst, back, iters = worklist_closest(
            scene, origin, direction, t_min, watertight)
    else:
        from .brute import brute_closest

        t, u, v, tri, inst, back = brute_closest(scene, origin, direction,
                                                 t_min, watertight)
        iters = torch.zeros_like(tri)
    return HitInfo(t=t, u=u, v=v, triangle=tri, instance=inst, backface=back,
                   hit=torch.isfinite(t), iterations=iters)


def intersect_any(scene, origin, direction, t_max, t_min=0.0, backend="auto",
                  watertight=False, opacity_u=None):
    """Occlusion: True where a hit lies in [t_min, t_max)."""
    _no_alpha(opacity_u)
    if _clustered(scene, backend):
        from .worklist import worklist_any

        return worklist_any(scene, origin, direction, t_max, t_min,
                            watertight)
    from .brute import brute_any

    return brute_any(scene, origin, direction, t_max, t_min, watertight)
