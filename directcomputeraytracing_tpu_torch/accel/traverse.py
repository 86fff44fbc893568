"""Ray-triangle tests and the intersection entry points.

PyTorch counterpart of the part of `directcomputeraytracing_tpu.accel.
traverse` that the port's traversals use: the Moeller and watertight
tests, `HitInfo`, and `intersect_closest` / `intersect_any` with a
port-side backend resolution. The port has no stack traversal, so the
reference's `stack_size` argument is gone.

Backends (`_resolve_backend`), as the reference resolves them on its
accelerator:
- "auto": scenes with work-list tables (world-soup clusters above 2048
  world triangles, or the instanced tables above 2^20) go to the
  work-list traversal (`accel.worklist`), the others to the dense sweep
  (`accel.brute`).
- "brute" and "pallas": the dense sweep over the world soup, on any scene
  that has one (dense or clustered); instanced tables have none (the
  reference's soup is a placeholder there) and raise ValueError.
- "pallas_wl", "pallas_wlg" and "pallas_pair": the work list's bundle
  sweep, its grouped sweep and the pair sweep (`accel.pairsweep`) on
  world-soup cluster tables; on instanced tables all three take the
  instanced per-ray sweep, as the reference downgrades "pallas_wlg" and
  "pallas_pair" there; a scene without cluster tables raises ValueError.
- "pallas_cluster": the clustered cull-and-sweep (`accel.clustered`) on
  world-soup cluster tables, ValueError on others (the reference's
  tables are placeholders there and its clustered kernels return misses).
All launch their CUDA kernels for CUDA tensors and run their PyTorch
twins for CPU tensors. `t_cap` caps the window of the work-list and pair
casts; the dense and clustered sweeps ignore it and report `iterations`
0, as the reference's non-work-list backends do.
`intersect_closest_slab` marches a closest cast in distance windows.
Alpha-tested casts, the stack walker ("jax") and the reference's
interpret-mode names raise NotImplementedError naming the ROADMAP item
that brings them (the twins stand in for interpret mode).
"""

from typing import NamedTuple

import torch


class HitInfo(NamedTuple):
    t: torch.Tensor          # (R,) f32, inf on miss
    u: torch.Tensor          # (R,) f32 barycentric
    v: torch.Tensor          # (R,) f32
    triangle: torch.Tensor   # (R,) i32 global triangle id
    instance: torch.Tensor   # (R,) i32
    backface: torch.Tensor   # (R,) bool
    hit: torch.Tensor        # (R,) bool
    iterations: torch.Tensor  # (R,) i32 clusters swept (0: dense sweep)


def _xyz(x):
    return x[..., 0], x[..., 1], x[..., 2]


def _cross(ax, ay, az, bx, by, bz):
    """The cross product of component triples."""
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def ray_triangle_moeller(o, d, t_min, t_max, v0, v1, v2):
    """Moeller-Trumbore over broadcastable (..., 3) rays and triangles.
    Returns (t, u, v, backface, hit). Computed per component (no stacked
    (..., 3) temporaries), in the order of the kernels' test."""
    ox, oy, oz = _xyz(o)
    dx, dy, dz = _xyz(d)
    v0x, v0y, v0z = _xyz(v0)
    e1x, e1y, e1z = (a - b for a, b in zip(_xyz(v1), (v0x, v0y, v0z)))
    e2x, e2y, e2z = (a - b for a, b in zip(_xyz(v2), (v0x, v0y, v0z)))
    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) >= 1e-10
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx, qy, qz = _cross(tx, ty, tz, e1x, e1y, e1z)
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    backface = det > -1e-10
    hit = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= t_min) & (t < t_max))
    return t, u, v, backface, hit


def _pick(x, y, z, k):
    return torch.where(k == 0, x, torch.where(k == 1, y, z))


def ray_triangle_watertight(o, d, t_min, t_max, v0, v1, v2):
    """PBRT permute+shear watertight test over broadcastable (..., 3) rays
    and triangles. Returns (t, u, v, backface, hit). Computed per
    component, in the order of the kernels' test."""
    ox, oy, oz = _xyz(o)
    dx, dy, dz = _xyz(d)
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    kz = torch.where((ax >= ay) & (ax >= az), 0,
                     torch.where(ay >= az, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    d_z = _pick(dx, dy, dz, kz)
    inv_z = 1.0 / torch.where(torch.abs(d_z) < 1e-30, 1e-30, d_z)
    sx = -_pick(dx, dy, dz, kx) * inv_z
    sy = -_pick(dx, dy, dz, ky) * inv_z

    def shear(vtx):
        vx, vy, vz = _xyz(vtx)
        q = (vx - ox, vy - oy, vz - oz)
        pz = _pick(*q, kz)
        return _pick(*q, kx) + sx * pz, _pick(*q, ky) + sy * pz, pz

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
    cx, cy, cz = _cross(*(a - b for a, b in zip(_xyz(v1), _xyz(v0))),
                        *(a - b for a, b in zip(_xyz(v2), _xyz(v0))))
    degenerate = cx * cx + cy * cy + cz * cz == 0.0
    hit = ~mixed & det_ok & ~degenerate & (t >= t_min) & (t < t_max)
    return t, u, v, backface, hit


# backend name -> cast kind on world-soup cluster tables ("wl" on
# instanced tables)
_WORKLIST_BACKENDS = {"pallas_wl": "wl", "pallas_wlg": "wlg",
                      "pallas_pair": "pair"}


def _resolve_backend(scene, backend):
    """"dense" (the dense sweep), "wl" (the work list's bundle sweep, the
    instanced sweep on instanced scenes), "wlg" (its grouped sweep),
    "pair" (the pair sweep) or "cluster" (the clustered cull-and-sweep);
    raise for what the port cannot cast yet (see the module docstring)."""
    instanced = scene.isup_inst.shape[0] > 1
    clustered = scene.cluster_bbox.shape[0] > 1
    if backend == "auto":
        return "wl" if clustered or instanced else "dense"
    if backend in ("brute", "pallas"):
        if instanced:
            raise ValueError(f"traversal backend {backend!r} sweeps the world "
                             "soup, which instanced tables do not build")
        return "dense"
    if backend == "pallas_cluster":
        if instanced or not clustered:
            raise ValueError("traversal backend 'pallas_cluster' needs "
                             "world-soup cluster tables (2049 to 2^20 "
                             "world triangles)")
        return "cluster"
    if backend not in _WORKLIST_BACKENDS:
        raise NotImplementedError(
            f"traversal backend {backend!r}: the port resolves 'auto', "
            "'brute', 'pallas', 'pallas_wl', 'pallas_wlg', 'pallas_pair' and "
            "'pallas_cluster'; the stack traversal ('jax') is ROADMAP queue "
            "1, item 8, and the interpret-mode names have the twins instead")
    if instanced:
        return "wl"
    if not clustered:
        raise ValueError(f"traversal backend {backend!r} needs a scene with "
                         "cluster tables (more than 2048 world triangles)")
    return _WORKLIST_BACKENDS[backend]


def _no_alpha(opacity_u):
    if opacity_u is not None:
        raise NotImplementedError(
            "alpha-tested casts (opacity_u): ROADMAP queue 1, item 4")


def intersect_closest(scene, origin, direction, t_min=0.0, backend="auto",
                      watertight=False, opacity_u=None, t_cap=None):
    """Closest hit over the scene; origin/direction (R, 3) f32. t_cap
    (scalar or (R,)) caps the window of the work-list and pair casts (see
    `worklist.worklist_closest`); the dense and clustered sweeps search
    the whole ray, as the reference's non-work-list backends do."""
    _no_alpha(opacity_u)
    kind = _resolve_backend(scene, backend)
    if kind == "pair":
        from .pairsweep import pair_closest

        t, u, v, tri, inst, back, iters = pair_closest(
            scene, origin, direction, t_min, watertight, t_cap=t_cap)
    elif kind in ("wl", "wlg"):
        from .worklist import worklist_closest

        t, u, v, tri, inst, back, iters = worklist_closest(
            scene, origin, direction, t_min, watertight,
            grouped=kind == "wlg", t_cap=t_cap)
    else:
        if kind == "cluster":
            from .clustered import clustered_closest as cast
        else:
            from .brute import brute_closest as cast
        t, u, v, tri, inst, back = cast(scene, origin, direction, t_min,
                                        watertight)
        iters = torch.zeros_like(tri)
    return HitInfo(t=t, u=u, v=v, triangle=tri, instance=inst, backface=back,
                   hit=torch.isfinite(t), iterations=iters)


def _safe_inv(d):
    """1/d with exact zeros nudged so 0 * inv stays finite."""
    return 1.0 / torch.where(d.abs() < 1e-30,
                             torch.where(d >= 0.0, 1e-30, -1e-30), d)


# each slab phase's window is this many times wider than the one before
SLAB_GROW = 5.0
# slab phases of a marched cast, the last one unbounded
SLAB_PHASES = 2


class SlabStats:
    """What `intersect_closest_slab` did: `casts` per phase (a phase with
    no unresolved ray casts nothing), `recast` rays per later phase and
    `host_reads` (device values the host waited for: the unresolved
    count and the phase floor)."""

    def __init__(self, phases):
        self.casts = [0] * phases
        self.recast = [0] * (phases - 1)
        self.host_reads = 0


def intersect_closest_slab(scene, origin, direction, t_cap, backend="auto",
                           watertight=False, live=None,
                           phases=SLAB_PHASES, stats=None):
    """Distance-slab closest hit in `phases` geometric windows (reference
    `accel.traverse.intersect_closest_slab`). Phase 1 caps each ray at its
    scene-box entry + t_cap. Each later phase re-casts the still
    unresolved rays (no hit strictly below the previous cap, and the ray
    leaves the box beyond it) with a window SLAB_GROW-x wider, the last one
    unbounded, floored at the least previous cap of those rays. The
    reference keeps all R lanes and parks the resolved ones; here the
    unresolved rays are gathered (`torch.nonzero`, order kept) and only
    they are cast. Exact against one full cast up to packed-argmin ties
    at the window boundaries. live masks lanes whose phase-1 result is
    final regardless. Each later phase reads two device values on the
    host (counted in `stats.host_reads`): the unresolved count and the
    floor, which the kernels take as a float. The scene box is the work
    list's table bounds (the reference uses its TLAS root box)."""
    if int(phases) < 2:
        raise ValueError("slab marching needs a final unbounded phase")
    from .worklist import scene_tables

    stats = stats if stats is not None else SlabStats(int(phases))
    lo, hi = scene_tables(scene).bounds
    t_en = torch.full(origin.shape[:1], -float("inf"), device=origin.device)
    t_ex = torch.full(origin.shape[:1], float("inf"), device=origin.device)
    for ax in range(3):
        inv = _safe_inv(direction[:, ax])
        a = (lo[ax] - origin[:, ax]) * inv
        b = (hi[ax] - origin[:, ax]) * inv
        t_en = torch.maximum(t_en, torch.minimum(a, b))
        t_ex = torch.minimum(t_ex, torch.maximum(a, b))
    entry = torch.where((t_ex >= t_en) & (t_ex >= 0.0),
                        torch.clamp_min(t_en, 0.0), 0.0)
    caps = entry + t_cap
    hit = intersect_closest(scene, origin, direction, backend=backend,
                            watertight=watertight, t_cap=caps)
    stats.casts[0] += 1
    # a capped miss is final when the ray leaves the scene box before the
    # cap: the cast's window was the whole ray
    need = torch.where(hit.hit, hit.t >= caps, t_ex > caps)
    if live is not None:
        need = need & live
    hit = list(hit)
    floor_prev = caps
    for k in range(1, int(phases)):
        last = k == int(phases) - 1
        cap_k = None if last else entry + t_cap * (SLAB_GROW ** k)
        idx = torch.nonzero(need)[:, 0]
        stats.host_reads += 1
        if not idx.numel():
            break
        floor_k = float(floor_prev[idx].min())
        stats.host_reads += 1
        stats.casts[k] += 1
        stats.recast[k - 1] += idx.numel()
        hit_k = intersect_closest(
            scene, origin[idx], direction[idx], t_min=floor_k,
            backend=backend, watertight=watertight,
            t_cap=None if cap_k is None else cap_k[idx])
        iters = hit[7]
        for j, x in enumerate(hit_k):
            hit[j] = hit[j].index_put((idx,), x)
        hit[7] = iters.index_put((idx,), iters[idx] + hit_k.iterations)
        if not last:
            need = need.index_put((idx,), torch.where(
                hit_k.hit, hit_k.t >= cap_k[idx], t_ex[idx] > cap_k[idx]))
            floor_prev = cap_k
    return HitInfo(*hit)


def intersect_any(scene, origin, direction, t_max, t_min=0.0, backend="auto",
                  watertight=False, opacity_u=None):
    """Occlusion: True where a hit lies in [t_min, t_max)."""
    _no_alpha(opacity_u)
    kind = _resolve_backend(scene, backend)
    if kind == "pair":
        from .pairsweep import pair_any

        return pair_any(scene, origin, direction, t_max, t_min, watertight)
    if kind in ("wl", "wlg"):
        from .worklist import worklist_any

        return worklist_any(scene, origin, direction, t_max, t_min,
                            watertight, grouped=kind == "wlg")
    if kind == "cluster":
        from .clustered import clustered_any as cast
    else:
        from .brute import brute_any as cast
    return cast(scene, origin, direction, t_max, t_min, watertight)
