"""Ray-triangle tests and the intersection entry points.

PyTorch counterpart of `directcomputeraytracing_tpu.accel.traverse`: the
Moeller and watertight tests, `HitInfo`, the two-level stack walker
(`walk`), and `intersect_closest` / `intersect_any` with a port-side
backend resolution. The walker's tables (`NodeTables`: the packed node
table, the leaf-ordered triangles and the stack bound) are kept beside
the scene by `flatten_scene`, which builds them on first use where the
scene has another traversal (`node_tables`), so the reference's
`stack_size` argument is gone.

Backends (`_resolve_backend`), as the reference resolves them on its
accelerator:
- "auto": scenes with work-list tables (world-soup clusters above 2048
  world triangles, or the instanced tables above 2^20) go to the
  work-list traversal (`accel.worklist`), scenes with a world soup to
  the dense sweep (`accel.brute`), and the others (above 2^20 world
  triangles from at most 64 local ones: node table only) to the walker.
- "jax": the stack walker on any scene, in plain PyTorch on the CPU and
  on the card alike (the reference's is an XLA loop, not a Pallas
  kernel).
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
Alpha-tested casts (`opacity_u`) run the reference's recast loop
(`alpha_recast`) around the opaque casts of every backend, over the
opaque/masked cluster split where the scene has one; the walker tests
alpha inline, per candidate hit, as the reference's does. The reference's
interpret-mode names raise NotImplementedError (the twins stand in for
interpret mode).
"""

from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core.constants import (
    BVHNODE_MISC_COUNT_SHIFT,
    BVHNODE_MISC_HAS_BLAS,
    BVHNODE_MISC_SPLIT_AXIS_MASK,
    INSTANCE_FLAG_OPAQUE,
    INSTANCE_MATERIAL_OVERRIDE_NONE,
)
from ..core.types import transform_point, transform_vector


class HitInfo(NamedTuple):
    t: torch.Tensor          # (R,) f32, inf on miss
    u: torch.Tensor          # (R,) f32 barycentric
    v: torch.Tensor          # (R,) f32
    triangle: torch.Tensor   # (R,) i32 global triangle id
    instance: torch.Tensor   # (R,) i32
    backface: torch.Tensor   # (R,) bool
    hit: torch.Tensor        # (R,) bool
    iterations: torch.Tensor  # (R,) i32 walker loop steps or clusters
                              #   swept (0: dense and clustered sweeps)


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


def ray_aabb(o, inv_d, t_min, t_max, bmin, bmax):
    """Slab test of (R, 3) rays against (R, 3) boxes: (R,) bool."""
    ta = (bmin - o) * inv_d
    tb = (bmax - o) * inv_d
    t0 = torch.amax(torch.minimum(ta, tb), dim=-1)
    t1 = torch.amin(torch.maximum(ta, tb), dim=-1)
    return (t1 >= t0) & (t0 < t_max) & (t1 >= t_min)


# the walker reads done.all() on the host once every this many steps; a
# finished ray's state does not change in a step, so the result is the
# same as with a read every step
WALK_CHECK_EVERY = 8
_STACK_BLAS_BIT = -(1 << 31)         # bit 31 of an int32 stack entry
_STACK_INDEX_MASK = 0x7FFFFFFF


class NodeTables(NamedTuple):
    """The stack walker's tables of a scene."""
    node_table: torch.Tensor   # (N, 8) f32 TLAS + BLAS nodes: bbox_min |
                               #   bbox_max | right_or_prim | misc
    tri_verts: torch.Tensor    # (T, 9) f32 leaf-ordered local v0|v1|v2
    stack_size: int            # the two-level build's max_stack


# scene.inst_rows -> NodeTables, or a function that builds them
_NODE_TABLES = WeakIdKeyDictionary()


def register_node_tables(scene, tables):
    """Keep a scene's `NodeTables`, or a function of no arguments that
    builds them on first use (`node_tables`). A scene is known by its
    `inst_rows` tensor, which views of it (`_replace`) share."""
    _NODE_TABLES[scene.inst_rows] = tables


def node_tables(scene):
    """The scene's `NodeTables`, built now where `flatten_scene` left a
    builder."""
    tables = _NODE_TABLES.get(scene.inst_rows)
    if tables is None:
        raise ValueError("the scene has no node tables: make it with "
                         "flatten_scene or from_reference")
    if not isinstance(tables, NodeTables):
        tables = tables()
        _NODE_TABLES[scene.inst_rows] = tables
    return tables


class WalkState(NamedTuple):
    """The walker's result: the hit fields, the any-hit flag and each
    ray's count of steps in which it was active."""
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    triangle: torch.Tensor
    instance: torch.Tensor
    backface: torch.Tensor
    occluded: torch.Tensor
    iters: torch.Tensor


def walk(scene, origin, direction, t_min, t_max, any_hit, watertight=False,
         opacity_u=None, alpha_textures=False,
         check_every=WALK_CHECK_EVERY):
    """The two-level stack walk of the reference's `_traverse`: every ray
    steps through the scene's node table (`node_tables`) in lock step,
    one node a step, with its own stack of S = `stack_size` entries.
    A step fetches the node's row, tests its box, and then enters a TLAS
    leaf's BLAS (the ray moves to the instance's space), descends an
    interior node to its near child (the far one is pushed; near is the
    left child unless the ray's direction along the split axis is
    negative), tests a leaf's (at most 2) triangles, or pops (a missed
    box or a tested leaf; popping a TLAS entry from a BLAS restores the
    world ray). The stack top is read and the push written by gather and
    scatter at the stack count, where the reference selects one-hot over
    all S lanes. With opacity_u a candidate hit counts only where
    `effective_opacity` accepts the ray's sample. Any-hit rays end once
    occluded. The host reads `done.all()` every `check_every` steps.
    Returns `WalkState`; `iters` counts the steps
    in which a ray was active, as the reference's does. Counters: the
    last walk's `walk.steps` and `walk.host_reads`; `walk.calls` and
    `walk.total_steps` since `reset_counters`."""
    tri_test = (ray_triangle_watertight if watertight
                else ray_triangle_moeller)
    r, dev = origin.shape[0], origin.device
    table, tri_verts, depth = node_tables(scene)
    n_nodes, n_tris = table.shape[0], tri_verts.shape[0]
    n_inst = scene.inst_rows.shape[0]
    inv_rows = scene.inst_rows
    inv_tf = torch.cat([inv_rows[:, 0:9], inv_rows[:, 9:12]],
                       dim=1).reshape(n_inst, 4, 3)
    i32 = torch.int32

    node = torch.zeros(r, dtype=i32, device=dev)
    is_blas = torch.zeros(r, dtype=torch.bool, device=dev)
    instance = torch.zeros(r, dtype=i32, device=dev)
    stack = torch.zeros((r, depth), dtype=i32, device=dev)
    stack_n = torch.zeros(r, dtype=i32, device=dev)
    lo, ld = origin, direction
    t_cur = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (r,)).clone()
    hit_t = torch.full((r,), float("inf"), device=dev)
    hit_u = torch.zeros(r, device=dev)
    hit_v = torch.zeros(r, device=dev)
    hit_tri = torch.zeros(r, dtype=i32, device=dev)
    hit_inst = torch.zeros(r, dtype=i32, device=dev)
    hit_back = torch.zeros(r, dtype=torch.bool, device=dev)
    occluded = torch.zeros(r, dtype=torch.bool, device=dev)
    done = torch.zeros(r, dtype=torch.bool, device=dev)
    iters = torch.zeros(r, dtype=i32, device=dev)
    step = 0
    walk.steps = walk.host_reads = 0
    walk.calls += 1
    while True:
        if step % check_every == 0:
            walk.host_reads += 1
            if bool(done.all()):
                break
        step += 1
        walk.steps += 1
        walk.total_steps += 1
        active = ~done
        row = table[node.clamp(0, n_nodes - 1).long()]
        rop = row[:, 6].to(i32)
        misc = row[:, 7].to(i32)
        box_hit = ray_aabb(lo, _safe_inv(ld), t_min, t_cur, row[:, 0:3],
                           row[:, 3:6]) & active
        has_blas = (misc & BVHNODE_MISC_HAS_BLAS) != 0
        cnt = misc >> BVHNODE_MISC_COUNT_SHIFT
        axis = misc & BVHNODE_MISC_SPLIT_AXIS_MASK
        is_enter = box_hit & has_blas
        is_interior = box_hit & ~has_blas & (cnt == 0)
        is_leaf = box_hit & ~has_blas & (cnt > 0)
        do_pop = active & ~is_enter & ~is_interior

        # TLAS -> BLAS: the ray moves to the instance's space
        inst_new = torch.where(is_enter, cnt, instance)
        m = inv_tf[inst_new.clamp(0, n_inst - 1).long()]
        enter = is_enter[:, None]
        lo_new = torch.where(enter, transform_point(origin, m), lo)
        ld_new = torch.where(enter, transform_vector(direction, m), ld)
        node_next = torch.where(is_enter, rop, node)
        is_blas_new = is_blas | is_enter

        # interior: push the far child, descend to the near one
        d_axis = torch.where(axis == 0, ld_new[:, 0],
                             torch.where(axis == 1, ld_new[:, 1],
                                         ld_new[:, 2]))
        dir_neg = d_axis < 0.0
        left = node + 1
        push_idx = torch.where(dir_neg, left, rop)
        node_next = torch.where(is_interior,
                                torch.where(dir_neg, rop, left), node_next)
        packed = (push_idx & _STACK_INDEX_MASK) | torch.where(
            is_blas_new, _STACK_BLAS_BIT, 0).to(i32)
        col = stack_n.clamp(0, depth - 1).long()[:, None]
        write = (is_interior & (stack_n < depth))[:, None]
        stack.scatter_(1, col, torch.where(write, packed[:, None],
                                           stack.gather(1, col)))
        stack_n_new = stack_n + is_interior.to(i32)

        # leaf: up to two triangle tests (BLAS leaves hold at most 2)
        for k in range(2):
            prim = (rop + k).clamp(0, n_tris - 1)
            tv = tri_verts[prim.long()]
            t, u, v, back, ok = tri_test(lo_new, ld_new, t_min, t_cur,
                                         tv[:, 0:3], tv[:, 3:6], tv[:, 6:9])
            accept = is_leaf & (k < cnt) & ok
            if opacity_u is not None:
                opac, opaque = effective_opacity(scene, prim, inst_new, u, v,
                                                 alpha_textures)
                accept = accept & (opaque | (opacity_u < opac))
            if any_hit:
                occluded = occluded | accept
                continue
            t_cur = torch.where(accept, t, t_cur)
            hit_t = torch.where(accept, t, hit_t)
            hit_u = torch.where(accept, u, hit_u)
            hit_v = torch.where(accept, v, hit_v)
            hit_tri = torch.where(accept, prim, hit_tri)
            hit_inst = torch.where(accept, inst_new, hit_inst)
            hit_back = torch.where(accept, back, hit_back)

        # pop (missed boxes and tested leaves)
        empty = stack_n == 0
        pop_ok = do_pop & ~empty
        stack_n_after = torch.where(pop_ok, stack_n_new - 1, stack_n_new)
        top_col = stack_n_after.clamp(0, depth - 1).long()[:, None]
        top = torch.where(stack_n_after < depth,
                          stack.gather(1, top_col)[:, 0], 0)
        pop_is_blas = top < 0
        node = torch.where(pop_ok, top & _STACK_INDEX_MASK, node_next)
        restore = (pop_ok & is_blas_new & ~pop_is_blas)[:, None]
        is_blas = torch.where(pop_ok, pop_is_blas, is_blas_new)
        lo = torch.where(restore, origin, lo_new)
        ld = torch.where(restore, direction, ld_new)
        instance, stack_n = inst_new, stack_n_after
        done = done | (do_pop & empty)
        if any_hit:
            done = done | occluded
        iters = iters + active.to(i32)
    return WalkState(hit_t, hit_u, hit_v, hit_tri, hit_inst, hit_back,
                     occluded, iters)


walk.steps = walk.host_reads = 0


# backend name -> cast kind on world-soup cluster tables ("wl" on
# instanced tables)
_WORKLIST_BACKENDS = {"pallas_wl": "wl", "pallas_wlg": "wlg",
                      "pallas_pair": "pair"}


def _resolve_backend(scene, backend):
    """"dense" (the dense sweep), "wl" (the work list's bundle sweep, the
    instanced sweep on instanced scenes), "wlg" (its grouped sweep),
    "pair" (the pair sweep), "cluster" (the clustered cull-and-sweep) or
    "walk" (the stack walker); raise for what the port cannot cast (see
    the module docstring)."""
    instanced = scene.isup_inst.shape[0] > 1
    clustered = scene.cluster_bbox.shape[0] > 1
    if backend == "jax":
        return "walk"
    if backend == "auto":
        if clustered or instanced:
            return "wl"
        return "dense" if scene.world_tris.shape[0] > 1 else "walk"
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
            "'jax', 'brute', 'pallas', 'pallas_wl', 'pallas_wlg', "
            "'pallas_pair' and 'pallas_cluster'; the interpret-mode names "
            "have the twins instead")
    if instanced:
        return "wl"
    if not clustered:
        raise ValueError(f"traversal backend {backend!r} needs a scene with "
                         "cluster tables (more than 2048 world triangles)")
    return _WORKLIST_BACKENDS[backend]


def _cast_closest(scene, kind, origin, direction, t_min, watertight,
                  t_cap=None):
    """One opaque closest cast of backend kind (`_resolve_backend`):
    (t, u, v, tri, inst, back, iters)."""
    if kind == "pair":
        from .pairsweep import pair_closest

        return pair_closest(scene, origin, direction, t_min, watertight,
                            t_cap=t_cap)
    if kind in ("wl", "wlg"):
        from .worklist import worklist_closest

        return worklist_closest(scene, origin, direction, t_min, watertight,
                                grouped=kind == "wlg", t_cap=t_cap)
    if kind == "cluster":
        from .clustered import clustered_closest as cast
    else:
        from .brute import brute_closest as cast
    out = cast(scene, origin, direction, t_min, watertight)
    return (*out, torch.zeros_like(out[3]))


def _cast_any(scene, kind, origin, direction, t_max, t_min, watertight):
    """One opaque occlusion cast of backend kind: (R,) bool."""
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


def effective_opacity(scene, prim, inst, u, v, alpha_textures):
    """Alpha-test opacity of candidate hits and the instance OPAQUE flag
    that bypasses the test (reference `effective_opacity`): an instance's
    material override wins over the triangle's material; with
    alpha_textures the opacity texture's R channel, sampled at the hit's
    UV times the material's tiling, multiplies it. prim: leaf-ordered
    triangle ids, u, v: barycentrics (R,)."""
    inst_c = inst.long().clamp(0, scene.instance_flags.shape[0] - 1)
    opaque = (scene.instance_flags[inst_c] & INSTANCE_FLAG_OPAQUE) != 0
    override = scene.instance_material_overrides[inst_c]
    has_ov = override != INSTANCE_MATERIAL_OVERRIDE_NONE
    last_mat = scene.mat_table.shape[0] - 1
    prim = prim.long().clamp(0, scene.tri_opacity.shape[0] - 1)
    opac = torch.where(has_ov, scene.mat_table[override.clamp(0, last_mat), 9],
                       scene.tri_opacity[prim])
    if alpha_textures:
        from ..integrator.common import sample_texture_atlas

        mrow = scene.mat_table[torch.where(has_ov, override,
                                           scene.material_ids[prim])
                               .clamp(0, last_mat)]
        otex = mrow[:, 12].long()
        c0, c1, c2 = (scene.vtx_table[scene.triangles[prim, k], 9:11]
                      for k in range(3))
        uvh = (c0 + (c1 - c0) * u[..., None] + (c2 - c0) * v[..., None]) \
            * mrow[:, 7:9]
        tex_o = sample_texture_atlas(scene.textures, scene.texture_sizes,
                                     otex, uvh)[..., 0]
        opac = opac * torch.where(otex >= 0, tex_o, 1.0)
    return opac, opaque


# the recast loop's bound (the deepest transparent stack it resolves) and
# the relative origin advance past a rejected hit (the reference's)
ALPHA_MAX_PASSES = 64
ALPHA_ADVANCE = 4e-4


def alpha_recast(scene, cast, origin, direction, first_floor, opacity_u,
                 alpha_textures, t_max=None):
    """Alpha-tested query by re-casting around an opaque closest cast
    (reference `_alpha_recast`): cast, take a hit whose opacity accepts
    the ray's pre-drawn sample (`opacity_u < opacity`, or an OPAQUE
    instance), and re-cast the rays whose hit was rejected from
    t * (1 + ALPHA_ADVANCE) + 1e-5 beyond it, at most ALPHA_MAX_PASSES
    passes. cast(o, d, t_min, cap) -> (t, u, v, tri, inst, back, ...): the
    pass's floor is first_floor on the first pass (the original origins)
    and 0 on later ones (advanced origins); cap is None, or per ray the
    window left, t_max - t_base (the distance already advanced).

    Where the reference keeps every lane and parks the resolved ones, each
    pass here casts only the unresolved rays, gathered in their order
    (one host read a pass, the live count), so a pass costs what its rays
    need; per-ray results are the reference's. With t_max (per ray or a
    scalar) only hits below t_max count, and a ray with t_max <= 0 is
    resolved before the first pass. Returns (t accumulated over the passes,
    +inf on miss; u; v; tri; inst; back; occluded = a hit was taken).
    Counters: `alpha_recast.calls`, `alpha_recast.passes` (casts made)."""
    r, dev = origin.shape[0], origin.device
    out_t = torch.full((r,), float("inf"), device=dev)
    out_u, out_v = torch.zeros(r, device=dev), torch.zeros(r, device=dev)
    out_tri = torch.zeros(r, dtype=torch.int32, device=dev)
    out_inst = torch.zeros_like(out_tri)
    out_back = torch.zeros(r, dtype=torch.bool, device=dev)
    alpha_recast.calls += 1
    bounded = t_max is not None
    live = torch.arange(r, device=dev)
    if bounded:
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                   device=dev), (r,))
        live = torch.nonzero(t_max > 0.0)[:, 0]
    cur_o, t_base = origin, torch.zeros(r, device=dev)
    for k in range(ALPHA_MAX_PASSES):
        if not live.numel():
            break
        o, d, t_b = cur_o[live], direction[live], t_base[live]
        cap = torch.clamp_min(t_max[live] - t_b, 0.0) if bounded else None
        alpha_recast.passes += 1
        t, u, v, tri, inst, back = cast(o, d, first_floor if k == 0 else 0.0,
                                        cap)[:6]
        hit = torch.isfinite(t)
        opac, opaque = effective_opacity(scene, tri, inst, u, v,
                                         alpha_textures)
        accept = opaque | (opacity_u[live] < opac)
        t_tot = t_b + t
        take = hit & accept
        ends = ~hit | accept
        if bounded:
            beyond = t_tot >= t_max[live]
            take, ends = take & ~beyond, ends | beyond
        for out, new in ((out_t, t_tot), (out_u, u), (out_v, v),
                         (out_tri, tri), (out_inst, inst), (out_back, back)):
            out[live] = torch.where(take, new, out[live])
        reject = hit & ~accept
        adv = t * (1.0 + ALPHA_ADVANCE) + 1e-5
        cur_o = cur_o.index_put((live,), torch.where(
            reject[:, None], o + adv[:, None] * d, o))
        t_base = t_base.index_put((live,), torch.where(reject, t_b + adv,
                                                       t_b))
        live = live[torch.nonzero(~ends)[:, 0]]
    return (out_t, out_u, out_v, out_tri, out_inst, out_back,
            torch.isfinite(out_t))


def _has_alpha_split(scene, kind):
    """True where the opaque/masked split applies: the scene carries both
    sides' cluster tables (world-soup tables only) and the backend casts
    through cluster tables a view can swap (not the dense sweep)."""
    return (kind != "dense" and scene.mclu_bbox.shape[0] > 1
            and scene.oclu_bbox.shape[0] > 1
            and scene.isup_inst.shape[0] <= 1)


def _split_view(scene, masked):
    """The scene with one side of the split as its cluster tables (a
    `_replace` aliases the tensors; the work-list, pair and clustered
    table caches key on `cluster_bbox`, so each side has its own)."""
    if masked:
        return scene._replace(cluster_tris=scene.mclu_tris,
                              cluster_bw=scene.mclu_bw,
                              cluster_bbox=scene.mclu_bbox)
    return scene._replace(cluster_tris=scene.oclu_tris,
                          cluster_bw=scene.oclu_bw,
                          cluster_bbox=scene.oclu_bbox)


def _recast_closest(scene, kind, watertight):
    """The recast loop's cast: an opaque closest cast of kind over scene,
    capped at the window left."""
    def cast(o, d, t_min, cap):
        return _cast_closest(scene, kind, o, d, t_min, watertight, cap)
    return cast


def intersect_closest(scene, origin, direction, t_min=0.0, backend="auto",
                      watertight=False, opacity_u=None, alpha_textures=False,
                      t_cap=None):
    """Closest hit over the scene; origin/direction (R, 3) f32. t_cap
    (scalar or (R,)) caps the window of the work-list and pair casts (see
    `worklist.worklist_closest`); the dense and clustered sweeps search
    the whole ray, as the reference's non-work-list backends do.
    opacity_u (R,): the alpha test's pre-drawn samples (alpha_textures:
    with opacity textures). With the opaque/masked split one plain cast
    answers the opaque side and `alpha_recast` the masked side below the
    opaque hit (and t_cap); without it `alpha_recast` runs over the whole
    scene, capped at t_cap, and reports `iterations` 0."""
    kind = _resolve_backend(scene, backend)
    if kind == "walk":
        w = walk(scene, origin, direction, t_min, float("inf"), False,
                 watertight, opacity_u, alpha_textures)
        out = (w.t, w.u, w.v, w.triangle, w.instance, w.backface, w.iters)
    elif opacity_u is None:
        out = _cast_closest(scene, kind, origin, direction, t_min, watertight,
                            t_cap)
    elif _has_alpha_split(scene, kind):
        out = _cast_closest(_split_view(scene, False), kind, origin,
                            direction, t_min, watertight, t_cap)
        ceil = out[0] if t_cap is None else torch.minimum(
            out[0], torch.as_tensor(t_cap, dtype=torch.float32,
                                    device=origin.device))
        masked = alpha_recast(
            scene, _recast_closest(_split_view(scene, True), kind,
                                   watertight),
            origin, direction, t_min, opacity_u, alpha_textures, ceil)
        m = torch.isfinite(masked[0]) & (masked[0] < out[0])
        out = tuple(torch.where(m, a, b) for a, b in zip(masked[:6], out)) \
            + (out[6],)
    else:
        out = alpha_recast(scene, _recast_closest(scene, kind, watertight),
                           origin, direction, t_min, opacity_u,
                           alpha_textures, t_cap)
        out = out[:6] + (torch.zeros_like(out[3]),)
    t, u, v, tri, inst, back, iters = out
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
                           phases=SLAB_PHASES, stats=None, opacity_u=None,
                           alpha_textures=False):
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
    list's table bounds; the walker's is the TLAS root box, the
    reference's on every backend. With
    opacity_u every phase is an alpha-tested cast of its rays; the floor
    then holds on the recast loop's first pass only (see
    `alpha_recast`)."""
    if int(phases) < 2:
        raise ValueError("slab marching needs a final unbounded phase")
    from .worklist import scene_tables

    stats = stats if stats is not None else SlabStats(int(phases))
    if _resolve_backend(scene, backend) == "walk":
        root = node_tables(scene).node_table[0]
        lo, hi = root[0:3], root[3:6]
    else:
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
                            watertight=watertight, opacity_u=opacity_u,
                            alpha_textures=alpha_textures, t_cap=caps)
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
            opacity_u=None if opacity_u is None else opacity_u[idx],
            alpha_textures=alpha_textures,
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
                  watertight=False, opacity_u=None, alpha_textures=False):
    """Occlusion: True where a hit lies in [t_min, t_max). With opacity_u
    (alpha-tested): on the split, the opaque side's occlusion cast, then
    `alpha_recast` over the masked side for the rays it left unoccluded;
    without the split `alpha_recast` over the whole scene."""
    kind = _resolve_backend(scene, backend)
    if kind == "walk":
        return walk(scene, origin, direction, t_min, t_max, True, watertight,
                    opacity_u, alpha_textures).occluded
    if opacity_u is None:
        return _cast_any(scene, kind, origin, direction, t_max, t_min,
                         watertight)
    if not _has_alpha_split(scene, kind):
        return alpha_recast(scene, _recast_closest(scene, kind, watertight),
                            origin, direction, t_min, opacity_u,
                            alpha_textures, t_max)[6]
    occ = _cast_any(_split_view(scene, False), kind, origin, direction,
                    t_max, t_min, watertight)
    t_rest = torch.where(occ, 0.0, torch.as_tensor(
        t_max, dtype=torch.float32, device=origin.device))
    return occ | alpha_recast(
        scene, _recast_closest(_split_view(scene, True), kind, watertight),
        origin, direction, t_min, opacity_u, alpha_textures, t_rest)[6]


def reset_counters():
    alpha_recast.calls = alpha_recast.passes = 0
    walk.calls = walk.total_steps = 0


reset_counters()
