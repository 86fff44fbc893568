"""CPU BVH construction (SAH bucket builder), numpy only.

The port's own copy of the single-level builder of
`directcomputeraytracing_tpu.accel.build` (the reference's
Source/BVHAccel.cpp:76-447: 12-bucket SAH with cost 0.125 +
SA-weighted counts, median split for <= 4 primitives, equal split for
degenerate extents, primitives reordered into leaf order), and of its
two-level assembly (`build_two_level`: a TLAS over the instances' world
boxes, each mesh's BLAS after it in one node buffer, the reference's
Source/Scene.cpp:174-215, 337-391) and BVH dump
(`serialize_bvh_to_xml`). `flatten_scene` orders each mesh's triangles
into leaf order and packs the two-level buffer into the stack walker's
node table. The tests hold the node arrays, and the dump string for
string, equal to the reference's.

Node packing:
  interior:  misc = split_axis,              right_or_prim = right child
  BLAS leaf: misc = count << 3 | split_axis, right_or_prim = first prim
  TLAS leaf: misc = instance << 3 | 0x4,     right_or_prim = BLAS root
"""

from dataclasses import dataclass

import numpy as np

from ..core.constants import BVHNODE_MISC_COUNT_SHIFT, BVHNODE_MISC_HAS_BLAS

_SAH_BUCKETS = 12
_SAH_TRAVERSAL_COST = 0.125


@dataclass
class BVH:
    bbox_min: np.ndarray       # (N, 3) f32
    bbox_max: np.ndarray       # (N, 3) f32
    right_or_prim: np.ndarray  # (N,) u32
    misc: np.ndarray           # (N,) u32
    prim_order: np.ndarray     # (P,) i64: leaf-order slot -> original prim
    max_depth: int             # root depth = 1
    leaf_depths: np.ndarray    # (P,) i32 depth of the leaf holding each slot

    @property
    def num_nodes(self):
        return self.bbox_min.shape[0]


def _surface_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def build_bvh(prim_bbox_min, prim_bbox_max, max_prims_in_node=2):
    """Build a single-level BVH over primitive AABBs. Every leaf holds at
    most max_prims_in_node primitives.
    """
    prim_bbox_min = np.asarray(prim_bbox_min, np.float32)
    prim_bbox_max = np.asarray(prim_bbox_max, np.float32)
    n = prim_bbox_min.shape[0]
    assert n > 0, "cannot build a BVH over zero primitives"
    centroids = 0.5 * (prim_bbox_min + prim_bbox_max)

    order = np.arange(n)
    bbox_min, bbox_max, right_or_prim, misc = [], [], [], []
    leaf_depths = np.zeros(n, np.int32)
    max_depth = 0

    def emit(bmin, bmax, rop, m):
        bbox_min.append(bmin)
        bbox_max.append(bmax)
        right_or_prim.append(rop)
        misc.append(m)
        return len(misc) - 1

    # Work stack of (lo, hi, depth, parent_to_patch). parent_to_patch is the
    # interior node whose right_or_prim must point at this subtree's root
    # (-1 for the root / left children, which sit at parent + 1).
    stack = [(0, n, 1, -1)]
    while stack:
        lo, hi, depth, patch = stack.pop()
        count = hi - lo
        idx = order[lo:hi]
        bmin = prim_bbox_min[idx].min(axis=0)
        bmax = prim_bbox_max[idx].max(axis=0)
        max_depth = max(max_depth, depth)

        cmin = centroids[idx].min(axis=0)
        cmax = centroids[idx].max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))

        make_leaf = count <= 1
        mid = -1
        if not make_leaf:
            if extent[axis] <= 0.0:
                # Degenerate: all centroids coincide — split equally so the
                # leaf bound still holds.
                if count <= max_prims_in_node:
                    make_leaf = True
                else:
                    mid = lo + count // 2
            elif count <= 4:
                # Median split
                key = centroids[idx, axis]
                part = np.argsort(key, kind="stable")
                order[lo:hi] = idx[part]
                mid = lo + count // 2
            else:
                # 12-bucket SAH
                key = centroids[idx, axis]
                rel = (key - cmin[axis]) / extent[axis]
                b = np.minimum((rel * _SAH_BUCKETS).astype(np.int64),
                               _SAH_BUCKETS - 1)
                # per-bucket bounds and counts (exact mins and maxes, so
                # one scatter equals the reference's loop over buckets)
                bucket_min = np.full((_SAH_BUCKETS, 3), np.inf, np.float32)
                bucket_max = np.full((_SAH_BUCKETS, 3), -np.inf, np.float32)
                np.minimum.at(bucket_min, b, prim_bbox_min[idx])
                np.maximum.at(bucket_max, b, prim_bbox_max[idx])
                bucket_cnt = np.bincount(b, minlength=_SAH_BUCKETS)
                # prefix/suffix sweep over the B-1 candidate splits, all at
                # once in the reference's float32 / float64 arithmetic
                lmin = np.minimum.accumulate(bucket_min, axis=0)
                lmax = np.maximum.accumulate(bucket_max, axis=0)
                lcnt = np.cumsum(bucket_cnt)
                rmin = np.minimum.accumulate(bucket_min[::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(bucket_max[::-1], axis=0)[::-1]
                rcnt = np.cumsum(bucket_cnt[::-1])[::-1]
                total_sa = max(_surface_area(bmin, bmax), 1e-30)
                sa_l = np.where(lcnt[:-1] > 0,
                                _surface_area(lmin[:-1], lmax[:-1]), 0.0)
                sa_r = np.where(rcnt[1:] > 0,
                                _surface_area(rmin[1:], rmax[1:]), 0.0)
                costs = _SAH_TRAVERSAL_COST + (
                    lcnt[:-1] * sa_l + rcnt[1:] * sa_r) / total_sa
                best = int(np.argmin(costs))
                leaf_cost = float(count)
                if count > max_prims_in_node or costs[best] < leaf_cost:
                    sel_left = b <= best
                    if sel_left.all() or not sel_left.any():
                        # SAH put everything on one side: equal fallback
                        part = np.argsort(key, kind="stable")
                        order[lo:hi] = idx[part]
                        mid = lo + count // 2
                    else:
                        order[lo:hi] = np.concatenate(
                            [idx[sel_left], idx[~sel_left]])
                        mid = lo + int(sel_left.sum())
                else:
                    make_leaf = True

        if make_leaf:
            emit(bmin, bmax, lo,
                 (count << BVHNODE_MISC_COUNT_SHIFT) | axis)
            leaf_depths[lo:hi] = depth
        else:
            node = emit(bmin, bmax, 0, axis)  # right child patched later
            # Left subtree is emitted next (depth-first), so push right first.
            stack.append((mid, hi, depth + 1, node))
            stack.append((lo, mid, depth + 1, -1))
        if patch >= 0:
            right_or_prim[patch] = len(misc) - 1

    return BVH(
        bbox_min=np.asarray(bbox_min, np.float32),
        bbox_max=np.asarray(bbox_max, np.float32),
        right_or_prim=np.asarray(right_or_prim, np.uint32),
        misc=np.asarray(misc, np.uint32),
        prim_order=order,
        max_depth=max_depth,
        leaf_depths=leaf_depths,
    )


def transform_aabb(bmin, bmax, m43):
    """World box of a transformed local box ((4, 3) row-vector affine)."""
    corners = np.array([[x, y, z] for x in (bmin[0], bmax[0])
                        for y in (bmin[1], bmax[1])
                        for z in (bmin[2], bmax[2])], np.float32)
    world = corners @ m43[:3, :] + m43[3, :]
    return world.min(axis=0), world.max(axis=0)


@dataclass
class TwoLevelBVH:
    """The TLAS's nodes at offset 0, each BLAS after them, TLAS leaves
    rewired to (instance, BLAS root); max_stack bounds the walker's
    stack."""

    bbox_min: np.ndarray
    bbox_max: np.ndarray
    right_or_prim: np.ndarray
    misc: np.ndarray
    max_stack: int


def build_two_level(blas_list, mesh_tri_offsets, instance_mesh,
                    instance_transforms):
    """Assemble the TLAS + BLAS node buffer.

    blas_list: one `BVH` per mesh over its triangles (mesh-local ids);
    mesh_tri_offsets: each mesh's first triangle in the leaf-ordered
    triangle buffer; instance_mesh: (I,) mesh per instance;
    instance_transforms: (I, 4, 3) local -> world.

    Returns (TwoLevelBVH, tlas_prim_order): the TLAS's leaf order of the
    instances. max_stack is the deepest TLAS leaf's depth plus the
    deepest BLAS under it, plus one (the reference's conservative bound).
    """
    num_instances = len(instance_mesh)
    inst_bmin = np.empty((num_instances, 3), np.float32)
    inst_bmax = np.empty((num_instances, 3), np.float32)
    for i in range(num_instances):
        blas = blas_list[instance_mesh[i]]
        inst_bmin[i], inst_bmax[i] = transform_aabb(
            blas.bbox_min[0], blas.bbox_max[0], instance_transforms[i])

    tlas = build_bvh(inst_bmin, inst_bmax, max_prims_in_node=1)
    blas_offsets = tlas.num_nodes + np.concatenate(
        [[0], np.cumsum([b.num_nodes for b in blas_list])[:-1]]
    ).astype(np.int64)
    total = tlas.num_nodes + sum(b.num_nodes for b in blas_list)
    bbox_min = np.empty((total, 3), np.float32)
    bbox_max = np.empty((total, 3), np.float32)
    rop = np.empty(total, np.uint32)
    misc = np.empty(total, np.uint32)

    # TLAS nodes; each leaf holds one instance and becomes its BLAS entry
    nt = tlas.num_nodes
    bbox_min[:nt] = tlas.bbox_min
    bbox_max[:nt] = tlas.bbox_max
    inst_mesh = np.asarray(instance_mesh, np.int64)
    leaf = (tlas.misc >> BVHNODE_MISC_COUNT_SHIFT) != 0
    inst = tlas.prim_order[np.where(leaf, tlas.right_or_prim, 0)
                           .astype(np.int64)]
    rop[:nt] = np.where(leaf, blas_offsets[inst_mesh[inst]],
                        tlas.right_or_prim).astype(np.uint32)
    misc[:nt] = np.where(
        leaf, (inst << BVHNODE_MISC_COUNT_SHIFT) | BVHNODE_MISC_HAS_BLAS,
        tlas.misc).astype(np.uint32)

    # BLAS nodes: child links by the BLAS's offset, leaves by the mesh's
    # first triangle
    for m, blas in enumerate(blas_list):
        o = blas_offsets[m]
        e = o + blas.num_nodes
        bbox_min[o:e] = blas.bbox_min
        bbox_max[o:e] = blas.bbox_max
        interior = (blas.misc >> BVHNODE_MISC_COUNT_SHIFT) == 0
        rop[o:e] = (blas.right_or_prim.astype(np.int64)
                    + np.where(interior, o, mesh_tri_offsets[m])
                    ).astype(np.uint32)
        misc[o:e] = blas.misc

    slot = np.empty(num_instances, np.int64)
    slot[tlas.prim_order] = np.arange(num_instances)
    blas_depth = np.asarray([b.max_depth for b in blas_list], np.int64)
    max_stack = int((tlas.leaf_depths[slot] + blas_depth[inst_mesh]).max())
    return (TwoLevelBVH(bbox_min=bbox_min, bbox_max=bbox_max,
                        right_or_prim=rop, misc=misc,
                        max_stack=max_stack + 1),
            tlas.prim_order)


def serialize_bvh_to_xml(scene):
    """Every BLAS and the combined TLAS + BLAS buffer as XML, for offline
    inspection and diffing (the reference's -OutputBVH dump)."""
    import io

    from ..scene.scene import triangle_bounds

    out = io.StringIO()
    out.write("<BVHDump>\n")

    def write_nodes(bmin_a, bmax_a, rop_a, misc_a, max_depth, tag):
        n = bmin_a.shape[0]
        out.write(f"  <{tag} nodeCount=\"{n}\" "
                  f"maxDepth=\"{max_depth}\">\n")
        for i in range(n):
            misc = int(misc_a[i])
            count = misc >> BVHNODE_MISC_COUNT_SHIFT
            kind = ("tlasLeaf" if misc & BVHNODE_MISC_HAS_BLAS
                    else ("leaf" if count else "interior"))
            bmin, bmax = bmin_a[i], bmax_a[i]
            out.write(
                f"    <Node index=\"{i}\" kind=\"{kind}\" "
                f"rightOrPrim=\"{int(rop_a[i])}\" "
                f"misc=\"{misc}\" "
                f"bboxMin=\"{bmin[0]:.6g} {bmin[1]:.6g} {bmin[2]:.6g}\" "
                f"bboxMax=\"{bmax[0]:.6g} {bmax[1]:.6g} {bmax[2]:.6g}\"/>\n")
        out.write(f"  </{tag}>\n")

    blas_list = []
    offsets = np.zeros(len(scene.meshes), np.int64)
    cursor = 0
    for m, mesh in enumerate(scene.meshes):
        blas = build_bvh(*triangle_bounds(mesh.positions, mesh.indices),
                         max_prims_in_node=2)
        blas_list.append(blas)
        offsets[m] = cursor
        cursor += mesh.indices.shape[0]
        write_nodes(blas.bbox_min, blas.bbox_max, blas.right_or_prim,
                    blas.misc, blas.max_depth, f"BLAS_{m}")
    two_level, _ = build_two_level(
        blas_list, offsets, [inst.mesh for inst in scene.instances],
        np.stack([inst.transform for inst in scene.instances]))
    write_nodes(two_level.bbox_min, two_level.bbox_max,
                two_level.right_or_prim, two_level.misc,
                two_level.max_stack, "CombinedTLASPlusBLAS")
    out.write("</BVHDump>\n")
    return out.getvalue()


def stack_bound(node_table):
    """`build_two_level`'s max_stack, read back from a packed (N, 8) node
    table: the deepest TLAS leaf's depth plus the height of the BLAS it
    enters, plus one. Children follow their parents in the table (left
    child n + 1, right child right_or_prim), so one backward pass gives
    each node's height and one forward pass each TLAS node's depth."""
    rop = node_table[:, 6].astype(np.int64)
    misc = node_table[:, 7].astype(np.int64)
    n = rop.shape[0]
    tlas_leaf = (misc & BVHNODE_MISC_HAS_BLAS) != 0
    interior = ~tlas_leaf & ((misc >> BVHNODE_MISC_COUNT_SHIFT) == 0)
    height = np.ones(n, np.int64)
    for i in range(n - 1, -1, -1):
        if interior[i]:
            height[i] = 1 + max(height[i + 1], height[rop[i]])
    depth = np.zeros(n, np.int64)
    depth[0] = 1
    best = 0
    for i in range(n):
        if not depth[i]:
            continue            # a BLAS node: not on a TLAS path
        if tlas_leaf[i]:
            best = max(best, depth[i] + height[rop[i]])
        elif interior[i]:
            depth[i + 1] = depth[rop[i]] = depth[i] + 1
    return int(best) + 1
