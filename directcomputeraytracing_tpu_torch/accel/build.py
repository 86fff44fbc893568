"""CPU BVH construction (SAH bucket builder), numpy only.

The port's own copy of the single-level builder of
`directcomputeraytracing_tpu.accel.build` (the reference's
Source/BVHAccel.cpp:76-447: 12-bucket SAH with cost 0.125 +
SA-weighted counts, median split for <= 4 primitives, equal split for
degenerate extents, primitives reordered into leaf order). The port
reads only `prim_order`: `flatten_scene` orders each mesh's triangles
into leaf order, as the reference does. The tests hold its node arrays
equal to the reference's.

Node packing: interior misc = split_axis, right_or_prim = right child;
leaf misc = count << 3 | split_axis, right_or_prim = first primitive.
"""

from dataclasses import dataclass

import numpy as np

from ..core.constants import BVHNODE_MISC_COUNT_SHIFT

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
                bucket_min = np.full((_SAH_BUCKETS, 3), np.inf, np.float32)
                bucket_max = np.full((_SAH_BUCKETS, 3), -np.inf, np.float32)
                bucket_cnt = np.zeros(_SAH_BUCKETS, np.int64)
                for ib in range(_SAH_BUCKETS):
                    sel = b == ib
                    c = int(sel.sum())
                    bucket_cnt[ib] = c
                    if c:
                        bucket_min[ib] = prim_bbox_min[idx[sel]].min(axis=0)
                        bucket_max[ib] = prim_bbox_max[idx[sel]].max(axis=0)
                # prefix/suffix sweep over the B-1 candidate splits
                costs = np.empty(_SAH_BUCKETS - 1, np.float64)
                lmin = np.minimum.accumulate(bucket_min, axis=0)
                lmax = np.maximum.accumulate(bucket_max, axis=0)
                lcnt = np.cumsum(bucket_cnt)
                rmin = np.minimum.accumulate(bucket_min[::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(bucket_max[::-1], axis=0)[::-1]
                rcnt = np.cumsum(bucket_cnt[::-1])[::-1]
                total_sa = max(_surface_area(bmin, bmax), 1e-30)
                for s in range(_SAH_BUCKETS - 1):
                    sa_l = _surface_area(lmin[s], lmax[s]) if lcnt[s] else 0.0
                    sa_r = (_surface_area(rmin[s + 1], rmax[s + 1])
                            if rcnt[s + 1] else 0.0)
                    costs[s] = _SAH_TRAVERSAL_COST + (
                        lcnt[s] * sa_l + rcnt[s + 1] * sa_r) / total_sa
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
