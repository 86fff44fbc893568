"""Triangle clusters for the work-list traversal (host side, numpy).

Port of `build_clusters`, `baldwin_table`, `build_local_clusters` and
`build_instanced_supers` from `directcomputeraytracing_tpu.accel.cluster`,
bit for bit. Triangles are split by recursive median over centroids into
clusters of at most `CLUSTER_SIZE` triangles. Cluster k owns rows
[k * CLUSTER_SIZE, (k + 1) * CLUSTER_SIZE) of the padded tables (zero
padding rows never hit), so a kernel indexes a cluster's triangles with
no range indirection. The world-space soup is clustered as one set; the
instanced tables cluster each mesh in its own space once, and every
instance gets world boxes of its mesh's clusters.
"""

import numpy as np

CLUSTER_SIZE = 16
SUPER_SIZE = 32          # clusters per supercluster (accel.worklist.SUPER)


def _median_split(cen, cluster_size):
    clusters = []

    def split(idx):
        if idx.size <= cluster_size:
            clusters.append(idx)
            return
        c = cen[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        half = idx.size // 2
        split(order[:half])
        split(order[half:])

    split(np.arange(cen.shape[0]))
    return clusters


def build_clusters(world_tris, world_tri_meta, cluster_size=CLUSTER_SIZE):
    """Returns (padded_tris (C * S, 13), cluster_bbox (C, 8)).

    padded_tris rows: v0|v1|v2 xyz, tri id, instance id, winding flip,
    world-soup row; cluster_bbox rows: bmin xyz, bmax xyz, 0, 0.
    """
    tris = np.asarray(world_tris, np.float32)
    meta = np.asarray(world_tri_meta, np.float32)
    n = tris.shape[0]
    v = tris.reshape(n, 3, 3)
    clusters = _median_split(v.mean(axis=1), cluster_size)

    tab = np.zeros((len(clusters) * cluster_size, 13), np.float32)
    bbox = np.zeros((len(clusters), 8), np.float32)
    for k, idx in enumerate(clusters):
        rows = slice(k * cluster_size, k * cluster_size + idx.size)
        tab[rows, 0:9] = tris[idx]
        tab[rows, 9:12] = meta[idx]
        tab[rows, 12] = idx.astype(np.float32)
        vv = v[idx]
        bbox[k, 0:3] = vv.min(axis=(0, 1))
        bbox[k, 3:6] = vv.max(axis=(0, 1))
    return tab, bbox


def baldwin_table(slab):
    """Per-triangle Baldwin-Weber transform rows from a cluster slab
    (Baldwin & Weber, JCGT 2016): the world -> barycentric affine map,
    so the test is a plane intersection plus two dot products.

    Returns (N, 16) f32 [n(3) | c0 | r1(3) | c1 | r2(3) | c2 | meta(3) |
    row] with t = (c0 - n.o) / (n.d), h = o + t d, u = r1.h + c1,
    v = r2.h + c2. den = n.d is the Moeller determinant negated, so its
    1e-10 degeneracy threshold and back-face sign carry over. Constants
    come from float64 and are rounded once; degenerate and padding rows
    get n = 0 and never hit."""
    v = slab[:, 0:9].astype(np.float64).reshape(-1, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    n2 = (n * n).sum(1)
    safe = np.where(n2 > 0, n2, 1.0)[:, None]
    r1 = np.cross(e2, n) / safe
    r2 = np.cross(n, e1) / safe
    c0 = (n * v[:, 0]).sum(1)
    c1 = -(r1 * v[:, 0]).sum(1)
    c2 = -(r2 * v[:, 0]).sum(1)
    n = np.where((n2 <= 0.0)[:, None], 0.0, n)
    return np.concatenate(
        [n, c0[:, None], r1, c1[:, None], r2, c2[:, None],
         slab[:, 9:12], slab[:, 12:13]], axis=1).astype(np.float32)


def build_local_clusters(tri_verts, tri_offsets, mesh_tri_counts,
                         cluster_size=CLUSTER_SIZE, super_size=SUPER_SIZE):
    """Mesh-local cluster slabs, one run per mesh, shared by all of its
    instances.

    tri_verts: (T, 9) leaf-ordered local triangles of all meshes;
    tri_offsets / mesh_tri_counts: each mesh's range. Returns (slab
    (CL * cluster_size, 13) rows v0|v1|v2 local, global tri id, 0, 0,
    row within the mesh; lbox (CL, 8) local cluster boxes, inverted
    (1, -1) on padding; mesh_super_offset (M,); mesh_super_count (M,)).
    Each mesh's run is padded to a super_size multiple, so a super never
    straddles two meshes."""
    slabs, boxes = [], []
    mso = np.zeros(len(tri_offsets), np.int64)
    msc = np.zeros(len(tri_offsets), np.int64)
    sup_cursor = 0
    for m, (lo, n) in enumerate(zip(tri_offsets, mesh_tri_counts)):
        v = tri_verts[lo:lo + n].reshape(n, 3, 3)
        clusters = _median_split(v.mean(axis=1), cluster_size)
        c_count = -(-len(clusters) // super_size) * super_size
        tab = np.zeros((c_count * cluster_size, 13), np.float32)
        bbox = np.zeros((c_count, 8), np.float32)
        bbox[:, 0:3] = 1.0
        bbox[:, 3:6] = -1.0
        for k, idx in enumerate(clusters):
            rows = slice(k * cluster_size, k * cluster_size + idx.size)
            tab[rows, 0:9] = tri_verts[lo + idx]
            tab[rows, 9] = (lo + idx).astype(np.float32)
            tab[rows, 12] = idx.astype(np.float32)
            bbox[k, 0:3] = v[idx].min(axis=(0, 1))
            bbox[k, 3:6] = v[idx].max(axis=(0, 1))
        slabs.append(tab)
        boxes.append(bbox)
        mso[m] = sup_cursor
        msc[m] = c_count // super_size
        sup_cursor += msc[m]
    return np.concatenate(slabs), np.concatenate(boxes), mso, msc


def _morton3(q, bits=8):
    out = np.zeros(q.shape[0], np.int64)
    for b in range(bits):
        for ax in range(3):
            out |= ((q[:, ax].astype(np.int64) >> b) & 1) << (3 * b + ax)
    return out


def build_instanced_supers(lbox, mesh_super_offset, mesh_super_count,
                           inst_mesh, inst_tf, super_size=SUPER_SIZE):
    """World-space boxes of every (instance, super) pair.

    Returns (isup_cbox (NS, super_size, 8) world boxes of the super's
    clusters, each the box of the local box's 8 transformed corners;
    isup_sbox (NS, 8) world super boxes; isup_local (NS,) the super's id
    in the shared local slab; isup_inst (NS,) its instance), sorted by
    the Morton code of the super box centre, so that consecutive supers,
    and so the hyper level's groups, are close in space."""
    corners_sel = np.array(
        [[x, y, z] for x in (0, 3) for y in (1, 4) for z in (2, 5)])
    cb, sb, sl, si = [], [], [], []
    for i, m in enumerate(inst_mesh):
        a, t = inst_tf[i][:3], inst_tf[i][3]
        s0, ns = int(mesh_super_offset[m]), int(mesh_super_count[m])
        box = lbox[s0 * super_size:(s0 + ns) * super_size]
        w = box[:, corners_sel] @ a + t
        inv = box[:, 0] > box[:, 3]          # padding clusters
        bmin = np.where(inv[:, None], 1.0, w.min(axis=1))
        bmax = np.where(inv[:, None], -1.0, w.max(axis=1))
        cbox = np.concatenate(
            [bmin, bmax, np.zeros((box.shape[0], 2), np.float32)],
            axis=1).astype(np.float32).reshape(ns, super_size, 8)
        real = ~inv.reshape(ns, super_size)
        any_real = real.any(1)[:, None]
        smin = np.where(any_real, np.where(real[..., None], cbox[..., 0:3],
                                           np.inf).min(1), 1.0)
        smax = np.where(any_real, np.where(real[..., None], cbox[..., 3:6],
                                           -np.inf).max(1), -1.0)
        cb.append(cbox)
        sb.append(np.concatenate([smin, smax, np.zeros((ns, 2), np.float32)],
                                 axis=1).astype(np.float32))
        sl.append(np.arange(s0, s0 + ns, dtype=np.int32))
        si.append(np.full(ns, i, np.int32))
    isup_sbox = np.concatenate(sb)
    cen = 0.5 * (isup_sbox[:, 0:3] + isup_sbox[:, 3:6])
    lo = cen.min(axis=0)
    ext = np.maximum(cen.max(axis=0) - lo, 1e-9)
    q = np.clip((cen - lo) / ext * 255.0, 0, 255).astype(np.int64)
    order = np.argsort(_morton3(q), kind="stable")
    return (np.concatenate(cb)[order], isup_sbox[order],
            np.concatenate(sl)[order], np.concatenate(si)[order])
