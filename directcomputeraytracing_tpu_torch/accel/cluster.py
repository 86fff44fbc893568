"""Triangle clusters for the work-list traversal (host side, numpy).

Port of `build_clusters` and `baldwin_table` from
`directcomputeraytracing_tpu.accel.cluster`, bit for bit. The world-space
triangle soup is split by recursive median over centroids into clusters
of at most `CLUSTER_SIZE` triangles. Cluster k owns rows
[k * CLUSTER_SIZE, (k + 1) * CLUSTER_SIZE) of the padded tables (zero
padding rows never hit), so a kernel indexes a cluster's triangles with
no range indirection.
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
