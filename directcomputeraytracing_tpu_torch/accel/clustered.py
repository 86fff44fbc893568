"""Clustered cull-and-sweep over the world soup: the CUDA kernels and their
twins.

Counterpart of the clustered half of `directcomputeraytracing_tpu.accel.
pallas_brute` (`_pad_cluster_tables`, `_cull_masks`, `_exact_masks`,
`clustered_closest_pallas`, `clustered_any_pallas`); its dense half is
`accel.brute`. The intersector takes it for `traversal_backend=
"pallas_cluster"` on scenes with world-soup cluster tables. A cast runs:

1. The cull. `cull_masks` (kernel `cull_kernel`, twin `cull_masks_torch`):
   per block of RAY_BLOCK consecutive rays, a conservative interval test
   of the block's ray bundle (the min and max of origin and direction per
   axis) against every cluster box, in the reference's arithmetic ->
   (n_blocks, Cg) uint8 cluster mask and (n_blocks, Cg / 16) group mask.
   The bundle is taken over the block's rays that can reach the scene
   (`reach_mask`: finite, a non-zero direction, the ray's own slab test
   enters the reach box), so that parked lanes and rays that leave the
   scene do not stretch it over every cluster. Sound: a ray left out
   misses the reach box, which holds every cluster box, so it enters no
   cluster box and has no hit to lose; it is still swept against what its
   block entered. The reference pads the rays to 8 blocks with zero rays
   and takes every ray into the bundle.
2. The sweep. `sweep_closest` / `sweep_any` (kernels `closest_kernel` /
   `any_kernel`, twins `sweep_closest_torch` / `sweep_any_torch`): every
   ray tests every row of every cluster its block entered, groups and
   clusters in ascending order, with its current best as t_max. The
   closest hit is the first triangle in cluster-table order among those
   at the minimum t (strict `<`); `back` is the test's flag XOR the
   table's flip column. Any-hit: a hit in [t_min, t_max).

`clustered_closest` / `clustered_any` are the casts the intersector
calls: kernels on CUDA tensors, twins on CPU tensors, and any other
device raises. `clustered_closest_torch` / `clustered_any_torch` are the
same casts with the twins on any device. `exact_masks_torch` is the
reference's per-ray exact mask, for the tests. The tables
(`pad_cluster_tables`) are built once per scene and cached on its
`cluster_bbox`.

Counters: `cull_masks.launches`, `sweep_closest.launches` and
`sweep_any.launches` count CUDA launches (`counters()`,
`reset_counters()`).
"""

import ctypes
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .brute import _slab_test
from .cluster import CLUSTER_SIZE
from .traverse import _safe_inv

RAY_BLOCK = 1024         # rays per mask row: one 32x32 tile of the renderer
CLUSTER_GROUP = 16       # clusters per group
GROUP_ROWS = CLUSTER_GROUP * CLUSTER_SIZE
BIG = 3.0e38
REACH_PAD = 1e-3         # the reach box: the scene box widened by this
                         # fraction of its largest extent
_INVERTED_BOX = (1.0, 1.0, 1.0, -1.0, -1.0, -1.0, 0.0, 0.0)
TWIN_PAIRS = 1 << 22     # (ray, row) or (block, cluster) pairs per step
                         # of the twins

_NVCC_EXTRA = ("-fmad=false",)   # round like the twins (see brute.py)
_built = None
_TABLES = WeakIdKeyDictionary()


def kernels():
    """The loaded kernel library (built on first call); `.seconds` and
    `.log` describe the build."""
    global _built
    if _built is None:
        from ..utils.cuda_build import load_library

        built = load_library("clustered.cu", _NVCC_EXTRA)
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = built.lib
        lib.dcrt_cluster_cull.argtypes = [c_p, c_i, c_p, c_p, c_i] \
            + [c_f] * 6 + [c_p, c_p, c_p]
        lib.dcrt_cluster_closest.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p,
                                             c_i, c_f, c_i] + [c_p] * 7
        lib.dcrt_cluster_any.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p, c_p,
                                         c_i, c_f, c_i, c_p, c_p]
        for fn in (lib.dcrt_cluster_cull, lib.dcrt_cluster_closest,
                   lib.dcrt_cluster_any):
            fn.restype = c_i
        _built = built
    return _built


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

class ClusterTables(NamedTuple):
    ctab: torch.Tensor   # (Cg * 16, 12) rows [v0 v1 v2 | tri | inst | flip]
    cbox: torch.Tensor   # (Cg, 8) boxes, inverted on padding clusters
    n_groups: int        # Cg / CLUSTER_GROUP
    reach: tuple         # reach box (lo xyz, hi xyz), float32 values


def pad_cluster_tables(scene):
    """The world-soup cluster tables padded to a CLUSTER_GROUP multiple
    (reference `_pad_cluster_tables` without its TPU lane padding):
    padding clusters get zero rows, which never hit, and inverted boxes.
    Built once and kept for as long as the scene's `cluster_bbox` lives;
    the reach box costs one host read then."""
    tab = _TABLES.get(scene.cluster_bbox)
    if tab is None:
        cbox = scene.cluster_bbox
        c = cbox.shape[0]
        cg = -(-c // CLUSTER_GROUP) * CLUSTER_GROUP
        ctab = scene.cluster_tris[:, :12]
        if cg != c:
            ctab = torch.nn.functional.pad(ctab,
                                           (0, 0, 0, (cg - c) * CLUSTER_SIZE))
            cbox = torch.cat([cbox, torch.tensor(
                _INVERTED_BOX, dtype=cbox.dtype,
                device=cbox.device).expand(cg - c, 8)])
        lo = scene.cluster_bbox[:, 0:3].amin(0)
        hi = scene.cluster_bbox[:, 3:6].amax(0)
        pad = REACH_PAD * (hi - lo).amax()
        reach = torch.cat([lo - pad, hi + pad]).cpu().tolist()
        tab = ClusterTables(ctab.contiguous(), cbox.contiguous(),
                            cg // CLUSTER_GROUP, tuple(reach))
        _TABLES[scene.cluster_bbox] = tab
    return tab


# ---------------------------------------------------------------------------
# the cull: kernel row 3, its twin, the exact masks
# ---------------------------------------------------------------------------

def reach_mask(tables, origin, direction):
    """(R,) bool: the rays that can reach the scene. A ray is finite, has
    a non-zero direction and its slab test enters the reach box."""
    box = torch.tensor(tables.reach, dtype=torch.float32,
                       device=origin.device)
    ok = (torch.isfinite(origin).all(1) & torch.isfinite(direction).all(1)
          & ((direction * direction).sum(1) > 0.0))
    t_lo = torch.full_like(origin[:, 0], -BIG)
    t_hi = torch.full_like(origin[:, 0], BIG)
    for ax in range(3):
        inv = _safe_inv(direction[:, ax])
        a = (box[ax] - origin[:, ax]) * inv
        b = (box[3 + ax] - origin[:, ax]) * inv
        t_lo = torch.maximum(t_lo, torch.minimum(a, b))
        t_hi = torch.minimum(t_hi, torch.maximum(a, b))
    return ok & (t_hi >= t_lo) & (t_hi >= 0.0)


def _n_blocks(r):
    return -(-r // RAY_BLOCK)


def _block_bounds(tables, origin, direction):
    """(n_blocks, 6) min and max of [origin | direction] over each block's
    rays that reach the scene (+inf and -inf in a block with none)."""
    r = origin.shape[0]
    pad = _n_blocks(r) * RAY_BLOCK - r
    reach = reach_mask(tables, origin, direction)[:, None]
    od = torch.cat([origin, direction], 1)

    def fold(fill, fn):
        x = torch.nn.functional.pad(torch.where(reach, od, fill),
                                    (0, 0, 0, pad), value=fill)
        return fn(x.view(-1, RAY_BLOCK, 6), 1)

    return fold(float("inf"), torch.amin), fold(-float("inf"), torch.amax)


def _interval_enter(cbox, lo, hi):
    """(nb, C) bool: the reference's interval test (`_cull_one_block`) of
    block bounds lo, hi (nb, 6) against boxes cbox (C, 8)."""
    nb, c = lo.shape[0], cbox.shape[0]
    t_lo = torch.full((nb, c), -BIG, dtype=cbox.dtype, device=cbox.device)
    t_hi = torch.full_like(t_lo, BIG)
    for ax in range(3):
        o_lo, o_hi = lo[:, ax, None], hi[:, ax, None]
        d_lo, d_hi = lo[:, 3 + ax, None], hi[:, 3 + ax, None]
        b0, b1 = cbox[None, :, ax], cbox[None, :, 3 + ax]
        spans = (d_lo <= 0.0) & (d_hi >= 0.0)
        i_a, i_b = _safe_inv(d_lo), _safe_inv(d_hi)
        i_lo, i_hi = torch.minimum(i_a, i_b), torch.maximum(i_a, i_b)
        n0_lo, n0_hi = b0 - o_hi, b0 - o_lo
        n1_lo, n1_hi = b1 - o_hi, b1 - o_lo
        cands = [n0_lo * i_lo, n0_lo * i_hi, n0_hi * i_lo, n0_hi * i_hi,
                 n1_lo * i_lo, n1_lo * i_hi, n1_hi * i_lo, n1_hi * i_hi]
        ax_lo = ax_hi = cands[0]
        for cd in cands[1:]:
            ax_lo = torch.minimum(ax_lo, cd)
            ax_hi = torch.maximum(ax_hi, cd)
        t_lo = torch.where(spans, t_lo, torch.maximum(t_lo, ax_lo))
        t_hi = torch.where(spans, t_hi, torch.minimum(t_hi, ax_hi))
    return (t_hi >= t_lo) & (t_hi >= 0.0)


def _group_mask(cmask, n_groups):
    return cmask.view(cmask.shape[0], n_groups, CLUSTER_GROUP).amax(2)


def cull_masks_torch(tables, origin, direction):
    """Twin of `cull_kernel`: (cmask (n_blocks, Cg) uint8, gmask
    (n_blocks, n_groups) uint8)."""
    lo, hi = _block_bounds(tables, origin, direction)
    step = max(1, TWIN_PAIRS // tables.cbox.shape[0])
    cmask = torch.cat([
        _interval_enter(tables.cbox, lo[i:i + step], hi[i:i + step])
        & (lo[i:i + step, 0:1] <= hi[i:i + step, 0:1])
        for i in range(0, lo.shape[0], step)]).to(torch.uint8)
    return cmask, _group_mask(cmask, tables.n_groups)


def exact_masks_torch(scene, origin, direction):
    """The reference's `_exact_masks` over the real rays: a cluster is
    entered where some ray of the block enters its box (per-ray slab
    test, no t range), padding clusters never. (cmask (n_blocks, Cg),
    gmask) uint8, for the tests."""
    tables = pad_cluster_tables(scene)
    cbox = scene.cluster_bbox
    r, c = origin.shape[0], cbox.shape[0]
    inv = _safe_inv(direction)
    rows = []
    for i in range(0, r, RAY_BLOCK):
        o, iv = origin[i:i + RAY_BLOCK, None, :], inv[i:i + RAY_BLOCK, None, :]
        a = (cbox[None, :, 0:3] - o) * iv
        b = (cbox[None, :, 3:6] - o) * iv
        t_lo = torch.full(a.shape[:2], -BIG, dtype=a.dtype, device=a.device)
        t_hi = torch.full_like(t_lo, BIG)
        for ax in range(3):
            t_lo = torch.maximum(t_lo, torch.minimum(a[..., ax], b[..., ax]))
            t_hi = torch.minimum(t_hi, torch.maximum(a[..., ax], b[..., ax]))
        rows.append(((t_hi >= t_lo) & (t_hi >= 0.0)).any(0))
    cmask = torch.zeros((_n_blocks(r), tables.cbox.shape[0]),
                        dtype=torch.uint8, device=origin.device)
    if rows:
        cmask[:, :c] = torch.stack(rows).to(torch.uint8)
    return cmask, _group_mask(cmask, tables.n_groups)


# ---------------------------------------------------------------------------
# the sweeps: kernel rows 4 (closest) and 5 (any), twins
# ---------------------------------------------------------------------------

def _group_rays(cmask, gmask, g, r):
    """The rays (n,) of the blocks that entered group g, and each one's
    (n, GROUP_ROWS) row mask (its block's entered clusters)."""
    blocks = torch.nonzero(gmask[:, g])[:, 0]
    rays = (blocks[:, None] * RAY_BLOCK
            + torch.arange(RAY_BLOCK, device=gmask.device)).reshape(-1)
    cols = cmask[blocks, g * CLUSTER_GROUP:(g + 1) * CLUSTER_GROUP].bool()
    cols = cols.repeat_interleave(CLUSTER_SIZE, 1)
    keep = rays < r
    return rays[keep], cols.repeat_interleave(RAY_BLOCK, 0)[keep]


def _chunks(n, width):
    step = max(1, TWIN_PAIRS // width)
    return ((i, min(n, i + step)) for i in range(0, n, step))


def sweep_closest_torch(tables, cmask, gmask, origin, direction, t_min=0.0,
                        watertight=False):
    """Twin of `closest_kernel`: (t, +inf on miss; u; v; tri i32; inst
    i32; back bool). Per group, the rays of the blocks that entered it
    test its rows with their best as t_max; the first row at the group's
    minimum replaces the best when strictly nearer, as the kernel's
    row-by-row scan does."""
    r, dev = origin.shape[0], origin.device
    t_b = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    u_b, v_b = torch.zeros_like(t_b), torch.zeros_like(t_b)
    row_b = torch.full((r,), -1, dtype=torch.int64, device=dev)
    back_b = torch.zeros(r, dtype=torch.bool, device=dev)
    for g in range(tables.n_groups):
        rays_g, cols_g = _group_rays(cmask, gmask, g, r)
        tab = tables.ctab[g * GROUP_ROWS:(g + 1) * GROUP_ROWS]
        for lo, hi in _chunks(rays_g.shape[0], GROUP_ROWS):
            rays, cols = rays_g[lo:hi], cols_g[lo:hi]
            best = t_b[rays]
            t, u, v, back, ok = _slab_test(tab, origin[rays], direction[rays],
                                           t_min, best[:, None], watertight)
            tm = torch.where(ok & cols, t, BIG)
            j = torch.argmin(tm, dim=1, keepdim=True)   # first minimum
            slab_min = tm.gather(1, j)[:, 0]
            win = torch.nonzero(slab_min < best)[:, 0]
            w, jw = rays[win], j[win, 0]
            t_b[w] = slab_min[win]
            u_b[w] = u[win, jw]
            v_b[w] = v[win, jw]
            back_b[w] = back[win, jw]
            row_b[w] = g * GROUP_ROWS + jw
    hit = t_b < BIG
    meta = tables.ctab[row_b.clamp_min(0), 9:12]
    return (torch.where(hit, t_b, float("inf")), u_b, v_b,
            torch.where(hit, meta[:, 0], 0.0).to(torch.int32),
            torch.where(hit, meta[:, 1], 0.0).to(torch.int32),
            hit & (back_b ^ (meta[:, 2] > 0.5)))


def _t_max_rays(t_max, origin):
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    return t_max.expand(origin.shape[:1]).contiguous()


def sweep_any_torch(tables, cmask, gmask, origin, direction, t_max,
                    t_min=0.0, watertight=False):
    """Twin of `any_kernel`: (R,) bool, a hit in [t_min, t_max) in a
    cluster the ray's block entered."""
    r = origin.shape[0]
    t_max = _t_max_rays(t_max, origin)
    occ = torch.zeros(r, dtype=torch.bool, device=origin.device)
    for g in range(tables.n_groups):
        rays_g, cols_g = _group_rays(cmask, gmask, g, r)
        live = torch.nonzero(~occ[rays_g])[:, 0]
        rays_g, cols_g = rays_g[live], cols_g[live]
        tab = tables.ctab[g * GROUP_ROWS:(g + 1) * GROUP_ROWS]
        for lo, hi in _chunks(rays_g.shape[0], GROUP_ROWS):
            rays = rays_g[lo:hi]
            ok = _slab_test(tab, origin[rays], direction[rays], t_min,
                            t_max[rays, None], watertight)[4]
            occ[rays[(ok & cols_g[lo:hi]).any(1)]] = True
    return occ


# ---------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, twin on CPU tensors
# ---------------------------------------------------------------------------

def _check_rays(origin, direction):
    for name, x in (("origin", origin), ("direction", direction)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous (R, 3) float32 "
                             f"tensor, got {tuple(x.shape)} {x.dtype}")
    if direction.shape[0] != origin.shape[0]:
        raise ValueError("origin and direction ray counts differ")


def _on_cuda(*xs):
    dev = xs[0].device
    for x in xs:
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no clustered sweep for device {dev}")
    return dev.type == "cuda"


def _check_masks(tables, cmask, gmask, r):
    nb = _n_blocks(r)
    for name, x, cols in (("cmask", cmask, tables.cbox.shape[0]),
                          ("gmask", gmask, tables.n_groups)):
        if x.dtype != torch.uint8 or tuple(x.shape) != (nb, cols) \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous ({nb}, {cols}) "
                             f"uint8 tensor, got {tuple(x.shape)} {x.dtype}")
    if cmask.data_ptr() % 16:
        raise ValueError("cmask: the kernels read 16-byte aligned rows")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def cull_masks(tables, origin, direction):
    """(cmask (n_blocks, Cg), gmask (n_blocks, n_groups)) uint8: kernel on
    CUDA tensors, twin on CPU tensors."""
    _check_rays(origin, direction)
    if not _on_cuda(origin, direction, tables.cbox):
        return cull_masks_torch(tables, origin, direction)
    nb = _n_blocks(origin.shape[0])
    cmask = torch.empty((nb, tables.cbox.shape[0]), dtype=torch.uint8,
                        device=origin.device)
    gmask = torch.empty((nb, tables.n_groups), dtype=torch.uint8,
                        device=origin.device)
    if nb == 0:
        return cmask, gmask
    with torch.cuda.device(origin.device):
        err = kernels().lib.dcrt_cluster_cull(
            tables.cbox.data_ptr(), tables.cbox.shape[0], origin.data_ptr(),
            direction.data_ptr(), origin.shape[0], *tables.reach,
            cmask.data_ptr(), gmask.data_ptr(), _stream(origin))
    _raise_on(err, "cull_masks")
    cull_masks.launches += 1
    return cmask, gmask


def sweep_closest(tables, cmask, gmask, origin, direction, t_min=0.0,
                  watertight=False):
    """The closest sweep over the entered clusters: kernel on CUDA
    tensors, twin on CPU tensors."""
    _check_rays(origin, direction)
    r = origin.shape[0]
    _check_masks(tables, cmask, gmask, r)
    if not _on_cuda(origin, direction, cmask, gmask, tables.ctab):
        return sweep_closest_torch(tables, cmask, gmask, origin, direction,
                                   t_min, watertight)
    f32 = dict(dtype=torch.float32, device=origin.device)
    i32 = dict(dtype=torch.int32, device=origin.device)
    t, u, v = (torch.empty(r, **f32) for _ in range(3))
    tri, inst = torch.empty(r, **i32), torch.empty(r, **i32)
    back = torch.empty(r, dtype=torch.bool, device=origin.device)
    if r == 0:
        return t, u, v, tri, inst, back
    with torch.cuda.device(origin.device):
        err = kernels().lib.dcrt_cluster_closest(
            tables.ctab.data_ptr(), cmask.data_ptr(), gmask.data_ptr(),
            tables.cbox.shape[0], origin.data_ptr(), direction.data_ptr(), r,
            float(t_min), int(watertight), t.data_ptr(), u.data_ptr(),
            v.data_ptr(), tri.data_ptr(), inst.data_ptr(), back.data_ptr(),
            _stream(origin))
    _raise_on(err, "sweep_closest")
    sweep_closest.launches += 1
    return t, u, v, tri, inst, back


def sweep_any(tables, cmask, gmask, origin, direction, t_max, t_min=0.0,
              watertight=False):
    """The occlusion sweep over the entered clusters: kernel on CUDA
    tensors, twin on CPU tensors."""
    _check_rays(origin, direction)
    r = origin.shape[0]
    _check_masks(tables, cmask, gmask, r)
    if not _on_cuda(origin, direction, cmask, gmask, tables.ctab):
        return sweep_any_torch(tables, cmask, gmask, origin, direction,
                               t_max, t_min, watertight)
    t_max = _t_max_rays(t_max, origin)
    occ = torch.empty(r, dtype=torch.bool, device=origin.device)
    if r == 0:
        return occ
    with torch.cuda.device(origin.device):
        err = kernels().lib.dcrt_cluster_any(
            tables.ctab.data_ptr(), cmask.data_ptr(), gmask.data_ptr(),
            tables.cbox.shape[0], origin.data_ptr(), direction.data_ptr(),
            t_max.data_ptr(), r, float(t_min), int(watertight),
            occ.data_ptr(), _stream(origin))
    _raise_on(err, "sweep_any")
    sweep_any.launches += 1
    return occ


# ---------------------------------------------------------------------------
# the casts
# ---------------------------------------------------------------------------

def clustered_closest(scene, origin, direction, t_min=0.0, watertight=False):
    """Closest hit over the scene's cluster tables: (t, +inf on miss; u;
    v; tri i32; inst i32; back bool). Kernels on CUDA tensors."""
    tables = pad_cluster_tables(scene)
    cmask, gmask = cull_masks(tables, origin, direction)
    return sweep_closest(tables, cmask, gmask, origin, direction, t_min,
                         watertight)


def clustered_any(scene, origin, direction, t_max, t_min=0.0,
                  watertight=False):
    """Occlusion over the scene's cluster tables: (R,) bool, a hit in
    [t_min, t_max) per ray. Kernels on CUDA tensors."""
    tables = pad_cluster_tables(scene)
    cmask, gmask = cull_masks(tables, origin, direction)
    return sweep_any(tables, cmask, gmask, origin, direction, t_max, t_min,
                     watertight)


def clustered_closest_torch(scene, origin, direction, t_min=0.0,
                            watertight=False):
    """`clustered_closest` with the twins, on any device."""
    tables = pad_cluster_tables(scene)
    cmask, gmask = cull_masks_torch(tables, origin, direction)
    return sweep_closest_torch(tables, cmask, gmask, origin, direction,
                               t_min, watertight)


def clustered_any_torch(scene, origin, direction, t_max, t_min=0.0,
                        watertight=False):
    """`clustered_any` with the twins, on any device."""
    tables = pad_cluster_tables(scene)
    cmask, gmask = cull_masks_torch(tables, origin, direction)
    return sweep_any_torch(tables, cmask, gmask, origin, direction, t_max,
                           t_min, watertight)


def counters():
    """CUDA launches of the three kernels."""
    return dict(cluster_cull=cull_masks.launches,
                cluster_closest=sweep_closest.launches,
                cluster_any=sweep_any.launches)


def reset_counters():
    cull_masks.launches = sweep_closest.launches = sweep_any.launches = 0


reset_counters()
