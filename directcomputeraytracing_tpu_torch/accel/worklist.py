"""Work-list traversal of clustered scenes: the CUDA kernels, their twins
and the glue between them.

Counterpart of `directcomputeraytracing_tpu.accel.worklist` for world-soup
cluster tables (scenes of 2049 to 2^20 world triangles) and the instanced
tables of larger scenes (`scene_tables`). A cast runs:

1. `prep_rays` (kernel `prep_kernel` of `csrc/prep.cu`, twin
   `prep_rays_torch`): (R, 3) rays -> (9, Rp) rows [o; d; 1/d] and a
   per-ray t_max row, padded to a multiple of `RB` with far rays that
   enter nothing; non-finite or zero-length rays are parked the same way.
   One launch replaces the twin's ~20 small device operations.
2. The cull. `cull_boxes` (kernel `cull_kernel`, twin `cull_boxes_torch`):
   for every block of RB rays and every box, the minimum entry distance
   over the block's rays that enter the box within their t_max (BIG: none
   does). Scenes above `HIER_MIN` supers cull hyper boxes first, then
   `refine` (kernel `refine_kernel`, twin `refine_torch`) culls each
   entered hyper's member supers for its block.
3. `phases`: the entered (block, super) pairs as an item list sorted by
   (block, entry distance, super) with per-block segment offsets. Lists
   are sized from the true count, read back by the host once per level
   (`torch.nonzero`): one synchronisation per cast, two with the hyper
   level. There is no capacity and so no overflow fallback.
4. The sweep. `sweep_closest` / `sweep_any` (kernels `closest_kernel` /
   `any_kernel`, twins `sweep_closest_torch` / `sweep_any_torch`). Each
   ray walks its block's items in order. Per item it tests the super's
   32 child boxes (its fine cull) and sweeps the 16-triangle clusters it
   entered, nearest first, each with the Baldwin-Weber test (or the
   watertight one), and stops at the first cluster that starts beyond
   its current best hit.

The closest hit is a bit-packed argmin: key = (bits(t) & ~_LOWM) |
(child << 4) | row, the best starts at bits(scene exit) | _LOWM, and a
cluster's smallest candidate key replaces the best only if strictly
smaller. The candidate window is the best's whole truncation quantum
(`_window`): t < the float after (best | _LOWM). The reference takes
t < the best read as a float, which makes a near-tie (two hits with the
same truncated t) depend on the order clusters are visited in; with the
whole quantum the result is the least key over the hits swept, so the
per-ray and grouped walks give the same hit bit for bit. The fine cull,
the nearest-first stop and the block vote use the same window. t, u and
v are the winner's own; the decode compares the truncated t against the
truncated scene exit. `iters` is the number of clusters the ray swept:
the clusters its own fine cull admitted, summed over its block's items.
(The reference counts clusters swept per block.)

5. The grouped sweep. `sweep_closest_grouped` / `sweep_any_grouped`
   (kernels `closest_grouped_kernel` / `any_grouped_kernel`) take the
   same inputs and return the same outputs, but walk each item per group
   of GL = 32 rays (one warp; the reference's groups are 128 lanes): the
   group pops its two nearest clusters per step and every ray of the
   group tests them, masked by its own fine cull. `iters` is then the
   number of clusters the ray's group swept in the items the ray entered
   something in. The closest twin `sweep_closest_grouped_torch` replays
   the group walk so that `iters` matches. The any-hit twin is
   `sweep_any_torch`: the grouped walk tests, for every ray not yet
   occluded, every cluster its own fine cull entered (a group stops only
   when all its rays are occluded), so its answer is the per-ray walk's.

6. The instanced sweeps. `sweep_closest_inst` / `sweep_any_inst`
   (kernels `closest_inst_kernel` / `any_inst_kernel`, twins
   `sweep_closest_inst_torch` / `sweep_any_inst_torch`, the per-ray
   walks of 4. above) sweep instanced tables: the mesh-local clusters
   are stored once per mesh, a super is an (instance, local super) pair
   with world-space child boxes. The cull, the items and the fine cull
   run in world space, as on the soup; each swept cluster is tested
   with the ray moved to the item's instance space (`local_rays`, the
   direction not normalised, so t and the packed keys stay the world
   ray's). The hit's instance is the item's. Its back-face flag is the
   mesh-local test's: a mirroring instance turns the world normal and
   its soup rows carry a flip that turns it back, so the local flag is
   the soup's and the reference stack walker's. (The reference's
   instanced kernel XORs the flip in as well, `worklist.py:1323`, and so
   inverts the flag on mirrored instances against its own soup and
   stack walker.) Casts on instanced tables take these sweeps whatever
   `grouped` says, as the reference's do.

`worklist_closest` also takes a window cap, t_cap (scalar or per ray):
the scene exit and the cull's t_max shrink to t_cap * 1.001 + 1e-3.

Wrappers launch the kernels of `csrc/worklist.cu` (`prep_rays` that of
`csrc/prep.cu`) on CUDA tensors and run
the twins on CPU tensors; any other device raises. `worklist_closest`
and `worklist_any` are the casts the intersector calls;
`worklist_closest_torch` and `worklist_any_torch` are the same casts with
every step in plain PyTorch, on any device. All four take grouped=True
for the grouped sweep.

Counters: `prep_rays.launches`, `cull_boxes.launches`, `refine.launches`,
`sweep_closest.launches`, `sweep_any.launches`,
`sweep_closest_grouped.launches`, `sweep_any_grouped.launches`,
`sweep_closest_inst.launches` and `sweep_any_inst.launches` count CUDA
launches;
`refine.skipped` counts casts whose hyper cull admitted nothing and
`worklist_closest.empty` / `worklist_any.empty` casts whose item list
came out empty (no sweep ran), on any device.
"""

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .cluster import CLUSTER_SIZE
from .traverse import ray_triangle_watertight

RB = 1024                    # rays per block: one CUDA block, one 32x32 tile
GL = 32                      # rays per group of the grouped sweep: one warp
SUPER = 32                   # clusters per super
HIER_MIN = 192               # supers above which the cull goes hyper -> super
_LOWM = (SUPER << 4) - 1     # packed best-hit low bits: (child << 4) | row
_KEYM = 63                   # group pick-key low bits: the child id
BIG = 3.0e38
_FAR = 2.0 * BIG ** 0.5      # parked-ray origin: enters no box
_FLT_MIN = 2.0 ** -126       # smallest normal float32
_INVERTED_BOX = (1.0, 1.0, 1.0, -1.0, -1.0, -1.0, 0.0, 0.0)
_I32_MAX = 0x7FFFFFFF
TWIN_RAY_CHUNK = 1 << 20     # rays per chunk of the sweep twins
TWIN_BOX_CHUNK = 1 << 24     # (block, box, ray) elements per cull-twin chunk
_BW_META, _RAW_META = 12, 9  # tri|inst|flip columns of the two slab tables

_NVCC_EXTRA = ("-fmad=false",)   # round like the twins (see brute.py)
_built = None
_prep_built = None
_TABLES = WeakIdKeyDictionary()


def kernels():
    """The loaded kernel library (built on first call); `.seconds` and
    `.log` describe the build."""
    global _built
    if _built is None:
        from ..utils.cuda_build import load_library

        built = load_library("worklist.cu", _NVCC_EXTRA)
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = built.lib
        lib.dcrt_wl_cull.argtypes = [c_p, c_i, c_p, c_p, c_i, c_i, c_p, c_p]
        lib.dcrt_wl_refine.argtypes = [c_p, c_i, c_p, c_p, c_i, c_p, c_p,
                                       c_i, c_i, c_p, c_p]
        closest = [c_p, c_p, c_p, c_i, c_p, c_p, c_i, c_p, c_p, c_i, c_i, c_f,
                   c_p, c_p, c_p, c_p, c_p, c_p, c_p, c_p, c_p]
        any_ = [c_p, c_p, c_i, c_p, c_p, c_i, c_p, c_p, c_i, c_i, c_f, c_p,
                c_p]
        lib.dcrt_wl_closest.argtypes = closest
        lib.dcrt_wl_any.argtypes = any_
        lib.dcrt_wl_closest_grouped.argtypes = closest
        lib.dcrt_wl_any_grouped.argtypes = any_
        # the instanced sweeps add three table pointers after the slab's
        lib.dcrt_wl_closest_inst.argtypes = closest[:6] + [c_p] * 3 \
            + closest[6:]
        lib.dcrt_wl_any_inst.argtypes = any_[:5] + [c_p] * 3 + any_[5:]
        for fn in (lib.dcrt_wl_cull, lib.dcrt_wl_refine, lib.dcrt_wl_closest,
                   lib.dcrt_wl_any, lib.dcrt_wl_closest_grouped,
                   lib.dcrt_wl_any_grouped, lib.dcrt_wl_closest_inst,
                   lib.dcrt_wl_any_inst):
            fn.restype = c_i
        _built = built
    return _built


# ---------------------------------------------------------------------------
# per-scene tables (built once per scene, cached on its table tensor)
# ---------------------------------------------------------------------------

class Tables(NamedTuple):
    ctab: torch.Tensor       # (Cs*SUPER*16, 13) raw-vertex slabs (watertight)
    bwtab: torch.Tensor      # (Cs*SUPER*16, 16) Baldwin-Weber slabs
    cbox3: torch.Tensor      # (Cs, SUPER, 8) child boxes (inverted padding)
    sbox: torch.Tensor       # (Cs, 8) super boxes
    hsup: Optional[torch.Tensor]   # (NH, HS, 8) member-super boxes per hyper
    hbox: Optional[torch.Tensor]   # (NH, 8) hyper boxes
    bounds: torch.Tensor     # (2, 3) scene box (for the scene exit)
    config: tuple            # (SUPER, HIER_MIN) the tables were built for
    # instanced tables only (None on the world soup's): the slabs are
    # mesh-local, Cs counts (instance, super) pairs, and super s sweeps
    # local super isup_local[s] in the space of instance isup_inst[s]
    isup_local: Optional[torch.Tensor] = None   # (Cs,) i32
    isup_inst: Optional[torch.Tensor] = None    # (Cs,) i32
    inst_rows: Optional[torch.Tensor] = None    # (I, 16) f32 world->local


def _inverted(n, like):
    return torch.tensor(_INVERTED_BOX, dtype=like.dtype,
                        device=like.device).expand(n, 8)


def hyper_fanout(cs):
    """Supers per hyper: 4 to 16, about cs / 64."""
    return int(min(16, max(4, cs // 64)))


def pad_tables(scene):
    """Cluster tables padded to a SUPER multiple: (ctab, bwtab, cbox3,
    sbox). Padding clusters have zero rows and inverted boxes, so empty
    supers stay inverted and are never entered."""
    ctab, bwtab, cbox = scene.cluster_tris, scene.cluster_bw, \
        scene.cluster_bbox
    c = cbox.shape[0]
    cpad = -(-c // SUPER) * SUPER
    if cpad != c:
        rows = (cpad - c) * CLUSTER_SIZE
        ctab = torch.nn.functional.pad(ctab, (0, 0, 0, rows))
        bwtab = torch.nn.functional.pad(bwtab, (0, 0, 0, rows))
        cbox = torch.cat([cbox, _inverted(cpad - c, cbox)])
    cbox3 = cbox.reshape(cpad // SUPER, SUPER, 8)
    sbox = torch.cat([cbox3[:, :, 0:3].amin(1), cbox3[:, :, 3:6].amax(1),
                      torch.zeros_like(cbox3[:, 0, 0:2])], dim=1)
    return ctab.contiguous(), bwtab.contiguous(), cbox3.contiguous(), sbox


def build_hyper(sbox):
    """Group the (cs, 8) super boxes into the hyper level: (hsup, hbox),
    or (None, None) at or below HIER_MIN supers."""
    cs = sbox.shape[0]
    if cs <= HIER_MIN:
        return None, None
    hs = hyper_fanout(cs)
    nh = -(-cs // hs)
    sbox_h = torch.cat([sbox, _inverted(nh * hs - cs, sbox)])
    hsup = sbox_h.reshape(nh, hs, 8)
    # inverted padding members only loosen the min/max
    all_pad = (hsup[:, :, 0] == 1.0).all(1)[:, None]
    hbox = torch.cat([torch.where(all_pad, 1.0, hsup[:, :, 0:3].amin(1)),
                      torch.where(all_pad, -1.0, hsup[:, :, 3:6].amax(1)),
                      torch.zeros_like(hsup[:, 0, 0:2])], dim=1)
    return hsup.contiguous(), hbox


def instanced(scene):
    """True when the scene carries the instanced work-list tables."""
    return scene.isup_inst.shape[0] > 1


def _box_bounds(boxes):
    """(2, 3) min and max over (n, 8) boxes, inverted padding included."""
    return torch.stack([boxes[:, 0:3].amin(0), boxes[:, 3:6].amax(0)])


def scene_tables(scene):
    """The work-list tables of `scene`, built on first use and kept for as
    long as the scene's table tensor lives (isup_sbox for the instanced
    tables, which win where a scene has both, else cluster_bbox)."""
    config = (SUPER, HIER_MIN)
    key = scene.isup_sbox if instanced(scene) else scene.cluster_bbox
    tab = _TABLES.get(key)
    if tab is None or tab.config != config:
        if instanced(scene):
            sbox = scene.isup_sbox.contiguous()
            tab = Tables(scene.icl_slab.contiguous(),
                         scene.icl_bw.contiguous(),
                         scene.isup_cbox.contiguous(), sbox,
                         *build_hyper(sbox), _box_bounds(sbox), config,
                         scene.isup_local.to(torch.int32).contiguous(),
                         scene.isup_inst.to(torch.int32).contiguous(),
                         scene.inst_rows.contiguous())
        else:
            ctab, bwtab, cbox3, sbox = pad_tables(scene)
            tab = Tables(ctab, bwtab, cbox3, sbox, *build_hyper(sbox),
                         _box_bounds(scene.cluster_bbox), config)
        _TABLES[key] = tab
    return tab


# ---------------------------------------------------------------------------
# ray preparation and the scene exit
# ---------------------------------------------------------------------------

def prep_kernels():
    """The loaded ray-prep library (`csrc/prep.cu`, built on first call)."""
    global _prep_built
    if _prep_built is None:
        from ..utils.cuda_build import load_library

        built = load_library("prep.cu", _NVCC_EXTRA)
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        built.lib.dcrt_prep_rays.argtypes = [c_p, c_p, c_i, c_p, c_i, c_f,
                                             c_f, c_i, c_p, c_p, c_p]
        built.lib.dcrt_prep_rays.restype = c_i
        _prep_built = built
    return _prep_built


def prep_rays(origin, direction, t_max=None):
    """(R, 3) rays [+ t_max, scalar or (R,)] -> (od (9, Rp) [o; d; 1/d],
    tm (Rp,) per-ray t_max, R), Rp a multiple of RB (see
    `prep_rays_torch`): the kernel `prep_kernel` (kernel row 6) on CUDA
    tensors, one launch a call with rays, the twin on CPU tensors."""
    _check_rays(origin, direction)
    if not _on_cuda(origin, direction):
        return prep_rays_torch(origin, direction, t_max)
    r = origin.shape[0]
    rp = -(-r // RB) * RB
    od = torch.empty((9, rp), dtype=torch.float32, device=origin.device)
    tm = torch.empty(rp, dtype=torch.float32, device=origin.device)
    if rp == 0:
        return od, tm, r
    ptr, stride, value = None, 0, BIG
    if isinstance(t_max, torch.Tensor):
        t_max = t_max.to(device=origin.device,
                         dtype=torch.float32).contiguous()
        if t_max.numel() != 1 and tuple(t_max.shape) != (r,):
            raise ValueError(f"t_max: need a scalar or ({r},), got "
                             f"{tuple(t_max.shape)}")
        ptr, stride = t_max.data_ptr(), int(t_max.numel() != 1)
    elif t_max is not None:
        value = float(t_max)
    origin, direction = origin.contiguous(), direction.contiguous()
    with torch.cuda.device(origin.device):
        err = prep_kernels().lib.dcrt_prep_rays(
            origin.data_ptr(), direction.data_ptr(), r, ptr, stride, value,
            _FAR, rp, od.data_ptr(), tm.data_ptr(), _stream(origin))
    _raise_on(err, "prep_rays")
    prep_rays.launches += 1
    return od, tm, r


def prep_rays_torch(origin, direction, t_max=None):
    """Twin of `prep_kernel`: (R, 3) rays [+ t_max, scalar or (R,)] ->
    (od (9, Rp) [o; d; 1/d], tm (Rp,) per-ray t_max, R), Rp a multiple of
    RB. Rays with a non-finite component or a zero-length direction are
    parked at _FAR along +x, where they enter no box; padding rays too,
    with t_max 0. Without t_max (closest casts) real rays get BIG.
    Reciprocals of |d| < 1e-30 are taken of +-1e-30, + for d >= 0. A
    denormal counts as zero, as in the reference's flush-to-zero float
    arithmetic: a direction whose squared components are all below
    _FLT_MIN is zero-length, and a negative denormal component gets
    +1e-30."""
    r = origin.shape[0]
    rp = -(-r // RB) * RB
    bad = ~(torch.isfinite(origin).all(1) & torch.isfinite(direction).all(1)
            & (direction * direction >= _FLT_MIN).any(1))
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=origin.dtype,
                          device=origin.device)
    o = torch.full((rp, 3), _FAR, dtype=origin.dtype, device=origin.device)
    d = x_axis.repeat(rp, 1)
    o[:r] = torch.where(bad[:, None], _FAR, origin)
    d[:r] = torch.where(bad[:, None], x_axis, direction)
    inv = 1.0 / torch.where(d.abs() < 1e-30,
                            torch.where(d > -_FLT_MIN, 1e-30, -1e-30), d)
    od = torch.cat([o, d, inv], dim=1).T.contiguous()
    tm = torch.zeros(rp, dtype=origin.dtype, device=origin.device)
    tm[:r] = BIG if t_max is None else torch.as_tensor(
        t_max, dtype=origin.dtype, device=origin.device).expand(r)
    return od, tm, r


def _slab(b0, b1, o, inv, t_lo, t_hi):
    a = (b0 - o) * inv
    b = (b1 - o) * inv
    return torch.maximum(t_lo, torch.minimum(a, b)), \
        torch.minimum(t_hi, torch.maximum(a, b))


def scene_exit(tables, od):
    """(Rp,) distance at which each ray leaves the scene box, padded past
    the packed-argmin truncation quantum (0 + pad for a ray that misses
    the box). Best hits start here, so miss rays stop early."""
    t_lo = torch.full_like(od[0], -BIG)
    t_hi = torch.full_like(od[0], BIG)
    for ax in range(3):
        t_lo, t_hi = _slab(tables.bounds[0, ax], tables.bounds[1, ax],
                           od[ax], od[6 + ax], t_lo, t_hi)
    tex = torch.where((t_hi >= t_lo) & (t_hi >= 0.0), t_hi, 0.0)
    return tex * 1.001 + 1e-3


# ---------------------------------------------------------------------------
# the cull: kernels rows 7 (cull_boxes) and 8 (refine), twins
# ---------------------------------------------------------------------------

def _entry_min(boxes, od_b, tm_b):
    """boxes (B or 1, n, 8), rays od_b (9, B, RB), tm_b (B, RB) -> (B, n)
    minimum over each block's rays of the clamped entry distance, BIG
    where no ray enters within its t_max."""
    t_lo = t_hi = None
    for ax in range(3):
        o = od_b[ax][:, None, :]
        inv = od_b[6 + ax][:, None, :]
        b0, b1 = boxes[:, :, ax, None], boxes[:, :, 3 + ax, None]
        if t_lo is None:
            t_lo = torch.full(torch.broadcast_shapes(b0.shape, o.shape),
                              -BIG, dtype=od_b.dtype, device=od_b.device)
            t_hi = torch.full_like(t_lo, BIG)
        t_lo, t_hi = _slab(b0, b1, o, inv, t_lo, t_hi)
    enter = (t_hi >= t_lo) & (t_hi >= 0.0) & (t_lo <= tm_b[:, None, :])
    return torch.where(enter, torch.clamp_min(t_lo, 0.0), BIG).amin(2)


def _blocks(od, tm):
    nb = od.shape[1] // RB
    return od.reshape(9, nb, RB), tm.reshape(nb, RB)


def cull_boxes_torch(boxes, od, tm):
    """Twin of `cull_kernel`: (n, 8) boxes against every RB-ray block ->
    (nb, n) minimum entry distance (BIG: no ray of the block enters)."""
    od_b, tm_b = _blocks(od, tm)
    n = boxes.shape[0]
    step = max(1, TWIN_BOX_CHUNK // max(n * RB, 1))
    return torch.cat([_entry_min(boxes[None], od_b[:, i:i + step],
                                 tm_b[i:i + step])
                      for i in range(0, od_b.shape[1], step)])


def refine_torch(hsup, blk, hyp, od, tm):
    """Twin of `refine_kernel`: per (block, hyper) item the (hs,) minimum
    entry distance of the hyper's member supers -> (n_items, hs)."""
    od_b, tm_b = _blocks(od, tm)
    step = max(1, TWIN_BOX_CHUNK // (hsup.shape[1] * RB))
    return torch.cat([
        _entry_min(hsup[hyp[i:i + step]], od_b[:, blk[i:i + step]],
                   tm_b[blk[i:i + step]])
        for i in range(0, blk.shape[0], step)])


def _check_f32(name, x, shape=None):
    if x.dtype != torch.float32 or not x.is_contiguous() or (
            shape is not None and tuple(x.shape) != tuple(shape)):
        raise ValueError(f"{name}: need a contiguous float32 tensor"
                         f"{'' if shape is None else f' of shape {shape}'},"
                         f" got {tuple(x.shape)} {x.dtype}")


def _on_cuda(*xs):
    dev = xs[0].device
    for x in xs:
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no work-list traversal for device {dev}")
    if dev.type == "cuda" and (RB > 1024 or RB % 32):
        raise ValueError(f"RB={RB}: a CUDA block holds whole warps, at most "
                         "1024 rays")
    return dev.type == "cuda"


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def cull_boxes(boxes, od, tm):
    """(n, 8) boxes x (9, Rp) rays -> (nb, n): kernel on CUDA tensors,
    twin on CPU tensors."""
    rp = od.shape[1]
    _check_f32("boxes", boxes, (boxes.shape[0], 8))
    _check_f32("od", od, (9, rp))
    _check_f32("tm", tm, (rp,))
    if not _on_cuda(boxes, od, tm):
        return cull_boxes_torch(boxes, od, tm)
    out = torch.empty((rp // RB, boxes.shape[0]), dtype=torch.float32,
                      device=od.device)
    with torch.cuda.device(od.device):
        err = kernels().lib.dcrt_wl_cull(
            boxes.data_ptr(), boxes.shape[0], od.data_ptr(), tm.data_ptr(),
            rp, RB, out.data_ptr(), _stream(od))
    _raise_on(err, "cull_boxes")
    cull_boxes.launches += 1
    return out


def refine(hsup, blk, hyp, od, tm):
    """(block, hyper) items -> (n_items, hs) member-super entries: kernel
    on CUDA tensors, twin on CPU tensors."""
    rp = od.shape[1]
    _check_f32("hsup", hsup)
    _check_f32("od", od, (9, rp))
    _check_f32("tm", tm, (rp,))
    if not _on_cuda(hsup, blk, hyp, od, tm):
        return refine_torch(hsup, blk, hyp, od, tm)
    hs = hsup.shape[1]
    if hs > 32:
        raise ValueError(f"refine: {hs} members per hyper, at most 32")
    blk32, hyp32 = blk.to(torch.int32), hyp.to(torch.int32)
    out = torch.empty((blk.shape[0], hs), dtype=torch.float32,
                      device=od.device)
    with torch.cuda.device(od.device):
        err = kernels().lib.dcrt_wl_refine(
            hsup.data_ptr(), hs, blk32.data_ptr(), hyp32.data_ptr(),
            blk.shape[0], od.data_ptr(), tm.data_ptr(), rp, RB,
            out.data_ptr(), _stream(od))
    _raise_on(err, "refine")
    refine.launches += 1
    return out


# ---------------------------------------------------------------------------
# items: compaction, ordering, per-block segments
# ---------------------------------------------------------------------------

class Items(NamedTuple):
    seg: torch.Tensor        # (nb + 1,) i32 item offsets per block
    sup: torch.Tensor        # (n,) i32 super ids, per block front to back
    t_ent: torch.Tensor      # (n,) f32 item entry distance
    block_any: torch.Tensor  # (nb,) bool: the block has an item


def compact_pairs(tlo):
    """(nb, n) cull grid -> entered (block, box, t_ent) in row-major
    order. Reads the count back to the host."""
    blk, idx = torch.nonzero(tlo < BIG, as_tuple=True)
    return blk, idx, tlo[blk, idx]


def expand_level(tlo_child, blk, hyp, hs, cs):
    """Refined (n_items, hs) member entries -> (block, super, t_ent) of
    the entered supers (super id = hyper * hs + member, < cs)."""
    ids = hyp[:, None] * hs + torch.arange(hs, device=hyp.device)
    it, m = torch.nonzero((tlo_child < BIG) & (ids < cs), as_tuple=True)
    return blk[it], ids[it, m], tlo_child[it, m]


def finish_items(blk, sup, t_ent, nb, cs):
    """Sort the items by (block, t_ent, super) and build the per-block
    segment offsets. t_ent >= 0, so its bits order like its values (the
    sign bit is masked for -0.0); the super breaks ties."""
    sb = max(1, (cs - 1).bit_length())
    if nb >= 1 << (32 - sb):
        raise ValueError(f"{nb} ray blocks overflow the item sort key")
    tb = t_ent.contiguous().view(torch.int32).to(torch.int64) & _I32_MAX
    key = (blk.to(torch.int64) << (31 + sb)) | (tb << sb) | sup
    order = torch.argsort(key)
    counts = torch.zeros(nb, dtype=torch.int64, device=blk.device) \
        .index_add_(0, blk, torch.ones_like(blk))  # bincount would sync
    seg = torch.zeros(nb + 1, dtype=torch.int32, device=blk.device)
    seg[1:] = torch.cumsum(counts, 0)
    return Items(seg, sup[order].to(torch.int32).contiguous(),
                 t_ent[order].contiguous(), counts > 0)


def phases(tables, od, tm, plain=False):
    """The cull: per-block front-to-back super items (Items), or None when
    no block enters anything. plain=True runs the twins on any device."""
    nb = od.shape[1] // RB
    cull = cull_boxes_torch if plain else cull_boxes
    cs = tables.sbox.shape[0]
    if tables.hbox is None:
        blk, sup, t = compact_pairs(cull(tables.sbox, od, tm))
    else:
        blk_h, hyp, _ = compact_pairs(cull(tables.hbox, od, tm))
        if blk_h.numel() == 0:
            if not plain:
                refine.skipped += 1
            return None
        tlo_s = (refine_torch if plain else refine)(tables.hsup, blk_h, hyp,
                                                    od, tm)
        blk, sup, t = expand_level(tlo_s, blk_h, hyp, tables.hsup.shape[1],
                                   cs)
    if blk.numel() == 0:
        return None
    return finish_items(blk, sup, t, nb, cs)


# ---------------------------------------------------------------------------
# the sweep: kernels rows 9 (closest) and 10 (any), twins
# ---------------------------------------------------------------------------

def bw_rows(tab, o, d, t_min, t_max):
    """Baldwin-Weber test of rays o, d (A, 1, 3) against rows tab
    (A, S, 16); t_max (A, 1). Returns (t, u, v, back, ok), each (A, S).
    den = n.d is the Moeller determinant negated."""
    def c(i):
        return tab[..., i]

    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    den = c(0) * dx + c(1) * dy + c(2) * dz
    den_ok = den.abs() >= 1e-10
    inv_den = 1.0 / torch.where(den_ok, den, 1.0)
    t = (c(3) - (c(0) * ox + c(1) * oy + c(2) * oz)) * inv_den
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    u = c(4) * hx + c(5) * hy + c(6) * hz + c(7)
    v = c(8) * hx + c(9) * hy + c(10) * hz + c(11)
    ok = (den_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t < t_max))
    return t, u, v, den < 1e-10, ok


def _tri_rows(tab, o, d, t_min, t_max, watertight):
    if watertight:
        return ray_triangle_watertight(o, d, t_min, t_max, tab[..., 0:3],
                                       tab[..., 3:6], tab[..., 6:9])
    return bw_rows(tab, o, d, t_min, t_max)


def _fine_cull(cbox, od_r, cap, t_min):
    """Per-ray slab test of the item's SUPER child boxes cbox (A, SUPER, 8)
    for rays od_r (9, A): enter where the ray crosses the box in front of
    t_min and enters it before cap (A,). Returns (enter, clamped entry)."""
    t_lo = torch.full(cbox.shape[:2], -BIG, dtype=cbox.dtype,
                      device=cbox.device)
    t_hi = torch.full_like(t_lo, BIG)
    for ax in range(3):
        t_lo, t_hi = _slab(cbox[:, :, ax], cbox[:, :, 3 + ax],
                           od_r[ax][:, None], od_r[6 + ax][:, None],
                           t_lo, t_hi)
    enter = ((t_hi >= t_lo) & (t_hi >= 0.0) & (t_lo < cap[:, None])
             & (t_hi >= t_min))
    return enter, torch.clamp_min(t_lo, 0.0)


def _ray_steps(items, lo, hi):
    """For rays [lo, hi): per step k, the rays whose block has a k-th
    item and that item's index: yields (rays, item)."""
    blk_lo, blk_hi = lo // RB, hi // RB
    seg = items.seg.long()
    counts = (seg[1:] - seg[:-1])[blk_lo:blk_hi]
    n_steps = int(counts.max()) if counts.numel() else 0
    lane = torch.arange(RB, device=seg.device)
    for k in range(n_steps):
        blocks = torch.nonzero(counts > k)[:, 0] + blk_lo
        rays = (blocks[:, None] * RB + lane).reshape(-1)
        yield rays, seg[blocks].repeat_interleave(RB) + k


def _float_bits(x):
    return x.contiguous().view(torch.int32)


def _bits_float(x):
    return x.contiguous().view(torch.float32)


def _window(best):
    """The candidate window of packed bests: t < the float after
    (best | _LOWM), every t whose truncated bits do not exceed the
    best's (see the module docstring)."""
    return _bits_float((best | _LOWM) + 1)


def _voted(items, rays, item, best):
    """The closest kernels' block vote: keep the blocks of (rays, item)
    where some ray's best lies beyond the item's entry distance. Without
    a t_cap the vote never drops an item a ray would enter; with one, a
    ray may enter a child box between its capped t_max and its best, and
    the twins skip what the kernels skip."""
    keep = (_window(best[rays]).view(-1, RB)
            > items.t_ent[item.view(-1, RB)[:, 0:1]]).any(1)
    keep = keep.repeat_interleave(RB)
    return rays[keep], item[keep]


class _Best:
    """The per-ray state of a closest twin: packed best, the winner's t,
    u, v, back flag, table row and (instanced tables) instance, and
    `iters`."""

    def __init__(self, texp):
        rp, dev = texp.shape[0], texp.device
        self.best = _float_bits(texp) | _LOWM
        self.t, self.u, self.v = (texp.clone(), torch.zeros_like(texp),
                                  torch.zeros_like(texp))
        self.row = torch.full((rp,), -1, dtype=torch.int64, device=dev)
        self.inst = torch.zeros(rp, dtype=torch.int64, device=dev)
        self.back = torch.zeros(rp, dtype=torch.bool, device=dev)
        self.iters = torch.zeros(rp, dtype=torch.int32, device=dev)

    def sweep(self, tab, rays, child, rows, colmask, o, d, t_min, watertight,
              inst=None):
        """Test rays (n,), o and d (n, 3), against their table rows (n, k)
        (child (n, k) of each row; colmask (n, k) the rows the ray may
        take) with t_max = the ray's best; the smallest candidate key
        replaces the best if strictly smaller. inst (n,): the instance
        of each ray's item, on instanced tables."""
        lane = (rows % CLUSTER_SIZE)
        best_r = self.best[rays]
        t, u, v, back, ok = _tri_rows(tab[rows], o[:, None, :], d[:, None, :],
                                      t_min, _window(best_r)[:, None],
                                      watertight)
        key = (_float_bits(t) & ~_LOWM) | ((child << 4) + lane).to(torch.int32)
        cand, j = torch.where(ok & colmask, key, _I32_MAX).min(1)
        win = torch.nonzero(cand < best_r)[:, 0]
        w, jw = rays[win], j[win]
        self.best[w] = cand[win]
        self.t[w] = t[win, jw]
        self.u[w] = u[win, jw]
        self.v[w] = v[win, jw]
        self.back[w] = back[win, jw]
        self.row[w] = rows[win, jw]
        if inst is not None:
            self.inst[w] = inst[win]

    def state(self, tab, watertight, instanced=False):
        """(packed best i32, t, u, v, tri i32, inst i32, back, iters i32).
        The soup's slab rows hold tri, instance and flip. On instanced
        tables the instance is the winning item's and the back flag is
        the mesh-local test's as it is: see the module docstring."""
        mc = _RAW_META if watertight else _BW_META
        found = self.row >= 0
        meta = tab[self.row.clamp_min(0), mc:mc + 3]
        tri = torch.where(found, meta[:, 0], 0.0).to(torch.int32)
        if instanced:
            inst = torch.where(found, self.inst, 0).to(torch.int32)
            back = found & self.back
        else:
            inst = torch.where(found, meta[:, 1], 0.0).to(torch.int32)
            back = found & (self.back ^ (meta[:, 2] > 0.5))
        return self.best, self.t, self.u, self.v, tri, inst, back, self.iters


def local_rays(rows, o, d):
    """World rays o, d (n, 3) in the space of instances whose (n, 16)
    inst_rows hold the inverse transform M: [o, 1] @ M and d @ M, term
    by term in the kernels' order (the reference's `_local_rays`). The
    direction is not normalised, so t stays the world ray's parameter
    and packed keys compare across instances."""
    def xf(v, ax):
        return v[:, 0] * rows[:, ax] + v[:, 1] * rows[:, 3 + ax] \
            + v[:, 2] * rows[:, 6 + ax]

    return (torch.stack([xf(o, ax) + rows[:, 9 + ax] for ax in range(3)], 1),
            torch.stack([xf(d, ax) for ax in range(3)], 1))


def _item_rays(tables, sup, od, rays):
    """Per (ray, item) pair: the super whose slab rows it sweeps, its ray
    (o, d (n, 3)) and its item's instance. World-soup tables: the item's
    super, the world ray, no instance. Instanced tables: the mesh-local
    super and the ray in its instance's space."""
    o, d = od[0:3, rays].T, od[3:6, rays].T
    if tables.inst_rows is None:
        return sup, o, d, None
    ins = tables.isup_inst[sup].long()
    o, d = local_rays(tables.inst_rows[ins], o, d)
    return tables.isup_local[sup].long(), o, d, ins


def walk_closest_torch(st, tab, rays, slab, o, d, enter, tl, t_min,
                       watertight, ins=None):
    """The twins' nearest-first cluster walk over one item per ray: rays
    (n,) index the state st; slab (n,) the super whose rows they sweep,
    o, d (n, 3) their rays, enter and tl (n, SUPER) their fine cull. Each
    ray sweeps its nearest entered cluster (lowest child on a tie) until
    the nearest left starts beyond its window; ins (n,): the instance of
    each ray's item, on instanced tables."""
    dev = rays.device
    lane16 = torch.arange(CLUSTER_SIZE, device=dev)
    while rays.numel():
        m, child = torch.where(enter, tl, float("inf")).min(1)
        go = m < _window(st.best[rays])
        idx = torch.nonzero(go)[:, 0]
        rays, child, slab, o, d = (rays[idx], child[idx], slab[idx], o[idx],
                                   d[idx])
        enter, tl = enter[idx], tl[idx]
        ins = None if ins is None else ins[idx]
        if not rays.numel():
            break
        enter[torch.arange(rays.numel(), device=dev), child] = False
        st.iters[rays] += 1
        rows = ((slab * SUPER + child) * CLUSTER_SIZE)[:, None] + lane16
        st.sweep(tab, rays, child[:, None].expand_as(rows), rows,
                 torch.ones_like(rows, dtype=torch.bool), o, d, t_min,
                 watertight, ins)


def walk_any_torch(occ, tab, rays, slab, o, d, enter, tm, t_min, watertight):
    """The twins' occlusion walk over one item per ray: occ[rays[j]] turns
    True where ray j (o, d (n, 3)) hits in [t_min, tm[rays[j]]) within a
    cluster of super slab[j] that its fine cull (enter (n, SUPER))
    admitted. Which order the clusters are visited in cannot change the
    answer."""
    lane16 = torch.arange(CLUSTER_SIZE, device=rays.device)
    for p in torch.split(torch.nonzero(enter), TWIN_RAY_CHUNK // 4):
        j, child = p[:, 0], p[:, 1]
        rows = ((slab[j] * SUPER + child) * CLUSTER_SIZE)[:, None] + lane16
        ok = _tri_rows(tab[rows], o[j][:, None, :], d[j][:, None, :], t_min,
                       tm[rays[j]][:, None], watertight)[4]
        occ[rays[j][ok.any(1)]] = True


def sweep_closest_torch(tables, items, od, texp, t_min, watertight):
    """Twin of `closest_kernel` and, on instanced tables, of
    `closest_inst_kernel` (the fine cull in world space, each swept
    cluster tested with the ray in its item's instance space). Returns
    the per-ray sweep state (packed best i32, t, u, v, tri i32, inst i32,
    back bool, iters i32), each (Rp,): see the module docstring for the
    rules it follows."""
    rp = od.shape[1]
    tab = tables.ctab if watertight else tables.bwtab
    st = _Best(texp)
    for lo in range(0, rp, TWIN_RAY_CHUNK):
        for rays, item in _ray_steps(items, lo, min(rp, lo + TWIN_RAY_CHUNK)):
            rays, item = _voted(items, rays, item, st.best)
            sup = items.sup[item].long()
            enter, tl = _fine_cull(tables.cbox3[sup], od[:, rays],
                                   _window(st.best[rays]), t_min)
            slab, o, d, ins = _item_rays(tables, sup, od, rays)
            walk_closest_torch(st, tab, rays, slab, o, d, enter, tl, t_min,
                               watertight, ins)
    return st.state(tab, watertight, tables.inst_rows is not None)


def sweep_any_torch(tables, items, od, tm, t_min, watertight):
    """Twin of `any_kernel` and, on instanced tables, of `any_inst_kernel`:
    (Rp,) bool, a hit in [t_min, t_max) within a cluster the ray's fine
    cull admits (box entered before t_max)."""
    rp = od.shape[1]
    tab = tables.ctab if watertight else tables.bwtab
    occ = torch.zeros(rp, dtype=torch.bool, device=od.device)
    for lo in range(0, rp, TWIN_RAY_CHUNK):
        for rays, item in _ray_steps(items, lo, min(rp, lo + TWIN_RAY_CHUNK)):
            live = torch.nonzero(~occ[rays])[:, 0]
            rays, sup = rays[live], items.sup[item[live]].long()
            enter, _ = _fine_cull(tables.cbox3[sup], od[:, rays], tm[rays],
                                  t_min)
            slab, o, d, _ = _item_rays(tables, sup, od, rays)
            walk_any_torch(occ, tab, rays, slab, o, d, enter, tm, t_min,
                           watertight)
    return occ


# the instanced kernels' twins: the per-ray walks above, which move each
# item's rays to its instance's space on instanced tables
sweep_closest_inst_torch = sweep_closest_torch
sweep_any_inst_torch = sweep_any_torch


def sweep_closest_grouped_torch(tables, items, od, texp, t_min, watertight):
    """Twin of `closest_grouped_kernel`: the same per-ray sweep state as
    `sweep_closest_torch`, computed by the grouped walk. Each group of GL
    consecutive rays (one warp) takes, per item, one pick key per child:
    (bits(t_g) & ~_KEYM) | child, t_g the least clamped entry distance of
    the group's rays that entered the child in their own fine cull (sign
    bit masked, so -0.0 sorts as 0). Each step pops the group's two
    nearest keys and stops the group once the nearest starts beyond every
    ray's window ((key & ~_KEYM) > (largest best | _LOWM)). A ray tests a
    popped cluster only if its own fine cull entered it; both clusters of
    a step are tested against the ray's window before the step and the
    smallest candidate key wins, strictly. `iters` adds the clusters of
    each step to every ray of the group that entered something in the
    item."""
    rp = od.shape[1]
    dev = od.device
    tab = tables.ctab if watertight else tables.bwtab
    st = _Best(texp)
    big = int(_float_bits(torch.tensor([BIG], dtype=torch.float32))[0])
    child_id = torch.arange(SUPER, dtype=torch.int32, device=dev)
    lane16 = torch.arange(CLUSTER_SIZE, device=dev)
    lanes = torch.arange(GL, device=dev)
    for lo in range(0, rp, TWIN_RAY_CHUNK):
        for rays, item in _ray_steps(items, lo, min(rp, lo + TWIN_RAY_CHUNK)):
            rays, item = _voted(items, rays, item, st.best)
            if not rays.numel():
                continue
            sup = items.sup[item].long()
            enter, tl = _fine_cull(tables.cbox3[sup], od[:, rays],
                                   _window(st.best[rays]), t_min)
            nw = rays.numel() // GL
            enter = enter.view(nw, GL, SUPER)
            t_g = (_float_bits(torch.where(enter.view(-1, SUPER), tl, BIG))
                   & _I32_MAX).view(nw, GL, SUPER).amin(1)
            keys = torch.where(t_g < big, (t_g & ~_KEYM) | child_id, _I32_MAX)
            member = enter.any(2)
            rays_w, sup_w = rays.view(nw, GL), sup.view(nw, GL)[:, 0]
            w = torch.arange(nw, device=dev)
            while w.numel():
                kw = keys[w]
                step = torch.arange(w.numel(), device=dev)
                k1, c1 = kw.min(1)
                kw[step, c1] = _I32_MAX
                k2, c2 = kw.min(1)
                kw[step, c2] = _I32_MAX
                keys[w] = kw
                bound = st.best[rays_w[w]].amax(1) | _LOWM
                go = torch.nonzero((k1 < _I32_MAX)
                                   & ((k1 & ~_KEYM) <= bound))[:, 0]
                w, c1, c2, has2 = w[go], c1[go], c2[go], (k2 < _I32_MAX)[go]
                if not w.numel():
                    break
                st.iters[rays_w[w]] += torch.where(
                    member[w], 1 + has2[:, None].int(), 0).int()
                e1 = enter[w[:, None], lanes, c1[:, None]]
                e2 = enter[w[:, None], lanes, c2[:, None]] & has2[:, None]
                pick = torch.nonzero((e1 | e2).reshape(-1))[:, 0]
                g = pick // GL
                child = torch.cat([c1[g, None].expand(-1, CLUSTER_SIZE),
                                   c2[g, None].expand(-1, CLUSTER_SIZE)], 1)
                rows = ((sup_w[w[g], None] * SUPER + child) * CLUSTER_SIZE
                        + lane16.repeat(2))
                colmask = torch.cat([
                    e1.reshape(-1)[pick, None].expand(-1, CLUSTER_SIZE),
                    e2.reshape(-1)[pick, None].expand(-1, CLUSTER_SIZE)], 1)
                r = rays_w[w].reshape(-1)[pick]
                st.sweep(tab, r, child, rows, colmask, od[0:3, r].T,
                         od[3:6, r].T, t_min, watertight)
    return st.state(tab, watertight)


def _launch_closest(fn, tables, items, od, texp, t_min, watertight):
    rp = od.shape[1]
    f32 = dict(dtype=torch.float32, device=od.device)
    i32 = dict(dtype=torch.int32, device=od.device)
    best, tri, inst, iters = (torch.empty(rp, **i32) for _ in range(4))
    t, u, v = (torch.empty(rp, **f32) for _ in range(3))
    back = torch.empty(rp, dtype=torch.bool, device=od.device)
    with torch.cuda.device(od.device):
        err = fn(items.seg.data_ptr(), items.sup.data_ptr(),
                 items.t_ent.data_ptr(), rp // RB,
                 *_table_ptrs(tables, watertight, fn), int(watertight),
                 od.data_ptr(), texp.data_ptr(), rp, RB, float(t_min),
                 best.data_ptr(), t.data_ptr(), u.data_ptr(), v.data_ptr(),
                 tri.data_ptr(), inst.data_ptr(), back.data_ptr(),
                 iters.data_ptr(), _stream(od))
    return err, (best, t, u, v, tri, inst, back, iters)


def _launch_any(fn, tables, items, od, tm, t_min, watertight):
    rp = od.shape[1]
    occ = torch.empty(rp, dtype=torch.bool, device=od.device)
    with torch.cuda.device(od.device):
        err = fn(items.seg.data_ptr(), items.sup.data_ptr(), rp // RB,
                 *_table_ptrs(tables, watertight, fn), int(watertight),
                 od.data_ptr(), tm.data_ptr(), rp, RB, float(t_min),
                 occ.data_ptr(), _stream(od))
    return err, occ


def _table_ptrs(tables, watertight, fn):
    """The sweep kernel fn's table pointers: child boxes and slab rows,
    then, for the instanced kernels, the per-super local super and
    instance and the instance rows. The kind of tables must be fn's."""
    inst = fn.__name__.endswith("_inst")
    if inst != (tables.inst_rows is not None):
        raise ValueError(f"{fn.__name__}: needs "
                         f"{'instanced' if inst else 'world-soup'} tables")
    tab = tables.ctab if watertight else tables.bwtab
    ptrs = [tables.cbox3.data_ptr(), tab.data_ptr()]
    if inst:
        ptrs += [tables.isup_local.data_ptr(), tables.isup_inst.data_ptr(),
                 tables.inst_rows.data_ptr()]
    return ptrs


def sweep_closest(tables, items, od, texp, t_min, watertight):
    """The closest sweep: kernel on CUDA tensors, twin on CPU tensors."""
    if not _on_cuda(od, texp, items.seg):
        return sweep_closest_torch(tables, items, od, texp, t_min, watertight)
    err, out = _launch_closest(kernels().lib.dcrt_wl_closest, tables, items,
                               od, texp, t_min, watertight)
    _raise_on(err, "sweep_closest")
    sweep_closest.launches += 1
    return out


def sweep_any(tables, items, od, tm, t_min, watertight):
    """The occlusion sweep: kernel on CUDA tensors, twin on CPU tensors."""
    if not _on_cuda(od, tm, items.seg):
        return sweep_any_torch(tables, items, od, tm, t_min, watertight)
    err, occ = _launch_any(kernels().lib.dcrt_wl_any, tables, items, od, tm,
                           t_min, watertight)
    _raise_on(err, "sweep_any")
    sweep_any.launches += 1
    return occ


def sweep_closest_grouped(tables, items, od, texp, t_min, watertight):
    """The grouped closest sweep: kernel on CUDA tensors, twin on CPU
    tensors. Same inputs and outputs as `sweep_closest`; the same hit."""
    if not _on_cuda(od, texp, items.seg):
        return sweep_closest_grouped_torch(tables, items, od, texp, t_min,
                                           watertight)
    err, out = _launch_closest(kernels().lib.dcrt_wl_closest_grouped, tables,
                               items, od, texp, t_min, watertight)
    _raise_on(err, "sweep_closest_grouped")
    sweep_closest_grouped.launches += 1
    return out


def sweep_any_grouped(tables, items, od, tm, t_min, watertight):
    """The grouped occlusion sweep: kernel on CUDA tensors, twin on CPU
    tensors (`sweep_any_torch`, see 5. above). Same inputs and output as
    `sweep_any`."""
    if not _on_cuda(od, tm, items.seg):
        return sweep_any_torch(tables, items, od, tm, t_min, watertight)
    err, occ = _launch_any(kernels().lib.dcrt_wl_any_grouped, tables, items,
                           od, tm, t_min, watertight)
    _raise_on(err, "sweep_any_grouped")
    sweep_any_grouped.launches += 1
    return occ


def sweep_closest_inst(tables, items, od, texp, t_min, watertight):
    """The instanced closest sweep: kernel on CUDA tensors, twin on CPU
    tensors. Same inputs and outputs as `sweep_closest`, on instanced
    tables."""
    if not _on_cuda(od, texp, items.seg):
        return sweep_closest_inst_torch(tables, items, od, texp, t_min,
                                        watertight)
    err, out = _launch_closest(kernels().lib.dcrt_wl_closest_inst, tables,
                               items, od, texp, t_min, watertight)
    _raise_on(err, "sweep_closest_inst")
    sweep_closest_inst.launches += 1
    return out


def sweep_any_inst(tables, items, od, tm, t_min, watertight):
    """The instanced occlusion sweep: kernel on CUDA tensors, twin on CPU
    tensors. Same inputs and output as `sweep_any`, on instanced
    tables."""
    if not _on_cuda(od, tm, items.seg):
        return sweep_any_inst_torch(tables, items, od, tm, t_min, watertight)
    err, occ = _launch_any(kernels().lib.dcrt_wl_any_inst, tables, items, od,
                           tm, t_min, watertight)
    _raise_on(err, "sweep_any_inst")
    sweep_any_inst.launches += 1
    return occ


# sweeps by (instanced tables, plain, grouped); instanced casts take the
# per-ray walk whatever `grouped` says, as the reference's do
_CLOSEST_SWEEPS = {(False, False, False): sweep_closest,
                   (False, False, True): sweep_closest_grouped,
                   (False, True, False): sweep_closest_torch,
                   (False, True, True): sweep_closest_grouped_torch,
                   (True, False, False): sweep_closest_inst,
                   (True, True, False): sweep_closest_inst_torch}
_ANY_SWEEPS = {(False, False, False): sweep_any,
               (False, False, True): sweep_any_grouped,
               (False, True, False): sweep_any_torch,
               (False, True, True): sweep_any_torch,
               (True, False, False): sweep_any_inst,
               (True, True, False): sweep_any_inst_torch}


def _sweep_of(sweeps, tables, plain, grouped):
    inst = tables.inst_rows is not None
    return sweeps[inst, plain, grouped and not inst]


# ---------------------------------------------------------------------------
# the casts
# ---------------------------------------------------------------------------

def decode_closest(state, texp, block_any, r):
    """Sweep state -> (t, +inf on miss; u; v; tri i32; inst i32; back;
    iters i32) for the first r rays. A best whose truncated t is not
    below the truncated scene exit is a miss; so is every ray of a block
    without items."""
    best, t, u, v, tri, inst, back, iters = (x[:r] for x in state)
    keep = block_any.repeat_interleave(RB)[:r]
    t_dec = _bits_float(best & ~_LOWM)
    texp_trunc = _bits_float(_float_bits(texp[:r]) & ~_LOWM)
    hit = keep & (t_dec < texp_trunc)
    return (torch.where(hit, t, float("inf")),
            torch.where(hit, u.clamp(0.0, 1.0), 0.0),
            torch.where(hit, v.clamp(0.0, 1.0), 0.0),
            torch.where(hit, tri, 0), torch.where(hit, inst, 0),
            back & hit, torch.where(keep, iters, 0))


def _miss(origin):
    r = origin.shape[0]
    zf = torch.zeros(r, dtype=torch.float32, device=origin.device)
    zi = torch.zeros(r, dtype=torch.int32, device=origin.device)
    return (torch.full_like(zf, float("inf")), zf, zf.clone(), zi,
            zi.clone(), torch.zeros(r, dtype=torch.bool,
                                    device=origin.device), zi.clone())


def _check_rays(origin, direction):
    for name, x in (("origin", origin), ("direction", direction)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name}: need an (R, 3) float32 tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if direction.shape[0] != origin.shape[0]:
        raise ValueError("origin and direction ray counts differ")


def _cap(t_cap, texp, r):
    """t_cap, scalar or (R,), as the window cap t_cap * 1.001 + 1e-3 (past
    the argmin's truncation quantum, like the scene exit) over the Rp
    padded rays; padding rays get 1e-3."""
    cap = torch.as_tensor(t_cap, dtype=torch.float32, device=texp.device)
    cap = cap * 1.001 + 1e-3
    if cap.dim() == 1:
        if cap.shape[0] != r:
            raise ValueError(f"t_cap: need a scalar or ({r},), got "
                             f"{tuple(cap.shape)}")
        cap = torch.nn.functional.pad(cap, (0, texp.shape[0] - r),
                                      value=1e-3)
    return cap


def _closest_cast(scene, origin, direction, t_min, watertight, plain,
                  grouped, t_cap):
    _check_rays(origin, direction)
    tables = scene_tables(scene)
    od, tm, r = (prep_rays_torch if plain else prep_rays)(origin, direction)
    texp = scene_exit(tables, od)
    if t_cap is not None:
        cap = _cap(t_cap, texp, r)
        texp, tm = torch.minimum(texp, cap), torch.minimum(tm, cap)
    items = phases(tables, od, tm, plain) if r else None
    if items is None:
        return _miss(origin), True
    state = _sweep_of(_CLOSEST_SWEEPS, tables, plain, grouped)(
        tables, items, od, texp, t_min, watertight)
    return decode_closest(state, texp, items.block_any, r), False


def _any_cast(scene, origin, direction, t_max, t_min, watertight, plain,
              grouped):
    _check_rays(origin, direction)
    tables = scene_tables(scene)
    od, tm, r = (prep_rays_torch if plain else prep_rays)(origin, direction,
                                                          t_max)
    items = phases(tables, od, tm, plain) if r else None
    if items is None:
        return torch.zeros(r, dtype=torch.bool, device=origin.device), True
    occ = _sweep_of(_ANY_SWEEPS, tables, plain, grouped)(
        tables, items, od, tm, t_min, watertight)
    return (occ & items.block_any.repeat_interleave(RB))[:r], False


def worklist_closest(scene, origin, direction, t_min=0.0, watertight=False,
                     grouped=False, t_cap=None):
    """Closest hit over a scene with work-list tables (world-soup clusters
    or instanced): (t, +inf on miss; u; v; tri i32; inst i32; back bool;
    iters i32). Kernels on CUDA tensors; the grouped sweep with
    grouped=True on world-soup tables (instanced tables take the per-ray
    sweep). t_cap (scalar or (R,), a float or a
    tensor) caps the window: a hit below t_cap is the closest hit, a miss
    means no hit below t_cap; a hit within the truncation quantum above
    t_cap may be reported."""
    out, empty = _closest_cast(scene, origin, direction, t_min, watertight,
                               False, grouped, t_cap)
    worklist_closest.empty += int(empty)
    return out


def worklist_any(scene, origin, direction, t_max, t_min=0.0,
                 watertight=False, grouped=False):
    """Occlusion over a scene with work-list tables: (R,) bool, a hit in
    [t_min, t_max) per ray. Kernels on CUDA tensors; the grouped sweep
    with grouped=True on world-soup tables."""
    occ, empty = _any_cast(scene, origin, direction, t_max, t_min,
                           watertight, False, grouped)
    worklist_any.empty += int(empty)
    return occ


def worklist_closest_torch(scene, origin, direction, t_min=0.0,
                           watertight=False, grouped=False, t_cap=None):
    """`worklist_closest` with every step in plain PyTorch (any device)."""
    return _closest_cast(scene, origin, direction, t_min, watertight, True,
                         grouped, t_cap)[0]


def worklist_any_torch(scene, origin, direction, t_max, t_min=0.0,
                       watertight=False, grouped=False):
    """`worklist_any` with every step in plain PyTorch (any device)."""
    return _any_cast(scene, origin, direction, t_max, t_min, watertight,
                     True, grouped)[0]


def counters():
    """Launch and cast counters (see the module docstring)."""
    return dict(prep_rays=prep_rays.launches,
                cull_boxes=cull_boxes.launches, refine=refine.launches,
                refine_skipped=refine.skipped,
                sweep_closest=sweep_closest.launches,
                sweep_any=sweep_any.launches,
                sweep_closest_grouped=sweep_closest_grouped.launches,
                sweep_any_grouped=sweep_any_grouped.launches,
                sweep_closest_inst=sweep_closest_inst.launches,
                sweep_any_inst=sweep_any_inst.launches,
                closest_empty=worklist_closest.empty,
                any_empty=worklist_any.empty)


def reset_counters():
    prep_rays.launches = 0
    cull_boxes.launches = refine.launches = refine.skipped = 0
    sweep_closest.launches = sweep_any.launches = 0
    sweep_closest_grouped.launches = sweep_any_grouped.launches = 0
    sweep_closest_inst.launches = sweep_any_inst.launches = 0
    worklist_closest.empty = worklist_any.empty = 0


reset_counters()
