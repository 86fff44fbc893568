"""Pair-expanded sweep of clustered scenes: the CUDA kernels, their twins
and the glue between them.

Counterpart of `directcomputeraytracing_tpu.accel.pairsweep` (the
`traversal_backend="pallas_pair"` casts) for world-soup cluster tables.
Where the work list walks a block's items with one best per ray carried
from super to super, the pair sweep refines each (block, super) item to
the rays that enter the super and walks every such (ray, super) pair on
its own. A cast runs:

1. `prep_rays` (its twin in the plain casts), `scene_exit` and `phases`
   of `accel.worklist`: the (block, super) items of the work list's
   cull, as the reference builds its items from the work list's phases
   A-B.
2. The emission. `emit_pairs` (kernel `emit_kernel`, twin
   `emit_pairs_torch`): per item and lane, one slab test of the item's
   super box, enter where (t_hi >= t_lo) & (t_hi >= 0) & (t_lo < cap) &
   (t_hi >= t_min) -> an (n_items, RB) uint8 grid in item order. A
   closest cast's cap is the candidate window of its initial best,
   `_window(bits(texp) | _LOWM)`, an any-hit cast's the ray's t_max. A
   super box is the exact min/max of its child boxes and slab arithmetic
   is monotone, so every ray that enters a child box enters its super:
   the pairs hold every cluster the work list's fine cull admits.
3. `pair_list`: `torch.nonzero` lists the set cells in grid order (one
   host read, sized from the true count: there is no capacity, so the
   reference's overflow fallback to the clustered sweep has no
   counterpart). Pair ray = block * RB + lane, pair super = the item's.
   A stable sort groups the pairs by super (grid order within a super),
   and the launch list cuts each super's run into chunks of at most
   `chunk()` pairs: (super, first pair, count).
4. The sweep. `pair_sweep_closest` / `pair_sweep_any` (kernels
   `pair_closest_kernel` / `pair_any_kernel`, twins
   `pair_sweep_closest_torch` / `pair_sweep_any_torch`), one result per
   pair in the pair list's order. Closest: the work list's per-item walk
   (fine cull of the super's 32 child boxes, nearest-first cluster walk,
   strict packed-key update under the candidate window) from the pair's
   own best bits(texp) | _LOWM, no best carried across supers: packed
   best, t, u, v, tri, inst, back and clusters swept. Any-hit: the same
   walk under the window t_max, stopping at the first hit: one byte.
5. The per-ray reduction, plain PyTorch on the device: best = the least
   pair key of the ray (`scatter_reduce` amin, from bits(texp) | _LOWM);
   the winner is the least grid-order pair whose key equals it. Equal
   keys in two supers happen when two hits share a truncated t and a
   (child, row) slot; the work list's strict update keeps the earlier
   item of the block's (t_ent, super) order, which is grid order. The
   winner's t, u, v, tri, inst and back are the ray's; `iters` is the sum
   of clusters swept over the ray's pairs (it is at least the work
   list's, which carries its best across supers; the reference adds a
   1024-lane pair block's count to every lane); `decode_closest` decodes.
   Any-hit: a per-ray OR.

With the work list's candidate window at every step (emission, fine cull,
walk), the pair cast's hit equals `worklist_closest`'s bit for bit, and
its occlusion `worklist_any`'s. With t_cap (as for the work list: the
scene exit and the cull's t_max shrink to t_cap * 1.001 + 1e-3) hits
strictly below the cap are equal.

Memory. The grid holds a byte per (item, lane) and a pair about 80 bytes
of glue. A cast emits its blocks in ranges of at most `GRID_CELLS` cells
and sweeps its pairs in block-aligned ranges of at most `RANGE_PAIRS`
pairs (each range one more host read); the result is the same.

Wrappers launch the kernels of `csrc/pairsweep.cu` on CUDA tensors and
run the twins on CPU tensors; any other device raises. `pair_closest` and
`pair_any` are the casts the intersector calls; `pair_closest_torch` and
`pair_any_torch` are the same casts with every step in plain PyTorch, on
any device. They need world-soup tables (the intersector takes the
instanced sweep on instanced tables, as the reference downgrades there).

Counters: `emit_pairs.launches`, `pair_sweep_closest.launches` and
`pair_sweep_any.launches` count CUDA launches; `pair_closest.empty` and
`pair_any.empty` casts with no item or no pair (no sweep ran, misses
returned), `.no_pair` those of them with items (the emission ran), on
any device.
"""

import ctypes
from typing import NamedTuple

import torch

from .worklist import (
    _LOWM,
    RB,
    TWIN_RAY_CHUNK,
    Items,
    _Best,
    _cap,
    _check_f32,
    _check_rays,
    _fine_cull,
    _float_bits,
    _miss,
    _on_cuda,
    _raise_on,
    _slab,
    _stream,
    _window,
    BIG,
    decode_closest,
    phases,
    prep_rays,
    prep_rays_torch,
    scene_exit,
    scene_tables,
    walk_any_torch,
    walk_closest_torch,
)

GRID_CELLS = 1 << 30         # emission cells (bytes) of one range of blocks
RANGE_PAIRS = 1 << 26        # pairs swept and reduced in one range
TWIN_CELL_CHUNK = 1 << 22    # (item, lane) cells per emission-twin chunk
_NO_PAIR = torch.iinfo(torch.int64).max

_NVCC_EXTRA = ("-fmad=false",)   # round like the twins (see brute.py)
_built = None


def kernels():
    """The loaded kernel library (built on first call); `.seconds` and
    `.log` describe the build."""
    global _built
    if _built is None:
        from ..utils.cuda_build import load_library

        built = load_library("pairsweep.cu", _NVCC_EXTRA)
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = built.lib
        lib.dcrt_pair_chunk.argtypes = []
        lib.dcrt_pair_emit.argtypes = [c_p, c_p, c_i, c_p, c_p, c_p, c_i,
                                       c_i, c_f, c_p, c_p]
        lib.dcrt_pair_closest.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p, c_p,
                                          c_i, c_p, c_p, c_i, c_f] \
            + [c_p] * 9
        lib.dcrt_pair_any.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p, c_p, c_i,
                                      c_p, c_p, c_i, c_f, c_p, c_p]
        for fn in (lib.dcrt_pair_chunk, lib.dcrt_pair_emit,
                   lib.dcrt_pair_closest, lib.dcrt_pair_any):
            fn.restype = c_i
        _built = built
    return _built


def chunk(device):
    """Pairs per chunk of the launch list: the kernels' block size on a
    CUDA device, the same 256 for the twins."""
    return kernels().lib.dcrt_pair_chunk() if device.type == "cuda" else 256


# ---------------------------------------------------------------------------
# the emission: kernel row 15, twin
# ---------------------------------------------------------------------------

def item_blocks(items):
    """(n_items,) int64 ray block of each item (items are block-major)."""
    n = items.sup.shape[0]
    return torch.searchsorted(items.seg[1:].long(),
                              torch.arange(n, device=items.seg.device),
                              right=True)


def emit_pairs_torch(tables, items, od, cap, t_min):
    """Twin of `emit_kernel`: the (n_items, RB) uint8 enter grid."""
    blk = item_blocks(items)
    n = blk.shape[0]
    out = torch.empty((n, RB), dtype=torch.uint8, device=od.device)
    lane = torch.arange(RB, device=od.device)
    step = max(1, TWIN_CELL_CHUNK // RB)
    for i in range(0, n, step):
        rays = blk[i:i + step, None] * RB + lane
        box = tables.sbox[items.sup[i:i + step].long()]
        t_lo = torch.full(rays.shape, -BIG, device=od.device)
        t_hi = torch.full_like(t_lo, BIG)
        for ax in range(3):
            t_lo, t_hi = _slab(box[:, ax, None], box[:, 3 + ax, None],
                               od[ax][rays], od[6 + ax][rays], t_lo, t_hi)
        out[i:i + step] = ((t_hi >= t_lo) & (t_hi >= 0.0)
                           & (t_lo < cap[rays]) & (t_hi >= t_min))
    return out


def emit_pairs(tables, items, od, cap, t_min):
    """(block, super) items x their blocks' rays -> the (n_items, RB)
    uint8 enter grid: kernel on CUDA tensors, twin on CPU tensors."""
    rp = od.shape[1]
    _check_f32("od", od, (9, rp))
    _check_f32("cap", cap, (rp,))
    if not _on_cuda(od, cap, items.sup):
        return emit_pairs_torch(tables, items, od, cap, t_min)
    n = items.sup.shape[0]
    blk = item_blocks(items).to(torch.int32)
    out = torch.empty((n, RB), dtype=torch.uint8, device=od.device)
    with torch.cuda.device(od.device):
        err = kernels().lib.dcrt_pair_emit(
            blk.data_ptr(), items.sup.data_ptr(), n, tables.sbox.data_ptr(),
            od.data_ptr(), cap.data_ptr(), rp, RB, float(t_min),
            out.data_ptr(), _stream(od))
    _raise_on(err, "emit_pairs")
    emit_pairs.launches += 1
    return out


# ---------------------------------------------------------------------------
# the pair list and its launch list (plain PyTorch on the device)
# ---------------------------------------------------------------------------

class Pairs(NamedTuple):
    ray: torch.Tensor      # (P,) i32 pair ray, the pairs grouped by super
    sup: torch.Tensor      # (P,) i32 pair super, ascending
    order: torch.Tensor    # (P,) i64 each pair's index in grid order
                           # (within its range of the cast)
    chunk_sup: torch.Tensor    # (n_chunks,) i32 launch list: super,
    chunk_first: torch.Tensor  # first pair
    chunk_count: torch.Tensor  # and pairs (0: a spare entry)


def _launch_list(sup_s, cs, n_pairs, size):
    """Chunks of at most `size` pairs per super run of the super-sorted
    pair supers sup_s, without a host read: the list has cs + P // size
    entries (a bound on the chunk count), the spare ones count 0."""
    dev = sup_s.device
    counts = torch.zeros(cs, dtype=torch.int64, device=dev).index_add_(
        0, sup_s.long(), torch.ones_like(sup_s, dtype=torch.int64))
    first = torch.cumsum(counts, 0) - counts
    n_ch = (counts + size - 1) // size
    end = torch.cumsum(n_ch, 0)
    j = torch.arange(cs + n_pairs // size, device=dev)
    s = torch.searchsorted(end, j, right=True)
    sc = s.clamp(max=cs - 1)
    k = j - (end[sc] - n_ch[sc])
    valid = s < cs
    count = torch.where(valid, (counts[sc] - k * size).clamp(0, size), 0)
    first = torch.where(valid, first[sc] + k * size, 0)
    return sc.to(torch.int32), first.to(torch.int32), count.to(torch.int32)


def pair_list(tables, items, it, lane):
    """Set grid cells (item it, lane), in grid order -> Pairs grouped by
    super (stable: grid order within a super) with their launch list."""
    ray = (item_blocks(items)[it] * RB + lane).to(torch.int32)
    sup_s, order = torch.sort(items.sup[it], stable=True)
    n = ray.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} pairs overflow the kernels' int32 pair index")
    return Pairs(ray[order], sup_s, order,
                 *_launch_list(sup_s, tables.sbox.shape[0], n,
                               chunk(ray.device)))


# ---------------------------------------------------------------------------
# the pair sweeps: kernel rows 16 (closest) and 17 (any), twins
# ---------------------------------------------------------------------------

def pair_sweep_closest_torch(tables, pairs, od, texp, t_min, watertight):
    """Twin of `pair_closest_kernel`: per pair (in the pair list's order)
    the work list's walk over the pair's super from bits(texp[ray]) |
    _LOWM -> (packed best i32, t, u, v, tri i32, inst i32, back bool,
    clusters swept i32), each (P,)."""
    tab = tables.ctab if watertight else tables.bwtab
    parts = []
    for lo in range(0, pairs.ray.shape[0], TWIN_RAY_CHUNK):
        ray = pairs.ray[lo:lo + TWIN_RAY_CHUNK].long()
        sup = pairs.sup[lo:lo + TWIN_RAY_CHUNK].long()
        st = _Best(texp[ray])
        enter, tl = _fine_cull(tables.cbox3[sup], od[:, ray],
                               _window(st.best), t_min)
        walk_closest_torch(st, tab, torch.arange(ray.shape[0],
                                                 device=od.device),
                           sup, od[0:3, ray].T, od[3:6, ray].T, enter, tl,
                           t_min, watertight)
        parts.append(st.state(tab, watertight))
    return tuple(torch.cat(x) for x in zip(*parts))


def pair_sweep_any_torch(tables, pairs, od, tm, t_min, watertight):
    """Twin of `pair_any_kernel`: per pair, a hit in [t_min, tm[ray])
    within a cluster of the pair's super that its fine cull admits ->
    (P,) bool."""
    tab = tables.ctab if watertight else tables.bwtab
    occ = torch.zeros(pairs.ray.shape[0], dtype=torch.bool, device=od.device)
    for lo in range(0, pairs.ray.shape[0], TWIN_RAY_CHUNK):
        ray = pairs.ray[lo:lo + TWIN_RAY_CHUNK].long()
        sup = pairs.sup[lo:lo + TWIN_RAY_CHUNK].long()
        enter, _ = _fine_cull(tables.cbox3[sup], od[:, ray], tm[ray], t_min)
        idx = torch.arange(ray.shape[0], device=od.device)
        walk_any_torch(occ[lo:lo + TWIN_RAY_CHUNK], tab, idx, sup,
                       od[0:3, ray].T, od[3:6, ray].T, enter, tm[ray], t_min,
                       watertight)
    return occ


def _pair_ptrs(tables, pairs, watertight):
    tab = tables.ctab if watertight else tables.bwtab
    return (pairs.chunk_sup.data_ptr(), pairs.chunk_first.data_ptr(),
            pairs.chunk_count.data_ptr(), pairs.chunk_sup.shape[0],
            pairs.ray.data_ptr(), tables.cbox3.data_ptr(), tab.data_ptr(),
            int(watertight))


def pair_sweep_closest(tables, pairs, od, texp, t_min, watertight):
    """The pair closest sweep: kernel on CUDA tensors, twin on CPU
    tensors."""
    if not _on_cuda(od, texp, pairs.ray):
        return pair_sweep_closest_torch(tables, pairs, od, texp, t_min,
                                        watertight)
    p = pairs.ray.shape[0]
    f32 = dict(dtype=torch.float32, device=od.device)
    i32 = dict(dtype=torch.int32, device=od.device)
    best, tri, inst, iters = (torch.empty(p, **i32) for _ in range(4))
    t, u, v = (torch.empty(p, **f32) for _ in range(3))
    back = torch.empty(p, dtype=torch.bool, device=od.device)
    with torch.cuda.device(od.device):
        err = kernels().lib.dcrt_pair_closest(
            *_pair_ptrs(tables, pairs, watertight), od.data_ptr(),
            texp.data_ptr(), od.shape[1], float(t_min), best.data_ptr(),
            t.data_ptr(), u.data_ptr(), v.data_ptr(), tri.data_ptr(),
            inst.data_ptr(), back.data_ptr(), iters.data_ptr(), _stream(od))
    _raise_on(err, "pair_sweep_closest")
    pair_sweep_closest.launches += 1
    return best, t, u, v, tri, inst, back, iters


def pair_sweep_any(tables, pairs, od, tm, t_min, watertight):
    """The pair occlusion sweep: kernel on CUDA tensors, twin on CPU
    tensors."""
    if not _on_cuda(od, tm, pairs.ray):
        return pair_sweep_any_torch(tables, pairs, od, tm, t_min, watertight)
    occ = torch.empty(pairs.ray.shape[0], dtype=torch.bool, device=od.device)
    with torch.cuda.device(od.device):
        err = kernels().lib.dcrt_pair_any(
            *_pair_ptrs(tables, pairs, watertight), od.data_ptr(),
            tm.data_ptr(), od.shape[1], float(t_min), occ.data_ptr(),
            _stream(od))
    _raise_on(err, "pair_sweep_any")
    pair_sweep_any.launches += 1
    return occ


# ---------------------------------------------------------------------------
# the per-ray reduction (plain PyTorch on the device)
# ---------------------------------------------------------------------------

def reduce_closest(state, out, pairs, texp):
    """Fold per-pair closest results into the per-ray sweep state (a list
    (best, t, u, v, tri, inst, back, iters) of (Rp,) tensors, updated in
    place). The pairs' rays have no pair outside this list."""
    best_p, t_p, u_p, v_p, tri_p, inst_p, back_p, it_p = out
    ray = pairs.ray.long()
    b0 = _float_bits(texp) | _LOWM
    best = b0.scatter_reduce(0, ray, best_p, "amin")
    cand = torch.where((best_p == best[ray]) & (best_p < b0[ray]),
                       pairs.order, _NO_PAIR)
    win = torch.full(texp.shape, _NO_PAIR, dtype=torch.int64,
                     device=texp.device).scatter_reduce(0, ray, cand, "amin")
    found = win < _NO_PAIR
    pos = torch.empty_like(pairs.order)
    pos[pairs.order] = torch.arange(pos.shape[0], device=pos.device)
    w = pos[torch.where(found, win, 0)]
    state[0] = torch.minimum(state[0], best)
    for i, x in ((1, t_p), (2, u_p), (3, v_p), (4, tri_p), (5, inst_p),
                 (6, back_p)):
        state[i] = torch.where(found, x[w], state[i])
    state[7] = state[7].index_add(0, ray, it_p)


def _initial_state(texp):
    """The per-ray state before any pair: best bits(texp) | _LOWM."""
    st = _Best(texp)
    return [st.best, st.t, st.u, st.v, torch.zeros_like(st.iters),
            torch.zeros_like(st.iters), st.back, st.iters]


# ---------------------------------------------------------------------------
# the casts
# ---------------------------------------------------------------------------

def _grid_ranges(items):
    """The cast's items by ray-block ranges of at most GRID_CELLS emission
    cells (one block at least): (first block, Items of the range renumbered
    from it), the whole cast unless it is larger (then one host read of the
    segment offsets)."""
    nb = items.seg.shape[0] - 1
    if items.sup.shape[0] * RB <= GRID_CELLS:
        return [(0, items)]
    seg = items.seg.tolist()
    bounds, b0 = [0], 0
    for b in range(1, nb + 1):
        if (seg[b] - seg[b0]) * RB > GRID_CELLS and b - 1 > b0:
            b0 = b - 1
            bounds.append(b0)
    bounds.append(nb)
    return [(b0, Items(items.seg[b0:b1 + 1] - seg[b0],
                       items.sup[seg[b0]:seg[b1]],
                       items.t_ent[seg[b0]:seg[b1]],
                       items.block_any[b0:b1]))
            for b0, b1 in zip(bounds[:-1], bounds[1:])]


def _pair_ranges(items, it):
    """Split the grid-order pair cells (items it) into block-aligned
    ranges of about RANGE_PAIRS pairs: a ray's pairs stay in one range."""
    n = it.shape[0]
    parts = -(-n // RANGE_PAIRS)
    if parts <= 1:
        return [(0, n)]
    blk = item_blocks(items)[it]
    at = torch.arange(1, parts, device=it.device) * (n // parts)
    cuts = torch.searchsorted(blk, blk[at]).tolist()
    bounds = sorted(set([0] + cuts + [n]))
    return list(zip(bounds[:-1], bounds[1:]))


def _cast_pairs(tables, items, od, cap, t_min, plain):
    """The pair lists of a cast, range by range (see the module
    docstring); pair rays index the whole cast's od."""
    emit = emit_pairs_torch if plain else emit_pairs
    for b0, sub in _grid_ranges(items):
        r0, r1 = b0 * RB, (b0 + sub.seg.shape[0] - 1) * RB
        grid = emit(tables, sub, od[:, r0:r1].contiguous(),
                    cap[r0:r1].contiguous(), t_min)
        it, lane = torch.nonzero(grid, as_tuple=True)
        del grid
        for p0, p1 in _pair_ranges(sub, it):
            pairs = pair_list(tables, sub, it[p0:p1], lane[p0:p1])
            yield pairs._replace(ray=pairs.ray + r0) if r0 else pairs


def _soup_tables(scene):
    tables = scene_tables(scene)
    if tables.inst_rows is not None:
        raise ValueError("the pair sweep needs world-soup cluster tables "
                         "(the intersector takes the instanced sweep)")
    return tables


def _closest_cast(scene, origin, direction, t_min, watertight, plain, t_cap):
    _check_rays(origin, direction)
    tables = _soup_tables(scene)
    od, tm, r = (prep_rays_torch if plain else prep_rays)(origin, direction)
    texp = scene_exit(tables, od)
    if t_cap is not None:
        cap = _cap(t_cap, texp, r)
        texp, tm = torch.minimum(texp, cap), torch.minimum(tm, cap)
    items = phases(tables, od, tm, plain) if r else None
    if items is None:
        return _miss(origin), None
    sweep = pair_sweep_closest_torch if plain else pair_sweep_closest
    state, swept = _initial_state(texp), False
    for pairs in _cast_pairs(tables, items, od,
                             _window(_float_bits(texp) | _LOWM), t_min,
                             plain):
        if pairs.ray.numel():
            swept = True
            reduce_closest(state, sweep(tables, pairs, od, texp, t_min,
                                        watertight), pairs, texp)
    return decode_closest(state, texp, items.block_any, r), swept


def _any_cast(scene, origin, direction, t_max, t_min, watertight, plain):
    _check_rays(origin, direction)
    tables = _soup_tables(scene)
    od, tm, r = (prep_rays_torch if plain else prep_rays)(origin, direction,
                                                          t_max)
    items = phases(tables, od, tm, plain) if r else None
    if items is None:
        return torch.zeros(r, dtype=torch.bool, device=origin.device), None
    sweep = pair_sweep_any_torch if plain else pair_sweep_any
    hits = torch.zeros(od.shape[1], dtype=torch.int32, device=od.device)
    swept = False
    for pairs in _cast_pairs(tables, items, od, tm, t_min, plain):
        if pairs.ray.numel():
            swept = True
            occ = sweep(tables, pairs, od, tm, t_min, watertight)
            hits.index_add_(0, pairs.ray.long(), occ.to(torch.int32))
    return (hits > 0)[:r], swept


def _count(cast, swept):
    """A cast's counters: swept None (no item), False (items, no pair) or
    True."""
    cast.empty += int(not swept)
    cast.no_pair += int(swept is False)


def pair_closest(scene, origin, direction, t_min=0.0, watertight=False,
                 t_cap=None):
    """Closest hit over a scene with world-soup cluster tables through the
    pair sweep: (t, +inf on miss; u; v; tri i32; inst i32; back bool;
    iters i32), `worklist_closest`'s contract and hit. Kernels on CUDA
    tensors. t_cap (scalar or (R,)) caps the window as there."""
    out, swept = _closest_cast(scene, origin, direction, t_min, watertight,
                               False, t_cap)
    _count(pair_closest, swept)
    return out


def pair_any(scene, origin, direction, t_max, t_min=0.0, watertight=False):
    """Occlusion through the pair sweep: (R,) bool, a hit in [t_min, t_max)
    per ray (`worklist_any`'s answer). Kernels on CUDA tensors."""
    occ, swept = _any_cast(scene, origin, direction, t_max, t_min,
                           watertight, False)
    _count(pair_any, swept)
    return occ


def pair_closest_torch(scene, origin, direction, t_min=0.0, watertight=False,
                       t_cap=None):
    """`pair_closest` with every step in plain PyTorch (any device)."""
    return _closest_cast(scene, origin, direction, t_min, watertight, True,
                         t_cap)[0]


def pair_any_torch(scene, origin, direction, t_max, t_min=0.0,
                   watertight=False):
    """`pair_any` with every step in plain PyTorch (any device)."""
    return _any_cast(scene, origin, direction, t_max, t_min, watertight,
                     True)[0]


def counters():
    """Launch and cast counters (see the module docstring)."""
    return dict(pair_emit=emit_pairs.launches,
                pair_sweep_closest=pair_sweep_closest.launches,
                pair_sweep_any=pair_sweep_any.launches,
                pair_closest_empty=pair_closest.empty,
                pair_any_empty=pair_any.empty,
                pair_closest_no_pair=pair_closest.no_pair,
                pair_any_no_pair=pair_any.no_pair)


def reset_counters():
    emit_pairs.launches = 0
    pair_sweep_closest.launches = pair_sweep_any.launches = 0
    pair_closest.empty = pair_any.empty = 0
    pair_closest.no_pair = pair_any.no_pair = 0


reset_counters()
