"""A/B of the pair emission and the pair sweeps (kernel rows 15-17) on
one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.pair_ab \
        [--parent DIR] [--reps N] [--sets SETS]

Times, in turns, `emit_kernel`, `pair_closest_kernel` and
`pair_any_kernel` of `csrc/pairsweep.cu`, Baldwin-Weber and watertight,
on `sphere_grid(12, 12)` (211,972 triangles, 512 supers of 32 clusters)
and the ray sets of `chip_smoke.py` phase 2g (`tools.common.
grid_ray_sets`, seed 20261021): `shadow` (2^20 rays towards the lamp,
per-ray t_max), `random_sorted` (2^20 random rays in `ray_sort_key`
order), `pool_sorted` (2^18 such rays) and `camera` (1024^2 tiled camera
rays); t_min 1e-4.

Variants:

- `parent`: `--parent DIR`'s `pairsweep.cu` with its headers
  (`worklist.cuh`, `ray_tri.cuh`), built under the library name
  pairsweep_parent: the package's C interface where it exports
  `dcrt_pair_resources`, else the first port's (an emission per item,
  which takes the items' ray blocks `ps.item_blocks`);
- `new`: the package's kernels.

Each is timed in turns (parent, new, new, parent) with
CUDA events (the mean of `reps` launches after a warm-up, default 5;
that includes the wrapper's own device ops) and beside them by the
profiler (`tools.common.kernel_ms`: the kernel alone). One `pair-ab`
line per (set, kind, row[, test]) gives the turns, means, kernel ms, the
bound (`pair_bounds`) and each variant's share of it; one `pair-census`
line per (set, kind) gives `pair_census`.

The tool exits non-zero where, in any bit: the new emission differs
from its twin (`emit_pairs_torch`, whole set) or from the parent's; the
new sweeps differ from their twins on the pairs of 64 ray blocks spread
over the set (the closest sweep also from `closest_replay`, the model
of its schedule), or from the parent's on every pair; or the pair casts
(`pair_closest` / `pair_any`) differ from `worklist_closest` /
`worklist_any` on the whole set (every hit field, occlusion). Prints
the card's name and power limit first, then per built variant its ptxas
lines and (package) the kernels' resources. Needs a CUDA device; with
none it exits non-zero.

`pair_census`, `pair_bounds` and `pair_subset` serve `chip_smoke.py`
phase 2g and the tests too; `closest_replay` models row 16 for the
tests.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..accel import pairsweep as ps
from ..accel import worklist as wl
from . import common
from .worklist_ab import ptxas_report as _ptxas_report

SEED = 20261021
SETS = ("shadow", "random_sorted", "pool_sorted", "camera")
T_MIN = 1e-4
TWIN_BLOCKS = 64                 # ray blocks of a twin sweep
FLOPS_BW = 31                    # one Baldwin-Weber test (chip_smoke.py)
CENSUS_PAIRS = 1 << 18           # pairs per step of the census


# ---------------------------------------------------------------------------
# the census and the bounds
# ---------------------------------------------------------------------------

def _warps(pairs):
    """(P,) i64 warp of each pair: 32 consecutive pairs of a chunk (a
    super's run is cut into chunks of 256 pairs from its start), and the
    warp count."""
    sup = pairs.sup.long()
    pos = torch.arange(sup.shape[0], device=sup.device) \
        - torch.searchsorted(sup, sup)
    warp = torch.cumsum((pos % 32 == 0).long(), 0) - 1
    return warp, int(warp[-1]) + 1 if warp.numel() else 0


def _per_warp(warp, n_warps, x, how):
    return torch.zeros(n_warps, dtype=torch.int64, device=x.device) \
        .scatter_reduce_(0, warp, x.long(), how)


def _union_per_warp(warp, n_warps, j, c):
    """Distinct clusters c over the entries (pair j, cluster c) of each
    warp."""
    key = torch.unique(warp[j] * wl.SUPER + c)
    return torch.zeros(n_warps, dtype=torch.int64, device=c.device) \
        .index_add_(0, key // wl.SUPER, torch.ones_like(key))


def _closest_keys(tables, ray, sup, od, texp, t_min, watertight):
    """Row 16's dealt tests for pairs (ray, sup) (n,): the initial best b0
    = bits(texp) | _LOWM, the fine cull under its window w0 (enter, tl:
    the twin's `_fine_cull`), and per entered cluster the least packed key
    of its 16 rows that hit in [t_min, w0) (keys (n, SUPER) i32, _I32_MAX
    where none hits or the cluster is not entered)."""
    dev = od.device
    tab = tables.ctab if watertight else tables.bwtab
    b0 = wl._float_bits(texp[ray]) | wl._LOWM
    w0 = wl._window(b0)
    enter, tl = wl._fine_cull(tables.cbox3[sup], od[:, ray], w0, t_min)
    keys = torch.full(enter.shape, wl._I32_MAX, dtype=torch.int32, device=dev)
    lane16 = torch.arange(wl.CLUSTER_SIZE, device=dev)
    j, c = torch.nonzero(enter, as_tuple=True)
    for s in range(0, j.shape[0], CENSUS_PAIRS):
        jj, cc = j[s:s + CENSUS_PAIRS], c[s:s + CENSUS_PAIRS]
        rows = ((sup[jj] * wl.SUPER + cc) * wl.CLUSTER_SIZE)[:, None] + lane16
        t, _, _, _, ok = wl._tri_rows(
            tab[rows], od[0:3, ray[jj]].T[:, None, :],
            od[3:6, ray[jj]].T[:, None, :], t_min, w0[jj][:, None],
            watertight)
        key = (wl._float_bits(t) & ~wl._LOWM) \
            | ((cc[:, None] << 4) + lane16).to(torch.int32)
        keys[jj, cc] = torch.where(ok, key, wl._I32_MAX).amin(1)
    return b0, enter, tl, keys


def _replay(b0, enter, tl, keys):
    """Row 16's replay of the nearest-first walk from the keys: pop the
    entered clusters by tl (lowest child on a tie), stop at the first
    that is not below the window of the best, count each pop, take a key
    strictly below the best. -> (best, iters, winning row of the super or
    -1), each (n,)."""
    dev = b0.device
    t_sorted, order = torch.sort(torch.where(enter, tl, float("inf")),
                                 dim=1, stable=True)
    n_enter = enter.sum(1)
    best = b0.clone()
    iters = torch.zeros_like(b0)
    row = torch.full_like(b0, -1)
    live = torch.ones(b0.shape, dtype=torch.bool, device=dev)
    for k in range(int(n_enter.max()) if n_enter.numel() else 0):
        live &= (k < n_enter) & (t_sorted[:, k] < wl._window(best))
        key = keys.gather(1, order[:, k:k + 1])[:, 0]
        take = live & (key < best)
        iters += live.to(iters.dtype)
        best = torch.where(take, key, best)
        row = torch.where(take, key & wl._LOWM, row)
    return best, iters, row


def closest_replay(tables, pairs, od, texp, t_min, watertight):
    """A plain model of `pair_closest_kernel` (row 16): the least key of
    every entered cluster under the pair's initial window, then the
    replay, then the winning row tested once more for its t, u, v and
    side -> (packed best i32, t, u, v, tri i32, inst i32, back bool,
    clusters swept i32), each (P,): `pair_sweep_closest_torch`'s outputs
    bit for bit (the proof is in csrc/pairsweep.cu)."""
    tab = tables.ctab if watertight else tables.bwtab
    meta = wl._RAW_META if watertight else wl._BW_META
    parts = []
    for lo in range(0, pairs.ray.shape[0], CENSUS_PAIRS):
        ray = pairs.ray[lo:lo + CENSUS_PAIRS].long()
        sup = pairs.sup[lo:lo + CENSUS_PAIRS].long()
        b0, enter, tl, keys = _closest_keys(tables, ray, sup, od, texp,
                                            t_min, watertight)
        best, iters, row = _replay(b0, enter, tl, keys)
        found = row >= 0
        g = torch.where(found, sup * wl.SUPER * wl.CLUSTER_SIZE + row, 0)
        t, u, v, back, _ = wl._tri_rows(
            tab[g][:, None, :], od[0:3, ray].T[:, None, :],
            od[3:6, ray].T[:, None, :], t_min, wl._window(b0)[:, None],
            watertight)
        m = tab[g, meta:meta + 3]
        parts.append((
            best, torch.where(found, t[:, 0], texp[ray]),
            torch.where(found, u[:, 0], 0.0), torch.where(found, v[:, 0], 0.0),
            torch.where(found, m[:, 0], 0.0).to(torch.int32),
            torch.where(found, m[:, 1], 0.0).to(torch.int32),
            found & (back[:, 0] ^ (m[:, 2] > 0.5)), iters))
    return tuple(torch.cat(x) for x in zip(*parts))


def pair_census(tables, items, pairs, od, cap, t_min, rays, tm=None,
                watertight=False, texp=None):
    """What one pair cast does, counted on its items and pairs (any
    device; one host read per quantity): items per ray block (mean,
    max), emission cells and the share that is set, pairs per ray, chunks
    of the launch list (pairs per chunk, share of full chunks), clusters a
    pair's fine cull under cap admits, and per warp of 32 pairs the most
    any of its lanes admits and the union of its lanes'. With tm (an
    any-hit cast; cap is then tm; a lane whose window [t_min, tm) is
    empty admits nothing): clusters a lane tests in child order up to its
    first hit (`any_walked`, the work the cast needs), and the kernel's
    balanced walk: its rounds per warp (32 (lane, cluster) tasks a round,
    lane-major), the clusters it tests per pair (a task is skipped once
    its lane has a hit from an earlier round) and the rows it reads per
    pair (16 a cluster). With texp (a closest cast; cap is then the
    window of bits(texp) | _LOWM, so `clusters_per_pair` counts the
    entered clusters under the initial window): the clusters a pair's
    walk sweeps (`closest_swept_per_pair`, the twin's `iters`, by
    `closest_replay`'s keys and replay) and per warp its longest walk
    (`closest_warp_longest`). They give the two schedules of row 16: (a)
    every entered cluster dealt out 32 a round tests `clusters_per_pair`
    a pair in `closest_rounds_a` rounds a warp; (b) a pair's k-th nearest
    cluster dealt once its (k-1)-th is folded and under the window, as
    the walk prunes, tests `closest_swept_per_pair` a pair, a task a pair
    a round, in `closest_warp_longest` rounds."""
    dev = od.device
    p = pairs.ray.shape[0]
    nb = items.seg.shape[0] - 1
    n_items = items.sup.shape[0]
    per_block = (items.seg[1:] - items.seg[:-1]).long()
    counts = pairs.chunk_count.long()
    counts = counts[counts > 0]
    out = dict(rays=rays, blocks=nb, items=n_items,
               items_per_block=n_items / max(nb, 1),
               items_per_block_max=int(per_block.max()) if nb else 0,
               cells=n_items * wl.RB,
               set_cell_share=p / max(1, n_items * wl.RB), pairs=p,
               pairs_per_ray=p / max(1, rays), chunks=int(counts.numel()),
               pairs_per_chunk=float(counts.double().mean())
               if counts.numel() else 0.0,
               full_chunk_share=float((counts == 256).double().mean())
               if counts.numel() else 0.0)
    if p == 0:
        return out
    warp, n_warps = _warps(pairs)
    tab = tables.ctab if watertight else tables.bwtab
    lane16 = torch.arange(wl.CLUSTER_SIZE, device=dev)
    n_enter = torch.zeros(p, dtype=torch.int64, device=dev)
    tasks = torch.zeros(p, dtype=torch.int64, device=dev)   # open lanes'
    k_hit = torch.full((p,), -1, dtype=torch.int64, device=dev)
    walked = torch.zeros(p, dtype=torch.int64, device=dev)
    swept = torch.zeros(p, dtype=torch.int64, device=dev)
    js, cs = [], []
    for lo in range(0, p, CENSUS_PAIRS):
        ray = pairs.ray[lo:lo + CENSUS_PAIRS].long()
        sup = pairs.sup[lo:lo + CENSUS_PAIRS].long()
        enter, _ = wl._fine_cull(tables.cbox3[sup], od[:, ray], cap[ray],
                                 t_min)
        n_enter[lo:lo + ray.shape[0]] = enter.sum(1)
        j, c = torch.nonzero(enter, as_tuple=True)
        js.append(j + lo)
        cs.append(c)
        if texp is not None:
            swept[lo:lo + ray.shape[0]] = _replay(*_closest_keys(
                tables, ray, sup, od, texp, t_min, watertight))[1]
        if tm is None:
            continue
        enter &= (tm[ray] > t_min)[:, None]
        j, c = torch.nonzero(enter, as_tuple=True)
        rows = ((sup[j] * wl.SUPER + c) * wl.CLUSTER_SIZE)[:, None] + lane16
        hit = torch.zeros(j.shape[0], dtype=torch.bool, device=dev)
        for s in range(0, j.shape[0], CENSUS_PAIRS):
            e = slice(s, s + CENSUS_PAIRS)
            jj = j[e]
            o_ = od[0:3, ray[jj]].T[:, None, :]
            d_ = od[3:6, ray[jj]].T[:, None, :]
            hit[e] = wl._tri_rows(tab[rows[e]], o_, d_, t_min,
                                  tm[ray[jj]][:, None], watertight)[4].any(1)
        first = torch.full((ray.shape[0],), wl.SUPER, dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, j[hit], c[hit], "amin")
        # a lane's k-th entered cluster, in child order
        rank = torch.cumsum(enter.long(), 1) - 1
        n_open = enter.sum(1)
        has = first < wl.SUPER
        sl = slice(lo, lo + ray.shape[0])
        tasks[sl] = n_open
        k_hit[sl] = torch.where(
            has, rank.gather(1, first.clamp(max=wl.SUPER - 1)[:, None])[:, 0],
            -1)
        walked[sl] = torch.where(has, k_hit[sl] + 1, n_open)
    j, c = torch.cat(js), torch.cat(cs)
    out.update(
        clusters_per_pair=float(n_enter.double().mean()),
        warps=n_warps,
        warp_max_lane=float(_per_warp(warp, n_warps, n_enter,
                                      "amax").double().mean()),
        warp_union=float(_union_per_warp(warp, n_warps, j, c)
                         .double().mean()))
    if texp is not None:
        entered = _per_warp(warp, n_warps, n_enter, "sum")
        longest = _per_warp(warp, n_warps, swept, "amax").double().mean()
        out.update(
            closest_swept_per_pair=float(swept.sum()) / p,
            closest_warp_longest=float(longest),
            closest_rounds_a=float((-(-entered // 32)).double().mean()))
    if tm is not None:
        # the balanced walk: lane l's tasks start at excl within its warp
        incl = torch.cumsum(tasks, 0)
        first_of = torch.searchsorted(warp, torch.arange(n_warps, device=dev))
        excl = incl - tasks - (incl - tasks)[first_of][warp]
        total = torch.zeros(n_warps, dtype=torch.int64,
                            device=dev).index_add_(0, warp, tasks)
        last = 32 * ((excl + k_hit) // 32 + 1) - excl
        tested = torch.where(k_hit >= 0, torch.minimum(tasks, last), tasks)
        out.update(
            any_walked=int(walked.sum()),
            any_clusters_per_pair=float(walked.sum()) / p,
            any_warp_rounds=float((-(-total // 32)).double().mean()),
            any_tested_per_pair=float(tested.sum()) / p,
            any_rows_per_pair=16 * float(tested.sum()) / p)
    return out


def pair_bounds(tables, items, pairs, rp, watertight, kind, iters_p=None,
                census=None):
    """(emission, sweep) bounds of one pair cast (`tools.common.bound`):
    the emission FLOPS_SLAB a cell against the grid written and the rays
    (o, 1/d and cap: 28 bytes), the items (a super id each, an offset a
    ray block) and the super boxes read once; the closest sweep the fine
    cull of every pair and 16 triangle tests per cluster its walk swept
    (iters_p, the sweep's per-pair counts), the any-hit sweep the fine
    cull of every pair and, with the census of the cast, 16 tests per
    cluster its lanes walk up to their first hit (else the fine cull
    only, a lower bound), against the pair list, the rays, the per-pair
    outputs and the tables once."""
    n, p = items.sup.shape[0], pairs.ray.shape[0]
    cells = n * wl.RB
    emit = common.bound(common.FLOPS_SLAB * cells,
                        cells + 28 * rp + 4 * n + 4 * items.seg.shape[0]
                        + 32 * tables.sbox.shape[0])
    tab = tables.ctab if watertight else tables.bwtab
    table_bytes = 4 * (tables.cbox3.numel() + tab.numel())
    fine = common.FLOPS_SLAB * wl.SUPER * p
    lists = 4 * p + 12 * pairs.chunk_sup.shape[0]
    test = common.FLOPS_MOELLER if watertight else FLOPS_BW
    if kind == "closest":
        sweep = common.bound(fine + 16 * test * int(iters_p.long().sum()),
                             lists + 29 * p + 40 * rp + table_bytes)
    else:
        walked = census["any_walked"] if census else 0
        sweep = common.bound(fine + 16 * test * walked,
                             lists + p + 40 * rp + table_bytes)
    return emit, sweep


def pair_subset(tables, items, it, lane, idx):
    """The pair list of the grid cells (items it, lanes lane) whose ray
    lies in the ray indices idx (whole ray blocks)."""
    blocks = torch.unique(idx // wl.RB)
    keep = torch.isin(ps.item_blocks(items)[it], blocks)
    return ps.pair_list(tables, items, it[keep], lane[keep])


# ---------------------------------------------------------------------------
# the variants
# ---------------------------------------------------------------------------

def ptxas_report(log):
    """The ptxas lines of a build's pair kernels: {short name: {registers,
    smem, stack, spill_stores, spill_loads}}."""
    def short(entry):
        if "emit_kernel" in entry:
            return "emit"
        test = "watertight" if "Watertight" in entry else "baldwin_weber"
        if "pair_closest_kernel" in entry:
            return f"closest_{test}"
        if "pair_any_kernel" in entry:
            return f"any_{test}"
        return None
    return _ptxas_report(log, short)


class _Variant:
    """A build's launches: `emit`, `closest` and `any` on the scene's
    tables, as the package's wrappers make them."""

    def __init__(self, lib, tables, package):
        self.lib, self.tables, self.package = lib, tables, package

    def emit(self, items, od, cap):
        t, rp = self.tables, od.shape[1]
        n = items.sup.shape[0]
        out = torch.empty((n, wl.RB), dtype=torch.uint8, device=od.device)
        if self.package:
            nb = items.seg.shape[0] - 1
            sms = torch.cuda.get_device_properties(
                od.device).multi_processor_count
            head = (items.seg.data_ptr(), items.sup.data_ptr(), n, nb,
                    ps.emit_shape(nb, n, t.sbox.shape[0], sms))
        else:
            blk = ps.item_blocks(items).to(torch.int32)
            head = (blk.data_ptr(), items.sup.data_ptr(), n)
        wl._raise_on(self.lib.dcrt_pair_emit(
            *head, t.sbox.data_ptr(), od.data_ptr(), cap.data_ptr(), rp,
            wl.RB, T_MIN, out.data_ptr(), wl._stream(od)), "emit")
        return out

    def closest(self, pairs, od, texp, wt):
        p = pairs.ray.shape[0]
        dt = (torch.int32, torch.float32, torch.float32, torch.float32,
              torch.int32, torch.int32, torch.bool, torch.int32)
        out = [torch.empty(p, dtype=x, device=od.device) for x in dt]
        wl._raise_on(self.lib.dcrt_pair_closest(
            *ps._pair_ptrs(self.tables, pairs, wt), od.data_ptr(),
            texp.data_ptr(), od.shape[1], T_MIN,
            *(x.data_ptr() for x in out), wl._stream(od)), "closest")
        return tuple(out)

    def any(self, pairs, od, tm, wt):
        occ = torch.empty(pairs.ray.shape[0], dtype=torch.bool,
                          device=od.device)
        wl._raise_on(self.lib.dcrt_pair_any(
            *ps._pair_ptrs(self.tables, pairs, wt), od.data_ptr(),
            tm.data_ptr(), od.shape[1], T_MIN, occ.data_ptr(),
            wl._stream(od)), "any")
        return occ


def _bind_first_port(lib):
    """The first port's C interface: the emission per item."""
    c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dcrt_pair_emit.argtypes = [c_p, c_p, c_i, c_p, c_p, c_p, c_i, c_i,
                                   c_f, c_p, c_p]
    lib.dcrt_pair_closest.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p, c_p,
                                      c_i, c_p, c_p, c_i, c_f] + [c_p] * 9
    lib.dcrt_pair_any.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p, c_p, c_i,
                                  c_p, c_p, c_i, c_f, c_p, c_p]
    for fn in (lib.dcrt_pair_emit, lib.dcrt_pair_closest, lib.dcrt_pair_any):
        fn.restype = ctypes.c_int


def _build(parent, tables):
    """name -> (_Variant, built library); the two nvcc runs go in
    parallel."""
    from ..utils.cuda_build import load_library

    with ThreadPoolExecutor(2) as pool:
        new = pool.submit(ps.kernels)
        old = parent and pool.submit(
            load_library, "pairsweep.cu", ps._NVCC_EXTRA,
            csrc=os.path.abspath(parent), name="pairsweep_parent")
    out = {}
    if old:
        built = old.result()
        package = hasattr(built.lib, "dcrt_pair_resources")
        (ps.bind if package else _bind_first_port)(built.lib)
        out["parent"] = (_Variant(built.lib, tables, package), built)
    out["new"] = (_Variant(new.result().lib, tables, True), new.result())
    return out


def _in_turns(runs, reps):
    """Each run timed in turns (the order, then reversed), reps launches a
    turn."""
    order = list(runs)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        turns[name].append(common.timed(runs[name], reps))
    return order + order[::-1], turns


def _timing(runs, reps, entry, bnd):
    order, turns = _in_turns(runs, reps)
    dev_ms = {name: common.kernel_ms(run, reps, entry)
              for name, run in runs.items()}
    return dict(order=order, reps=reps, ms=turns,
                mean_ms={n: sum(v) / len(v) for n, v in turns.items()},
                kernel_ms=dev_ms, bound=bnd,
                share={n: t and bnd[0] / t for n, t in dev_ms.items()})


def grid_sets(device, names=SETS):
    """(arrays, tables, {name: (o, d, t_max)}): sphere_grid(12, 12) on
    the device and phase 2g's ray sets (with the camera's)."""
    from ..core.types import to_device
    from ..scene.presets import sphere_grid
    from ..scene.scene import flatten_scene

    scene, cam = sphere_grid(12, 12)
    arrays, _ = flatten_scene(scene, device)
    tables = wl.scene_tables(arrays)
    sets = common.grid_ray_sets(np.random.default_rng(SEED), tables,
                                to_device(cam, device), device, names=names)
    return arrays, tables, sets


def _bits(a, b):
    """Elements whose bits differ, over the fields of two tuples (or two
    tensors)."""
    if isinstance(a, torch.Tensor):
        return common.bit_diff(a, b)
    return {common.SWEEP_FIELDS[i]: common.bit_diff(x, y)
            for i, (x, y) in enumerate(zip(a, b))}


def _any_bad(d):
    return any(_any_bad(v) for v in d.values()) if isinstance(d, dict) \
        else d != 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory of an earlier pairsweep.cu")
    ap.add_argument("--sets", default=",".join(SETS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pair_ab: no CUDA device", file=sys.stderr)
        return 1
    names = args.sets.split(",")
    if set(names) - set(SETS):
        ap.error(f"--sets: pick from {SETS}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    arrays, tables, sets = grid_sets(dev, names)
    variants = _build(args.parent, tables)
    for name, (var, built) in variants.items():
        rep = dict(variant=name, build_s=built.seconds,
                   ptxas=ptxas_report(built.log))
        if name == "new":
            rep["resources"] = ps.resources()
        print("pair-ab-build", json.dumps(rep))
    new = variants["new"][0]
    bad = []
    for case in names:
        o, d, t_max = sets[case]
        r = o.shape[0]
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        texp = wl.scene_exit(tables, od)
        cap_c = wl._window(wl._float_bits(texp) | wl._LOWM)
        idx = common.spread_blocks(r, TWIN_BLOCKS, dev, wl.RB)
        for kind, tm, cap in (("closest", tm_c, cap_c), ("any", tm_a, tm_a)):
            items = wl.phases(tables, od, tm)
            grid = new.emit(items, od, cap)
            emit_diff = dict(twin=common.bit_diff(grid, ps.emit_pairs_torch(
                tables, items, od, cap, T_MIN)))
            if "parent" in variants:
                emit_diff["parent"] = common.bit_diff(
                    grid, variants["parent"][0].emit(items, od, cap))
            it, lane = torch.nonzero(grid, as_tuple=True)
            del grid
            pairs = ps.pair_list(tables, items, it, lane)
            sub = pair_subset(tables, items, it, lane, idx)
            del it, lane
            if _any_bad(emit_diff):
                bad.append((case, kind, "emit"))
            runs = {name: (lambda v=v: v.emit(items, od, cap))
                    for name, (v, _) in variants.items()}
            for wt in (False, True):
                # the closest cast's census once, with the Baldwin-Weber test
                if kind == "any" or not wt:
                    census = pair_census(
                        tables, items, pairs, od, cap, T_MIN, r,
                        tm if kind == "any" else None, wt,
                        texp if kind == "closest" else None)
                    print("pair-census", json.dumps(dict(
                        set=case, kind=kind, watertight=wt, **census)))
                if kind == "closest":
                    out = new.closest(pairs, od, texp, wt)
                    ks = new.closest(sub, od, texp, wt)
                    twin = _bits(ks, ps.pair_sweep_closest_torch(
                        tables, sub, od, texp, T_MIN, wt))
                    cast = ps.pair_closest(arrays, o, d, T_MIN, wt)
                    ref = wl.worklist_closest(arrays, o, d, T_MIN, wt)
                    vs_wl = {f: common.bit_diff(a, b) for f, a, b in zip(
                        common.SWEEP_FIELDS[1:7], cast, ref)}
                    diffs = dict(twin=twin, worklist=vs_wl,
                                 model=_bits(ks, closest_replay(
                                     tables, sub, od, texp, T_MIN, wt)))
                    if "parent" in variants:
                        diffs["parent"] = _bits(out, variants["parent"][0]
                                                .closest(pairs, od, texp, wt))
                    sweep_runs = {name: (lambda v=v: v.closest(
                        pairs, od, texp, wt))
                        for name, (v, _) in variants.items()}
                    iters_p = out[7]
                else:
                    out = new.any(pairs, od, tm, wt)
                    twin = _bits(new.any(sub, od, tm, wt),
                                 ps.pair_sweep_any_torch(tables, sub, od, tm,
                                                         T_MIN, wt))
                    vs_wl = common.bit_diff(
                        ps.pair_any(arrays, o, d, t_max, T_MIN, wt),
                        wl.worklist_any(arrays, o, d, t_max, T_MIN, wt))
                    diffs = dict(twin=twin, worklist=vs_wl)
                    if "parent" in variants:
                        diffs["parent"] = _bits(out, variants["parent"][0]
                                                .any(pairs, od, tm, wt))
                    sweep_runs = {name: (lambda v=v: v.any(pairs, od, tm,
                                                           wt))
                                  for name, (v, _) in variants.items()}
                    iters_p = None
                if _any_bad(diffs):
                    bad.append((case, kind, wt, "sweep"))
                eb, sb = pair_bounds(tables, items, pairs, od.shape[1], wt,
                                     kind, iters_p, census)
                head = dict(set=case, kind=kind, rays=r,
                            items=items.sup.shape[0],
                            pairs=pairs.ray.shape[0])
                if not wt:   # the emission does not depend on the test
                    print("pair-ab", json.dumps(dict(
                        head, row=15, emit_diff=emit_diff,
                        **_timing(runs, args.reps, "emit_kernel", eb))))
                print("pair-ab", json.dumps(dict(
                    head, row=16 if kind == "closest" else 17,
                    watertight=wt, diffs=diffs,
                    **_timing(sweep_runs, args.reps, f"pair_{kind}_kernel",
                              sb))))
            del pairs, sub
    if bad:
        print(f"pair_ab: failed checks: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
