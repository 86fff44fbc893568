"""A/B of the work-list sweeps' warp-walk kernels on one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.worklist_ab \
        [--parent DIR] [--rows ROWS] [--reps N]

Times, in turns, the kernels of `csrc/worklist.cu` that walk a ray
block's items by warps, Baldwin-Weber and watertight:

- `grouped` (kernel rows 11-12): `closest_grouped_kernel` and
  `any_grouped_kernel` on the five ray sets of `chip_smoke.py` phase 2c
  over `sphere_grid(12, 12)` (211,972 triangles; `ray_sets`, seed
  20261018): 1,048,576 tiled camera rays, 1,048,576 random rays from
  inside the scene box, 1,048,576 shadow rays towards the lamp, the
  random set in `ray_sort_key` order and a pool-sized (2^18) sorted set;
  the per-ray sweeps `sweep_closest` / `sweep_any` beside them;
- `ray` (row 9): the per-ray closest sweep `closest_ray_kernel` on the
  same five sets;
- `inst` (row 13): the same kernel on instanced tables, on the four sets
  of phase 2d over `sphere_grid(27, 27)` (1,073,092 triangles; seed
  20261019): camera, shadow, random sorted and the sorted 2^18 pool;
- `ray_any` (row 10): the per-ray any-hit sweep `any_ray_kernel` on the
  five sets of `ray`, each with its per-ray t_max;
- `inst_any` (row 14): the same kernel on instanced tables, on the four
  sets of `inst`;
- `cull` and `refine` (rows 7 and 8): `cull_kernel` on the hyper boxes
  and `refine_kernel` on the items the hyper cull admits, on both grids
  (`sphere_grid(12, 12)`: 64 hypers of 8; `sphere_grid(27, 27)`: 183 of
  16) at the main path's shapes: camera rays, the sorted random set (the
  megakernel's sorted bounce casts) and the sorted 2^18 pool, each with
  the closest casts' t_max, the shadow set with its own (the shadow
  casts), and small casts of 1, 2, 4 and 32 ray blocks spread over the
  shadow set (`SMALL_BLOCKS`, as an alpha recast pass or a late bounce
  casts). Each line gives the rays, ray blocks, boxes or items, the
  turns, each variant's kernel time by the profiler (`kernel_ms`: small
  casts launch faster than the host can issue them, so CUDA events
  around their turns time the host) and the bound
  (`tools.common.cull_bound` / `refine_bound`) with its share of that
  time.

`--rows` picks some of them (comma-separated; default all). Variants:

- `parent`: `--parent DIR`'s `worklist.cu` with its headers, an earlier
  version of the source with the package's C interface, built under the
  library name worklist_parent. A source without `entry_min_list` has
  the first refine, whose entry takes each item's block
  (`_bind_parent`);
- `new`: the package's build of the source.

Each is timed with CUDA events, the mean of `reps` (default 5) launches
after a warm-up, in turns: the variants in order, then in reverse
(parent, new, new, parent; the grouped row also the per-ray sweep). A
line per (row, set, test, kind) gives the turns and their mean. Every
variant must equal `new` in every field of the sweep state (`iters`
included: without a cap the walks count the same; any-hit: `occ`),
`new` its twin in every field on 64 ray blocks spread over the set
(rows 9, 10, 13 and 14), and the grouped kernels the per-ray sweep in
the hit fields; the culls' outputs must equal the twins' and each
other's bit for bit on every set (rows 7 and 8); the tool exits non-zero
otherwise.
Prints the card's name and power limit first, then per built variant
its sweep kernels' and culls' ptxas lines and (`new`) the warp-walk
kernels' and the culls' resources (resident blocks per SM, registers,
shared and spill bytes).
Needs a CUDA device; with none it exits non-zero.

`ray_sets`, `inst_ray_sets`, the censuses (`closest_census`,
`any_census`, `ray_census`), their summaries, `ptxas_report`,
`cull_ptxas_report` and `cull_refine_diffs` serve `chip_smoke.py`
phases 1, 2b, 2c and 2d too: the censuses walk the
twins' own steps and count the (item, warp) pairs of the warp walks;
`padding_iters` walks the per-ray twin the same way and counts what a
vote per 1024-ray block, the first per-ray kernels', adds to `iters`.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..accel import worklist as wl
from ..core.types import to_device
from ..scene.presets import sphere_grid
from ..scene.scene import flatten_scene
from .common import (
    bit_diff,
    cull_bound,
    grid_ray_sets,
    kernel_ms,
    refine_bound,
    spread_blocks,
    sweep_diffs,
    timed,
)

GRID = (12, 12)
INST_GRID = (27, 27)
SEED = 20261018
INST_SEED = 20261019
INST_SETS = ("camera", "shadow", "random_sorted", "pool_sorted")
TWIN_BLOCKS = 64
T_MIN = 1e-4
ROWS = ("grouped", "ray", "inst", "ray_any", "inst_any", "cull", "refine")
CULL_SETS = ("camera", "random_sorted", "pool_sorted", "shadow")
SMALL_BLOCKS = (1, 2, 4, 32)


def ray_sets(tables, cam, device, seed=SEED):
    """The five ray sets of the sphere grid, name -> (o, d, t_max)
    (`tools.common.grid_ray_sets`)."""
    return grid_ray_sets(np.random.default_rng(seed), tables, cam, device)


def inst_ray_sets(tables, cam, device, seed=INST_SEED):
    """The four ray sets of `sphere_grid(27, 27)` (phase 2d's)."""
    return grid_ray_sets(np.random.default_rng(seed), tables, cam, device,
                         half=21.0, shadow_half=20.0, names=INST_SETS)


def _walk_census(step, tables, items, od, texp, t_min, watertight,
                 gap=None):
    """Walk a closest twin's steps (`step`: `wl.closest_step` or
    `wl.grouped_closest_step`) over one cast and count its (item, warp)
    pairs: `pairs` (every warp of a block against every item of its
    block), `block_voted` (passing the first per-ray sweep's block vote),
    `warp_voted` (the warp vote), `admitted` (then the super-box
    admission, `wl.warp_admitted`) and `entered`, the (ray, item) pairs
    whose fine cull entered a child (where the instanced kernel moves the
    ray to local space). With gap ((2, Rp) int32) also add `_vote_gap`'s
    counts of each step. Returns (the walk's state, `wl._Best`, and the
    counts)."""
    rp, n = od.shape[1], Counter()
    st = wl._Best(texp)
    for lo in range(0, rp, wl.TWIN_RAY_CHUNK):
        for rays, item in wl._ray_steps(items, lo,
                                        min(rp, lo + wl.TWIN_RAY_CHUNK)):
            voted, v_item = wl._voted(items, rays, item, st.best, wl.GL)
            block, b_item = wl._voted(items, rays, item, st.best)
            sup = items.sup[v_item].long()
            cap = wl._window(st.best[voted])
            adm = wl.warp_admitted(tables.abox[sup], od[:, voted], cap, t_min)
            enter, _ = wl._fine_cull(tables.cbox3[sup], od[:, voted], cap,
                                     t_min)
            n.update(pairs=rays.numel() // wl.GL,
                     block_voted=block.numel() // wl.GL,
                     warp_voted=voted.numel() // wl.GL,
                     admitted=int(adm.sum()) // wl.GL,
                     entered=int(enter.any(1).sum()))
            if gap is not None:
                _vote_gap(tables, items, od, t_min, st, voted, block, b_item,
                          gap)
            step(tables, items, od, t_min, watertight, st, rays, item)
    return st, dict(n)


def _vote_gap(tables, items, od, t_min, st, warp, block, b_item, gap):
    """Per ray of `block` (a step's rays that the block vote keeps, against
    their items b_item) that the warp vote drops (its rays `warp`): add
    the padding children (gap[0]) and the real children (gap[1]) that its
    fine cull enters under its window before the step."""
    drop = torch.ones(od.shape[1], dtype=torch.bool, device=od.device)
    drop[warp] = False
    keep = drop[block]
    rays, box = block[keep], tables.cbox3[items.sup[b_item[keep]].long()]
    enter, _ = wl._fine_cull(box, od[:, rays], wl._window(st.best[rays]),
                             t_min)
    pad = box[..., 0] > box[..., 3]     # inverted: a padding child
    gap[0].index_add_(0, rays, (enter & pad).sum(1, dtype=torch.int32))
    gap[1].index_add_(0, rays, (enter & ~pad).sum(1, dtype=torch.int32))


def grouped_census(tables, items, od, texp, t_min, watertight):
    """The grouped closest walk of one cast by the twin's own steps
    (`wl.grouped_closest_step`): (its sweep state, which is
    `wl.sweep_closest_grouped_torch`'s, and the counts of
    `_walk_census`)."""
    st, n = _walk_census(wl.grouped_closest_step, tables, items, od, texp,
                         t_min, watertight)
    return st.state(tables.ctab if watertight else tables.bwtab,
                    watertight), n


def closest_census(tables, items, od, texp, t_min, watertight):
    """The counts of `_walk_census` of the grouped closest walk of one
    cast."""
    return grouped_census(tables, items, od, texp, t_min, watertight)[1]


def ray_census(tables, items, od, texp, t_min, watertight):
    """The per-ray closest walk of one cast (world-soup or instanced
    tables) by the twin's own steps: (its sweep state, which is
    `wl.sweep_closest_torch`'s, and the counts of `_walk_census`)."""
    st, n = _walk_census(wl.closest_step, tables, items, od, texp, t_min,
                         watertight)
    tab = tables.ctab if watertight else tables.bwtab
    return st.state(tab, watertight, tables.inst_rows is not None), n


def any_census(tables, items, od, tm, t_min, watertight):
    """The per-ray any-hit walk of one cast (world-soup or instanced
    tables) by the twin's own steps (`wl.any_step`): (its occlusion,
    which is `wl.sweep_any_torch`'s, and the counts of its (item, warp)
    pairs): `pairs` (every warp of a block against every item of its
    block), `visited` (some ray of the warp not yet done: occluded, or
    from the start where t_max <= t_min), `admitted` (then the super-box
    admission, rays that are done capped at -BIG) and `entered`, the
    (ray, item) pairs whose fine cull entered a child (where the
    instanced kernel moves the ray to instance space). The grouped
    any-hit walk visits and admits the same pairs, but keeps rays with
    t_max <= t_min live (the ray sets here have none)."""
    rp, n = od.shape[1], Counter()
    occ = torch.zeros(rp, dtype=torch.bool, device=od.device)
    dead = ~(tm > t_min)
    for lo in range(0, rp, wl.TWIN_RAY_CHUNK):
        for rays, item in wl._ray_steps(items, lo,
                                        min(rp, lo + wl.TWIN_RAY_CHUNK)):
            done = (occ | dead)[rays]
            sup = items.sup[item].long()
            cap = torch.where(done, -wl.BIG, tm[rays])
            adm = torch.nonzero(wl.warp_admitted(tables.abox[sup],
                                                 od[:, rays], cap,
                                                 t_min))[:, 0]
            enter, _ = wl._fine_cull(tables.cbox3[sup[adm]], od[:, rays[adm]],
                                     cap[adm], t_min)
            n.update(pairs=rays.numel() // wl.GL,
                     visited=int((~done).view(-1, wl.GL).any(1).sum()),
                     admitted=adm.numel() // wl.GL,
                     entered=int(enter.any(1).sum()))
            wl.any_step(tables, items, od, tm, t_min, watertight, occ, rays,
                        item)
    return occ, dict(n)


def _share(c, key):
    return c.get(key, 0) / max(1, c.get("pairs", 0))


def census_summary(closest, any_, rp):
    """Per-ray and per-pair figures of the warp walks from the censuses
    (`closest_census` of the grouped closest walk, `any_census` of the
    any-hit walk) of one cast of rp padded rays. Fine-cull slab tests per
    ray: 32 for each pair the warp admits (the first closest designs: 32
    for each pair of an item that passed the block vote)."""
    warps = rp // wl.GL
    return dict(
        pairs_per_warp=closest.get("pairs", 0) / warps,
        closest_block_voted_share=_share(closest, "block_voted"),
        closest_warp_voted_share=_share(closest, "warp_voted"),
        closest_admitted_share=_share(closest, "admitted"),
        fine_tests_per_ray=wl.SUPER * closest.get("admitted", 0) / warps,
        fine_tests_per_ray_block_walk=wl.SUPER
        * closest.get("block_voted", 0) / warps,
        **any_census_summary(any_, rp))


def any_census_summary(counts, rp):
    """Per-ray and per-pair figures of the any-hit warp walk from its
    census (`any_census`) of one cast of rp padded rays: the shares of
    (item, warp) pairs visited and admitted, fine-cull slab tests per ray
    (32 for each admitted pair; the block walk of the first per-ray
    kernel: 32 for each pair) and items entered per ray."""
    warps = rp // wl.GL
    return dict(
        any_pairs_per_warp=counts.get("pairs", 0) / warps,
        any_visited_share=_share(counts, "visited"),
        any_admitted_share=_share(counts, "admitted"),
        any_fine_tests_per_ray=wl.SUPER * counts.get("admitted", 0) / warps,
        any_fine_tests_per_ray_block_walk=wl.SUPER * counts.get("pairs", 0)
        / warps,
        any_entered_items_per_ray=counts.get("entered", 0) / rp)


def ray_census_summary(counts, rp):
    """Per-ray and per-pair figures of the per-ray closest walk from its
    census (`ray_census`) of one cast of rp padded rays: the shares of
    (item, warp) pairs past the block vote, the warp vote and the
    admission; fine-cull slab tests per ray (32 for each admitted pair;
    the block walk of the first per-ray kernel: 32 for each pair of an
    item its block voted for); items entered per ray."""
    warps = rp // wl.GL
    return dict(
        pairs_per_warp=counts.get("pairs", 0) / warps,
        block_voted_share=_share(counts, "block_voted"),
        warp_voted_share=_share(counts, "warp_voted"),
        admitted_share=_share(counts, "admitted"),
        fine_tests_per_ray=wl.SUPER * counts.get("admitted", 0) / warps,
        fine_tests_per_ray_block_walk=wl.SUPER
        * counts.get("block_voted", 0) / warps,
        entered_items_per_ray=counts.get("entered", 0) / rp)


def padding_iters(tables, items, od, texp, t_min, watertight):
    """The per-ray closest twin's walk of one cast (warp vote), and what
    the first per-ray kernels' vote per 1024-ray block adds to it:
    (the twin's sweep state, gap (2, Rp) int32). A padding child's
    inverted box reads to a slab test as the cube [-1, 1]^3, which may
    lie outside its super's box, so a vote on the super's entry distance
    is not exact for it. Per ray, gap[0] counts the padding children its
    fine cull enters in the items that its block votes for and its warp
    does not: empty clusters that the block walk sweeps (so its `iters`
    is the twin's plus gap[0]) and that change nothing else. gap[1]
    counts the real children entered there: none without a t_cap, where
    the vote skips only items whose real children the ray cannot enter
    (`block_vote_diffs` holds a block-vote state to this)."""
    gap = torch.zeros(2, od.shape[1], dtype=torch.int32, device=od.device)
    st, _ = _walk_census(wl.closest_step, tables, items, od, texp, t_min,
                         watertight, gap)
    tab = tables.ctab if watertight else tables.bwtab
    return st.state(tab, watertight, tables.inst_rows is not None), gap


def block_vote_diffs(block, warp, gap):
    """Rays where a sweep state of the block vote (block) and one of the
    warp vote (warp) of the same cast disagree, per field, beyond the
    padding clusters of `padding_iters` (gap): every field but `iters`
    must be equal and `iters` exceed warp's by exactly gap[0]; `real`
    counts rays that entered a real child in an item only the block
    voted for."""
    out = sweep_diffs(block, warp, 7)
    out["iters"] = int(((block[7] - warp[7]) != gap[0]).sum())
    out["real"] = int((gap[1] != 0).sum())
    return out


def _short(entry):
    """Short name (one of `wl.WARP_KERNELS`) of a warp-walk sweep
    kernel's mangled entry, or None."""
    test = "wt" if "RawWatertight" in entry else "bw"
    for kind in ("closest", "any"):
        if f"{kind}_ray_kernel" in entry:
            # the second template argument, kInst, mangles as Lb1E
            return f"{'inst' if 'Lb1E' in entry else 'ray'}_{kind}_{test}"
    for kind in ("closest", "any"):
        if f"{kind}_grouped_kernel" in entry:
            return f"{kind}_{test}"
    return None


def _cull_short(entry):
    """Short name (one of `wl.CULL_KERNELS`) of a cull kernel's mangled
    entry, or None."""
    for name in wl.CULL_KERNELS:
        if f"{name}_kernel" in entry:
            return name
    return None


def ptxas_report(log, short=_short):
    """The ptxas lines (`nvcc -Xptxas -v`) of the kernels `short` names:
    {short name: {registers, smem, stack, spill_stores, spill_loads}},
    short names those of `wl.WARP_KERNELS` (`_short`, the sweeps) or of
    `wl.CULL_KERNELS` (`_cull_short`)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = short(m.group(1))
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        for name, pat in (("registers", r"Used (\d+) registers"),
                          ("smem", r"(\d+) bytes smem"),
                          ("stack", r"(\d+) bytes stack frame"),
                          ("spill_stores", r"(\d+) bytes spill stores"),
                          ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                out[cur][name] = int(m.group(1))
    return out


def cull_ptxas_report(log):
    """`ptxas_report` of the culls, under the names of
    `wl.CULL_KERNELS`."""
    return ptxas_report(log, _cull_short)


def _bind_parent(lib, source):
    """Bind a parent's build (its `worklist.cu` text: source) as the
    package's C interface; a source without `entry_min_list` has the
    first refine, which takes each item's block (int32) where the
    package's takes per-block item offsets (`_refine_call`)."""
    wl.bind(lib)
    if "entry_min_list" not in source:
        c_p, c_i = ctypes.c_void_p, ctypes.c_int
        lib.dcrt_wl_refine.argtypes = [c_p, c_i, c_p, c_p, c_i, c_p, c_p,
                                       c_i, c_i, c_p, c_p]
        lib.dcrt_wl_refine.item_blocks = True


def _entries(lib):
    return dict(ray=lib.dcrt_wl_closest, inst=lib.dcrt_wl_closest_inst,
                grouped_closest=lib.dcrt_wl_closest_grouped,
                grouped_any=lib.dcrt_wl_any_grouped,
                ray_any=lib.dcrt_wl_any, inst_any=lib.dcrt_wl_any_inst,
                cull=lib.dcrt_wl_cull, refine=lib.dcrt_wl_refine)


def _build(parent):
    """name -> (entries, built library) of the package's kernels and,
    given a directory, the parent's. The two nvcc runs go in parallel."""
    from ..utils.cuda_build import load_library

    with ThreadPoolExecutor(2) as pool:
        new = pool.submit(wl.kernels)
        old = parent and pool.submit(
            load_library, "worklist.cu", wl._NVCC_EXTRA,
            csrc=os.path.abspath(parent), name="worklist_parent")
    out = {}
    if old:
        built = old.result()
        with open(os.path.join(parent, "worklist.cu")) as f:
            _bind_parent(built.lib, f.read())
        out["parent"] = (_entries(built.lib), built)
    out["new"] = (_entries(new.result().lib), new.result())
    return out


def _closest_run(fn, tables, items, od, texp, wt):
    def run():
        err, out = wl._launch_closest(fn, tables, items, od, texp, T_MIN, wt)
        wl._raise_on(err, fn.__name__)
        return out
    return run


def _any_run(fn, tables, items, od, tm, wt):
    def run():
        err, occ = wl._launch_any(fn, tables, items, od, tm, T_MIN, wt)
        wl._raise_on(err, fn.__name__)
        return occ
    return run


def _cull_call(fn, boxes, od, tm):
    """A run of a build's cull entry fn: (n, 8) boxes x rays -> (nb, n)."""
    def run():
        out = torch.empty((od.shape[1] // wl.RB, boxes.shape[0]),
                          dtype=torch.float32, device=od.device)
        wl._raise_on(fn(boxes.data_ptr(), boxes.shape[0], od.data_ptr(),
                        tm.data_ptr(), od.shape[1], wl.RB, out.data_ptr(),
                        wl._stream(od)), "cull")
        return out
    return run


def _refine_call(fn, hsup, blk, hyp, od, tm):
    """A run of a build's refine entry fn over the (block, hyper) items:
    -> (n_items, hs). The package's takes per-block item offsets, a first
    refine (`_bind_parent`) each item's block."""
    hs, rp = hsup.shape[1], od.shape[1]
    # the index tensors live as long as the run (it holds their pointers)
    hyp32 = hyp.to(torch.int32)
    if getattr(fn, "item_blocks", False):
        index = (blk.to(torch.int32), hyp32)
        head = (hsup.data_ptr(), hs)
    else:
        index = (wl.item_segments(blk, rp // wl.RB), hyp32)
        head = (hsup.data_ptr(), hs, hsup.shape[0])

    def run():
        out = torch.empty((blk.shape[0], hs), dtype=torch.float32,
                          device=od.device)
        wl._raise_on(fn(*head, *(x.data_ptr() for x in index), blk.shape[0],
                        od.data_ptr(), tm.data_ptr(), rp, wl.RB,
                        out.data_ptr(), wl._stream(od)), "refine")
        return out
    return run


def cull_sets(sets):
    """The culls' sets of `sets` (`CULL_SETS`, then `small_k`: k ray
    blocks spread over the shadow set, k in SMALL_BLOCKS), name -> (o, d,
    t_max or None): the closest casts' t_max (BIG) on all but the shadow
    sets, which keep their own."""
    out = {name: (o, d, t_max if name == "shadow" else None)
           for name, (o, d, t_max) in sets.items() if name in CULL_SETS}
    o, d, t_max = sets["shadow"]
    for k in SMALL_BLOCKS:
        idx = spread_blocks(o.shape[0], k, o.device, wl.RB)
        out[f"small_{k}"] = (o[idx], d[idx], t_max[idx])
    return out


def cull_refine_diffs(tables, od, tm):
    """The package's hyper cull and refine against their twins on one
    cast (tables with a hyper level): bit differences of each, with the
    hypers and the items."""
    tlo_w = wl.cull_boxes_torch(tables.hbox, od, tm)
    blk, hyp, _ = wl.compact_pairs(tlo_w)
    return dict(
        hypers=int(tables.hbox.shape[0]), items=int(blk.shape[0]),
        cull_bits=bit_diff(wl.cull_boxes(tables.hbox, od, tm), tlo_w),
        refine_bits=bit_diff(wl.refine(tables.hsup, blk, hyp, od, tm),
                              wl.refine_torch(tables.hsup, blk, hyp, od,
                                              tm)))


def _cull_row(rows, variants, tables, sets, reps, bad, grid):
    """Rows 7 and 8: every variant's cull of the hyper boxes and refine
    of the admitted items, in turns, on the culls' sets; each bit-equal
    to the twin."""
    for case, (o, d, t_max) in cull_sets(sets).items():
        od, tm, _ = wl.prep_rays(o, d, t_max)
        rp, nb = od.shape[1], od.shape[1] // wl.RB
        cast = "closest" if t_max is None else "any"
        boxes = tables.hbox
        want = wl.cull_boxes_torch(boxes, od, tm)
        blk, hyp, _ = wl.compact_pairs(want)
        lines = {}
        if "cull" in rows:
            runs = {n: _cull_call(e["cull"], boxes, od, tm)
                    for n, (e, _) in variants.items()}
            lines["cull"] = (runs, want, None,
                             dict(boxes=int(boxes.shape[0])),
                             cull_bound(rp, boxes.shape[0], wl.RB))
        if "refine" in rows and blk.numel():
            runs = {n: _refine_call(e["refine"], tables.hsup, blk, hyp, od,
                                    tm)
                    for n, (e, _) in variants.items()}
            lines["refine"] = (
                runs, wl.refine_torch(tables.hsup, blk, hyp, od, tm),
                int(blk.shape[0]), dict(hs=int(tables.hsup.shape[1])),
                refine_bound(rp, tables.hsup, blk.shape[0], wl.RB))
        for row, (runs, twin, items, size, bnd) in lines.items():
            check = {n: bit_diff(run(), twin) for n, run in runs.items()}
            if any(check.values()):
                bad.append((row, grid, case, check))
            order, turns = _in_turns(runs, reps)
            dev_ms = {n: kernel_ms(run, reps, f"{row}_kernel")
                      for n, run in runs.items()}
            line = _line(row, case, None, cast, o.shape[0], items, order,
                         turns, grid=grid, ray_blocks=nb, **size,
                         kernel_ms=dev_ms, bound=bnd, bits_vs_twin=check,
                         share={n: t and bnd[0] / t
                                for n, t in dev_ms.items()})
            print("worklist-ab", json.dumps(line))


def _in_turns(runs, reps):
    """name -> the ms of each turn: the runs in order, then in reverse."""
    order = list(runs)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        turns[name].append(timed(runs[name], reps))
    return order + order[::-1], turns


def _line(row, case, wt, kind, rays, items, order, turns, **extra):
    return dict(row=row, case=case, watertight=wt, kind=kind, rays=rays,
                items=items, order=order, ms=turns,
                mean_ms={n: sum(t) / len(t) for n, t in turns.items()},
                **extra)


def _prepared(tables, o, d, t_max):
    od, tm_c, _ = wl.prep_rays(o, d)
    _, tm_a, _ = wl.prep_rays(o, d, t_max)
    return (od, tm_a, wl.scene_exit(tables, od), wl.phases(tables, od, tm_c),
            wl.phases(tables, od, tm_a))


def _grouped_row(variants, tables, sets, reps, bad):
    for case, (o, d, t_max) in sets.items():
        od, tm_a, texp, it_c, it_a = _prepared(tables, o, d, t_max)
        for wt in (False, True):
            runs_c = {n: _closest_run(e["grouped_closest"], tables, it_c, od,
                                      texp, wt)
                      for n, (e, _) in variants.items()}
            runs_a = {n: _any_run(e["grouped_any"], tables, it_a, od, tm_a,
                                  wt)
                      for n, (e, _) in variants.items()}
            runs_c["per_ray"] = lambda: wl.sweep_closest(
                tables, it_c, od, texp, T_MIN, wt)
            runs_a["per_ray"] = lambda: wl.sweep_any(tables, it_a, od, tm_a,
                                                     T_MIN, wt)
            want_c, want_a = runs_c["new"](), runs_a["new"]()
            check = {}
            for name in runs_c:
                n = 7 if name == "per_ray" else 8
                check[name] = dict(
                    closest=sweep_diffs(runs_c[name](), want_c, n),
                    occ=int((runs_a[name]() != want_a).sum()))
                if any(check[name]["closest"].values()) \
                        or check[name]["occ"]:
                    bad.append(("grouped", case, wt, name))
            for kind, runs, it in (("closest", runs_c, it_c),
                                   ("any", runs_a, it_a)):
                order, turns = _in_turns(runs, reps)
                extra = dict(diffs_vs_new=check) if kind == "closest" else {}
                print("worklist-ab", json.dumps(_line(
                    "grouped", case, wt, kind, o.shape[0],
                    int(it.seg[-1]), order, turns, **extra)))


def _ray_row(row, variants, tables, sets, reps, bad):
    """Rows 9 and 13: the per-ray closest sweep of every variant, in turns;
    equality with `new` on the whole set, and of `new` with its twin on
    TWIN_BLOCKS spread blocks."""
    for case, (o, d, t_max) in sets.items():
        od, _, texp, it_c, _ = _prepared(tables, o, d, t_max)
        idx = spread_blocks(o.shape[0], TWIN_BLOCKS, o.device, wl.RB)
        od_s, _, texp_s, it_s, _ = _prepared(tables, o[idx], d[idx],
                                             t_max[idx])
        for wt in (False, True):
            runs = {n: _closest_run(e[row], tables, it_c, od, texp, wt)
                    for n, (e, _) in variants.items()}
            want = runs["new"]()
            check = {n: sweep_diffs(run(), want) for n, run in runs.items()}
            new_s = _closest_run(variants["new"][0][row], tables, it_s, od_s,
                                 texp_s, wt)()
            check["twin"] = sweep_diffs(
                new_s, wl.sweep_closest_torch(tables, it_s, od_s, texp_s,
                                              T_MIN, wt))
            for name, diff in check.items():
                if any(diff.values()):
                    bad.append((row, case, wt, name))
            order, turns = _in_turns(runs, reps)
            print("worklist-ab", json.dumps(_line(
                row, case, wt, "closest", o.shape[0], int(it_c.seg[-1]),
                order, turns, twin_rays=int(idx.numel()),
                diffs_vs_new=check,
                iters_per_ray=float(want[7][:o.shape[0]].float().mean()))))


def _any_row(row, variants, tables, sets, reps, bad):
    """Rows 10 and 14: the per-ray any-hit sweep of every variant, in
    turns; `occ` equal to `new`'s on the whole set, and `new`'s to its
    twin's on TWIN_BLOCKS spread blocks."""
    for case, (o, d, t_max) in sets.items():
        od, tm_a, _, _, it_a = _prepared(tables, o, d, t_max)
        idx = spread_blocks(o.shape[0], TWIN_BLOCKS, o.device, wl.RB)
        od_s, tm_s, _, _, it_s = _prepared(tables, o[idx], d[idx],
                                           t_max[idx])
        for wt in (False, True):
            runs = {n: _any_run(e[row], tables, it_a, od, tm_a, wt)
                    for n, (e, _) in variants.items()}
            want = runs["new"]()
            check = {n: int((run() != want).sum()) for n, run in runs.items()}
            new_s = _any_run(variants["new"][0][row], tables, it_s, od_s,
                             tm_s, wt)()
            check["twin"] = int((new_s != wl.sweep_any_torch(
                tables, it_s, od_s, tm_s, T_MIN, wt)).sum())
            for name, diff in check.items():
                if diff:
                    bad.append((row, case, wt, name))
            order, turns = _in_turns(runs, reps)
            print("worklist-ab", json.dumps(_line(
                row, case, wt, "any", o.shape[0], int(it_a.seg[-1]), order,
                turns, twin_rays=int(idx.numel()), occ_diffs_vs_new=check,
                occluded=float(want[:o.shape[0]].float().mean()))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory of an earlier worklist.cu")
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("worklist_ab: no CUDA device", file=sys.stderr)
        return 1
    rows = args.rows.split(",")
    if set(rows) - set(ROWS):
        ap.error(f"--rows: pick from {ROWS}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    variants = _build(args.parent)
    for name, (_, built) in variants.items():
        rep = dict(variant=name, build_s=built.seconds,
                   ptxas=ptxas_report(built.log),
                   cull_ptxas=cull_ptxas_report(built.log))
        if name == "new":
            rep["resources"] = wl.warp_resources()
            rep["cull_resources"] = wl.cull_resources()
        print("worklist-ab-build", json.dumps(rep))
    bad = []
    culls = [r for r in rows if r in ("cull", "refine")]
    if set(rows) & {"grouped", "ray", "ray_any", "cull", "refine"}:
        scene, cam = sphere_grid(*GRID)
        arrays, _ = flatten_scene(scene, dev)
        tables = wl.scene_tables(arrays)
        sets = ray_sets(tables, to_device(cam, dev), dev)
        if "grouped" in rows:
            _grouped_row(variants, tables, sets, args.reps, bad)
        if "ray" in rows:
            _ray_row("ray", variants, tables, sets, args.reps, bad)
        if "ray_any" in rows:
            _any_row("ray_any", variants, tables, sets, args.reps, bad)
        if culls:
            _cull_row(culls, variants, tables, sets, args.reps, bad,
                      "grid_12x12")
        del arrays, tables, sets
    if set(rows) & {"inst", "inst_any", "cull", "refine"}:
        scene, cam = sphere_grid(*INST_GRID)
        arrays, _ = flatten_scene(scene, dev)
        tables = wl.scene_tables(arrays)
        if tables.inst_rows is None:
            raise SystemExit("sphere_grid(27, 27) should use the instanced "
                             "tables")
        sets = inst_ray_sets(tables, to_device(cam, dev), dev)
        if "inst" in rows:
            _ray_row("inst", variants, tables, sets, args.reps, bad)
        if "inst_any" in rows:
            _any_row("inst_any", variants, tables, sets, args.reps, bad)
        if culls:
            _cull_row(culls, variants, tables, sets, args.reps, bad,
                      "instanced_27x27")
    if bad:
        print(f"worklist_ab: variants differ: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
