"""A/B of the clustered cull and sweeps (kernel rows 3-5) on one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.clustered_ab \
        [--parent DIR] [--reps N] [--sets SETS]

Times, in turns, `cull_kernel`, `closest_kernel` and `any_kernel` of
`csrc/clustered.cu` (the sweeps Moeller and watertight) on
`sphere_grid(12, 12)` (211,972 triangles, 16,384 clusters) and the four
ray sets of `chip_smoke.py` phase 2f (`tools.common.grid_ray_sets`, seed
20261020): `camera` (1024^2 tiled camera rays), `shadow` (2^20 rays towards the lamp, per-ray t_max),
`random_sorted` (2^20 random rays in `ray_sort_key` order) and
`pool_sorted` (2^18 such rays); t_min 1e-4.

Variants:

- `parent`: `--parent DIR`'s `clustered.cu` with its headers, built under
  the library name clustered_parent: the package's C interface where it
  exports `dcrt_cluster_resources`, else the first port's (the block
  sweep, no rows or boxes);
- `new`: the package's kernels.

Each is timed in turns (parent, new, new, parent) with CUDA events (the
mean of `reps` launches after a warm-up, default 5; 1 for a variant
whose launch takes over 50 ms) and beside them by the profiler
(`tools.common.kernel_ms`). A `clustered-ab` line per set for the cull
(`kind` "cull", `cull_bound`: the kernel's work, the reference's count
beside it) and per (set, test, kind) for the sweeps
gives the turns, their means, the kernel ms, the bounds (`cast_bounds`:
the warp walk's work, the block walk's beside it) and each variant's
share of the warp walk's. Per set a `clustered-census` line gives the
warp walk's census (`admission_census`): group boxes and clusters admitted per warp, votes
and triangle tests per ray, and the shares of the block's clusters that
the ray's own slab test and its warp enter.

The tool exits non-zero where the new kernels differ from their twins
(`sweep_closest_torch` / `sweep_any_torch` on 64 ray blocks spread over
the set) in any bit of any field; where the new casts differ from the
parent's on the whole set in a ray that is not an explained graze
(`graze_diffs`: the hit the parent found lies in a cluster whose box the
ray's own slab test misses); where the parent's cull masks differ from
the package's or from the cull twin's in any bit; or where the census
finds a cluster admitted in a group whose box its warp does not enter.
Prints the card's name and power limit first, then per built variant its
ptxas lines and (package) the kernels' resources.
Needs a CUDA device; with none it exits non-zero.

`admission_census`, `cast_bounds` and `graze_diffs` serve
`chip_smoke.py` phase 2f and the tests too; `interval_enter_signed`
models the cull's per-pair arithmetic for the tests.
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

from ..accel import clustered as cl
from ..accel.brute import _slab_test
from . import common
from .brute_ab import closest_diffs
from .worklist_ab import ptxas_report as _ptxas_report

SEED = 20261020
SETS = ("camera", "shadow", "random_sorted", "pool_sorted")
T_MIN = 1e-4
TWIN_BLOCKS = 64                 # ray blocks of a twin cast
HEAVY_MS = 50.0                  # above this a launch is timed once
LISTED = 256                     # differing rays explained one by one
# a lane's vote (clustered.cu `vote`, worklist.cuh `slab`): per axis 2
# differences, 2 products, a min and a max of them and one more each into
# the entry and the exit, then 2 comparisons
FLOPS_VOTE = 3 * 8 + 2
# the interval cull of one (ray block, cluster) pair as the reference
# computes it: per axis 4 numerator differences, 8 products, 14 min/max
# over them and 2 into the entry and exit, then 3 for enter
FLOPS_INTERVAL = 3 * 28 + 3
# the same pair as `cull_kernel` computes it: per axis whose direction
# bounds do not span zero 2 numerator differences, 4 products, a min and
# a max of them and 2 into the entry and exit (spanning axes: none), then
# 3 for enter; blocks with no reaching ray test nothing
FLOPS_SIGNED_AXIS = 10
FLOPS_ENTER = 3
CENSUS_RAYS = 1 << 18            # rays per step of the census (whole blocks)


# ---------------------------------------------------------------------------
# the census and the bounds
# ---------------------------------------------------------------------------

def interval_enter_signed(cbox, lo, hi):
    """A plain model of `cull_kernel`'s per-pair arithmetic (row 3): per
    axis whose direction bounds do not span zero, the two endpoint
    numerators chosen by the sign of the direction (min(b0, b1) - o_hi
    and max(b0, b1) - o_lo, swapped where it is negative), 2 products
    each, a min and a max; enter = (t_hi >= t_lo) & (t_hi >= 0) on blocks
    with a reaching ray (lo <= hi). (nb, C) bool for block bounds lo, hi
    (nb, 6) and boxes cbox (C, 8): `cl._interval_enter(cbox, lo, hi) &
    (lo[:, :1] <= hi[:, :1])` bit for bit (the proof is in
    csrc/clustered.cu)."""
    nb, c = lo.shape[0], cbox.shape[0]
    t_lo = torch.full((nb, c), -cl.BIG, dtype=cbox.dtype, device=cbox.device)
    t_hi = torch.full_like(t_lo, cl.BIG)
    for ax in range(3):
        o_lo, o_hi = lo[:, ax, None], hi[:, ax, None]
        d_lo, d_hi = lo[:, 3 + ax, None], hi[:, 3 + ax, None]
        i_a, i_b = cl._safe_inv(d_lo), cl._safe_inv(d_hi)
        i_lo, i_hi = torch.minimum(i_a, i_b), torch.maximum(i_a, i_b)
        spans = (d_lo <= 0.0) & (d_hi >= 0.0)
        pos = d_lo > 0.0
        b0, b1 = cbox[None, :, ax], cbox[None, :, 3 + ax]
        b_min, b_max = torch.minimum(b0, b1), torch.maximum(b0, b1)
        e_lo = torch.where(pos, b_min - o_hi, b_max - o_lo)
        e_hi = torch.where(pos, b_max - o_lo, b_min - o_hi)
        ax_lo = torch.minimum(e_lo * i_lo, e_lo * i_hi)
        ax_hi = torch.maximum(e_hi * i_lo, e_hi * i_hi)
        t_lo = torch.where(spans, t_lo, torch.maximum(t_lo, ax_lo))
        t_hi = torch.where(spans, t_hi, torch.minimum(t_hi, ax_hi))
    return (t_hi >= t_lo) & (t_hi >= 0.0) & (lo[:, 0:1] <= hi[:, 0:1])


def cull_bound(tables, cmask, gmask, o, d):
    """The cull's bounds (`tools.common.bound`) on rays o, d -> (kernel,
    reference). Operations: `kernel` counts what `cull_kernel` computes
    on this cast, per (ray block, cluster) of a block with a reaching ray
    FLOPS_SIGNED_AXIS per axis whose direction bounds do not span zero and
    FLOPS_ENTER; `reference` FLOPS_INTERVAL per (ray block, cluster), the
    count of the reference's eight products. Bytes, both: each ray (24),
    box (32) and mask byte moved once."""
    nb, cg = cmask.shape
    lo, hi = cl._block_bounds(tables, o, d)
    spans = (lo[:, 3:] <= 0.0) & (hi[:, 3:] >= 0.0)
    per_block = FLOPS_ENTER + FLOPS_SIGNED_AXIS * (~spans).sum(1)
    ops = int((per_block * (lo[:, 0] <= hi[:, 0])).sum()) * cg
    nbytes = 24 * o.shape[0] + 32 * cg + nb * (cg + gmask.shape[1])
    return (common.bound(ops, nbytes),
            common.bound(FLOPS_INTERVAL * nb * cg, nbytes))


def admission_census(tables, cmask, gmask, o, d, occ=None):
    """What the warp walks of one cast do, counted by the sweeps' rule on
    the cast's rays. Per ray: group-box votes (one per group its block
    entered), cluster-box votes (one per masked cluster of each group
    whose box its warp enters), clusters admitted for its warp (16
    triangle tests each), masked clusters its own slab test enters, and
    masked clusters (its block's). Per warp: group boxes entered and
    clusters admitted. `group_misses` counts (ray, cluster) admissions in
    a group whose box the warp does not enter (0: the group vote is
    exact). With occ (the any-hit cast's result): the any-hit walk's
    lower bound, the votes of the warps that hold a ray ending unoccluded
    (they walk to the end) and the triangle tests of those rays only."""
    r = o.shape[0]
    keys = ("group_votes", "cluster_votes", "admitted", "own", "masked",
            "warp_groups", "warp_admitted", "group_misses", "any_group_votes",
            "any_cluster_votes", "any_admitted")
    acc = {k: torch.zeros((), dtype=torch.int64, device=o.device)
           for k in keys}
    for g in range(tables.n_groups):
        rays_g = cl.group_rays(cmask, gmask, g, r)
        lo = g * cl.CLUSTER_GROUP
        for s in range(0, rays_g.shape[0], CENSUS_RAYS):
            rays = rays_g[s:s + CENSUS_RAYS]
            os_, ds = o[rays], d[rays]
            cm = cmask[rays // cl.RAY_BLOCK, lo:lo + cl.CLUSTER_GROUP].bool()
            gv = cl.warp_any(cl.ray_votes(tables.gbox[g:g + 1], os_, ds))[:, 0]
            votes = cl.ray_votes(tables.cbox[lo:lo + cl.CLUSTER_GROUP], os_,
                                 ds)
            adm = cm & cl.warp_any(votes)
            n_masked = cm.sum(1)
            first = rays % cl.WARP == 0
            acc["group_votes"] += rays.shape[0]
            acc["cluster_votes"] += (n_masked * gv).sum()
            acc["admitted"] += adm.sum()
            acc["own"] += (cm & votes).sum()
            acc["masked"] += n_masked.sum()
            acc["warp_groups"] += gv[first].sum()
            acc["warp_admitted"] += adm[first].sum()
            acc["group_misses"] += (adm & ~gv[:, None]).sum()
            if occ is not None:
                free = ~occ[rays]
                walks = cl.warp_any(free[:, None])[:, 0]
                acc["any_group_votes"] += walks.sum()
                acc["any_cluster_votes"] += (n_masked * (gv & walks)).sum()
                acc["any_admitted"] += (adm & free[:, None]).sum()
    out = {k: int(v) for k, v in acc.items()}
    warps = -(-r // cl.WARP)
    blocks = cmask.shape[0]
    warps_of = torch.full((blocks,), cl.RAY_BLOCK // cl.WARP,
                          dtype=torch.int64, device=o.device)
    warps_of[-1] = -(-(r - (blocks - 1) * cl.RAY_BLOCK) // cl.WARP)
    entered = gmask.sum(1, dtype=torch.int64)
    out.update(
        rays=r, warps=warps,
        clusters_per_block=float(cmask.sum()) / blocks,
        groups_per_block=float(entered.sum()) / blocks,
        group_boxes_per_warp=out["warp_groups"] / warps,
        admitted_per_warp=out["warp_admitted"] / warps,
        votes_per_ray=(out["group_votes"] + out["cluster_votes"]) / r,
        triangle_tests_per_ray=cl.CLUSTER_SIZE * out["admitted"] / r,
        block_triangle_tests_per_ray=cl.CLUSTER_SIZE * out["masked"] / r,
        own_share=out["own"] / max(1, out["masked"]),
        warp_share=out["admitted"] / max(1, out["masked"]),
        group_box_share=out["warp_groups"] / max(
            1, int((warps_of * entered).sum())))
    return out


def cast_bounds(tables, cmask, gmask, o, d, occ, census):
    """The bounds of one clustered cast of rays o, d
    (`tools.common.bound`): `cull` / `cull_reference` (`cull_bound`: the
    kernel's work, the reference's count); `closest` / `any`,
    the warp walks' work from the census: FLOPS_VOTE per vote and
    FLOPS_MOELLER per triangle test (any-hit: the census's lower bound);
    `closest_block_walk` / `any_block_walk`, the first design's: 16
    Moeller tests per ray and cluster its block entered (any-hit: the rays
    that end unoccluded, occ the any-hit result). Bytes: each ray, mask
    and output once, the tables whole."""
    r = o.shape[0]
    masks = cmask.shape[0] * (cmask.shape[1] + gmask.shape[1])
    table = 4 * (tables.ctab.numel() + tables.cbox.numel()
                 + tables.gbox.numel())
    per_ray = cmask.sum(1, dtype=torch.int64) \
        .repeat_interleave(cl.RAY_BLOCK)[:r]
    rows = cl.CLUSTER_SIZE * common.FLOPS_MOELLER
    c = census
    cull, cull_reference = cull_bound(tables, cmask, gmask, o, d)
    return dict(
        cull=cull, cull_reference=cull_reference,
        closest=common.bound(
            FLOPS_VOTE * (c["group_votes"] + c["cluster_votes"])
            + rows * c["admitted"], 45 * r + masks + table),
        any=common.bound(
            FLOPS_VOTE * (c["any_group_votes"] + c["any_cluster_votes"])
            + rows * c["any_admitted"], 29 * r + masks + table),
        closest_block_walk=common.bound(rows * int(per_ray.sum()),
                                        45 * r + masks + table),
        any_block_walk=common.bound(rows * int(per_ray[~occ].sum()),
                                    29 * r + masks + table))


# ---------------------------------------------------------------------------
# differences against a sweep of more clusters, explained as grazes
# ---------------------------------------------------------------------------

def _cluster_of(tables, tri, inst):
    """The cluster holding the table row of triangle tri, instance inst
    (-1: none)."""
    rows = torch.nonzero((tables.ctab[:, 9] == float(tri))
                         & (tables.ctab[:, 10] == float(inst)))
    return int(rows[0, 0]) // cl.CLUSTER_SIZE if rows.numel() else -1


def _own_enters(tables, o, d, i, clusters):
    """(k,) bool: ray i's own slab test (no vote rule) enters the boxes of
    the clusters."""
    inv = cl._safe_inv(d[i:i + 1])
    return cl._slab_enters(tables.cbox[clusters], o[i:i + 1], inv)[0]


def graze_diffs(tables, cmask, o, d, new, ref, occ_new, occ_ref, t_max,
                t_min, watertight):
    """The new casts (new: closest outputs, occ_new) against casts that
    sweep more clusters (ref, occ_ref: the parent's block rule or the
    dense sweep over the soup), which the admission rule may only lose
    grazes to. Closest: a ray differs where the hit status or the bits of
    t differ; it is an explained graze where the reference hits, the new
    cast misses or hits farther, and the ray's own slab test misses the
    box of the reference's hit cluster. Triangle ids that differ at equal
    t are exact-t ties (counted); u, v and side of the same triangle at
    the same t must be equal. Any-hit: a ray differs where the occlusion
    does; it is explained where the reference is occluded, some cluster
    of the table holds a hit in [t_min, t_max), and the ray's own slab
    test misses the box of every such cluster. At most LISTED differing rays of each kind are
    examined and listed; the rest count as unexplained."""
    hk, hr = torch.isfinite(new[0]), torch.isfinite(ref[0])
    both = hk & hr
    t_bits = new[0].view(torch.int32) != ref[0].view(torch.int32)
    hit_rays = torch.nonzero((hk != hr) | (both & t_bits))[:, 0]
    same_t = both & ~t_bits
    ids = same_t & ((new[3] != ref[3]) | (new[4] != ref[4]))
    same = same_t & ~ids
    fields = (new[1] != ref[1]) | (new[2] != ref[2]) | (new[5] != ref[5])
    listed, explained = [], 0
    for i in hit_rays[:LISTED].tolist():
        c = _cluster_of(tables, int(ref[3][i]), int(ref[4][i])) \
            if bool(hr[i]) else -1
        farther = bool(hr[i]) and (not bool(hk[i])
                                   or float(new[0][i]) > float(ref[0][i]))
        own = c >= 0 and bool(_own_enters(tables, o, d, i, [c])[0])
        ok = farther and c >= 0 and not own
        explained += int(ok)
        u, v = float(ref[1][i]), float(ref[2][i])
        listed.append(dict(ray=i, t=[float(new[0][i]), float(ref[0][i])],
                           tri=int(ref[3][i]), cluster=c,
                           block_entered=bool(
                               c >= 0 and cmask[i // cl.RAY_BLOCK, c]),
                           own_enters=own, uv=[u, v],
                           margin=min(u, v, 1.0 - u - v), explained=ok))
    occ_rays = torch.nonzero(occ_new != occ_ref)[:, 0]
    occ_listed, occ_explained = [], 0
    for i in occ_rays[:LISTED].tolist():
        hit = _slab_test(tables.ctab, o[i:i + 1], d[i:i + 1], t_min,
                         t_max[i:i + 1, None], watertight)[4][0]
        clusters = torch.unique(torch.nonzero(hit)[:, 0] // cl.CLUSTER_SIZE)
        own = _own_enters(tables, o, d, i, clusters)
        ok = bool(occ_ref[i]) and clusters.numel() > 0 \
            and not bool(own.any())
        occ_explained += int(ok)
        occ_listed.append(dict(ray=i, occluded=[bool(occ_new[i]),
                                                bool(occ_ref[i])],
                               hit_clusters=clusters.tolist(),
                               own_enters=own.tolist(), explained=ok))
    n_hit, n_occ = int(hit_rays.numel()), int(occ_rays.numel())
    return dict(hit_diff=n_hit, hit_diff_unexplained=n_hit - explained,
                id_ties=int(ids.sum()),
                uv_back_diff_same_triangle=int((same & fields).sum()),
                occ_diff=n_occ, occ_diff_unexplained=n_occ - occ_explained,
                hit_diff_rays=listed[:20], occ_diff_rays=occ_listed[:20])


def graze_ok(rep):
    """Whether `graze_diffs` found only explained differences."""
    return (rep["hit_diff_unexplained"] == rep["occ_diff_unexplained"] == 0
            and rep["uv_back_diff_same_triangle"] == 0)


# ---------------------------------------------------------------------------
# the variants
# ---------------------------------------------------------------------------

def ptxas_report(log):
    """The ptxas lines of a build's clustered kernels: {short name:
    {registers, smem, stack, spill_stores, spill_loads}}."""
    def short(entry):
        for kind in ("cull", "closest", "any"):
            if f"{kind}_kernel" in entry:
                if kind == "cull":
                    return kind
                return f"{kind}_" + ("watertight" if "Watertight" in entry
                                     else "moeller")
        return None
    return _ptxas_report(log, short)


class _Variant:
    """A build's casts: `cull(o, d)`, `closest(cmask, gmask, o, d, wt)` and
    `any(cmask, gmask, o, d, t_max, wt)` on the scene's tables."""

    def __init__(self, lib, tables, package):
        self.lib, self.tables, self.package = lib, tables, package

    def cull(self, o, d):
        t = self.tables
        nb = -(-o.shape[0] // cl.RAY_BLOCK)
        cmask = torch.empty((nb, t.cbox.shape[0]), dtype=torch.uint8,
                            device=o.device)
        gmask = torch.empty((nb, t.n_groups), dtype=torch.uint8,
                            device=o.device)
        cl._raise_on(self.lib.dcrt_cluster_cull(
            t.cbox.data_ptr(), t.cbox.shape[0], o.data_ptr(), d.data_ptr(),
            o.shape[0], *t.reach, cmask.data_ptr(), gmask.data_ptr(),
            cl._stream(o)), "cull")
        return cmask, gmask

    def closest(self, cmask, gmask, o, d, wt):
        t, r = self.tables, o.shape[0]
        out = [torch.empty(r, dtype=dt, device=o.device) for dt in (
            torch.float32, torch.float32, torch.float32, torch.int32,
            torch.int32, torch.bool)]
        head = ((t.ctab.data_ptr(), cl.prepared_rows(t, wt).data_ptr(),
                 t.cbox.data_ptr(), t.gbox.data_ptr()) if self.package
                else (t.ctab.data_ptr(),))
        cl._raise_on(self.lib.dcrt_cluster_closest(
            *head, cmask.data_ptr(), gmask.data_ptr(), t.cbox.shape[0],
            o.data_ptr(), d.data_ptr(), r, T_MIN, int(wt),
            *(x.data_ptr() for x in out), cl._stream(o)), "closest")
        return tuple(out)

    def any(self, cmask, gmask, o, d, t_max, wt):
        t = self.tables
        occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
        head = ((cl.prepared_rows(t, wt).data_ptr(), t.cbox.data_ptr(),
                 t.gbox.data_ptr()) if self.package else (t.ctab.data_ptr(),))
        cl._raise_on(self.lib.dcrt_cluster_any(
            *head, cmask.data_ptr(), gmask.data_ptr(), t.cbox.shape[0],
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), o.shape[0], T_MIN,
            int(wt), occ.data_ptr(), cl._stream(o)), "any")
        return occ


def _bind_first_port(lib):
    """The first port's C interface (the block sweep): the table, the
    masks, the rays."""
    c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dcrt_cluster_cull.argtypes = [c_p, c_i, c_p, c_p, c_i] \
        + [c_f] * 6 + [c_p, c_p, c_p]
    lib.dcrt_cluster_closest.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p, c_i,
                                         c_f, c_i] + [c_p] * 7
    lib.dcrt_cluster_any.argtypes = [c_p, c_p, c_p, c_i, c_p, c_p, c_p, c_i,
                                     c_f, c_i, c_p, c_p]
    for fn in (lib.dcrt_cluster_cull, lib.dcrt_cluster_closest,
               lib.dcrt_cluster_any):
        fn.restype = c_i


def _build(parent, tables):
    """name -> (_Variant, built library); the two nvcc runs go in
    parallel."""
    from ..utils.cuda_build import load_library

    with ThreadPoolExecutor(2) as pool:
        new = pool.submit(cl.kernels)
        old = parent and pool.submit(
            load_library, "clustered.cu", cl._NVCC_EXTRA,
            csrc=os.path.abspath(parent), name="clustered_parent")
    out = {}
    if old:
        built = old.result()
        package = hasattr(built.lib, "dcrt_cluster_resources")
        (cl.bind if package else _bind_first_port)(built.lib)
        out["parent"] = (_Variant(built.lib, tables, package), built)
    out["new"] = (_Variant(new.result().lib, tables, True), new.result())
    return out


def _in_turns(runs, reps):
    """Each run timed in turns (the order, then reversed), reps[name]
    launches a turn."""
    order = list(runs)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        turns[name].append(common.timed(runs[name], reps[name]))
    return order + order[::-1], turns


def grid_sets(device, names=SETS):
    """(arrays, tables, {name: (o, d, t_max)}): sphere_grid(12, 12) on
    the device and phase 2f's ray sets."""
    from ..accel import worklist as wl
    from ..core.types import to_device
    from ..scene.presets import sphere_grid
    from ..scene.scene import flatten_scene

    scene, cam = sphere_grid(12, 12)
    arrays, _ = flatten_scene(scene, device)
    sets = common.grid_ray_sets(np.random.default_rng(SEED),
                                wl.scene_tables(arrays),
                                to_device(cam, device), device, names=names)
    return arrays, cl.pad_cluster_tables(arrays), sets


def _time_cull(variants, o, d, reps, cull_diff, bnd, case):
    """The cull of every variant timed in turns: one `clustered-ab`
    line (bnd: `cull_bound`'s kernel and reference bounds)."""
    runs = {name: (lambda v=v: v.cull(o, d))
            for name, (v, _) in variants.items()}
    order, turns = _in_turns(runs, {name: reps for name in runs})
    dev_ms = {name: common.kernel_ms(run, reps, "cull_kernel")
              for name, run in runs.items()}
    print("clustered-ab", json.dumps(dict(
        set=case, kind="cull", row=3, rays=o.shape[0], order=order,
        reps=reps, ms=turns,
        mean_ms={n: sum(v) / len(v) for n, v in turns.items()},
        kernel_ms=dev_ms, bound=bnd[0], bound_reference=bnd[1],
        share={n: t and bnd[0][0] / t for n, t in dev_ms.items()},
        cull_diff=cull_diff)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory of an earlier clustered.cu")
    ap.add_argument("--sets", default=",".join(SETS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("clustered_ab: no CUDA device", file=sys.stderr)
        return 1
    names = args.sets.split(",")
    if set(names) - set(SETS):
        ap.error(f"--sets: pick from {SETS}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    _, tables, sets = grid_sets(dev, names)
    variants = _build(args.parent, tables)
    for name, (var, built) in variants.items():
        rep = dict(variant=name, build_s=built.seconds,
                   ptxas=ptxas_report(built.log))
        if name == "new":
            rep["resources"] = cl.resources()
        print("clustered-ab-build", json.dumps(rep))
    new = variants["new"][0]
    bad = []
    for case, (o, d, t_max) in sets.items():
        r = o.shape[0]
        cmask, gmask = new.cull(o, d)
        cm_w, gm_w = cl.cull_masks_torch(tables, o, d)
        cull_diff = dict(twin=common.bit_diff(cmask, cm_w)
                         + common.bit_diff(gmask, gm_w))
        if "parent" in variants:
            cm_p, gm_p = variants["parent"][0].cull(o, d)
            cull_diff["parent"] = (common.bit_diff(cmask, cm_p)
                                   + common.bit_diff(gmask, gm_p))
        if any(cull_diff.values()):
            bad.append((case, "cull"))
        _time_cull(variants, o, d, args.reps, cull_diff,
                   cull_bound(tables, cmask, gmask, o, d), case)
        idx = common.spread_blocks(r, TWIN_BLOCKS, dev, cl.RAY_BLOCK)
        blocks = idx[::cl.RAY_BLOCK] // cl.RAY_BLOCK
        sub = (cmask[blocks].contiguous(), gmask[blocks].contiguous(),
               o[idx], d[idx], t_max[idx])
        for wt in (False, True):
            k = new.closest(cmask, gmask, o, d, wt)
            ka = new.any(cmask, gmask, o, d, t_max, wt)
            census = admission_census(tables, cmask, gmask, o, d, ka)
            print("clustered-census", json.dumps(dict(
                set=case, watertight=wt, cull_diff=cull_diff, **census)))
            if census["group_misses"]:
                bad.append((case, "group_misses"))
            bounds = cast_bounds(tables, cmask, gmask, o, d, ka, census)
            ks = new.closest(*sub[:4], wt)
            kas = new.any(*sub, wt)
            twin = dict(
                closest=closest_diffs(ks, cl.sweep_closest_torch(
                    tables, *sub[:4], T_MIN, wt)),
                any=common.bit_diff(kas, cl.sweep_any_torch(
                    tables, *sub, T_MIN, wt)))
            if any(twin["closest"].values()) or twin["any"]:
                bad.append((case, wt, "twin"))
            vs_parent = None
            if "parent" in variants:
                par = variants["parent"][0]
                vs_parent = graze_diffs(
                    tables, cmask, o, d, k, par.closest(cmask, gmask, o, d,
                                                        wt),
                    ka, par.any(cmask, gmask, o, d, t_max, wt), t_max,
                    T_MIN, wt)
                if not graze_ok(vs_parent):
                    bad.append((case, wt, "parent"))
            for kind in ("closest", "any"):
                runs = {name: (lambda v=v: v.closest(cmask, gmask, o, d, wt))
                        if kind == "closest" else
                        (lambda v=v: v.any(cmask, gmask, o, d, t_max, wt))
                        for name, (v, _) in variants.items()}
                reps = {name: 1 if common.timed(run, 1) > HEAVY_MS
                        else args.reps for name, run in runs.items()}
                order, turns = _in_turns(runs, reps)
                dev_ms = {name: common.kernel_ms(run, reps[name],
                                                 f"{kind}_kernel")
                          for name, run in runs.items()}
                bnd, blk = bounds[kind], bounds[f"{kind}_block_walk"]
                line = dict(
                    set=case, watertight=wt, kind=kind, rays=r, order=order,
                    reps=reps, ms=turns,
                    mean_ms={n: sum(v) / len(v) for n, v in turns.items()},
                    kernel_ms=dev_ms, bound=bnd, bound_block_walk=blk,
                    share={n: t and bnd[0] / t for n, t in dev_ms.items()},
                    twin_rays=int(idx.numel()),
                    bits_vs_twin=twin[kind],
                    hits=int(torch.isfinite(k[0]).sum()) if kind == "closest"
                    else int(ka.sum()))
                if kind == "closest":
                    line["cull_bound"] = bounds["cull"]
                if vs_parent is not None:
                    line["vs_parent"] = vs_parent
                print("clustered-ab", json.dumps(line))
    if bad:
        print(f"clustered_ab: failed checks: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
