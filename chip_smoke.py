"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc
(CUDA_HOME, PATH or /usr/local/cuda). It imports no jax. Phases, in order;
any failure exits non-zero:

1. setup: print the card's name and power limit, build the dense-sweep
   and work-list kernels (csrc/brute_sweep.cu, csrc/worklist.cu; the two
   nvcc runs in parallel) and print the build times and ptxas reports;
2. dense-sweep kernels against their PyTorch twins on the card, Moeller
   and watertight, closest and any-hit: (a) the Cornell soup (32
   triangles) with 1,048,576 camera rays plus 1,048,576 random rays from
   inside the box, (b) a seeded 2048-triangle random soup with 1,048,576
   random rays; mismatch counts, max errors and kernel/twin times;
2b. work-list kernels (cull, refine, closest and any-hit sweeps) against
   their twins on sphere_grid(12, 12) (211,972 triangles), Baldwin-Weber
   and watertight: 1,048,576 tiled camera rays, 1,048,576 random rays
   from inside the scene box, 1,048,576 shadow rays towards the lamp with
   per-ray t_max; mismatch counts, `iters` equality, kernel and twin
   times at the camera rays (CUDA events), items per block and mean
   clusters swept per ray;
3. the main path: Cornell glossy 1024x1024, 16 spp, max_bounce 4 through
   `Renderer.render`, with the kernels' launch counts checked against
   spp * (max_bounce + 2) * chunks (closest) and spp * (max_bounce + 1) *
   chunks (any-hit);
2c. grouped work-list kernels (closest and any-hit) against their twins
   and against the per-ray sweeps on the three 1M-ray sets of 2b plus the
   random set sorted by `ray_sort_key` (like a permuted pool) and a
   pool-sized (2^18) sorted set, Baldwin-Weber and watertight: mismatch
   counts of every field, `iters` equality against the twin; the twins
   run on the first 2^18 rays of the incoherent sets, where a 1M-ray
   twin cast would take minutes, and on the whole camera set; CUDA-event
   times of grouped and per-ray kernels, clusters swept per ray;
3b. the main path on a clustered scene: sphere_grid(12, 12) 1024x1024,
   16 spp, max_bounce 4. Closest sweeps plus closest casts with an empty
   item list must equal spp * (max_bounce + 2) * chunks, any-hit sweeps
   plus empty any-hit casts spp * (max_bounce + 1) * chunks; one cull per
   cast, one refine per cast whose hyper cull admitted something; no
   dense-sweep launch;
3c. the wavefront path: sphere_grid(12, 12) at 1920x1080, max_bounce 4,
   `Renderer(..., integrator="wavefront").render(8)` (one fused pool pass
   of 8 samples) after a warm-up; ms/spp, peak memory, `LAST_STATS`; the
   bundle sweeps launch 0 times, grouped sweeps plus empty casts equal
   the pool casts `LAST_STATS` counted, one cull per cast; then the same
   pass without slab marching (slab_march=0.0) and with it again, in the
   order off, off, on (with the render: on, off, off, on), its image held
   to the render's (RMSE <= 1e-3); then one timed pass with a 2^20-path
   pool;
3d. the wavefront against the megakernel on the card (sphere_grid(12,
   12), 256x256, 4 spp, same seeds): RMSE <= 1e-3;
4. the card's render against the port's CPU render, Cornell (64x64,
   4 spp), 4b. sphere_grid(3, 3, stacks=12, slices=16) (64x64, 4 spp)
   and 4c. the same small grid through the wavefront;
5. one JSON line listing the eight kernels, then the contract line, last.

Tolerances (kernel vs twin): the kernels are built without FMA
contraction, so they round like the twins; a hit/miss or occlusion
disagreement is allowed only where the twin's t lies within 1e-5 (1 + t)
of t_min or t_max, a triangle-id disagreement only between hits within
that bound of each other (a near-tie; for the work list also within
2^-12 relative, twice the packed argmin's truncation quantum), and t, u,
v of same-triangle hits must agree within 1e-5 (relative to 1 + t for
t). Work-list `iters` must be equal. The grouped kernels must equal their
twins in every field, and the per-ray sweeps in every hit field. The
grouped any-hit sweep's plain version is the per-ray twin
`sweep_any_torch`, whose answer the grouped walk must give (its
`plain_ms` in the kernels line times that twin).

Bounds (`bound_ms` of the kernels line): the larger of the counted
floating-point operations at 67 TFLOP/s and the bytes read and written
once at 3.35 TB/s (the H100 SXM's published float32 and memory rates),
from this run's inputs: a Moeller test 45 operations, a Baldwin-Weber
test 31, a slab test of a ray and a box 20; the work-list sweeps count
the fine cull of every item of the ray's block and 16 triangle tests per
cluster the per-ray walk swept (the any-hit sweeps only the fine cull, a
lower bound); tables count once, whole.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TOL = 1e-5
TIE_WL = 2.0 ** -12
N_RAYS = 1 << 20
RENDER = dict(width=1024, height=1024, spp=16, max_bounce=4)
SMALL = dict(width=64, height=64, spp=4, max_bounce=4)
GRID = (12, 12)                         # 211,972 world triangles
SMALL_GRID = ((3, 3), dict(stacks=12, slices=16))
# CPU vs card render gate. Paths are identical up to float rounding
# (transcendentals differ by an ulp between torch's CPU and CUDA math);
# a rare flipped branch changes one path of one pixel, so the gate allows
# a few diverged pixels but not a systematic difference.
GATE_RMSE = 0.02
GATE_DIVERGED_FRACTION = 0.01
WAVEFRONT = dict(width=1920, height=1080, spp=8, max_bounce=4)
POOL_BIG = 1 << 20
TWIN_SUBSET = 1 << 18                   # rays of a twin cast on big sets
POOL_RAYS = 1 << 18                     # the default pool at 1080p x 8 spp
MK_VS_WF = dict(width=256, height=256, spp=4, max_bounce=4)
GATE_WF_RMSE = 1e-3
PEAK_FLOPS = 67e12                      # H100 SXM float32, no tensor cores
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
FLOPS_MOELLER, FLOPS_BW, FLOPS_SLAB = 45, 31, 20


def _timed(fn, reps):
    """Mean ms of fn() over reps launches after one warm-up (CUDA events)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops, nbytes):
    """(bound_ms, bound_by) of work of `flops` operations moving `nbytes`."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _rays_inside(rng, n, lo, hi):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return rng.uniform(lo, hi, (n, 3)), d


def _random_soup(rng, n):
    """n small random triangles in [-1, 1]^3 with random winding flips."""
    v0 = rng.uniform(-1.0, 1.0, (n, 3))
    tab = np.concatenate([v0, v0 + rng.normal(0.0, 0.15, (n, 3)),
                          v0 + rng.normal(0.0, 0.15, (n, 3)),
                          np.arange(n)[:, None], np.zeros((n, 1)),
                          rng.integers(0, 2, (n, 1))], axis=1)
    return tab.astype(np.float32)


def _camera_rays(cam, width, height, device):
    import torch

    from directcomputeraytracing_tpu_torch.camera.camera import generate_ray

    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    film = torch.stack([(xs.reshape(-1) + 0.5) / width,
                        (ys.reshape(-1) + 0.5) / height], dim=-1)
    return generate_ray(cam, film, torch.zeros(film.shape[0], 3,
                                               device=device))


def compare_kernels(tab, o, d, t_max, t_min, watertight):
    """Dense-sweep kernel vs twin on one ray set; the mismatch report."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute

    scene = _SoupScene(tab)
    k = brute.brute_closest(scene, o, d, t_min, watertight)
    w = brute.brute_closest_torch(tab, o, d, t_min, watertight)
    occ_k = brute.brute_any(scene, o, d, t_max, t_min, watertight)
    occ_w = brute.brute_any_torch(tab, o, d, t_max, t_min, watertight)
    torch.cuda.synchronize()
    rep = _mismatches(k, w, occ_k, occ_w, o, t_max, t_min, 0.0)
    rep.update(tris=tab.shape[0], watertight=bool(watertight))
    return rep


def _mismatches(k, w, occ_k, occ_w, o, t_max, t_min, tie_rel):
    """Mismatch report of kernel (k, occ_k) against twin (w, occ_w)
    results; tie_rel widens the near-tie bound by tie_rel * |t|."""
    import torch

    (tk, uk, vk, trik, instk, backk), (tw, uw, vw, triw, instw, backw) = \
        k[:6], w[:6]
    hk, hw = torch.isfinite(tk), torch.isfinite(tw)

    def near(t, bound):
        """t finite and within TOL (1 + |t|) + tie_rel |t| of bound."""
        return torch.isfinite(t) & ((t - bound).abs()
                                    <= TOL * (1 + t.abs()) + tie_rel * t.abs())

    hit_miss = hk != hw
    hit_miss_bad = hit_miss & ~near(torch.where(hw, tw, tk), t_min)
    both = hk & hw
    tri_diff = both & (trik != triw)
    tri_bad = tri_diff & ~near(tk, tw)
    same = both & (trik == triw)
    dt = torch.where(same, (tk - tw).abs() / (1 + tw.abs()), 0.0)
    du = torch.where(same, (uk - uw).abs(), 0.0)
    dv = torch.where(same, (vk - vw).abs(), 0.0)
    attr_bad = same & ((instk != instw) | (backk != backw))
    occ_diff = occ_k != occ_w
    # an occlusion flip is explained when the nearest hit above t_min sits
    # at t_max (or t_min) within the bound
    tm = torch.as_tensor(t_max, device=o.device).expand(o.shape[:1])
    occ_bad = occ_diff & ~(near(tw, tm) | near(tw, t_min))
    rep = dict(rays=o.shape[0],
               hits=int(hw.sum()), occluded=int(occ_w.sum()),
               hit_miss_diff=int(hit_miss.sum()),
               hit_miss_unexplained=int(hit_miss_bad.sum()),
               tri_diff=int(tri_diff.sum()),
               tri_unexplained=int(tri_bad.sum()),
               inst_or_back_diff=int(attr_bad.sum()),
               max_rel_dt=float(dt.max()), max_du=float(du.max()),
               max_dv=float(dv.max()),
               occ_diff=int(occ_diff.sum()),
               occ_unexplained=int(occ_bad.sum()))
    rep["ok"] = (rep["hit_miss_unexplained"] == 0 and rep["tri_unexplained"]
                 == 0 and rep["inst_or_back_diff"] == 0
                 and rep["occ_unexplained"] == 0
                 and max(rep["max_rel_dt"], rep["max_du"], rep["max_dv"])
                 <= TOL)
    rep["closest_max_abs_err"] = float(max(
        torch.where(same, (tk - tw).abs(), 0.0).max(), du.max(), dv.max()))
    rep["any_max_abs_err"] = float(occ_diff.float().max())
    return rep


class _SoupScene:
    """The two fields the dense sweep reads, from a (B, 12) table."""

    def __init__(self, tab):
        self.world_tris = tab[:, 0:9]
        self.world_tri_meta = tab[:, 9:12]


def phase_kernels(device):
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261016)
    scene, cam = cornell_box("area", "glossy")
    arrays, _ = flatten_scene(scene, device)
    cornell_tab = brute.build_table(arrays)
    o_cam, d_cam = _camera_rays(to_device(cam, device), 1024, 1024, device)
    o_in, d_in = _rays_inside(rng, N_RAYS, [-0.95, 0.05, -0.95],
                              [0.95, 1.95, 0.95])
    o_soup, d_soup = _rays_inside(rng, N_RAYS, -1.5, 1.5)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    cases = {
        "cornell32": (cornell_tab, torch.cat([o_cam, f32(o_in)]),
                      torch.cat([d_cam, f32(d_in)]),
                      f32(rng.uniform(0.05, 4.0, 2 * N_RAYS))),
        "soup2048": (f32(_random_soup(rng, 2048)), f32(o_soup), f32(d_soup),
                     f32(rng.uniform(0.05, 3.0, N_RAYS))),
    }
    reports, times = [], {}
    t_min = 1e-4
    for name, (tab, o_all, d_all, t_max_all) in cases.items():
        scene_like = _SoupScene(tab)
        # timed at the main path's cast size: one ray per pixel of 1024^2
        # (for Cornell, the camera rays)
        o, d, t_max = o_all[:N_RAYS], d_all[:N_RAYS], t_max_all[:N_RAYS]
        for wt in (False, True):
            rep = compare_kernels(tab, o_all, d_all, t_max_all, t_min, wt)
            rep["case"] = name
            reports.append(rep)
            print("kernel-vs-twin", json.dumps(rep))
            tag = f"{name}_{'watertight' if wt else 'moeller'}"
            times[tag] = dict(
                closest_ms=_timed(lambda: brute.brute_closest(
                    scene_like, o, d, t_min, wt), 10),
                closest_twin_ms=_timed(lambda: brute.brute_closest_torch(
                    tab, o, d, t_min, wt), 2),
                any_ms=_timed(lambda: brute.brute_any(
                    scene_like, o, d, t_max, t_min, wt), 10),
                any_twin_ms=_timed(lambda: brute.brute_any_torch(
                    tab, o, d, t_max, t_min, wt), 2))
            print("timing", tag, f"rays={o.shape[0]} tris={tab.shape[0]}",
                  json.dumps(times[tag]))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel/twin mismatch beyond tolerance: {bad}")
    return reports, times


def _tiled_camera_rays(cam, width, height, device):
    """Pixel-centre camera rays in the renderer's 32x32 tile order."""
    import torch

    from directcomputeraytracing_tpu_torch.camera.camera import generate_ray
    from directcomputeraytracing_tpu_torch.integrator.common import (
        RenderConfig,
    )
    from directcomputeraytracing_tpu_torch.integrator.megakernel import (
        tiled_frame_pixels,
    )

    px, py, _ = tiled_frame_pixels(RenderConfig(width=width, height=height),
                                   device)
    film = torch.stack([(px + 0.5) / width, (py + 0.5) / height], dim=-1)
    return generate_ray(cam, film.float(),
                        torch.zeros(film.shape[0], 3, device=device))


def _items_census(tables, od, tm):
    """Items per block of one cast: mean and max over blocks."""
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    items = wl.phases(tables, od, tm)
    if items is None:
        return dict(items=0, items_per_block=0.0, items_per_block_max=0)
    counts = (items.seg[1:] - items.seg[:-1]).float()
    return dict(items=int(items.seg[-1]), items_per_block=float(counts.mean()),
                items_per_block_max=int(counts.max()))


def phase_worklist_kernels(device):
    """Work-list kernels vs twins on sphere_grid(12, 12); kernel and twin
    times at the camera rays; the item and cluster census."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261017)
    scene, cam = sphere_grid(*GRID)
    t0 = time.perf_counter()
    arrays, _ = flatten_scene(scene, device)
    flatten_s = time.perf_counter() - t0
    tables = wl.scene_tables(arrays)
    print("worklist scene", json.dumps(dict(
        world_tris=arrays.world_tris.shape[0],
        clusters=arrays.cluster_bbox.shape[0], supers=tables.sbox.shape[0],
        hypers=None if tables.hbox is None else tables.hbox.shape[0],
        flatten_s=flatten_s)))
    if tables.hbox is None:
        raise SystemExit("sphere_grid(12, 12) should use the hyper level")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = [-18.0, 0.01, -18.0], [18.0, 6.9, 18.0]
    side = int(np.sqrt(N_RAYS))
    o_cam, d_cam = _tiled_camera_rays(to_device(cam, device), side, side,
                                      device)
    o_in, d_in = _rays_inside(rng, N_RAYS, lo, hi)
    o_sh = rng.uniform([-9.0, 0.01, -9.0], [9.0, 1.5, 9.0], (N_RAYS, 3))
    to_lamp = rng.uniform([-2.0, 7.0, -2.0], [2.0, 7.0, 2.0],
                          (N_RAYS, 3)) - o_sh
    dist = np.linalg.norm(to_lamp, axis=1)
    sets = {
        "camera": (o_cam, d_cam, f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "random": (f32(o_in), f32(d_in), f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "shadow": (f32(o_sh), f32(to_lamp / dist[:, None]),
                   f32(0.999 * dist)),
    }
    t_min = 1e-4
    reports, census = [], {}
    cull = dict(diff=0, err=0.0, refine_diff=0, refine_err=0.0)
    for name, (o, d, t_max) in sets.items():
        od, tm_closest, _ = wl.prep_rays(o, d)
        _, tm_any, _ = wl.prep_rays(o, d, t_max)
        census[name] = dict(closest=_items_census(tables, od, tm_closest),
                            any=_items_census(tables, od, tm_any))
        for tm in (tm_closest, tm_any):
            tlo = wl.cull_boxes(tables.hbox, od, tm)
            tlo_w = wl.cull_boxes_torch(tables.hbox, od, tm)
            blk, hyp, _ = wl.compact_pairs(tlo_w)
            ref = wl.refine(tables.hsup, blk, hyp, od, tm)
            ref_w = wl.refine_torch(tables.hsup, blk, hyp, od, tm)
            cull["diff"] += int((tlo != tlo_w).sum())
            cull["err"] = max(cull["err"], float((tlo - tlo_w).abs().max()))
            cull["refine_diff"] += int((ref != ref_w).sum())
            cull["refine_err"] = max(cull["refine_err"],
                                     float((ref - ref_w).abs().max()))
        for wt in (False, True):
            t0 = time.perf_counter()
            k = wl.worklist_closest(arrays, o, d, t_min, wt)
            occ_k = wl.worklist_any(arrays, o, d, t_max, t_min, wt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            w = wl.worklist_closest_torch(arrays, o, d, t_min, wt)
            occ_w = wl.worklist_any_torch(arrays, o, d, t_max, t_min, wt)
            torch.cuda.synchronize()
            rep = _mismatches(k, w, occ_k, occ_w, o, t_max, t_min, TIE_WL)
            rep["iters_diff"] = int((k[6] != w[6]).sum())
            rep["ok"] = rep["ok"] and rep["iters_diff"] == 0
            rep.update(case=name, watertight=wt, kernel_casts_s=t1 - t0,
                       twin_casts_s=time.perf_counter() - t1)
            if not wt:
                hit = torch.isfinite(k[0])
                census[name].update(
                    iters_per_ray=float(k[6].float().mean()),
                    iters_per_hit=float(k[6][hit].float().mean()),
                    hit_fraction=float(hit.float().mean()))
            reports.append(rep)
            print("worklist-kernel-vs-twin", json.dumps(rep))
    print("worklist census", json.dumps(census))
    print("worklist cull-and-refine-vs-twin", json.dumps(cull))

    # kernel and twin times at the main path's first cast: 1M camera rays
    o, d, t_max = sets["camera"]
    od, tm, _ = wl.prep_rays(o, d)
    _, tm_any, _ = wl.prep_rays(o, d, t_max)
    texp = wl.scene_exit(tables, od)
    boxes = tables.hbox
    blk, hyp, _ = wl.compact_pairs(wl.cull_boxes(boxes, od, tm))
    items = wl.phases(tables, od, tm)
    items_any = wl.phases(tables, od, tm_any)
    times = dict(
        cull_ms=_timed(lambda: wl.cull_boxes(boxes, od, tm), 20),
        cull_twin_ms=_timed(lambda: wl.cull_boxes_torch(boxes, od, tm), 2),
        closest_ms=_timed(lambda: wl.sweep_closest(
            tables, items, od, texp, t_min, False), 10),
        closest_twin_ms=_timed(lambda: wl.sweep_closest_torch(
            tables, items, od, texp, t_min, False), 1),
        any_ms=_timed(lambda: wl.sweep_any(
            tables, items_any, od, tm_any, t_min, False), 10),
        any_twin_ms=_timed(lambda: wl.sweep_any_torch(
            tables, items_any, od, tm_any, t_min, False), 1),
        closest_cast_ms=_timed(lambda: wl.worklist_closest(
            arrays, o, d, t_min), 5),
        any_cast_ms=_timed(lambda: wl.worklist_any(
            arrays, o, d, t_max, t_min), 5),
        refine_items=int(blk.shape[0]),
        refine_ms=_timed(lambda: wl.refine(tables.hsup, blk, hyp, od, tm),
                         20),
        refine_twin_ms=_timed(lambda: wl.refine_torch(
            tables.hsup, blk, hyp, od, tm), 2))
    print("worklist timing camera", f"rays={o.shape[0]}", json.dumps(times))
    bad = [r for r in reports if not r["ok"]]
    if bad or cull["diff"] or cull["refine_diff"]:
        raise SystemExit(f"work-list kernel/twin mismatch: {bad} {cull}")
    rp = od.shape[1]
    iters = wl.sweep_closest(tables, items, od, texp, t_min, False)[7]
    hs = tables.hsup.shape[1]
    table_bytes = 4 * (tables.cbox3.numel() + tables.bwtab.numel())
    n_items, n_items_any = int(items.seg[-1]), int(items_any.seg[-1])
    fine = FLOPS_SLAB * wl.RB * wl.SUPER
    work = dict(
        cull=_bound(FLOPS_SLAB * rp * boxes.shape[0],
                    40 * rp + 32 * boxes.shape[0]
                    + 4 * boxes.shape[0] * rp // wl.RB),
        refine=_bound(FLOPS_SLAB * blk.shape[0] * wl.RB * hs,
                      40 * rp + 4 * tables.hsup.numel()
                      + (8 + 4 * hs) * blk.shape[0]),
        sweep_closest=_bound(fine * n_items
                             + 16 * FLOPS_BW * int(iters.long().sum()),
                             69 * rp + 12 * n_items + table_bytes),
        sweep_any=_bound(fine * n_items_any,
                         41 * rp + 8 * n_items_any + table_bytes))
    print("worklist bounds camera", json.dumps(work))
    return reports, times, cull, work


def _sweep_diffs(a, b, fields):
    """Per-field count of rays whose sweep state differs (bits)."""
    names = ("best", "t", "u", "v", "tri", "inst", "back", "iters")
    return {names[i]: int((a[i] != b[i]).sum()) for i in fields}


def _sorted_rays(tables, o, d):
    """Rays in `ray_sort_key` order, as the wavefront sorts its pool."""
    import torch

    from directcomputeraytracing_tpu_torch.integrator.common import (
        ray_sort_key,
    )

    lo, hi = tables.bounds
    key = ray_sort_key(o, d, lo, 1.0 / (hi - lo).clamp_min(1e-6))
    order = torch.argsort(key, stable=True)
    return o[order].contiguous(), d[order].contiguous()


def phase_grouped_kernels(device):
    """Grouped kernels against their twins and the per-ray sweeps on the
    sphere grid; grouped vs per-ray kernel times; clusters per ray."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261018)
    scene, cam = sphere_grid(*GRID)
    arrays, _ = flatten_scene(scene, device)
    tables = wl.scene_tables(arrays)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = [-18.0, 0.01, -18.0], [18.0, 6.9, 18.0]
    side = int(np.sqrt(N_RAYS))
    o_cam, d_cam = _tiled_camera_rays(to_device(cam, device), side, side,
                                      device)
    o_in, d_in = (f32(x) for x in _rays_inside(rng, N_RAYS, lo, hi))
    o_sh = rng.uniform([-9.0, 0.01, -9.0], [9.0, 1.5, 9.0], (N_RAYS, 3))
    to_lamp = rng.uniform([-2.0, 7.0, -2.0], [2.0, 7.0, 2.0],
                          (N_RAYS, 3)) - o_sh
    dist = np.linalg.norm(to_lamp, axis=1)
    o_pool, d_pool = (f32(x) for x in _rays_inside(rng, POOL_RAYS, lo, hi))
    sets = {
        "camera": (o_cam, d_cam, f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "random": (o_in, d_in, f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "shadow": (f32(o_sh), f32(to_lamp / dist[:, None]),
                   f32(0.999 * dist)),
        "random_sorted": (*_sorted_rays(tables, o_in, d_in),
                          f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "pool_sorted": (*_sorted_rays(tables, o_pool, d_pool),
                        f32(rng.uniform(0.5, 30.0, POOL_RAYS))),
    }
    t_min = 1e-4
    reports, timing, errs = [], {}, dict(closest=0.0, any=0.0)

    def prepared(o, d, t_max):
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        return (od, tm_c, tm_a, wl.scene_exit(tables, od),
                wl.phases(tables, od, tm_c), wl.phases(tables, od, tm_a))

    for name, (o, d, t_max) in sets.items():
        full = prepared(o, d, t_max)
        n_twin = o.shape[0] if name in ("camera", "pool_sorted") \
            else TWIN_SUBSET
        sub = prepared(o[:n_twin], d[:n_twin], t_max[:n_twin])
        for wt in (False, True):
            od, tm_c, tm_a, texp, it_c, it_a = full
            g = wl.sweep_closest_grouped(tables, it_c, od, texp, t_min, wt)
            p = wl.sweep_closest(tables, it_c, od, texp, t_min, wt)
            ga = wl.sweep_any_grouped(tables, it_a, od, tm_a, t_min, wt)
            pa = wl.sweep_any(tables, it_a, od, tm_a, t_min, wt)
            od_s, _, tm_as, texp_s, it_cs, it_as = sub
            t0 = time.perf_counter()
            gs = wl.sweep_closest_grouped(tables, it_cs, od_s, texp_s, t_min,
                                          wt)
            gw = wl.sweep_closest_grouped_torch(tables, it_cs, od_s, texp_s,
                                                t_min, wt)
            gas = wl.sweep_any_grouped(tables, it_as, od_s, tm_as, t_min, wt)
            gaw = wl.sweep_any_torch(tables, it_as, od_s, tm_as, t_min, wt)
            torch.cuda.synchronize()
            rep = dict(case=name, watertight=wt, rays=o.shape[0],
                       twin_rays=n_twin,
                       twin_s=time.perf_counter() - t0,
                       vs_twin=_sweep_diffs(gs, gw, range(8)),
                       vs_twin_occ=int((gas != gaw).sum()),
                       vs_per_ray=_sweep_diffs(g, p, range(7)),
                       vs_per_ray_occ=int((ga != pa).sum()),
                       iters_per_ray=float(p[7].float().mean()),
                       grouped_iters_per_ray=float(g[7].float().mean()),
                       hits=int(torch.isfinite(wl.decode_closest(
                           g, texp, it_c.block_any, o.shape[0])[0]).sum()),
                       occluded=int(ga.sum()))
            rep["ok"] = (not any(rep["vs_twin"].values())
                         and not any(rep["vs_per_ray"].values())
                         and rep["vs_twin_occ"] == 0
                         and rep["vs_per_ray_occ"] == 0)
            errs["closest"] = max(errs["closest"], *(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(gs[1:4], gw[1:4])))
            errs["any"] = max(errs["any"], float((gas != gaw).float().max()))
            reports.append(rep)
            print("grouped-kernel", json.dumps(rep))
        od, tm_c, tm_a, texp, it_c, it_a = full
        timing[name] = dict(
            rays=o.shape[0],
            items_per_block=float(it_c.seg[-1]) / (od.shape[1] // wl.RB),
            closest_ms=_timed(lambda: wl.sweep_closest(
                tables, it_c, od, texp, t_min, False), 5),
            closest_grouped_ms=_timed(lambda: wl.sweep_closest_grouped(
                tables, it_c, od, texp, t_min, False), 5),
            any_ms=_timed(lambda: wl.sweep_any(
                tables, it_a, od, tm_a, t_min, False), 5),
            any_grouped_ms=_timed(lambda: wl.sweep_any_grouped(
                tables, it_a, od, tm_a, t_min, False), 5))
        print("grouped-timing", name, json.dumps(timing[name]))
    # the main path's shape: a sorted pool of 2^18 rays
    od, tm_c, tm_a, texp, it_c, it_a = prepared(*sets["pool_sorted"])
    rp = od.shape[1]
    iters = wl.sweep_closest(tables, it_c, od, texp, t_min, False)[7]
    table_bytes = 4 * (tables.cbox3.numel() + tables.bwtab.numel())
    fine = FLOPS_SLAB * wl.RB * wl.SUPER
    n_c, n_a = int(it_c.seg[-1]), int(it_a.seg[-1])
    pool = dict(
        closest_twin_ms=_timed(lambda: wl.sweep_closest_grouped_torch(
            tables, it_c, od, texp, t_min, False), 1),
        any_twin_ms=_timed(lambda: wl.sweep_any_torch(
            tables, it_a, od, tm_a, t_min, False), 1),
        closest_bound=_bound(fine * n_c + 16 * FLOPS_BW
                             * int(iters.long().sum()),
                             69 * rp + 12 * n_c + table_bytes),
        any_bound=_bound(fine * n_a, 41 * rp + 8 * n_a + table_bytes))
    pool.update(closest_ms=timing["pool_sorted"]["closest_grouped_ms"],
                any_ms=timing["pool_sorted"]["any_grouped_ms"])
    print("grouped-pool", json.dumps(pool))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"grouped kernel mismatch: {bad}")
    return reports, timing, errs, pool


def _scene(name):
    from directcomputeraytracing_tpu_torch.scene.presets import (
        cornell_box,
        sphere_grid,
    )

    if name == "cornell":
        return cornell_box("area", "glossy")
    if name == "grid":
        return sphere_grid(*GRID)
    return sphere_grid(*SMALL_GRID[0], **SMALL_GRID[1])


def _launches():
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    return dict(brute_closest=brute.brute_closest.launches,
                brute_any=brute.brute_any.launches, **wl.counters())


def _reset_launches():
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    brute.brute_closest.launches = brute.brute_any.launches = 0
    wl.reset_counters()


def _expected_launches(name, n_closest, n_any, got):
    """The counts the main path must show: every cast went through the
    path's kernels (the dense sweep for Cornell, the work list for the
    sphere grid) and nothing else launched."""
    zero = dict.fromkeys(got, 0)
    if name == "cornell":
        return dict(zero, brute_closest=n_closest, brute_any=n_any)
    # work list: a cast with an empty item list launches no sweep (counted
    # apart); each cast culls once; a cast whose hyper cull admitted
    # nothing runs no refine (counted apart)
    return dict(zero, cull_boxes=n_closest + n_any,
                refine=n_closest + n_any - got["refine_skipped"],
                refine_skipped=got["refine_skipped"],
                sweep_closest=n_closest - got["closest_empty"],
                closest_empty=got["closest_empty"],
                sweep_any=n_any - got["any_empty"], any_empty=got["any_empty"])


def phase_render(device, name):
    import torch

    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    p = RENDER
    r = Renderer(*_scene(name), p["width"], p["height"],
                 max_bounce=p["max_bounce"], device=device)
    # warm-up: the timed call itself, so that the allocator's growth for
    # the fused pass falls outside the timed window
    r.render(spp=p["spp"])
    r.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    expect = _expected_launches(
        name, p["spp"] * (p["max_bounce"] + 2) * r.n_chunks,
        p["spp"] * (p["max_bounce"] + 1) * r.n_chunks, launches)
    post = r.postprocessed()
    stats = dict(scene=name, world_tris=r.arrays.world_tris.shape[0],
                 tiled_and_sorted=r._inv is not None,
                 shape=list(img.shape), finite=bool(np.isfinite(img).all()),
                 mean=float(img.mean()), max=float(img.max()),
                 ms_per_spp=1000.0 * seconds / p["spp"],
                 total_s=seconds, chunks=r.n_chunks,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 post_mean=float(post.mean()), post_min=float(post.min()),
                 post_max=float(post.max()),
                 post_finite=bool(np.isfinite(post).all()),
                 launches=launches, expected_launches=expect)
    print("render", json.dumps(stats))
    if not (stats["finite"] and stats["post_finite"] and stats["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit(f"{name} render is not a finite, non-black image")
    if launches != expect:
        raise SystemExit(f"{name} launch counts {launches} != {expect}")
    return stats


def _expected_wavefront_launches(stats, got):
    """Every pool cast of the wavefront went through the grouped sweep
    (or found no item): no bundle sweep, no dense sweep, one cull per
    cast."""
    n_closest = sum(stats["closest_casts_per_phase"])
    n_any = sum(stats["any_casts_per_phase"])
    return dict(dict.fromkeys(got, 0), cull_boxes=n_closest + n_any,
                refine=n_closest + n_any - got["refine_skipped"],
                refine_skipped=got["refine_skipped"],
                sweep_closest_grouped=n_closest - got["closest_empty"],
                closest_empty=got["closest_empty"],
                sweep_any_grouped=n_any - got["any_empty"],
                any_empty=got["any_empty"])


def phase_wavefront(device):
    """The wavefront path at 1920x1080 on the sphere grid."""
    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    p = WAVEFRONT
    r = Renderer(*_scene("grid"), p["width"], p["height"],
                 max_bounce=p["max_bounce"], integrator="wavefront",
                 device=device)
    t0 = time.perf_counter()
    r.render(spp=p["spp"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    r.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    stats = dict(wf.LAST_STATS)
    expect = _expected_wavefront_launches(stats, launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    slabs = _slab_ab(r, img, seconds)
    # one timed pass of the same 8 samples through a 2^20-path pool
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf.render_samples_wavefront(r.arrays, r.luts, r.camera, r.cfg, r._px,
                                r._py, 100, pool_size=POOL_BIG,
                                spp_batch=p["spp"])
    torch.cuda.synchronize()
    big = dict(pool_size=POOL_BIG, seconds=time.perf_counter() - t0,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               stats=dict(wf.LAST_STATS))
    big["ms_per_spp"] = 1000.0 * big["seconds"] / p["spp"]
    rep = dict(scene="grid", integrator="wavefront",
               world_tris=r.arrays.world_tris.shape[0],
               shape=list(img.shape), finite=bool(np.isfinite(img).all()),
               mean=float(img.mean()), max=float(img.max()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               warmup_s=warm_s, peak_mem_gib=peak, last_stats=stats,
               launches=launches, expected_launches=expect,
               slab_ab=slabs, pool_2_20=big)
    print("wavefront", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit("wavefront render is not a finite, non-black image")
    if launches != expect:
        raise SystemExit(f"wavefront launch counts {launches} != {expect}")
    if not slabs["rmse_off_vs_on"] <= GATE_WF_RMSE:
        raise SystemExit("the wavefront without slabs differs from the "
                         "slab-marched render")
    return rep


def _slab_ab(r, img, on_s):
    """The render's pool pass (seed 0, 8 samples) without slab marching,
    twice, then with it once more: ms/spp in the order on (the render),
    off, off, on, the no-slab pass's stats and its image's RMSE against
    the render's."""
    from dataclasses import replace

    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    p = WAVEFRONT
    out = dict(order=["on", "off", "off", "on"],
               ms_per_spp=[1000.0 * on_s / p["spp"]])
    for march in (0.0, 0.0, None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, val = wf.render_samples_wavefront(
            r.arrays, r.luts, r.camera, replace(r.cfg, slab_march=march),
            r._px, r._py, 0, spp_batch=p["spp"])
        torch.cuda.synchronize()
        out["ms_per_spp"].append(1000.0 * (time.perf_counter() - t0)
                                 / p["spp"])
        if march == 0.0:
            off, out["off_stats"] = val, dict(wf.LAST_STATS)
    got = (r._raster(off) / p["spp"]).reshape(img.shape).cpu().numpy()
    out["rmse_off_vs_on"] = float(np.sqrt(((got - img) ** 2).mean()))
    return out


def phase_wavefront_vs_megakernel(device):
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    p = MK_VS_WF
    imgs = {}
    for integ in ("megakernel", "wavefront"):
        r = Renderer(*_scene("grid"), p["width"], p["height"],
                     max_bounce=p["max_bounce"], integrator=integ,
                     device=device)
        imgs[integ] = r.render(spp=p["spp"])
    a, b = imgs["megakernel"], imgs["wavefront"]
    rep = dict(scene="grid", rmse=float(np.sqrt(((a - b) ** 2).mean())),
               max_abs=float(np.abs(a - b).max()), gate_rmse=GATE_WF_RMSE,
               mean_megakernel=float(a.mean()), mean_wavefront=float(b.mean()))
    print("wavefront-vs-megakernel", json.dumps(rep))
    if not (rep["rmse"] <= GATE_WF_RMSE and b.mean() > 0):
        raise SystemExit("wavefront differs from the megakernel on the card")
    return rep


def phase_cpu_vs_card(device, name, integrator="megakernel"):
    import torch

    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    p = SMALL
    imgs = {}
    for dev in (torch.device("cpu"), device):
        r = Renderer(*_scene(name), p["width"], p["height"],
                     max_bounce=p["max_bounce"], integrator=integrator,
                     device=dev)
        imgs[dev.type] = r.render(spp=p["spp"])
    a, b = imgs["cpu"], imgs[device.type]
    rmse = float(np.sqrt(((a - b) ** 2).mean()))
    diverged = float((np.abs(a - b).max(-1) > 1e-3 * (1.0 + np.abs(a).max(-1)))
                     .mean())
    rep = dict(scene=name, integrator=integrator,
               world_tris=r.arrays.world_tris.shape[0],
               rmse=rmse, gate_rmse=GATE_RMSE, diverged_pixels=diverged,
               gate_diverged=GATE_DIVERGED_FRACTION, mean_cpu=float(a.mean()),
               mean_card=float(b.mean()))
    print("cpu-vs-card", json.dumps(rep))
    if rmse > GATE_RMSE or diverged > GATE_DIVERGED_FRACTION:
        raise SystemExit(f"{name}: card render differs from the CPU render")
    return rep


def _build_all():
    """Build both kernel libraries, the two nvcc runs in parallel."""
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    with ThreadPoolExecutor(2) as pool:
        futures = {src: pool.submit(mod.kernels) for src, mod in
                   (("brute_sweep.cu", brute), ("worklist.cu", wl))}
    for src, fut in futures.items():
        built = fut.result()
        print(f"build: {src} -> {built.path} in {built.seconds:.1f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas:", line.strip())


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    device = torch.device("cuda")

    t_start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("1 build", _build_all)
    reports, times = phase("2 dense kernels", phase_kernels, device)
    wl_reports, wl_times, wl_cull, wl_work = phase(
        "2b work-list kernels", phase_worklist_kernels, device)
    _, _, g_errs, g_pool = phase("2c grouped kernels",
                                 phase_grouped_kernels, device)
    cornell = phase("3 Cornell render", phase_render, device, "cornell")
    grid = phase("3b sphere-grid render", phase_render, device, "grid")
    wave = phase("3c wavefront render", phase_wavefront, device)
    phase("3d wavefront vs megakernel", phase_wavefront_vs_megakernel,
          device)
    phase("4 Cornell card vs CPU", phase_cpu_vs_card, device, "cornell")
    phase("4b small grid card vs CPU", phase_cpu_vs_card, device,
          "small_grid")
    phase("4c small grid wavefront card vs CPU", phase_cpu_vs_card, device,
          "small_grid", "wavefront")
    if "jax" in sys.modules:
        raise SystemExit("the port imported jax")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    brute_src = "directcomputeraytracing_tpu_torch/csrc/brute_sweep.cu"
    wl_src = "directcomputeraytracing_tpu_torch/csrc/worklist.cu"
    ref_wl = "directcomputeraytracing_tpu/accel/worklist.py"
    top = times["cornell32_moeller"]   # the main path's scene and test
    n, tris = N_RAYS, 32
    brute_closest_bound = _bound(FLOPS_MOELLER * n * tris,
                                 45 * n + 48 * tris)
    brute_any_bound = _bound(FLOPS_MOELLER * n * tris, 29 * n + 48 * tris)
    wl_closest_err = max(r["closest_max_abs_err"] for r in wl_reports)
    wl_any_err = max(r["any_max_abs_err"] for r in wl_reports)

    def row(name, src, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        row("brute_closest", brute_src,
            "directcomputeraytracing_tpu/accel/pallas_brute.py:128",
            cornell["launches"]["brute_closest"],
            max(r["closest_max_abs_err"] for r in reports),
            top["closest_ms"], top["closest_twin_ms"], brute_closest_bound),
        row("brute_any", brute_src,
            "directcomputeraytracing_tpu/accel/pallas_brute.py:179",
            cornell["launches"]["brute_any"],
            max(r["any_max_abs_err"] for r in reports),
            top["any_ms"], top["any_twin_ms"], brute_any_bound),
        row("cull_boxes", wl_src, f"{ref_wl}:365",
            grid["launches"]["cull_boxes"], wl_cull["err"],
            wl_times["cull_ms"], wl_times["cull_twin_ms"], wl_work["cull"]),
        row("refine", wl_src, f"{ref_wl}:445", grid["launches"]["refine"],
            wl_cull["refine_err"], wl_times["refine_ms"],
            wl_times["refine_twin_ms"], wl_work["refine"]),
        row("sweep_closest", wl_src, f"{ref_wl}:678",
            grid["launches"]["sweep_closest"], wl_closest_err,
            wl_times["closest_ms"], wl_times["closest_twin_ms"],
            wl_work["sweep_closest"]),
        row("sweep_any", wl_src, f"{ref_wl}:866",
            grid["launches"]["sweep_any"], wl_any_err, wl_times["any_ms"],
            wl_times["any_twin_ms"], wl_work["sweep_any"]),
        row("sweep_closest_grouped", wl_src, f"{ref_wl}:1000",
            wave["launches"]["sweep_closest_grouped"], g_errs["closest"],
            g_pool["closest_ms"], g_pool["closest_twin_ms"],
            g_pool["closest_bound"]),
        row("sweep_any_grouped", wl_src, f"{ref_wl}:1113",
            wave["launches"]["sweep_any_grouped"], g_errs["any"],
            g_pool["any_ms"], g_pool["any_twin_ms"], g_pool["any_bound"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
