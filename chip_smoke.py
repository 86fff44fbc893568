"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc
(CUDA_HOME, PATH or /usr/local/cuda). It imports no jax. Phases, in order;
any failure exits non-zero:

1. setup: print the card's name and power limit, build the dense-sweep,
   work-list, clustered, pair, ray-prep and probe kernels
   (csrc/brute_sweep.cu, csrc/worklist.cu, csrc/clustered.cu,
   csrc/pairsweep.cu, csrc/prep.cu, csrc/probes.cu; the six nvcc runs in
   parallel) and print the build times and ptxas reports;
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
2c. grouped work-list kernels (closest and any-hit) against their twins
   and against the per-ray sweeps on the three 1M-ray sets of 2b plus the
   random set sorted by `ray_sort_key` (like a permuted pool) and a
   pool-sized (2^18) sorted set, Baldwin-Weber and watertight: mismatch
   counts of every field, `iters` equality against the twin; the twins
   run on the first 2^18 rays of the incoherent sets, where a 1M-ray
   twin cast would take minutes, and on the whole camera set; CUDA-event
   times of grouped and per-ray kernels, clusters swept per ray;
2d. instanced work-list kernels (closest and any-hit sweeps) against their
   twins on sphere_grid(27, 27) (1,073,092 world triangles from 1,476
   local ones, in the instanced tables), Baldwin-Weber and watertight:
   1,048,576 tiled camera rays, 1,048,576 shadow rays towards the lamp,
   1,048,576 random rays from inside the box sorted by `ray_sort_key`,
   and a pool-sized (2^18) sorted set. The twins run on 64 blocks spread
   over each set (65,536 rays; a 1M-ray twin cast takes minutes), where
   kernel and twin must agree in every field of the sweep state and the
   kernels' item lists must equal the twins'; CUDA-event times, bounds
   and the census (items per block, clusters swept per ray) on the whole
   sets, beside the soup's census of 2b;
2e. instanced against soup: sphere_grid(12, 12) flattened twice, as the
   world soup and forced onto the instanced tables (SOUP_MAX_TRIS
   lowered): on 1,048,576 camera rays, watertight and Baldwin-Weber,
   equal hit masks, t within rtol 3e-5, triangle and instance ids equal
   except at near-ties (2^-12), but for rays the two roundings of the
   geometry part: watertight, a nearer hit within 1e-4 (barycentric) of
   an edge; Baldwin-Weber, a crack of that test, where the nearer hit is
   the watertight one (counted and listed); then both rendered at
   256x256, 4 spp, within the CPU-vs-card gates;
2f. clustered kernels (cull, closest and any-hit sweeps) on
   sphere_grid(12, 12), Moeller and watertight: 1,048,576 tiled camera
   rays, 1,048,576 shadow rays towards the lamp, 1,048,576 random rays
   from inside the box sorted by `ray_sort_key`, and a pool-sized (2^18)
   sorted set. The cull kernel's masks must equal its twin's on every
   set, and contain the exact per-ray masks on 64 blocks spread over it;
   the sweeps must equal their twins in every field on those 64 blocks
   (a 1M-ray twin cast takes seconds to minutes), and the dense sweep
   over the world soup on the whole set: hits and t equal, ids equal but
   at exact-t ties (counted); CUDA-event times, bounds, and the census
   (clusters and groups entered per block, tests per ray);
2g. pair kernels (emission, closest and any-hit pair sweeps) against
   their twins on sphere_grid(12, 12), Baldwin-Weber and watertight:
   1,048,576 shadow rays towards the lamp, 1,048,576 random rays sorted
   by `ray_sort_key`, and the pool-sized (2^18) sorted set. The emission
   grid must equal its twin's on the whole set, the sweeps their twins
   in every per-pair field on the pairs of 64 spread blocks, and the
   pair casts `worklist_closest` / `worklist_any` in every hit field on
   the whole set (`iters` at least the work list's); CUDA-event times of
   each step (emission, `nonzero`, the pair list, the sweep, the
   reduction) and of the whole pair, work-list and grouped casts, the
   peak memory of a pair cast, bounds, and the census (items, cells,
   pairs per ray, pairs per chunk, clusters swept per pair);
2h. the ray-prep kernel against `prep_rays_torch` on the three 1M-ray
   sets of 2b, the random set in `ray_sort_key` order and a 1M-ray set
   with NaN, inf, zero, +-1e-31, -0.0 and denormal components injected,
   each without and with a per-ray t_max: od and tm bit-equal; CUDA-event
   times of the kernel and the twin's route on the camera rays;
2i. the probes through the port's tools (`tools/probe_worklist.py`,
   `tools/prof_prep.py`), their launches counted from 0: the item-list
   kernel at the reference probe's four capacities (64 blocks, 4096
   slabs, 1,024 to 262,144 items), equal to its twin, ms and ns per item
   beside `sweep_closest`'s cost per item on 2b's camera rays; the
   (2^20, 16) transpose bit-equal to `.T.contiguous()` (the library
   call, timed) and to its twin, beside the layout routes (the twin's
   cat-and-transpose prep, the prep kernel, a 36 MB copy);
3. the main path: Cornell glossy 1024x1024, 16 spp, max_bounce 4 through
   `Renderer.render`, with the kernels' launch counts checked against
   spp * (max_bounce + 2) * chunks (closest) and spp * (max_bounce + 1) *
   chunks (any-hit);
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
3e. the main path on the instanced scene: sphere_grid(27, 27) 1024x1024,
   16 spp, max_bounce 4, after a warm-up; the launch rule of 3b with the
   instanced sweeps, and no soup, grouped or dense sweep;
3f. the wavefront on the instanced scene: 1920x1080, 4 spp, max_bounce
   4, default pool and slab marching, after a warm-up; the rule of 3c
   with the instanced sweeps;
3g. the main path through traversal_backend="pallas_cluster":
   sphere_grid(12, 12) 1024x1024, max_bounce 4, after a one-sample
   warm-up; culls, closest sweeps and any-hit sweeps each one per cast
   (spp * (max_bounce + 2) closest and spp * (max_bounce + 1) any-hit
   casts), no other kernel launched;
3h. the wavefront through "pallas_cluster": sphere_grid(12, 12) at
   1920x1080, max_bounce 4, one pool pass, after a warm-up; ms/spp,
   `LAST_STATS`, peak memory; launches one per pool cast that
   `LAST_STATS` counts, and no slab phase;
3i. the main path through traversal_backend="pallas_pair":
   sphere_grid(12, 12) 1024x1024, 4 spp, max_bounce 4, after a one-sample
   warm-up: one cull per cast (one refine where the hyper cull admitted
   something), one emission per cast with items, one pair sweep per cast
   with pairs; pair sweeps plus empty casts equal spp * (max_bounce + 2)
   closest and spp * (max_bounce + 1) any-hit casts; no other sweep;
3j. the wavefront with pool_backend="pallas_pair": sphere_grid(12, 12) at
   1920x1080, 4 spp in one pool pass, max_bounce 4, default slabs, after
   a warm-up: ms/spp, `LAST_STATS`, peak memory, the launch rule of 3i
   over the pool casts `LAST_STATS` counts (slab phases included), and
   the image against the grouped sweep's pass at the same seed (timed
   beside it), RMSE <= 1e-3;
3k. the alpha-tested main path: `alpha_sphere_grid(12, 12)` (the spheres
   of override 1 at opacity 0.4: the opaque/masked split, 8,192 clusters
   a side) 1024x1024, 4 spp, max_bounce 4, after a one-sample warm-up:
   ms/spp, peak memory, recast passes per cast, and the rule of 3b where
   every cast is one opaque cast and one recast loop (`alpha_calls`) and
   every recast pass (`alpha_passes`) one more closest cast: prep
   launches equal the work-list casts made, recast passes and opaque
   split casts included;
3l. the wavefront on the same scene, 1920x1080, 2 spp, one pool pass
   after a warm-up: `LAST_STATS` and the rule of 3k over the pool casts;
3m. the textured variant (opacity 1, the dot-grid mask over the
   spheres' UVs), megakernel 1024x1024, 2 spp: the rule of 3k;
4. the card's render against the port's CPU render, Cornell (64x64,
   4 spp), 4b. sphere_grid(3, 3, stacks=12, slices=16) (64x64, 4 spp),
   4c. the same small grid through the wavefront, 4d. the same small
   grid forced onto the instanced tables (megakernel), 4e. the same
   small grid through "pallas_cluster" (megakernel), 4f. the same small
   grid through the wavefront with pool_backend="pallas_pair", 4g. the
   same small grid through the megakernel with slab_march=0.03, 4h. the
   alpha-tested panel (the dense sweep, megakernel), 4i. the small grid
   with alpha through the wavefront and 4j. its textured variant
   (megakernel);
5. one JSON line listing the nineteen kernels, then the contract line,
   last.

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
`plain_ms` in the kernels line times that twin). The instanced kernels
must equal their twins in every field, `iters` included, and so must
the clustered kernels, whose masks are bit-equal to the cull twin's.

Bounds (`bound_ms` of the kernels line): the larger of the counted
floating-point operations at 67 TFLOP/s and the bytes read and written
once at 3.35 TB/s (the H100 SXM's published float32 and memory rates),
from this run's inputs: a Moeller test 45 operations, a Baldwin-Weber
test 31, a slab test of a ray and a box 20; the work-list sweeps count
the fine cull of every item of the ray's block and 16 triangle tests per
cluster the per-ray walk swept (the any-hit sweeps only the fine cull, a
lower bound; the instanced sweeps leave out the move of the ray to
instance space, also a lower bound); tables count once, whole. The
clustered cull counts FLOPS_INTERVAL operations per (ray block,
cluster), its closest sweep one Moeller test per ray and row of every
cluster the ray's block entered, its any-hit sweep the same for the rays
that end unoccluded only (they test everything; the others stop early).
The pair emission counts 20 operations a cell against the grid written
and the rays, caps, items and super boxes read once; the pair closest
sweep the fine cull of every pair (32 slab tests) and 16 triangle tests
per cluster its walk swept, the any-hit sweep the fine cull only (a
lower bound), against the pair list, rays, per-pair outputs and tables
read or written once. The pair kernels must equal their twins in every
field. The ray prep counts 24 bytes read a ray and 40 written a padded
ray (14 operations a ray bound nothing); the item-list probe 23
operations a (row, lane) of each item against the items, the slab table
and the rays read once; the transpose 64 bytes read and 64 written a
row. Prep and probes must equal their twins bit for bit.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext

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
INST_GRID = (27, 27)                    # 1,073,092 world triangles, instanced
INST_TWIN_BLOCKS = 64                   # ray blocks of an instanced twin cast
INST_WAVEFRONT = dict(width=1920, height=1080, spp=4, max_bounce=4)
FORCED_SOUP_MAX = 2048                  # SOUP_MAX_TRIS that forces instancing
INST_VS_SOUP = dict(width=256, height=256, spp=4, max_bounce=4)
T_RTOL_INST = 3e-5
EDGE_TOL = 1e-4                         # barycentric margin of an edge hit
PEAK_FLOPS = 67e12                      # H100 SXM float32, no tensor cores
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
FLOPS_MOELLER, FLOPS_BW, FLOPS_SLAB = 45, 31, 20
# the interval cull of one (ray block, cluster) pair: per axis 4 numerator
# differences, 8 products, 14 min/max over them and 2 into the entry and
# exit, then 3 for enter
FLOPS_INTERVAL = 3 * 28 + 3
CLUSTER_TWIN_BLOCKS = 64                # ray blocks of a clustered twin cast
CLUSTER_RENDER = dict(width=1024, height=1024, spp=4, max_bounce=4)
CLUSTER_WAVEFRONT = dict(width=1920, height=1080, spp=2, max_bounce=4)
PAIR_TWIN_BLOCKS = 64                   # ray blocks of a pair twin sweep
PAIR_RENDER = dict(width=1024, height=1024, spp=4, max_bounce=4)
PAIR_WAVEFRONT = dict(width=1920, height=1080, spp=4, max_bounce=4)
ALPHA_RENDER = dict(width=1024, height=1024, spp=4, max_bounce=4)
ALPHA_WAVEFRONT = dict(width=1920, height=1080, spp=2, max_bounce=4)
ALPHA_TEX_RENDER = dict(width=1024, height=1024, spp=2, max_bounce=4)


def _timed(fn, reps, warm=True):
    """Mean ms of fn() over reps launches, after one warm-up launch unless
    warm is False (CUDA events)."""
    import torch

    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_call(fn):
    """(fn(), its ms) of one launch, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def _grid_ray_sets(rng, cam, device):
    """The three 1M-ray sets of the sphere grid: tiled camera rays, random
    rays from inside the scene box and shadow rays towards the lamp, each
    (o, d, t_max)."""
    import torch

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = [-18.0, 0.01, -18.0], [18.0, 6.9, 18.0]
    side = int(np.sqrt(N_RAYS))
    o_cam, d_cam = _tiled_camera_rays(cam, side, side, device)
    o_in, d_in = _rays_inside(rng, N_RAYS, lo, hi)
    o_sh = rng.uniform([-9.0, 0.01, -9.0], [9.0, 1.5, 9.0], (N_RAYS, 3))
    to_lamp = rng.uniform([-2.0, 7.0, -2.0], [2.0, 7.0, 2.0],
                          (N_RAYS, 3)) - o_sh
    dist = np.linalg.norm(to_lamp, axis=1)
    return {
        "camera": (o_cam, d_cam, f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "random": (f32(o_in), f32(d_in), f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "shadow": (f32(o_sh), f32(to_lamp / dist[:, None]),
                   f32(0.999 * dist)),
    }


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

    sets = _grid_ray_sets(rng, to_device(cam, device), device)
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
    return reports, times, cull, work, census


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


def _spread_blocks(n_rays, n_blocks, device):
    """Indices of the rays of n_blocks RB-ray blocks spread evenly over
    n_rays rays."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    nb = n_rays // wl.RB
    blocks = torch.arange(0, nb, max(1, nb // n_blocks),
                          device=device)[:n_blocks]
    return (blocks[:, None] * wl.RB
            + torch.arange(wl.RB, device=device)).reshape(-1)


def _inst_bounds(tables, it_c, it_a, iters, rp, watertight):
    """(closest, any) bounds of the instanced sweeps on one ray set: the
    work-list sweeps' count (module docstring); the tables are the world
    child boxes, the local slab, the per-super ids and the instance rows."""
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    tab = tables.ctab if watertight else tables.bwtab
    table_bytes = 4 * (tables.cbox3.numel() + tab.numel()
                       + tables.inst_rows.numel() + 2 * tables.sbox.shape[0])
    fine = FLOPS_SLAB * tables.cbox3.shape[1]
    n_c, n_a = int(it_c.seg[-1]), int(it_a.seg[-1])
    test = FLOPS_MOELLER if watertight else FLOPS_BW
    return (_bound(fine * wl.RB * n_c + 16 * test * int(iters.long().sum()),
                   69 * rp + 12 * n_c + table_bytes),
            _bound(fine * wl.RB * n_a, 41 * rp + 8 * n_a + table_bytes))


def phase_instanced_kernels(device, soup_census):
    """Instanced kernels against their twins on sphere_grid(27, 27); kernel
    times, bounds and the census on four ray sets; the kernels line's rows
    at the camera rays."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261019)
    scene, cam = _scene("inst_grid")
    t0 = time.perf_counter()
    arrays, _ = flatten_scene(scene, device)
    flatten_s = time.perf_counter() - t0
    tables = wl.scene_tables(arrays)
    print("instanced scene", json.dumps(dict(
        world_tris=_world_tris(scene), local_tris=arrays.triangles.shape[0],
        instances=arrays.inst_rows.shape[0],
        local_clusters=arrays.icl_slab.shape[0] // 16,
        supers=tables.sbox.shape[0],
        hypers=None if tables.hbox is None else tables.hbox.shape[0],
        flatten_s=flatten_s)))
    if tables.inst_rows is None or tables.hbox is None:
        raise SystemExit("sphere_grid(27, 27) should use the instanced "
                         "tables and the hyper level")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = [-21.0, 0.01, -21.0], [21.0, 6.9, 21.0]
    side = int(np.sqrt(N_RAYS))
    o_cam, d_cam = _tiled_camera_rays(to_device(cam, device), side, side,
                                      device)
    o_sh = rng.uniform([-20.0, 0.01, -20.0], [20.0, 1.5, 20.0], (N_RAYS, 3))
    to_lamp = rng.uniform([-2.0, 7.0, -2.0], [2.0, 7.0, 2.0],
                          (N_RAYS, 3)) - o_sh
    dist = np.linalg.norm(to_lamp, axis=1)
    o_in, d_in = (f32(x) for x in _rays_inside(rng, N_RAYS, lo, hi))
    o_pool, d_pool = (f32(x) for x in _rays_inside(rng, POOL_RAYS, lo, hi))
    sets = {
        "camera": (o_cam, d_cam, f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "shadow": (f32(o_sh), f32(to_lamp / dist[:, None]),
                   f32(0.999 * dist)),
        "random_sorted": (*_sorted_rays(tables, o_in, d_in),
                          f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "pool_sorted": (*_sorted_rays(tables, o_pool, d_pool),
                        f32(rng.uniform(0.5, 30.0, POOL_RAYS))),
    }
    t_min = 1e-4
    reports, census, errs = [], {}, dict(closest=0.0, any=0.0)

    def prepared(o, d, t_max, plain=False):
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        return (od, tm_c, tm_a, wl.scene_exit(tables, od),
                wl.phases(tables, od, tm_c, plain),
                wl.phases(tables, od, tm_a, plain))

    for name, (o, d, t_max) in sets.items():
        od, tm_c, tm_a, texp, it_c, it_a = prepared(o, d, t_max)
        idx = _spread_blocks(o.shape[0], INST_TWIN_BLOCKS, device)
        od_s, _, tm_as, texp_s, it_cs, it_as = prepared(o[idx], d[idx],
                                                        t_max[idx])
        plain = prepared(o[idx], d[idx], t_max[idx], plain=True)
        items_equal = all(torch.equal(a, b) for it, it_w in
                          ((it_cs, plain[4]), (it_as, plain[5]))
                          for a, b in zip(it, it_w))
        nb, r = od.shape[1] // wl.RB, o.shape[0]
        counts = (it_c.seg[1:] - it_c.seg[:-1]).float()
        census[name] = dict(items_per_block=float(counts.mean()),
                            items_per_block_max=int(counts.max()),
                            any_items_per_block=int(it_a.seg[-1]) / nb)
        for wt in (False, True):
            k = wl.sweep_closest_inst(tables, it_c, od, texp, t_min, wt)
            ks = wl.sweep_closest_inst(tables, it_cs, od_s, texp_s, t_min, wt)
            kas = wl.sweep_any_inst(tables, it_as, od_s, tm_as, t_min, wt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = wl.sweep_closest_inst_torch(tables, it_cs, od_s, texp_s,
                                            t_min, wt)
            wa = wl.sweep_any_inst_torch(tables, it_as, od_s, tm_as, t_min,
                                         wt)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            hit = torch.isfinite(wl.decode_closest(k, texp, it_c.block_any,
                                                   r)[0])
            iters = k[7][:r]
            timing = dict(
                closest_ms=_timed(lambda: wl.sweep_closest_inst(
                    tables, it_c, od, texp, t_min, wt), 3),
                any_ms=_timed(lambda: wl.sweep_any_inst(
                    tables, it_a, od, tm_a, t_min, wt), 3))
            bc, ba = _inst_bounds(tables, it_c, it_a, iters, od.shape[1], wt)
            rep = dict(case=name, watertight=wt, rays=r,
                       twin_rays=int(idx.numel()), twin_s=twin_s,
                       items_equal=items_equal,
                       vs_twin=_sweep_diffs(ks, w, range(8)),
                       vs_twin_occ=int((kas != wa).sum()),
                       hits=int(hit.sum()),
                       twin_occluded=int(wa.sum()),
                       iters_per_ray=float(iters.float().mean()),
                       iters_per_hit=float(iters[hit].float().mean()),
                       **timing, closest_bound=bc, any_bound=ba,
                       closest_share=bc[0] / timing["closest_ms"],
                       any_share=ba[0] / timing["any_ms"])
            rep["ok"] = (items_equal and not any(rep["vs_twin"].values())
                         and rep["vs_twin_occ"] == 0)
            errs["closest"] = max(errs["closest"], *(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(ks[1:4], w[1:4])))
            errs["any"] = max(errs["any"], float((kas != wa).float().max()))
            if not wt:
                census[name].update(iters_per_ray=rep["iters_per_ray"],
                                    iters_per_hit=rep["iters_per_hit"],
                                    hit_fraction=float(hit.float().mean()))
            reports.append(rep)
            print("instanced-kernel", json.dumps(rep))
    print("instanced census", json.dumps(dict(
        instanced_27x27=census, soup_12x12=soup_census)))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"instanced kernel/twin mismatch: {bad}")

    # the kernels line's rows: the main path's first cast, 1M camera rays,
    # Baldwin-Weber; the twins timed once each on the whole set
    o, d, t_max = sets["camera"]
    od, tm_c, tm_a, texp, it_c, it_a = prepared(o, d, t_max)
    cam_rep = next(r for r in reports
                   if r["case"] == "camera" and not r["watertight"])
    row = dict(
        closest_ms=cam_rep["closest_ms"], any_ms=cam_rep["any_ms"],
        closest_bound=cam_rep["closest_bound"],
        any_bound=cam_rep["any_bound"],
        closest_twin_ms=_timed(lambda: wl.sweep_closest_inst_torch(
            tables, it_c, od, texp, t_min, False), 1, warm=False),
        any_twin_ms=_timed(lambda: wl.sweep_any_inst_torch(
            tables, it_a, od, tm_a, t_min, False), 1, warm=False))
    print("instanced-row", json.dumps(row))
    return reports, errs, row


@contextmanager
def _forced_instanced():
    """Flatten scenes onto the instanced tables from FORCED_SOUP_MAX world
    triangles up, as the tests force them."""
    from directcomputeraytracing_tpu_torch.scene import scene as scene_mod

    old = scene_mod.SOUP_MAX_TRIS
    scene_mod.SOUP_MAX_TRIS = FORCED_SOUP_MAX
    try:
        yield
    finally:
        scene_mod.SOUP_MAX_TRIS = old


def _casts_diff(a, b):
    """Rays where closest hits a and b disagree beyond the gate: hit mask,
    t beyond rtol T_RTOL_INST, or triangle or instance ids apart from a
    near-tie (t within 2^-12 relative)."""
    both = a.hit & b.hit
    dt = (a.t - b.t).abs()
    ids = (a.triangle != b.triangle) | (a.instance != b.instance)
    return (a.hit != b.hit) | (both & ((dt > T_RTOL_INST * a.t.abs())
                                       | (ids & (dt > TIE_WL * a.t.abs()))))


def phase_instanced_vs_soup(device):
    """sphere_grid(12, 12) as the world soup and forced onto the instanced
    tables: the same geometry through two kernel families, which round it
    apart (world vertices against a ray moved to mesh space). With the
    watertight test a ray may disagree only where its nearer hit lies
    within EDGE_TOL (barycentric) of its triangle's edge: at a silhouette
    one cast grazes the triangle and the other passes and hits something
    behind. The Baldwin-Weber test is not watertight: a ray may disagree
    only where one cast went through the crack between two triangles,
    i.e. its nearer hit is the watertight soup cast's (t within 2^-12).
    Such rays are counted and listed; any other disagreement fails."""
    import torch

    from directcomputeraytracing_tpu_torch.accel.traverse import (
        intersect_closest,
    )
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    scene, cam = _scene("grid")
    soup, _ = flatten_scene(scene, device)
    with _forced_instanced():
        inst, _ = flatten_scene(_scene("grid")[0], device)
    if inst.isup_inst.shape[0] <= 1 or soup.cluster_bbox.shape[0] <= 1:
        raise SystemExit("sphere_grid(12, 12): expected soup clusters and "
                         "forced instanced tables")
    side = int(np.sqrt(N_RAYS))
    o, d = _tiled_camera_rays(to_device(cam, device), side, side, device)
    rep = dict(rays=o.shape[0], edge_tol=EDGE_TOL)
    t_wt = None
    for wt in (True, False):
        a = intersect_closest(soup, o, d, watertight=wt)
        b = intersect_closest(inst, o, d, watertight=wt)
        both = a.hit & b.hit
        same = both & (a.triangle == b.triangle) & (a.instance == b.instance)
        bad = _casts_diff(a, b)
        near_a = a.t <= b.t
        u, v = torch.where(near_a, a.u, b.u), torch.where(near_a, a.v, b.v)
        if wt:
            t_wt = a.t
            why = torch.minimum(torch.minimum(u, v), 1.0 - u - v) <= EDGE_TOL
        else:
            why = torch.isfinite(t_wt) & (
                (torch.minimum(a.t, b.t) - t_wt).abs() <= TIE_WL * t_wt)
        rays = torch.nonzero(bad)[:, 0][:20]
        rep["watertight" if wt else "baldwin_weber"] = dict(
            hits=int(a.hit.sum()), hit_diff=int((a.hit != b.hit).sum()),
            id_diff=int((both & ~same).sum()), outside_gate=int(bad.sum()),
            explained=int((bad & why).sum()),
            unexplained=int((bad & ~why).sum()),
            max_rel_dt_same_triangle=float(torch.where(
                same, (a.t - b.t).abs() / a.t.abs(), 0.0).max()),
            back_agree=float((a.backface == b.backface)[same].float()
                             .mean()),
            outside=[dict(ray=int(i), t=[float(a.t[i]), float(b.t[i])],
                          tri=[int(a.triangle[i]), int(b.triangle[i])],
                          inst=[int(a.instance[i]), int(b.instance[i])],
                          uv=[float(u[i]), float(v[i])]) for i in rays])
    imgs = {name: _renderer(name, INST_VS_SOUP, device)[0].render(
        spp=INST_VS_SOUP["spp"]) for name in ("grid", "grid_forced")}
    x, y = imgs["grid"], imgs["grid_forced"]
    rep.update(render=_image_diff(x, y), mean_soup=float(x.mean()),
               mean_instanced=float(y.mean()))
    print("instanced-vs-soup", json.dumps(rep))
    if (rep["watertight"]["unexplained"] or rep["baldwin_weber"]["unexplained"]
            or not _image_ok(rep["render"]) or not y.mean() > 0):
        raise SystemExit(f"instanced casts differ from the soup's: {rep}")
    return rep


def _vs_dense(tables, cmask, o, d, k, ka, dense, dense_a):
    """The clustered cast (k, ka) against the dense sweep over the world
    soup (dense, dense_a): the same test on the same vertices, so hits, t
    and the same triangle's u, v, instance and side are equal; the ids
    differ only where two triangles give the very same t (exact-t ties:
    the two visit the triangles in other orders). A ray whose hits
    differ is explained (an edge graze, counted and listed) where the
    dense hit's cluster was not entered and the ray's own slab test of
    that cluster's box misses it: the box test and the triangle test
    round the ray apart at the box's boundary, and the reference's exact
    masks leave that cluster out as well."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import clustered as cl

    hk, hd = torch.isfinite(k[0]), torch.isfinite(dense[0])
    both = hk & hd
    ids = both & ((k[3] != dense[3]) | (k[4] != dense[4]))
    same = both & ~ids
    fields = ((k[1] != dense[1]) | (k[2] != dense[2]) | (k[5] != dense[5]))
    hit_rays = torch.nonzero(hk != hd)[:, 0]
    listed, explained = [], 0
    for i in hit_rays[:20].tolist():
        rows = torch.nonzero((tables.ctab[:, 9] == float(dense[3][i]))
                             & (tables.ctab[:, 10] == float(dense[4][i])))
        c = int(rows[0, 0]) // cl.CLUSTER_SIZE if rows.numel() else -1
        box = tables.cbox[c]
        inv = cl._safe_inv(d[i])
        a, b = (box[0:3] - o[i]) * inv, (box[3:6] - o[i]) * inv
        t_lo = torch.minimum(a, b).max()
        t_hi = torch.maximum(a, b).min()
        entered = bool(cmask[i // cl.RAY_BLOCK, c])
        box_miss = bool((t_hi < t_lo) | (t_hi < 0.0))
        u, v = float(dense[1][i]), float(dense[2][i])
        explained += int(not entered and box_miss)
        listed.append(dict(ray=i, t=[float(k[0][i]), float(dense[0][i])],
                           tri=int(dense[3][i]), cluster=c,
                           block_entered=entered, box_t=[float(t_lo),
                                                         float(t_hi)],
                           uv=[u, v], margin=min(u, v, 1.0 - u - v)))
    n_hit = int(hit_rays.numel())
    return dict(hit_diff=n_hit,
                hit_diff_unexplained=n_hit - explained,
                t_diff=int((both & (k[0] != dense[0])).sum()),
                id_diff=int(ids.sum()),
                uv_back_diff_same_triangle=int((same & fields).sum()),
                occ_diff=int((ka != dense_a).sum()), hit_diff_rays=listed)


def _cluster_census(cmask, gmask, r):
    """Clusters and groups entered per ray block, and triangle tests per
    ray of a closest sweep (every row of every cluster its block
    entered)."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import clustered as cl

    per_block = cmask.sum(1, dtype=torch.int64)
    rays = torch.full_like(per_block, cl.RAY_BLOCK)
    rays[-1] = r - cl.RAY_BLOCK * (per_block.shape[0] - 1)
    tests = int((per_block * rays).sum()) * cl.CLUSTER_SIZE
    return dict(clusters_per_block=float(per_block.float().mean()),
                clusters_per_block_max=int(per_block.max()),
                clusters=cmask.shape[1],
                groups_per_block=float(gmask.float().sum(1).mean()),
                groups=gmask.shape[1], tests_per_ray=tests / r,
                tests=tests)


def _cluster_bounds(tables, cmask, gmask, r, occ):
    """(cull, closest, any) bounds of one clustered cast of r rays; occ
    the any-hit result (its unoccluded rays test every entered row)."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import clustered as cl

    nb, cg = cmask.shape
    masks = nb * (cg + gmask.shape[1])
    table = 4 * (tables.ctab.numel() + tables.cbox.numel())
    per_ray = cmask.sum(1, dtype=torch.int64) \
        .repeat_interleave(cl.RAY_BLOCK)[:r]
    rows = cl.CLUSTER_SIZE * FLOPS_MOELLER
    return (_bound(FLOPS_INTERVAL * nb * cg, 24 * r + 32 * cg + masks),
            _bound(rows * int(per_ray.sum()), 45 * r + masks + table),
            _bound(rows * int(per_ray[~occ].sum()), 29 * r + masks + table))


def phase_clustered_kernels(device):
    """Clustered kernels against their twins and the dense sweep on
    sphere_grid(12, 12); CUDA-event times, bounds and the census; the
    kernels line's rows at the camera rays."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261020)
    scene, cam = _scene("grid")
    arrays, _ = flatten_scene(scene, device)
    tables = cl.pad_cluster_tables(arrays)
    print("clustered scene", json.dumps(dict(
        world_tris=arrays.world_tris.shape[0],
        clusters=tables.cbox.shape[0], groups=tables.n_groups,
        reach=tables.reach)))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = [-18.0, 0.01, -18.0], [18.0, 6.9, 18.0]
    side = int(np.sqrt(N_RAYS))
    o_cam, d_cam = _tiled_camera_rays(to_device(cam, device), side, side,
                                      device)
    o_sh = rng.uniform([-9.0, 0.01, -9.0], [9.0, 1.5, 9.0], (N_RAYS, 3))
    to_lamp = rng.uniform([-2.0, 7.0, -2.0], [2.0, 7.0, 2.0],
                          (N_RAYS, 3)) - o_sh
    dist = np.linalg.norm(to_lamp, axis=1)
    o_in, d_in = (f32(x) for x in _rays_inside(rng, N_RAYS, lo, hi))
    o_pool, d_pool = (f32(x) for x in _rays_inside(rng, POOL_RAYS, lo, hi))
    wtab = wl.scene_tables(arrays)
    sets = {
        "camera": (o_cam.contiguous(), d_cam.contiguous(),
                   f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "shadow": (f32(o_sh), f32(to_lamp / dist[:, None]),
                   f32(0.999 * dist)),
        "random_sorted": (*_sorted_rays(wtab, o_in, d_in),
                          f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "pool_sorted": (*_sorted_rays(wtab, o_pool, d_pool),
                        f32(rng.uniform(0.5, 30.0, POOL_RAYS))),
    }
    t_min = 1e-4
    reports, census, errs = [], {}, dict(cull=0.0, closest=0.0, any=0.0)
    rows = {}
    for name, (o, d, t_max) in sets.items():
        r = o.shape[0]
        cmask, gmask = cl.cull_masks(tables, o, d)
        cm_w, gm_w = cl.cull_masks_torch(tables, o, d)
        cull_diff = int((cmask != cm_w).sum() + (gmask != gm_w).sum())
        errs["cull"] = max(errs["cull"], float(cull_diff > 0))
        idx = _spread_blocks(r, CLUSTER_TWIN_BLOCKS, device)
        blocks = idx[::cl.RAY_BLOCK] // cl.RAY_BLOCK
        cm_s, gm_s = cmask[blocks].contiguous(), gmask[blocks].contiguous()
        o_s, d_s, tm_s = o[idx], d[idx], t_max[idx]
        exact = cl.exact_masks_torch(arrays, o_s, d_s)[0]
        census[name] = dict(_cluster_census(cmask, gmask, r),
                            exact_clusters_per_block=float(
                                exact.float().sum(1).mean()),
                            spread_clusters_per_block=float(
                                cm_s.float().sum(1).mean()),
                            reaching=float(cl.reach_mask(tables, o, d)
                                           .float().mean()))
        cull_ms = _timed(lambda: cl.cull_masks(tables, o, d), 5)
        for wt in (False, True):
            k = cl.sweep_closest(tables, cmask, gmask, o, d, t_min, wt)
            ka = cl.sweep_any(tables, cmask, gmask, o, d, t_max, t_min, wt)
            ks = cl.sweep_closest(tables, cm_s, gm_s, o_s, d_s, t_min, wt)
            kas = cl.sweep_any(tables, cm_s, gm_s, o_s, d_s, tm_s, t_min, wt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = cl.sweep_closest_torch(tables, cm_s, gm_s, o_s, d_s, t_min,
                                       wt)
            wa = cl.sweep_any_torch(tables, cm_s, gm_s, o_s, d_s, tm_s,
                                    t_min, wt)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            dense, dense_ms = _timed_call(lambda: brute.brute_closest(
                arrays, o, d, t_min, wt))
            dense_a, dense_any_ms = _timed_call(lambda: brute.brute_any(
                arrays, o, d, t_max, t_min, wt))
            reps = 1 if name == "shadow" else 5
            timing = dict(
                cull_ms=cull_ms,
                closest_ms=_timed(lambda: cl.sweep_closest(
                    tables, cmask, gmask, o, d, t_min, wt), reps),
                any_ms=_timed(lambda: cl.sweep_any(
                    tables, cmask, gmask, o, d, t_max, t_min, wt), reps),
                dense_closest_ms=dense_ms, dense_any_ms=dense_any_ms)
            bc, bk, ba = _cluster_bounds(tables, cmask, gmask, r, ka)
            rep = dict(case=name, watertight=wt, rays=r,
                       twin_rays=int(idx.numel()), twin_s=twin_s,
                       cull_diff=cull_diff,
                       cull_sound=bool((cm_s >= exact).all()),
                       vs_twin={f: int((a != b).sum()) for f, a, b in zip(
                           ("t", "u", "v", "tri", "inst", "back"), ks, w)},
                       vs_twin_occ=int((kas != wa).sum()),
                       vs_dense=_vs_dense(tables, cmask, o, d, k, ka, dense,
                                          dense_a),
                       hits=int(torch.isfinite(k[0]).sum()),
                       occluded=int(ka.sum()), **timing,
                       cull_bound=bc, closest_bound=bk, any_bound=ba,
                       closest_share=bk[0] / timing["closest_ms"],
                       any_share=ba[0] / timing["any_ms"])
            vd = rep["vs_dense"]
            rep["ok"] = (cull_diff == 0 and rep["cull_sound"]
                         and not any(rep["vs_twin"].values())
                         and rep["vs_twin_occ"] == 0
                         and vd["hit_diff_unexplained"] == vd["t_diff"] == 0
                         and vd["uv_back_diff_same_triangle"] == 0
                         and vd["occ_diff"] == 0)
            errs["closest"] = max(errs["closest"], *(
                float(torch.where(torch.isfinite(a), a - b, 0.0).abs().max())
                for a, b in zip(ks[:3], w[:3])))
            errs["any"] = max(errs["any"], float((kas != wa).float().max()))
            if name == "camera" and not wt:
                rows = dict(
                    cull_ms=cull_ms, closest_ms=timing["closest_ms"],
                    any_ms=timing["any_ms"], cull_bound=bc,
                    closest_bound=bk, any_bound=ba,
                    cull_twin_ms=_timed(lambda: cl.cull_masks_torch(
                        tables, o, d), 1, warm=False),
                    closest_twin_ms=_timed(lambda: cl.sweep_closest_torch(
                        tables, cmask, gmask, o, d, t_min), 1, warm=False),
                    any_twin_ms=_timed(lambda: cl.sweep_any_torch(
                        tables, cmask, gmask, o, d, t_max, t_min), 1,
                        warm=False))
            reports.append(rep)
            print("clustered-kernel", json.dumps(rep))
    print("clustered census", json.dumps(census))
    print("clustered-row", json.dumps(rows))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"clustered kernel mismatch: {bad}")
    return reports, errs, rows, census


def _pair_bounds(tables, items, pairs, iters_p, rp, watertight, kind):
    """(emission, sweep) bounds of one pair cast: the emission 20
    operations a cell against the grid written and the rays, caps, items
    and super boxes read once; the closest sweep the fine cull of every
    pair and 16 triangle tests per cluster its walk swept, the any-hit
    sweep the fine cull only (a lower bound), against the pair list, the
    rays, the per-pair outputs and the tables once."""
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    n, p = items.sup.shape[0], pairs.ray.shape[0]
    cells = n * wl.RB
    emit = _bound(FLOPS_SLAB * cells,
                  cells + 40 * rp + 8 * n + 32 * tables.sbox.shape[0])
    tab = tables.ctab if watertight else tables.bwtab
    table_bytes = 4 * (tables.cbox3.numel() + tab.numel())
    fine = FLOPS_SLAB * wl.SUPER * p
    lists = 4 * p + 12 * pairs.chunk_sup.shape[0]
    if kind == "closest":
        test = FLOPS_MOELLER if watertight else FLOPS_BW
        sweep = _bound(fine + 16 * test * int(iters_p.long().sum()),
                       lists + 29 * p + 40 * rp + table_bytes)
    else:
        sweep = _bound(fine, lists + p + 40 * rp + table_bytes)
    return emit, sweep


def _pair_subset(tables, items, it, lane, idx):
    """The pair list of the cells whose ray lies in the ray indices idx
    (whole blocks)."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    blocks = torch.unique(idx // wl.RB)
    keep = torch.isin(ps.item_blocks(items)[it], blocks)
    return ps.pair_list(tables, items, it[keep], lane[keep])


def phase_pair_kernels(device):
    """Pair kernels against their twins and the pair casts against the
    work list on sphere_grid(12, 12); CUDA-event times of every step of a
    cast beside the work list's and the grouped sweep's; bounds, census
    and peak memory; the kernels line's rows at the pool-sorted set."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261021)
    arrays, _ = flatten_scene(_scene("grid")[0], device)
    tables = wl.scene_tables(arrays)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = [-18.0, 0.01, -18.0], [18.0, 6.9, 18.0]
    o_sh = rng.uniform([-9.0, 0.01, -9.0], [9.0, 1.5, 9.0], (N_RAYS, 3))
    to_lamp = rng.uniform([-2.0, 7.0, -2.0], [2.0, 7.0, 2.0],
                          (N_RAYS, 3)) - o_sh
    dist = np.linalg.norm(to_lamp, axis=1)
    o_in, d_in = (f32(x) for x in _rays_inside(rng, N_RAYS, lo, hi))
    o_pool, d_pool = (f32(x) for x in _rays_inside(rng, POOL_RAYS, lo, hi))
    sets = {
        "shadow": (f32(o_sh), f32(to_lamp / dist[:, None]),
                   f32(0.999 * dist)),
        "random_sorted": (*_sorted_rays(tables, o_in, d_in),
                          f32(rng.uniform(0.5, 30.0, N_RAYS))),
        "pool_sorted": (*_sorted_rays(tables, o_pool, d_pool),
                        f32(rng.uniform(0.5, 30.0, POOL_RAYS))),
    }
    t_min = 1e-4
    reports, errs, rows = [], dict(emit=0.0, closest=0.0, any=0.0), {}
    for name, (o, d, t_max) in sets.items():
        r = o.shape[0]
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        texp = wl.scene_exit(tables, od)
        cap_c = wl._window(wl._float_bits(texp) | wl._LOWM)
        idx = _spread_blocks(r, PAIR_TWIN_BLOCKS, device)
        for kind, tm, cap in (("closest", tm_c, cap_c), ("any", tm_a, tm_a)):
            items = wl.phases(tables, od, tm)
            grid = ps.emit_pairs(tables, items, od, cap, t_min)
            twin, emit_twin_ms = _timed_call(lambda: ps.emit_pairs_torch(
                tables, items, od, cap, t_min))
            emit_diff = int((grid != twin).sum())
            del twin
            emit_ms = _timed(lambda: ps.emit_pairs(tables, items, od, cap,
                                                   t_min), 3)
            it, lane = torch.nonzero(grid, as_tuple=True)
            nonzero_ms = _timed(lambda: torch.nonzero(grid, as_tuple=True),
                                3)
            cells = grid.numel()
            del grid
            pairs = ps.pair_list(tables, items, it, lane)
            list_ms = _timed(lambda: ps.pair_list(tables, items, it, lane),
                             3)
            sub = _pair_subset(tables, items, it, lane, idx)
            del it, lane
            p = pairs.ray.shape[0]
            counts = pairs.chunk_count[pairs.chunk_count > 0].float()
            for wt in (False, True):
                if kind == "closest":
                    sweep = ps.pair_sweep_closest
                    twin_fn = ps.pair_sweep_closest_torch
                    cast = ps.pair_closest
                    wl_cast = wl.worklist_closest
                    args = (texp,)
                else:
                    sweep, twin_fn = ps.pair_sweep_any, ps.pair_sweep_any_torch
                    cast, wl_cast, args = ps.pair_any, wl.worklist_any, (tm,)
                out = sweep(tables, pairs, od, *args, t_min, wt)
                sweep_ms = _timed(lambda: sweep(tables, pairs, od, *args,
                                                t_min, wt), 3)
                ks = sweep(tables, sub, od, *args, t_min, wt)
                ws = twin_fn(tables, sub, od, *args, t_min, wt)
                if kind == "closest":
                    vs_twin = _sweep_diffs(ks, ws, range(8))
                    errs["closest"] = max(errs["closest"], *(
                        float((a.float() - b.float()).abs().max())
                        for a, b in zip(ks[1:4], ws[1:4])))
                    reduce_ms = _timed(lambda: ps.reduce_closest(
                        ps._initial_state(texp), out, pairs, texp), 3)
                    iters_p = out[7]
                else:
                    vs_twin = dict(occ=int((ks != ws).sum()))
                    errs["any"] = max(errs["any"],
                                      float((ks != ws).float().max()))
                    hits = torch.zeros(od.shape[1], dtype=torch.int32,
                                       device=device)
                    reduce_ms = _timed(lambda: hits.index_add_(
                        0, pairs.ray.long(), out.to(torch.int32)), 3)
                    iters_p = None
                del out
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                if kind == "closest":
                    pc = cast(arrays, o, d, t_min, wt)
                    peak = torch.cuda.max_memory_allocated() - base
                    wc = wl_cast(arrays, o, d, t_min, wt)
                    cast_ms = _timed(lambda: cast(arrays, o, d, t_min, wt), 3)
                    wl_ms = _timed(lambda: wl_cast(arrays, o, d, t_min, wt),
                                   3)
                    wlg_ms = _timed(lambda: wl_cast(
                        arrays, o, d, t_min, wt, grouped=True), 3)
                    vs_wl = {f: int((a != b).sum()) for f, a, b in zip(
                        ("t", "u", "v", "tri", "inst", "back"), pc, wc)}
                    extra = dict(
                        iters_ge_wl=bool((pc[6] >= wc[6]).all()),
                        hits=int(torch.isfinite(pc[0]).sum()),
                        iters_per_ray=float(pc[6].float().mean()),
                        wl_iters_per_ray=float(wc[6].float().mean()),
                        swept_per_pair=float(iters_p.float().mean()))
                else:
                    pc = cast(arrays, o, d, t_max, t_min, wt)
                    peak = torch.cuda.max_memory_allocated() - base
                    wc = wl_cast(arrays, o, d, t_max, t_min, wt)
                    cast_ms = _timed(lambda: cast(arrays, o, d, t_max, t_min,
                                                  wt), 3)
                    wl_ms = _timed(lambda: wl_cast(arrays, o, d, t_max, t_min,
                                                   wt), 3)
                    wlg_ms = _timed(lambda: wl_cast(
                        arrays, o, d, t_max, t_min, wt, grouped=True), 3)
                    vs_wl = dict(occ=int((pc != wc).sum()))
                    extra = dict(occluded=int(pc.sum()))
                peak /= 2**30
                eb, sb = _pair_bounds(tables, items, pairs, iters_p,
                                      od.shape[1], wt, kind)
                rep = dict(
                    case=name, kind=kind, watertight=wt, rays=r,
                    items=items.sup.shape[0], cells=cells, pairs=p,
                    pairs_per_ray=p / r,
                    pairs_per_chunk=float(counts.mean()),
                    chunks=int(counts.numel()),
                    twin_pairs=sub.ray.shape[0], emit_diff=emit_diff,
                    vs_twin=vs_twin, vs_worklist=vs_wl, **extra,
                    emit_ms=emit_ms, emit_twin_ms=emit_twin_ms,
                    nonzero_ms=nonzero_ms, list_ms=list_ms,
                    sweep_ms=sweep_ms, reduce_ms=reduce_ms,
                    cast_ms=cast_ms, worklist_cast_ms=wl_ms,
                    grouped_cast_ms=wlg_ms, cast_peak_gib=peak,
                    emit_bound=eb, sweep_bound=sb,
                    emit_share=eb[0] / emit_ms, sweep_share=sb[0] / sweep_ms)
                rep["ok"] = (emit_diff == 0 and not any(vs_twin.values())
                             and not any(vs_wl.values())
                             and extra.get("iters_ge_wl", True))
                reports.append(rep)
                print("pair-kernel", json.dumps(rep))
                if name == "pool_sorted" and not wt:
                    twin_out, twin_ms = _timed_call(lambda: twin_fn(
                        tables, pairs, od, *args, t_min, wt))
                    del twin_out
                    rows[kind] = dict(emit_ms=emit_ms,
                                      emit_twin_ms=emit_twin_ms,
                                      emit_bound=eb, sweep_ms=sweep_ms,
                                      sweep_twin_ms=twin_ms, sweep_bound=sb)
            errs["emit"] = max(errs["emit"], float(emit_diff > 0))
            del pairs, sub
    print("pair-rows", json.dumps(rows))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"pair kernel mismatch: {bad}")
    return reports, errs, rows


def _bit_diff(a, b):
    """Elements of two float32 tensors whose bits differ."""
    import torch

    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def _injected_rays(rng, n, device):
    """n random rays with NaN and inf origin components, zero, NaN and inf
    directions, components of +-1e-31, -0.0 and negative denormals
    injected at random rays, and per-ray t_max."""
    import torch

    o, d = _rays_inside(rng, n, -5.0, 5.0)
    o, d = o.astype(np.float32), d.astype(np.float32)
    for vals, arr in (((np.nan, np.inf, -np.inf), o),
                      ((0.0, np.nan, np.inf, 1e-31, -1e-31, -0.0, -1e-40),
                       d)):
        for v in vals:
            i = rng.integers(0, n, n // 100)
            arr[i, rng.integers(0, 3, i.size)] = v
    d[rng.integers(0, n, n // 100)] = 0.0
    t_max = rng.uniform(0.1, 30.0, n).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (o, d, t_max))


def phase_prep_kernel(device):
    """Row 6: the prep kernel against `prep_rays_torch` on the grid's
    three 1M-ray sets of 2b, the random set in `ray_sort_key` order (the
    pool's) and a 1M-ray set with injected NaN, inf, zero, +-1e-31, -0.0
    and denormal components; each without t_max (a closest cast) and with
    its per-ray t_max (a shadow cast). Bit-equal od and tm; CUDA-event
    times of the kernel and of the twin's route on the camera set; the
    bound."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261018)
    scene, cam = sphere_grid(*GRID)
    tables = wl.scene_tables(flatten_scene(scene, device)[0])
    sets = _grid_ray_sets(rng, to_device(cam, device), device)
    o, d, t_max = sets["random"]
    sets["random_sorted"] = (*_sorted_rays(tables, o, d), t_max)
    sets["injected"] = _injected_rays(rng, N_RAYS, device)
    reports, err = [], 0.0
    for name, (o, d, t_max) in sets.items():
        for tm_in in (None, t_max):
            od, tm, _ = wl.prep_rays(o, d, tm_in)
            od_w, tm_w, _ = wl.prep_rays_torch(o, d, tm_in)
            torch.cuda.synchronize()
            rep = dict(case=name, t_max=tm_in is not None, rays=o.shape[0],
                       od_bits_diff=_bit_diff(od, od_w),
                       tm_bits_diff=_bit_diff(tm, tm_w),
                       parked=int((od_w[0, :o.shape[0]] == wl._FAR).sum()))
            err = max(err, float((od - od_w).abs().nan_to_num().max()),
                      float((tm - tm_w).abs().max()))
            reports.append(rep)
            print("prep-kernel-vs-twin", json.dumps(rep))
    if any(r["od_bits_diff"] or r["tm_bits_diff"] for r in reports):
        raise SystemExit(f"prep kernel/twin mismatch: {reports}")
    if not next(r for r in reports if r["case"] == "injected")["parked"]:
        raise SystemExit("the injected set parked no ray")
    o, d, t_max = sets["camera"]
    rp = -(-N_RAYS // wl.RB) * wl.RB
    row = dict(
        rays=N_RAYS, max_abs_err=err,
        ms=_timed(lambda: wl.prep_rays(o, d), 50),
        twin_ms=_timed(lambda: wl.prep_rays_torch(o, d), 20),
        shadow_ms=_timed(lambda: wl.prep_rays(o, d, t_max), 50),
        shadow_twin_ms=_timed(lambda: wl.prep_rays_torch(o, d, t_max), 20),
        # 3 tests, 3 squares and 2 adds, 3 compares and 3 divisions a ray
        bound=_bound(14 * N_RAYS, 24 * N_RAYS + 40 * rp))
    print("prep timing camera", json.dumps(row))
    return row


def phase_probes(device, wl_times, wl_census):
    """Rows 18 and 19 through the port's probe tools: each tool's
    measurement (its launches counted from 0), then each kernel against
    its twin: the item-list probe at the reference's four capacities (64
    blocks, 4096 slabs), equal, beside `sweep_closest`'s cost per item on
    2b's camera rays; the (2^20, 16) transpose, bit-equal to
    `.T.contiguous()` and to the twin."""
    import torch

    from directcomputeraytracing_tpu_torch.tools import prof_prep as pp
    from directcomputeraytracing_tpu_torch.tools import probe_worklist as pw

    pw.item_list.launches = pp.transpose16.launches = 0
    rows = pw.measure(device)
    layout = pp.measure(device)
    launches = dict(item_list=pw.item_list.launches,
                    transpose16=pp.transpose16.launches)
    tab, o = (torch.from_numpy(x).to(device) for x in pw.make_inputs())
    diffs, err = [], 0.0
    for row in rows:
        items = torch.from_numpy(pw.make_items(row["capacity"])).to(device)
        got, want = pw.item_list(items, tab, o), pw.item_list_torch(items,
                                                                    tab, o)
        torch.cuda.synchronize()
        row["diff"] = _bit_diff(got, want)
        err = max(err, float((got - want).abs().max()))
        diffs.append(row["diff"])
    sweep_items = wl_census["camera"]["closest"]["items"]
    sweep_ns = 1e6 * wl_times["closest_ms"] / max(sweep_items, 1)
    print("item-list probe", json.dumps(dict(
        rows=rows, sweep_closest_items=sweep_items,
        sweep_closest_ns_per_item=sweep_ns)))
    x = pp.build_table(*(torch.from_numpy(a).to(device)
                         for a in pp.make_rays()))
    t, lib, twin = pp.transpose16(x), x.T.contiguous(), pp.transpose16_torch(x)
    torch.cuda.synchronize()
    layout.update(diff_vs_library=_bit_diff(t, lib),
                  diff_vs_twin=_bit_diff(t, twin))
    print("layout probe", json.dumps(layout), json.dumps(launches))
    if any(diffs) or layout["diff_vs_library"] or layout["diff_vs_twin"]:
        raise SystemExit(f"probe kernel/twin mismatch: {rows} {layout}")
    if not (launches["item_list"] and launches["transpose16"]):
        raise SystemExit(f"a probe tool launched no kernel: {launches}")
    cap = rows[-1]["capacity"]
    r = 64 * pw.RB
    item = dict(row=rows[-1], max_abs_err=err, launches=launches["item_list"],
                twin_ms=_timed(lambda: pw.item_list_torch(items, tab, o), 1),
                bound=_bound(23 * pw.CS * pw.RB * cap,
                             4 * cap + 4 * tab.numel() + 8 * r))
    tr = dict(layout=layout, launches=launches["transpose16"],
              bound=_bound(0, 2 * 64 * pp.R))
    return item, tr


def _image_diff(a, b):
    """RMSE and diverged-pixel share of two images (the CPU-vs-card
    gate's measure)."""
    return dict(rmse=float(np.sqrt(((a - b) ** 2).mean())),
                diverged_pixels=float(
                    (np.abs(a - b).max(-1) > 1e-3 * (1.0 + np.abs(a).max(-1)))
                    .mean()),
                gate_rmse=GATE_RMSE, gate_diverged=GATE_DIVERGED_FRACTION)


def _image_ok(diff):
    return (diff["rmse"] <= GATE_RMSE
            and diff["diverged_pixels"] <= GATE_DIVERGED_FRACTION)


def _world_tris(scene):
    return sum(scene.meshes[i.mesh].indices.shape[0] for i in scene.instances)


def _scene(name):
    """A scene of the run by name; a name ending in `_forced` is the same
    scene, which `_renderer` flattens onto the instanced tables."""
    from directcomputeraytracing_tpu_torch.scene.presets import (
        alpha_panel,
        alpha_sphere_grid,
        cornell_box,
        sphere_grid,
    )

    name = name.removesuffix("_forced")
    if name == "cornell":
        return cornell_box("area", "glossy")
    if name == "alpha_panel":
        return alpha_panel()
    if name.startswith("alpha_grid"):
        return alpha_sphere_grid(*GRID, textured=name.endswith("textured"))
    if name.startswith("small_alpha_grid"):
        return alpha_sphere_grid(*SMALL_GRID[0], **SMALL_GRID[1],
                                 textured=name.endswith("textured"))
    if name == "grid":
        return sphere_grid(*GRID)
    if name == "inst_grid":
        return sphere_grid(*INST_GRID)
    return sphere_grid(*SMALL_GRID[0], **SMALL_GRID[1])


def _renderer(name, p, device, integrator="megakernel", backend="auto",
              **cfg):
    """(Renderer of scene `name` at p's size through traversal backend
    `backend` with RenderConfig fields cfg, its world triangle count)."""
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    scene, cam = _scene(name)
    with _forced_instanced() if name.endswith("_forced") else nullcontext():
        r = Renderer(scene, cam, p["width"], p["height"],
                     max_bounce=p["max_bounce"], integrator=integrator,
                     device=device, traversal_backend=backend, **cfg)
    return r, _world_tris(scene)


def _launches():
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import traverse as tv
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    return dict(brute_closest=brute.brute_closest.launches,
                brute_any=brute.brute_any.launches, **wl.counters(),
                **cl.counters(), **ps.counters(),
                alpha_calls=tv.alpha_recast.calls,
                alpha_passes=tv.alpha_recast.passes)


def _reset_launches():
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import traverse as tv
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    brute.brute_closest.launches = brute.brute_any.launches = 0
    wl.reset_counters()
    cl.reset_counters()
    ps.reset_counters()
    tv.reset_counters()


def _expected_launches(arrays, n_closest, n_any, got, sweeps="",
                       backend="auto", alpha=False):
    """The counts the main path must show: every cast went through the
    path's kernels (the dense sweep for Cornell, the work list's sweeps
    `sweep_closest{sweeps}` and `sweep_any{sweeps}` for the sphere grids,
    the instanced ones on instanced tables, with "pallas_cluster" one
    cull and one clustered sweep, with "pallas_pair" the work list's cull
    and per cast with pairs one emission and one pair sweep; one ray prep
    per work-list or pair cast, empty ones included) and nothing else
    launched. With alpha (an alpha-tested scene on the opaque/masked
    split) each of the n_closest + n_any casts runs one recast loop
    (`alpha_calls`) after its opaque cast, and every recast pass
    (`alpha_passes`) is one more closest cast."""
    passes = got["alpha_passes"] if alpha else 0
    expect = _expected_cast_launches(arrays, n_closest + passes, n_any, got,
                                     sweeps, backend)
    expect.update(alpha_calls=n_closest + n_any if alpha else 0,
                  alpha_passes=passes)
    return expect


def _expected_cast_launches(arrays, n_closest, n_any, got, sweeps, backend):
    """`_expected_launches` for n_closest closest and n_any any-hit casts
    of one backend."""
    zero = dict.fromkeys(got, 0)
    if backend == "pallas_cluster":
        return dict(zero, cluster_cull=n_closest + n_any,
                    cluster_closest=n_closest, cluster_any=n_any)
    if backend == "pallas_pair":
        # a cast with items emits; one without items or pairs sweeps
        # nothing (counted apart; `no_pair`: emitted, no pair)
        c_empty, a_empty = got["pair_closest_empty"], got["pair_any_empty"]
        return dict(zero, prep_rays=n_closest + n_any,
                    cull_boxes=n_closest + n_any,
                    refine=n_closest + n_any - got["refine_skipped"],
                    refine_skipped=got["refine_skipped"],
                    pair_emit=(n_closest - c_empty + got["pair_closest_no_pair"]
                               + n_any - a_empty + got["pair_any_no_pair"]),
                    pair_closest_empty=c_empty, pair_any_empty=a_empty,
                    pair_closest_no_pair=got["pair_closest_no_pair"],
                    pair_any_no_pair=got["pair_any_no_pair"],
                    pair_sweep_closest=n_closest - c_empty,
                    pair_sweep_any=n_any - a_empty)
    if arrays.cluster_bbox.shape[0] <= 1 and arrays.isup_inst.shape[0] <= 1:
        return dict(zero, brute_closest=n_closest, brute_any=n_any)
    if arrays.isup_inst.shape[0] > 1:
        sweeps = "_inst"
    # work list: a cast with an empty item list launches no sweep (counted
    # apart); each cast culls once; a cast whose hyper cull admitted
    # nothing runs no refine (counted apart)
    return dict(zero, prep_rays=n_closest + n_any,
                cull_boxes=n_closest + n_any,
                refine=n_closest + n_any - got["refine_skipped"],
                refine_skipped=got["refine_skipped"],
                closest_empty=got["closest_empty"], any_empty=got["any_empty"],
                **{"sweep_closest" + sweeps: n_closest - got["closest_empty"],
                   "sweep_any" + sweeps: n_any - got["any_empty"]})


def phase_render(device, name, p=RENDER, backend="auto", warm_spp=None):
    import torch

    r, world_tris = _renderer(name, p, device, backend=backend)
    # warm-up: by default the timed call itself, so that the allocator's
    # growth for the fused pass falls outside the timed window
    r.render(spp=warm_spp or p["spp"])
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
        r.arrays, p["spp"] * (p["max_bounce"] + 2) * r.n_chunks,
        p["spp"] * (p["max_bounce"] + 1) * r.n_chunks, launches,
        backend=backend, alpha=r.cfg.any_hit)
    post = r.postprocessed()
    stats = dict(scene=name, backend=backend, world_tris=world_tris,
                 instanced=r.arrays.isup_inst.shape[0] > 1,
                 tiled_and_sorted=r._inv is not None,
                 shape=list(img.shape), finite=bool(np.isfinite(img).all()),
                 mean=float(img.mean()), max=float(img.max()),
                 ms_per_spp=1000.0 * seconds / p["spp"],
                 total_s=seconds, chunks=r.n_chunks,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 post_mean=float(post.mean()), post_min=float(post.min()),
                 post_max=float(post.max()),
                 post_finite=bool(np.isfinite(post).all()),
                 launches=launches, expected_launches=expect,
                 **_alpha_stats(r, launches))
    print("render", json.dumps(stats))
    if not (stats["finite"] and stats["post_finite"] and stats["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit(f"{name} render is not a finite, non-black image")
    if launches != expect:
        raise SystemExit(f"{name} launch counts {launches} != {expect}")
    return stats


def _alpha_stats(r, launches):
    """Recast passes per alpha-tested cast of a render (empty when the
    scene has no alpha)."""
    if not r.cfg.any_hit:
        return {}
    calls = launches["alpha_calls"]
    return dict(alpha=True, alpha_textures=r.cfg.any_hit_texture,
                recast_calls=calls, recast_passes=launches["alpha_passes"],
                recast_passes_per_cast=(launches["alpha_passes"]
                                        / max(calls, 1)),
                split=r.arrays.mclu_bbox.shape[0] > 1)


def _expected_wavefront_launches(arrays, stats, got, backend="auto",
                                 alpha=False):
    """Every pool cast of the wavefront went through the grouped sweep,
    or on instanced tables the instanced one (or found no item), or with
    "pallas_cluster" the clustered sweeps: no other sweep, one cull per
    cast."""
    return _expected_launches(arrays, sum(stats["closest_casts_per_phase"]),
                              sum(stats["any_casts_per_phase"]), got,
                              "_grouped", backend, alpha)


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
    expect = _expected_wavefront_launches(r.arrays, stats, launches)
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


def phase_wavefront_pass(device, name, p, backend="auto"):
    """One timed pool pass of the wavefront at p's size after a warm-up
    pass, default pool: on the instanced sphere grid with its slab
    marching (3f), on the soup grid through "pallas_cluster", which
    marches no slabs (3h), or on the alpha-tested grid (3l)."""
    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    r, world_tris = _renderer(name, p, device, "wavefront", backend)
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
    expect = _expected_wavefront_launches(r.arrays, stats, launches,
                                          backend, r.cfg.any_hit)
    rep = dict(scene=name, integrator="wavefront", backend=backend,
               world_tris=world_tris,
               instanced=r.arrays.isup_inst.shape[0] > 1,
               shape=list(img.shape), finite=bool(np.isfinite(img).all()),
               mean=float(img.mean()), max=float(img.max()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               warmup_s=warm_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               last_stats=stats, launches=launches, expected_launches=expect,
               **_alpha_stats(r, launches))
    print(f"wavefront-{name}-{backend}", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit(f"{name} wavefront render is not a finite, "
                         "non-black image")
    if launches != expect:
        raise SystemExit(f"{name} wavefront launch counts {launches} != "
                         f"{expect}")
    if backend == "pallas_cluster" and (
            stats["slab_depth"] is not None
            or any(stats["closest_casts_per_phase"][1:])
            or any(stats["any_casts_per_phase"][1:])):
        raise SystemExit(f"{name}: pool casts through {backend} marched "
                         f"slabs: {stats}")
    return rep


def phase_pair_wavefront(device):
    """The wavefront through pool_backend="pallas_pair" on the sphere grid
    at 1920x1080: one timed pool pass after a warm-up, default slabs;
    every pool cast, slab phases included, is a pair cast; the image
    against the grouped sweep's pass at the same seed, which is timed
    beside it."""
    from dataclasses import replace

    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    p = PAIR_WAVEFRONT
    r, world_tris = _renderer("grid", p, device, "wavefront",
                              pool_backend="pallas_pair")
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
    expect = _expected_launches(r.arrays, sum(stats["closest_casts_per_phase"]),
                                sum(stats["any_casts_per_phase"]), launches,
                                backend="pallas_pair")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    _, val = wf.render_samples_wavefront(
        r.arrays, r.luts, r.camera, replace(r.cfg, pool_backend=""), r._px,
        r._py, 0, spp_batch=p["spp"])
    torch.cuda.synchronize()
    grouped_s = time.perf_counter() - t0
    grouped = dict(wf.LAST_STATS)
    ref = (r._raster(val) / p["spp"]).reshape(img.shape).cpu().numpy()
    rep = dict(scene="grid", integrator="wavefront", backend="pallas_pair",
               world_tris=world_tris, shape=list(img.shape),
               finite=bool(np.isfinite(img).all()), mean=float(img.mean()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               warmup_s=warm_s, peak_mem_gib=peak, last_stats=stats,
               launches=launches, expected_launches=expect,
               grouped_ms_per_spp=1000.0 * grouped_s / p["spp"],
               grouped_stats=grouped,
               rmse_vs_grouped=float(np.sqrt(((img - ref) ** 2).mean())))
    print("wavefront-grid-pallas_pair", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit("pair wavefront render is not a finite, non-black "
                         "image")
    if stats["pool_backend"] != "pallas_pair" or launches != expect:
        raise SystemExit(f"pair wavefront launch counts {launches} != "
                         f"{expect}")
    if not rep["rmse_vs_grouped"] <= GATE_WF_RMSE:
        raise SystemExit("the pair wavefront differs from the grouped one")
    return rep


def phase_cpu_vs_card(device, name, integrator="megakernel", backend="auto",
                      **cfg):
    import torch

    p = SMALL
    imgs = {}
    for dev in (torch.device("cpu"), device):
        r, world_tris = _renderer(name, p, dev, integrator, backend, **cfg)
        imgs[dev.type] = r.render(spp=p["spp"])
    a, b = imgs["cpu"], imgs[device.type]
    rep = dict(scene=name, integrator=integrator, backend=backend, cfg=cfg,
               world_tris=world_tris,
               instanced=r.arrays.isup_inst.shape[0] > 1,
               **_image_diff(a, b), mean_cpu=float(a.mean()),
               mean_card=float(b.mean()))
    print("cpu-vs-card", json.dumps(rep))
    if not _image_ok(rep):
        raise SystemExit(f"{name}: card render differs from the CPU render")
    return rep


def _build_all():
    """Build the six kernel libraries, the nvcc runs in parallel."""
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.tools import probe_worklist as pw

    sources = (("brute_sweep.cu", brute.kernels),
               ("worklist.cu", wl.kernels), ("clustered.cu", cl.kernels),
               ("pairsweep.cu", ps.kernels), ("prep.cu", wl.prep_kernels),
               ("probes.cu", pw.kernels))
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {src: pool.submit(fn) for src, fn in sources}
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

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("1 build", _build_all)
    reports, times = phase("2 dense kernels", phase_kernels, device)
    wl_reports, wl_times, wl_cull, wl_work, wl_census = phase(
        "2b work-list kernels", phase_worklist_kernels, device)
    _, _, g_errs, g_pool = phase("2c grouped kernels",
                                 phase_grouped_kernels, device)
    _, inst_errs, inst_row = phase(
        "2d instanced kernels", phase_instanced_kernels, device, wl_census)
    phase("2e instanced vs soup", phase_instanced_vs_soup, device)
    _, cl_errs, cl_row, _ = phase("2f clustered kernels",
                                  phase_clustered_kernels, device)
    _, pair_errs, pair_rows = phase("2g pair kernels", phase_pair_kernels,
                                    device)
    prep = phase("2h prep kernel", phase_prep_kernel, device)
    probe_item, probe_tr = phase("2i probe kernels", phase_probes, device,
                                 wl_times, wl_census)
    cornell = phase("3 Cornell render", phase_render, device, "cornell")
    grid = phase("3b sphere-grid render", phase_render, device, "grid")
    wave = phase("3c wavefront render", phase_wavefront, device)
    phase("3d wavefront vs megakernel", phase_wavefront_vs_megakernel,
          device)
    inst = phase("3e instanced render", phase_render, device, "inst_grid")
    if not inst["instanced"]:
        raise SystemExit("sphere_grid(27, 27) did not flatten instanced")
    phase("3f instanced wavefront render", phase_wavefront_pass, device,
          "inst_grid", INST_WAVEFRONT)
    cl_grid = phase("3g clustered render", phase_render, device, "grid",
                    CLUSTER_RENDER, "pallas_cluster", 1)
    phase("3h clustered wavefront render", phase_wavefront_pass, device,
          "grid", CLUSTER_WAVEFRONT, "pallas_cluster")
    pair_grid = phase("3i pair render", phase_render, device, "grid",
                      PAIR_RENDER, "pallas_pair", 1)
    pair_wave = phase("3j pair wavefront render", phase_pair_wavefront,
                      device)
    alpha = phase("3k alpha render", phase_render, device, "alpha_grid",
                  ALPHA_RENDER, "auto", 1)
    phase("3l alpha wavefront render", phase_wavefront_pass, device,
          "alpha_grid", ALPHA_WAVEFRONT)
    phase("3m textured alpha render", phase_render, device,
          "alpha_grid_textured", ALPHA_TEX_RENDER, "auto", 1)
    if not (alpha["split"] and alpha["recast_passes"]):
        raise SystemExit(f"the alpha render cast no split: {alpha}")
    phase("4 Cornell card vs CPU", phase_cpu_vs_card, device, "cornell")
    phase("4b small grid card vs CPU", phase_cpu_vs_card, device,
          "small_grid")
    phase("4c small grid wavefront card vs CPU", phase_cpu_vs_card, device,
          "small_grid", "wavefront")
    small_inst = phase("4d small instanced grid card vs CPU",
                       phase_cpu_vs_card, device, "small_grid_forced")
    if not small_inst["instanced"]:
        raise SystemExit("the forced small grid did not flatten instanced")
    phase("4e small grid clustered card vs CPU", phase_cpu_vs_card, device,
          "small_grid", "megakernel", "pallas_cluster")
    phase("4f small grid pair wavefront card vs CPU", phase_cpu_vs_card,
          device, "small_grid", "wavefront", pool_backend="pallas_pair")
    phase("4g small grid slab-marched megakernel card vs CPU",
          phase_cpu_vs_card, device, "small_grid", slab_march=0.03)
    phase("4h alpha panel card vs CPU", phase_cpu_vs_card, device,
          "alpha_panel")
    phase("4i small alpha grid wavefront card vs CPU", phase_cpu_vs_card,
          device, "small_alpha_grid", "wavefront")
    phase("4j small textured alpha grid card vs CPU", phase_cpu_vs_card,
          device, "small_alpha_grid_textured")
    if "jax" in sys.modules:
        raise SystemExit("the port imported jax")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    brute_src = "directcomputeraytracing_tpu_torch/csrc/brute_sweep.cu"
    wl_src = "directcomputeraytracing_tpu_torch/csrc/worklist.cu"
    cl_src = "directcomputeraytracing_tpu_torch/csrc/clustered.cu"
    pair_src = "directcomputeraytracing_tpu_torch/csrc/pairsweep.cu"
    probes_src = "directcomputeraytracing_tpu_torch/csrc/probes.cu"
    ref_pair = "directcomputeraytracing_tpu/accel/pairsweep.py"
    ref_wl = "directcomputeraytracing_tpu/accel/worklist.py"
    ref_brute = "directcomputeraytracing_tpu/accel/pallas_brute.py"
    top = times["cornell32_moeller"]   # the main path's scene and test
    n, tris = N_RAYS, 32
    brute_closest_bound = _bound(FLOPS_MOELLER * n * tris,
                                 45 * n + 48 * tris)
    brute_any_bound = _bound(FLOPS_MOELLER * n * tris, 29 * n + 48 * tris)
    wl_closest_err = max(r["closest_max_abs_err"] for r in wl_reports)
    wl_any_err = max(r["any_max_abs_err"] for r in wl_reports)

    def row(name, src, replaces, launches, err, ms, plain_ms, bound,
            library_ms=None):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

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
        row("sweep_closest_inst", wl_src, f"{ref_wl}:1208",
            inst["launches"]["sweep_closest_inst"], inst_errs["closest"],
            inst_row["closest_ms"], inst_row["closest_twin_ms"],
            inst_row["closest_bound"]),
        row("sweep_any_inst", wl_src, f"{ref_wl}:1349",
            inst["launches"]["sweep_any_inst"], inst_errs["any"],
            inst_row["any_ms"], inst_row["any_twin_ms"],
            inst_row["any_bound"]),
        row("cluster_cull", cl_src, f"{ref_brute}:338",
            cl_grid["launches"]["cluster_cull"], cl_errs["cull"],
            cl_row["cull_ms"], cl_row["cull_twin_ms"], cl_row["cull_bound"]),
        row("cluster_closest", cl_src, f"{ref_brute}:425",
            cl_grid["launches"]["cluster_closest"], cl_errs["closest"],
            cl_row["closest_ms"], cl_row["closest_twin_ms"],
            cl_row["closest_bound"]),
        row("cluster_any", cl_src, f"{ref_brute}:508",
            cl_grid["launches"]["cluster_any"], cl_errs["any"],
            cl_row["any_ms"], cl_row["any_twin_ms"], cl_row["any_bound"]),
        row("pair_emit", pair_src, f"{ref_pair}:78",
            pair_wave["launches"]["pair_emit"], pair_errs["emit"],
            pair_rows["closest"]["emit_ms"],
            pair_rows["closest"]["emit_twin_ms"],
            pair_rows["closest"]["emit_bound"]),
        row("pair_sweep_closest", pair_src, f"{ref_pair}:274",
            pair_wave["launches"]["pair_sweep_closest"], pair_errs["closest"],
            pair_rows["closest"]["sweep_ms"],
            pair_rows["closest"]["sweep_twin_ms"],
            pair_rows["closest"]["sweep_bound"]),
        row("pair_sweep_any", pair_src, f"{ref_pair}:359",
            pair_wave["launches"]["pair_sweep_any"], pair_errs["any"],
            pair_rows["any"]["sweep_ms"], pair_rows["any"]["sweep_twin_ms"],
            pair_rows["any"]["sweep_bound"]),
        row("prep_rays", "directcomputeraytracing_tpu_torch/csrc/prep.cu",
            f"{ref_wl}:205", alpha["launches"]["prep_rays"],
            prep["max_abs_err"], prep["ms"], prep["twin_ms"], prep["bound"]),
        row("item_list", probes_src, "experiments/probe_worklist.py:23",
            probe_item["launches"], probe_item["max_abs_err"],
            probe_item["row"]["ms"], probe_item["twin_ms"],
            probe_item["bound"]),
        row("transpose16", probes_src, "experiments/prof_prep.py:56",
            probe_tr["launches"], 0.0, probe_tr["layout"]["kernel_ms"],
            probe_tr["layout"]["twin_ms"], probe_tr["bound"],
            probe_tr["layout"]["library_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
