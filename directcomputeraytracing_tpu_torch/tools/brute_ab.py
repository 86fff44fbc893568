"""A/B of the dense sweep's kernels (kernel rows 1 and 2) on one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.brute_ab \
        [--parent DIR] [--reps N] [--sets SETS]

Times, in turns, `closest_kernel` and `any_kernel` of
`csrc/brute_sweep.cu`, Moeller and watertight, on the sets of
`dense_sets` (seed 20261016, `chip_smoke.py` phase 2's draws):

- `cornell_camera`: the Cornell soup (`cornell_box("area", "glossy")`,
  32 triangles) and its 1024^2 pixel-centre camera rays, row-major;
- `cornell_random`: the same soup, 1,048,576 random rays from inside the
  box;
- `cornell_pool`: the first 262,144 of those (a 2^18 pool);
- `soup_random`: the seeded 2048-triangle random soup
  (`tools.common.random_soup`) and 1,048,576 random rays from
  [-1.5, 1.5]^3;
- `soup_pool`: the first 262,144 of those;
- `grid_camera`, `grid_random`: 65,536 rays on the 211,972-triangle soup
  of `sphere_grid(12, 12)` (the streamed path): 64 blocks of 1024 camera
  rays spread over the 1024^2 frame, and the first 65,536 random rays from
  inside its scene box (`tools.common.grid_ray_sets`, seed 20261020).

Each set's any-hit casts take its per-ray t_max (uniform: Cornell
[0.05, 4), soup [0.05, 3), grid [0.5, 30)); t_min is 1e-4.

Variants:

- `parent`: `--parent DIR`'s `brute_sweep.cu` with its headers, built
  under the library name brute_sweep_parent: the package's C interface,
  or the first port's (no prepared rows);
- `new`: the package's kernels.

Each is timed in turns (parent, new, new, parent), with CUDA events (the
mean of
`reps` launches after a warm-up, default 5) and beside them by the
profiler (`tools.common.kernel_ms`: the kernels' own time, without the
host's gaps). A line per (set, test, kind) gives the turns, their means,
the kernel ms, the bound (`tools.common.dense_bound`, chip_smoke.py's
counts) and each variant's share of it. Every variant must equal `new`
on the whole set and the twin (`brute_closest_torch` /
`brute_any_torch`) bit for bit in every field, the zeros' signs included
(the twin on the grid sets on 4096 rays spread over the set), and the
package's kernels must equal their twins on the
adversarial set (`adversarial_set`, each triangle cast alone); the tool
exits non-zero otherwise. Prints the card's name and power limit first,
then per built variant its ptxas lines and (package) the kernels'
resources (resident blocks per SM with a full resident table,
registers, shared and spill bytes).
Needs a CUDA device; with none it exits non-zero.

`dense_sets`, `adversarial_set`, `adversarial_diffs`, `ptxas_report`
and `closest_diffs` serve `chip_smoke.py` phases 1 and 2 and the tests too.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..accel import brute
from ..core.types import to_device
from ..scene.presets import cornell_box, sphere_grid
from ..scene.scene import flatten_scene
from . import common
from .worklist_ab import ptxas_report as _ptxas_report

SEED = 20261016
GRID_SEED = 20261020
N_RAYS = 1 << 20
POOL = 1 << 18
GRID_RAYS = 1 << 16
GRID_TWIN_RAYS = 4096
T_MIN = 1e-4
SETS = ("cornell_camera", "cornell_random", "cornell_pool", "soup_random",
        "soup_pool", "grid_camera", "grid_random")
FIELDS = ("t", "u", "v", "tri", "inst", "back")


class Soup:
    """The two scene fields the dense sweep reads, from a (B, 12) table."""

    def __init__(self, tab):
        self.world_tris = tab[:, 0:9]
        self.world_tri_meta = tab[:, 9:12]


def dense_sets(device, names=SETS):
    """name -> (table, o, d, t_max) on device, for the names kept (the
    sets of the module docstring; Cornell and the soup from phase 2's
    generator, in its order)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    rng = np.random.default_rng(SEED)
    scene, cam = cornell_box("area", "glossy")
    arrays, _ = flatten_scene(scene, device)
    cornell = brute.build_table(arrays)
    o_cam, d_cam = common.camera_rays(to_device(cam, device), 1024, 1024,
                                      device)
    o_in, d_in = (f32(x) for x in common.rays_inside(
        rng, N_RAYS, [-0.95, 0.05, -0.95], [0.95, 1.95, 0.95]))
    o_soup, d_soup = (f32(x) for x in common.rays_inside(rng, N_RAYS, -1.5,
                                                         1.5))
    tm_cornell = f32(rng.uniform(0.05, 4.0, 2 * N_RAYS))
    soup = f32(common.random_soup(rng, 2048))
    tm_soup = f32(rng.uniform(0.05, 3.0, N_RAYS))
    sets = dict(
        cornell_camera=(cornell, o_cam.contiguous(), d_cam.contiguous(),
                        tm_cornell[:N_RAYS]),
        cornell_random=(cornell, o_in, d_in, tm_cornell[N_RAYS:]),
        cornell_pool=(cornell, o_in[:POOL], d_in[:POOL],
                      tm_cornell[N_RAYS:N_RAYS + POOL]),
        soup_random=(soup, o_soup, d_soup, tm_soup),
        soup_pool=(soup, o_soup[:POOL], d_soup[:POOL], tm_soup[:POOL]))
    if {"grid_camera", "grid_random"} & set(names):
        scene, cam = sphere_grid(12, 12)
        arrays, _ = flatten_scene(scene, device)
        grid = brute.build_table(arrays)
        g = common.grid_ray_sets(np.random.default_rng(GRID_SEED), None,
                                 to_device(cam, device), device,
                                 names=("camera", "random"))
        idx = common.spread_blocks(N_RAYS, GRID_RAYS // 1024, device, 1024)
        o, d, t_max = g["camera"]
        sets["grid_camera"] = (grid, o[idx].contiguous(),
                               d[idx].contiguous(), t_max[idx].contiguous())
        o, d, t_max = g["random"]
        sets["grid_random"] = (grid, o[:GRID_RAYS], d[:GRID_RAYS],
                               t_max[:GRID_RAYS])
    return {name: sets[name] for name in names}


def adversarial_set():
    """Triangles and rays at the edges of the dense tests, each triangle
    meant to be cast alone against its own rays; numpy float32 (tab (T,
    12), o (T, N, 3), d (T, N, 3), t_max (N,)), t_min T_MIN.

    Triangles: right triangles (v0 at the origin, legs s along x and y,
    both windings) at scales s from 2^-64 to 2^64 (det = s^2 for axis
    rays: at +-1e-10 within a few ulps, huge, and +inf), degenerate ones
    (a repeated vertex, collinear vertices, edges whose cross product
    underflows) and a skewed one. Rays, straight down and up through the
    legs' plane, axis-aligned and near-axis, at heights t_min, just below
    it and 1/2: through (u, v) = (x, y) / s with u, v exactly 0, 1, 1/2,
    u + v = 1, one ulp outside, and at tiny absolute offsets from the legs
    (down to the least subnormal, whose products with the legs underflow
    to -0); and rays in the plane (det = 0). Every other ray takes t_max
    at its height (the hit lies at t_max: excluded), the others the next
    float above it."""
    f32 = np.float32
    tris = []
    for k in (-64, -40, -20, -8, 0, 8, 20, 40, 60, 63, 64):
        s = 2.0 ** k
        tris += [[0, 0, 0, s, 0, 0, 0, s, 0], [0, 0, 0, 0, s, 0, s, 0, 0]]
    for n in range(-3, 4):                # legs whose det straddles 1e-10
        s = f32(np.sqrt(1e-10))
        for _ in range(abs(n)):
            s = np.nextafter(s, f32(np.inf if n > 0 else 0))
        s = float(s)
        tris += [[0, 0, 0, s, 0, 0, 0, s, 0], [0, 0, 0, 0, s, 0, s, 0, 0]]
    tris += [[0, 0, 0, 0, 0, 0, 0, 1, 0],          # v1 = v0
             [0, 0, 0, 1, 1, 0, 2, 2, 0],          # collinear
             [0, 0, 0, 1e-25, 0, 0, 0, 1e-25, 0],  # cross product -> 0
             [0.1, 0.2, 0.3, 1.3, -0.2, 0.5, -0.4, 0.9, 0.1]]
    tris = np.asarray(tris, np.float64)
    n_t = tris.shape[0]
    tab = np.concatenate([tris, np.arange(n_t)[:, None], np.ones((n_t, 1)),
                          (np.arange(n_t) % 2)[:, None]], axis=1).astype(f32)

    # (fx, fy, ax, ay): the origin's x, y are (fx, fy) * leg + (ax, ay)
    one_up = float(np.nextafter(f32(1), f32(2)))
    half_up = float(np.nextafter(f32(0.5), f32(1)))
    pts = [(x, y, 0, 0) for x, y in (
        (0, 0), (1, 0), (0, 1), (0.5, 0.5), (0.25, 0.75), (0.75, 0.25),
        (0.3, 0.7), (1 / 3, 2 / 3), (one_up, 0), (0, one_up), (0.5, half_up),
        (0.2, 0.2))]
    for tiny in (-2.0 ** -126, -2.0 ** -140, -2.0 ** -149, -1e-30):
        pts += [(0, 0.5, tiny, 0), (0.5, 0, 0, tiny), (0.5, 0.5, -tiny, 0)]
    heights = [T_MIN, float(np.nextafter(f32(T_MIN), f32(0))), 0.5]
    dirs = [(0, 0, -1), (1e-7, 0, -1), (0, -1e-7, -1), (1e-30, 1e-30, -1),
            (2.0 ** -140, 0, -1)]
    frac, absol, d = [], [], []
    for fx, fy, ax, ay in pts:
        for h in heights:
            for dx, dy, dz in dirs:
                frac += [(fx, fy, 0), (fx, fy, 0)]
                absol += [(ax, ay, h), (ax, ay, -h)]
                d += [(dx, dy, dz), (dx, dy, -dz)]
    for fx in (0.25, 0.0, 1.0):           # in the plane: det = 0
        frac += [(fx, 0.25, 0), (fx - 1, 0.25, 0)]
        absol += [(0, 0, 0), (0, 0, 0)]
        d += [(1, 0, 0), (1, 0, 0)]
    frac, absol = np.asarray(frac), np.asarray(absol)
    leg = np.abs(tris[:, 3:9]).max(axis=1)
    leg = np.where(leg > 0, leg, 1.0)
    o = (frac[None] * leg[:, None, None] + absol[None]).astype(f32)
    d = np.repeat(np.asarray(d, f32)[None], n_t, axis=0)
    h = np.abs(absol[:, 2]).astype(f32)
    h = np.where(h > 0, h, f32(1.0))
    t_max = np.where(np.arange(h.shape[0]) % 2 == 0, h,
                     np.nextafter(h, f32(np.inf))).astype(f32)
    return tab, o, d, t_max


def closest_diffs(a, b):
    """Per field of two closest casts' outputs, the rays whose bits
    differ (`tools.common.bit_diff`)."""
    return {f: common.bit_diff(x, y) for f, x, y in zip(FIELDS, a, b)}


def adversarial_diffs(device, watertight):
    """The package's kernels against their twins on the adversarial set,
    each triangle cast alone against its rays: summed bit differences per
    field, occlusion differences, and the twin's hits and occlusions."""
    tab, o_t, d_t, t_max = adversarial_set()
    lib = brute.kernels().lib
    tm = torch.from_numpy(t_max).to(device)
    diffs = dict.fromkeys(FIELDS, 0)
    diffs.update(occ=0, hits=0, occluded=0)
    for i in range(tab.shape[0]):
        row = torch.from_numpy(tab[i:i + 1]).to(device)
        rows = brute.prepare_rows(row, watertight)
        oi = torch.from_numpy(o_t[i]).to(device)
        di = torch.from_numpy(d_t[i]).to(device)
        err, k = brute.launch_closest(lib.dcrt_brute_closest, row, rows, oi,
                                      di, T_MIN, watertight)
        brute._raise_on(err, "brute_closest")
        err, occ = brute.launch_any(lib.dcrt_brute_any, rows, oi, di, tm,
                                    T_MIN, watertight)
        brute._raise_on(err, "brute_any")
        w = brute.brute_closest_torch(row, oi, di, T_MIN, watertight)
        occ_w = brute.brute_any_torch(row, oi, di, tm, T_MIN, watertight)
        for f, n in closest_diffs(k, w).items():
            diffs[f] += n
        diffs["occ"] += int((occ != occ_w).sum())
        diffs["hits"] += int(torch.isfinite(w[0]).sum())
        diffs["occluded"] += int(occ_w.sum())
    return diffs


def _short(entry):
    """Short name (one of `brute.KERNELS`; the first port's kernels take
    the same names) of a dense kernel's mangled entry, or None."""
    for kind in ("closest", "any"):
        if f"{kind}_kernel" in entry:
            test = "watertight" if "Watertight" in entry else "moeller"
            return f"{kind}_{test}"
    return None


def ptxas_report(log):
    """The ptxas lines of a build's dense kernels: {short name:
    {registers, smem, stack, spill_stores, spill_loads}}."""
    return _ptxas_report(log, _short)


def _bind_parent(lib):
    """Bind a parent's build: the package's C interface where it has
    `dcrt_brute_resources`, else the first port's (the (B, 12) table
    only, one ray a thread)."""
    import ctypes

    if hasattr(lib, "dcrt_brute_resources"):
        brute.bind(lib)
        return True
    c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dcrt_brute_closest.argtypes = [c_p, c_i, c_p, c_p, c_i, c_f, c_i] \
        + [c_p] * 7
    lib.dcrt_brute_any.argtypes = [c_p, c_i, c_p, c_p, c_p, c_i, c_f, c_i,
                                   c_p, c_p]
    lib.dcrt_brute_closest.restype = lib.dcrt_brute_any.restype = c_i
    return False


def _build(parent):
    """name -> (run maker, built library) per variant; the two nvcc runs
    go in parallel."""
    from ..utils.cuda_build import load_library

    with ThreadPoolExecutor(2) as pool:
        new = pool.submit(brute.kernels)
        old = parent and pool.submit(
            load_library, "brute_sweep.cu", brute._NVCC_EXTRA,
            csrc=os.path.abspath(parent), name="brute_sweep_parent")
    out = {}
    if old:
        built = old.result()
        out["parent"] = (_runs(built.lib, _bind_parent(built.lib)), built)
    out["new"] = (_runs(new.result().lib, True), new.result())
    return out


def _runs(lib, prepared):
    """(closest, any) run makers of one build: each maps (tab, o, d,
    t_max, watertight) to a function that launches the kernel once."""
    def closest(tab, rows, o, d, t_max, wt):
        if prepared:
            return lambda: _ok(brute.launch_closest(
                lib.dcrt_brute_closest, tab, rows, o, d, T_MIN, wt))
        return lambda: _first_port_closest(lib, tab, o, d, wt)

    def any_(tab, rows, o, d, t_max, wt):
        if prepared:
            return lambda: _ok(brute.launch_any(
                lib.dcrt_brute_any, rows, o, d, t_max, T_MIN, wt))
        return lambda: _first_port_any(lib, tab, o, d, t_max, wt)
    return closest, any_


def _ok(result):
    err, out = result
    brute._raise_on(err, "dense sweep")
    return out


def _first_port_closest(lib, tab, o, d, wt):
    r = o.shape[0]
    out = [torch.empty(r, dtype=dt, device=o.device) for dt in (
        torch.float32, torch.float32, torch.float32, torch.int32,
        torch.int32, torch.bool)]
    brute._raise_on(lib.dcrt_brute_closest(
        tab.data_ptr(), tab.shape[0], o.data_ptr(), d.data_ptr(), r,
        T_MIN, int(wt), *(x.data_ptr() for x in out),
        torch.cuda.current_stream().cuda_stream), "parent closest")
    return tuple(out)


def _first_port_any(lib, tab, o, d, t_max, wt):
    occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    brute._raise_on(lib.dcrt_brute_any(
        tab.data_ptr(), tab.shape[0], o.data_ptr(), d.data_ptr(),
        t_max.data_ptr(), o.shape[0], T_MIN, int(wt), occ.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "parent any")
    return occ


def _in_turns(runs, reps):
    order = list(runs)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        turns[name].append(common.timed(runs[name], reps))
    return order + order[::-1], turns


def _twin_rays(case, n_rays, device):
    """The rays the twins check: all of them, on the grid sets
    GRID_TWIN_RAYS spread evenly over the set (a twin cast of 211,972
    triangles is slow)."""
    step = n_rays // GRID_TWIN_RAYS if case.startswith("grid") else 1
    return torch.arange(0, n_rays, step, device=device)


def _diffs(kind, a, b):
    """Fields (closest) or rays (any-hit) whose bits differ, and whether
    any do."""
    if kind == "closest":
        diff = closest_diffs(a, b)
        return diff, any(diff.values())
    diff = common.bit_diff(a, b)
    return diff, diff != 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory of an earlier brute_sweep.cu")
    ap.add_argument("--sets", default=",".join(SETS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("brute_ab: no CUDA device", file=sys.stderr)
        return 1
    names = args.sets.split(",")
    if set(names) - set(SETS):
        ap.error(f"--sets: pick from {SETS}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    variants = _build(args.parent)
    for name in ("parent", "new"):
        if name in variants:
            built = variants[name][1]
            rep = dict(variant=name, build_s=built.seconds,
                       ptxas=ptxas_report(built.log))
            if name == "new":
                rep["resources"] = brute.resources()
            print("brute-ab-build", json.dumps(rep))
    bad = []
    for wt in (False, True):
        adv = adversarial_diffs(dev, wt)
        print("brute-ab-adversarial", json.dumps(dict(watertight=wt, **adv)))
        if any(adv[f] for f in FIELDS + ("occ",)):
            bad.append(("adversarial", wt))
    for case, (tab, o, d, t_max) in dense_sets(dev, names).items():
        idx = _twin_rays(case, o.shape[0], dev)
        for wt in (False, True):
            rows = brute.prepare_rows(tab, wt)
            twins = dict(
                closest=brute.brute_closest_torch(tab, o[idx], d[idx], T_MIN,
                                                  wt),
                any=brute.brute_any_torch(tab, o[idx], d[idx], t_max[idx],
                                          T_MIN, wt))
            for kind, twin in twins.items():
                runs = {name: mk[0 if kind == "closest" else 1](
                            tab, rows, o, d, t_max, wt)
                        for name, (mk, _) in variants.items()}
                first = runs["new"]()
                vs_twin, vs_new = {}, {}
                for name, run in runs.items():
                    out = run()
                    sub = ([x[idx] for x in out] if kind == "closest"
                           else out[idx])
                    vs_twin[name], bad_twin = _diffs(kind, sub, twin)
                    vs_new[name], bad_new = _diffs(kind, out, first)
                    if bad_twin or bad_new:
                        bad.append((case, wt, kind, name))
                order, turns = _in_turns(runs, args.reps)
                dev_ms = {name: common.kernel_ms(run, args.reps,
                                                 f"{kind}_kernel")
                          for name, run in runs.items()}
                bnd = common.dense_bound(kind, o.shape[0], tab.shape[0])
                line = dict(
                    set=case, watertight=wt, kind=kind, rays=o.shape[0],
                    tris=tab.shape[0], order=order, ms=turns,
                    mean_ms={k: sum(v) / len(v) for k, v in turns.items()},
                    kernel_ms=dev_ms, bound=bnd,
                    share={k: t and bnd[0] / t for k, t in dev_ms.items()},
                    twin_rays=int(idx.numel()), bits_vs_twin=vs_twin,
                    bits_vs_new=vs_new,
                    hits=int(torch.isfinite(twin[0]).sum())
                    if kind == "closest" else int(twin.sum()))
                print("brute-ab", json.dumps(line))
    if bad:
        print(f"brute_ab: variants differ from the twins or new: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
