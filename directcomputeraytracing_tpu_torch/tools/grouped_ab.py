"""A/B of the grouped work-list sweeps (kernel rows 11-12) on one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.grouped_ab \
        [--parent DIR] [--reps N]

Times `closest_grouped_kernel` and `any_grouped_kernel` of
`csrc/worklist.cu` on the five ray sets of `chip_smoke.py` phase 2c over
`sphere_grid(12, 12)` (211,972 triangles; `ray_sets`, seed 20261018):
1,048,576 tiled camera rays, 1,048,576 random rays from inside the scene
box, 1,048,576 shadow rays towards the lamp, the random set in
`ray_sort_key` order and a pool-sized (2^18) sorted set, Baldwin-Weber
and watertight. Variants:

- `parent`: `--parent DIR`'s `worklist.cu` with its headers, an earlier
  version of the source, built under the library name worklist_parent
  and launched through its C interface (no admission boxes);
- `new`: the package's build of the source;
- `per_ray`: the per-ray sweeps `sweep_closest` / `sweep_any`, the
  yardstick.

Each is timed with CUDA events, the mean of `reps` (default 5) launches
after a warm-up, in turns: the variants in order, then in reverse
(parent, new, per_ray, per_ray, new, parent). A line per (set,
test, kind) gives both turns and their mean. Every variant must equal
`new` in every field of the sweep state (`iters` included: the parent
walks its items per block and, without a cap, counts the same) and the
per-ray sweep in the hit fields, and the any-hit variants must agree;
the tool exits non-zero otherwise. Prints the card's name and
power limit first, then per built variant its grouped kernels' ptxas
lines, and the package's kernels' resources (resident blocks per SM,
registers, shared and spill bytes). Needs a CUDA device; with none it
exits non-zero.

`ray_sets`, `closest_census`, `any_census`, `census_summary` and
`ptxas_report` serve `chip_smoke.py` phases 1 and 2c too: the censuses
walk the twins' own steps and count the (item, warp) pairs of the
grouped walks.
"""

import argparse
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
from .common import grid_ray_sets, sweep_diffs, timed

GRID = (12, 12)
SEED = 20261018
T_MIN = 1e-4


def ray_sets(tables, cam, device, seed=SEED):
    """The five ray sets of the sphere grid, name -> (o, d, t_max)
    (`tools.common.grid_ray_sets`)."""
    return grid_ray_sets(np.random.default_rng(seed), tables, cam, device)


def closest_census(tables, items, od, texp, t_min, watertight):
    """Counts of the (item, warp) pairs of the grouped closest walk of one
    cast, by the twin's own steps (`wl.grouped_closest_step`): `pairs`
    (every warp of a block against every item of its block),
    `block_voted` (passing the per-ray sweep's block vote), `warp_voted`
    (the warp vote) and `admitted` (then the super-box admission,
    `wl.warp_admitted`)."""
    rp, n = od.shape[1], Counter()
    st = wl._Best(texp)
    for lo in range(0, rp, wl.TWIN_RAY_CHUNK):
        for rays, item in wl._ray_steps(items, lo,
                                        min(rp, lo + wl.TWIN_RAY_CHUNK)):
            voted, v_item = wl._voted(items, rays, item, st.best, wl.GL)
            adm = wl.warp_admitted(tables.abox[items.sup[v_item].long()],
                                   od[:, voted], wl._window(st.best[voted]),
                                   t_min)
            n.update(pairs=rays.numel() // wl.GL,
                     block_voted=wl._voted(items, rays, item,
                                           st.best)[0].numel() // wl.GL,
                     warp_voted=voted.numel() // wl.GL,
                     admitted=int(adm.sum()) // wl.GL)
            wl.grouped_closest_step(tables, items, od, t_min, watertight,
                                    st, rays, item)
    return dict(n)


def any_census(tables, items, od, tm, t_min, watertight):
    """Counts of the (item, warp) pairs of the grouped any-hit walk of one
    cast, by the twin's own steps (`wl.any_step`): `pairs`, `visited`
    (some ray of the warp not yet occluded) and `admitted` (then the
    super-box admission, occluded rays capped at -BIG)."""
    rp, n = od.shape[1], Counter()
    occ = torch.zeros(rp, dtype=torch.bool, device=od.device)
    for lo in range(0, rp, wl.TWIN_RAY_CHUNK):
        for rays, item in wl._ray_steps(items, lo,
                                        min(rp, lo + wl.TWIN_RAY_CHUNK)):
            occ_r = occ[rays]
            adm = wl.warp_admitted(tables.abox[items.sup[item].long()],
                                   od[:, rays],
                                   torch.where(occ_r, -wl.BIG, tm[rays]),
                                   t_min)
            n.update(pairs=rays.numel() // wl.GL,
                     visited=int((~occ_r).view(-1, wl.GL).any(1).sum()),
                     admitted=int(adm.sum()) // wl.GL)
            wl.any_step(tables, items, od, tm, t_min, watertight, occ, rays,
                        item)
    return dict(n)


def census_summary(closest, any_, rp):
    """Per-ray and per-pair figures of the grouped walks from the
    censuses (`closest_census`, `any_census`) of one cast of rp padded
    rays. Fine-cull slab tests per ray: 32 for each pair the warp admits
    (the per-ray sweep and the first grouped design: 32 for each pair of
    an item that passed the block vote)."""
    warps = rp // wl.GL

    def share(c, key):
        return c.get(key, 0) / max(1, c.get("pairs", 0))

    return dict(
        pairs_per_warp=closest.get("pairs", 0) / warps,
        closest_block_voted_share=share(closest, "block_voted"),
        closest_warp_voted_share=share(closest, "warp_voted"),
        closest_admitted_share=share(closest, "admitted"),
        fine_tests_per_ray=wl.SUPER * closest.get("admitted", 0) / warps,
        fine_tests_per_ray_block_walk=wl.SUPER
        * closest.get("block_voted", 0) / warps,
        any_pairs_per_warp=any_.get("pairs", 0) / warps,
        any_visited_share=share(any_, "visited"),
        any_admitted_share=share(any_, "admitted"),
        any_fine_tests_per_ray=wl.SUPER * any_.get("admitted", 0) / warps)


def _short(entry):
    kind = "closest" if "closest_grouped" in entry else "any"
    return f"{kind}_{'wt' if 'RawWatertight' in entry else 'bw'}"


def ptxas_report(log, key="grouped_kernel"):
    """The ptxas lines (`nvcc -Xptxas -v`) of the entries whose mangled
    name holds `key`: {short name: {registers, smem, stack, spill_stores,
    spill_loads}}, short names closest_bw, closest_wt, any_bw, any_wt."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = _short(m.group(1)) if key in m.group(1) else None
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


class _Named:
    """A ctypes entry point under another name: `wl._table_ptrs` reads
    the name to pick the table pointers (the parent's grouped entry
    points take no admission boxes)."""

    def __init__(self, fn, name):
        self.fn, self.__name__ = fn, name

    def __call__(self, *args):
        return self.fn(*args)


def _bind_parent(lib):
    """The earlier C interface of the grouped sweeps: no admission boxes."""
    import ctypes

    c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dcrt_wl_closest_grouped.argtypes = [
        c_p, c_p, c_p, c_i, c_p, c_p, c_i, c_p, c_p, c_i, c_i, c_f,
        c_p, c_p, c_p, c_p, c_p, c_p, c_p, c_p, c_p]
    lib.dcrt_wl_any_grouped.argtypes = [c_p, c_p, c_i, c_p, c_p, c_i, c_p,
                                        c_p, c_i, c_i, c_f, c_p, c_p]
    lib.dcrt_wl_closest_grouped.restype = c_i
    lib.dcrt_wl_any_grouped.restype = c_i
    return (_Named(lib.dcrt_wl_closest_grouped, "parent_closest"),
            _Named(lib.dcrt_wl_any_grouped, "parent_any"))


def _build(parent):
    """name -> (closest entry, any entry, built library) of the package's
    kernels and, given a directory, the parent's; the nvcc runs in
    parallel."""
    from ..utils.cuda_build import load_library

    with ThreadPoolExecutor(2) as pool:
        new = pool.submit(wl.kernels)
        old = parent and pool.submit(
            load_library, "worklist.cu", wl._NVCC_EXTRA,
            csrc=os.path.abspath(parent), name="worklist_parent")
        out = {}
        if parent:
            built = old.result()
            out["parent"] = (*_bind_parent(built.lib), built)
        built = new.result()
        out["new"] = (built.lib.dcrt_wl_closest_grouped,
                      built.lib.dcrt_wl_any_grouped, built)
    return out


def _launches(variants, tables, od, texp, tm_a, it_c, it_a, wt):
    """name -> (closest(), any()) launching each variant on one set."""
    def grouped(c_fn, a_fn):
        def closest():
            err, out = wl._launch_closest(c_fn, tables, it_c, od, texp,
                                          T_MIN, wt)
            wl._raise_on(err, c_fn.__name__)
            return out

        def any_():
            err, occ = wl._launch_any(a_fn, tables, it_a, od, tm_a, T_MIN,
                                      wt)
            wl._raise_on(err, a_fn.__name__)
            return occ

        return closest, any_

    runs = {name: grouped(c, a) for name, (c, a, _) in variants.items()}
    runs["per_ray"] = (
        lambda: wl.sweep_closest(tables, it_c, od, texp, T_MIN, wt),
        lambda: wl.sweep_any(tables, it_a, od, tm_a, T_MIN, wt))
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="directory of an earlier worklist.cu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grouped_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    variants = _build(args.parent)
    for name, (c_fn, _, built) in variants.items():
        rep = dict(variant=name, build_s=built.seconds,
                   ptxas=ptxas_report(built.log))
        if name == "new":
            rep["resources"] = wl.grouped_resources()
        print("grouped-ab-build", json.dumps(rep))
    scene, cam = sphere_grid(*GRID)
    arrays, _ = flatten_scene(scene, dev)
    tables = wl.scene_tables(arrays)
    order = list(variants) + ["per_ray"]
    bad = []
    for set_name, (o, d, t_max) in ray_sets(tables, to_device(cam, dev),
                                            dev).items():
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        texp = wl.scene_exit(tables, od)
        it_c, it_a = wl.phases(tables, od, tm_c), wl.phases(tables, od, tm_a)
        for wt in (False, True):
            runs = _launches(variants, tables, od, texp, tm_a, it_c, it_a,
                             wt)
            want_c, want_a = (f() for f in runs["new"])
            check = {}
            for name, (c_fn, a_fn) in runs.items():
                got_c, got_a = c_fn(), a_fn()
                n = 7 if name == "per_ray" else 8
                check[name] = dict(closest=sweep_diffs(got_c, want_c, n),
                                   occ=int((got_a != want_a).sum()))
                if any(check[name]["closest"].values()) \
                        or check[name]["occ"]:
                    bad.append((set_name, wt, name))
            for kind in (0, 1):
                turns = {name: [] for name in order}
                for name in order + order[::-1]:
                    turns[name].append(timed(runs[name][kind], args.reps))
                line = dict(
                    case=set_name, watertight=wt,
                    kind=("closest", "any")[kind], rays=o.shape[0],
                    items=int((it_c, it_a)[kind].seg[-1]),
                    order=order + order[::-1],
                    ms={n: t for n, t in turns.items()},
                    mean_ms={n: sum(t) / len(t) for n, t in turns.items()})
                if kind == 0:
                    line["diffs_vs_new"] = check
                print("grouped-ab", json.dumps(line))
    if bad:
        print(f"grouped_ab: variants differ: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
