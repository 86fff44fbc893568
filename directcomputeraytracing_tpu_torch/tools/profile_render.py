"""Where the time of a render goes, on one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.profile_render [case]

case: `cornell` (default, `cornell_box("area", "glossy")`, the dense
sweep, 1024x1024), `sphere_grid` (`sphere_grid(12, 12)`, 211,972
triangles, the work-list traversal, 1024x1024), `instanced`
(`sphere_grid(27, 27)`, 1,073,092 triangles in the instanced tables,
the instanced work-list sweeps, 1024x1024), `clustered` (`sphere_grid(12,
12)` through `traversal_backend="pallas_cluster"`, 1024x1024), `pair`
(`sphere_grid(12, 12)` through `traversal_backend="pallas_pair"`,
1024x1024), all through the megakernel, or `wavefront` (`sphere_grid(12,
12)` at 1920x1080 through the wavefront integrator and its grouped pool
casts), `pair_wavefront` (the same with `pool_backend="pallas_pair"`)
and `clustered_wavefront` (the same through
`traversal_backend="pallas_cluster"`: the clustered pool casts);
`cornell_wavefront` is the Cornell scene through the wavefront
integrator (the dense sweep on 2^18-ray pool casts) at 512x512: a closed
box keeps every path to its last bounce, and at 1024x1024 one run of the
tool outlasted 300 s on an H100;
`alpha` is `alpha_sphere_grid(12, 12)` (half the spheres alpha-tested,
the opaque/masked split) through the megakernel at 1024x1024.
Needs a CUDA
device; with none it exits non-zero. Renders at max_bounce 4 through
`Renderer.render(spp=8)`: the fused 8-sample call that chip_smoke.py's
renders make (one pool pass of 8 samples for the wavefront). Prints the
card's name and power limit, the
operators with the most device time (a `key_averages()` table), and four
JSON lines:

- `wall`: ms/spp by the host clock around `render(8)` ending in
  `torch.cuda.synchronize()`, for three runs after a warm-up of the same
  call, and the peak device memory;
- `trace`: one more `render(8)` under `torch.profiler`, per sample pass:
  device busy ms (the union of the intervals of the device's kernels and
  copies), device ops launched, and the profiled wall ms. `idle_traced`
  is the idle share of the profiled run itself; `idle_unprofiled` sets the
  same busy time against the median unprofiled wall ms. The profiler slows
  the host and not the kernels, so the second is the nearer estimate;
- `ops`: device time per PyTorch operator (its kernels' time) as a share
  of busy time, largest first;
- `port_kernels`: device ms per sample pass of each of the port's own
  kernels (launched through ctypes, so no PyTorch operator holds them),
  and their share of busy time;
- `wavefront_stats` (the wavefront case): `LAST_STATS` of the traced
  pass (iterations, casts per slab phase, host reads);
- `alpha` (the alpha case): recast loops and passes per sample pass.
"""

import json
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..integrator.renderer import Renderer
from ..accel import traverse
from ..scene.presets import alpha_sphere_grid, cornell_box, sphere_grid

MAX_BOUNCE = 4
SPP = 8
REPS = 3
# case: (scene, width, height, integrator, traversal backend, pool
# backend)
CASES = {"cornell": (lambda: cornell_box("area", "glossy"), 1024, 1024,
                     "megakernel", "auto", ""),
         "sphere_grid": (lambda: sphere_grid(12, 12), 1024, 1024,
                         "megakernel", "auto", ""),
         "instanced": (lambda: sphere_grid(27, 27), 1024, 1024,
                       "megakernel", "auto", ""),
         "clustered": (lambda: sphere_grid(12, 12), 1024, 1024,
                       "megakernel", "pallas_cluster", ""),
         "pair": (lambda: sphere_grid(12, 12), 1024, 1024, "megakernel",
                  "pallas_pair", ""),
         "wavefront": (lambda: sphere_grid(12, 12), 1920, 1080,
                       "wavefront", "auto", ""),
         "pair_wavefront": (lambda: sphere_grid(12, 12), 1920, 1080,
                            "wavefront", "auto", "pallas_pair"),
         "clustered_wavefront": (lambda: sphere_grid(12, 12), 1920, 1080,
                                 "wavefront", "pallas_cluster", ""),
         "cornell_wavefront": (lambda: cornell_box("area", "glossy"), 512,
                               512, "wavefront", "auto", ""),
         "alpha": (lambda: alpha_sphere_grid(12, 12), 1024, 1024,
                   "megakernel", "auto", "")}
# the port's kernels, told apart by entry point and template or parameter
# types in the demangled names the profiler reports (the per-ray sweeps'
# second template argument is true on instanced tables); a kernel
# counts under the first key it matches (the clustered sweeps take mask
# pointers, `unsigned char const*`, which no other closest or any-hit
# kernel takes; the pair kernels' names hold the work list's as a suffix)
PORT_KERNELS = {
    "prep.cu prep_kernel": ("prep_kernel",),
    "pairsweep.cu emit_kernel": ("emit_kernel",),
    "pairsweep.cu pair_closest_kernel": ("pair_closest_kernel",),
    "pairsweep.cu pair_any_kernel": ("pair_any_kernel",),
    "clustered.cu cull_kernel": ("cull_kernel", "Reach"),
    "clustered.cu closest_kernel": ("closest_kernel", "unsigned char const*"),
    "clustered.cu any_kernel": ("any_kernel", "unsigned char const*"),
    "worklist.cu cull_kernel": ("cull_kernel",),
    "worklist.cu refine_kernel": ("refine_kernel",),
    "worklist.cu closest_ray_kernel": ("closest_ray_kernel", "false>"),
    "worklist.cu any_ray_kernel": ("any_ray_kernel", "false>"),
    "worklist.cu closest_grouped_kernel": ("closest_grouped_kernel",),
    "worklist.cu any_grouped_kernel": ("any_grouped_kernel",),
    "worklist.cu closest_ray_kernel (instanced)": ("closest_ray_kernel",
                                                   "true>"),
    "worklist.cu any_ray_kernel (instanced)": ("any_ray_kernel", "true>"),
    "brute_sweep.cu closest_kernel": ("closest_kernel", "Moeller",
                                      "Watertight"),
    "brute_sweep.cu any_kernel": ("any_kernel", "Moeller", "Watertight"),
}


def _timed_render(r):
    r.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=SPP)
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0) / SPP


def _busy_ms(events):
    """Length of the union of device-side event intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1000.0, len(spans)


def _port_kernel_ms(events):
    """Device ms of each of the port's kernels over the traced run."""
    out = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        for key, (entry, *args) in PORT_KERNELS.items():
            if entry in e.name and (not args
                                    or any(a in e.name for a in args)):
                out[key] = out.get(key, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1000.0
                break
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    case = argv[0] if argv else "cornell"
    if case not in CASES:
        print(f"profile_render: case is one of {sorted(CASES)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120, check=True)
    print(smi.stdout.strip())
    make, width, height, integrator, backend, pool = CASES[case]
    r = Renderer(*make(), width, height, max_bounce=MAX_BOUNCE,
                 integrator=integrator, device=torch.device("cuda"),
                 traversal_backend=backend, pool_backend=pool)
    _timed_render(r)   # warm-up: kernel build, allocator growth
    torch.cuda.reset_peak_memory_stats()
    wall = [_timed_render(r) for _ in range(REPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30

    r.reset()
    torch.cuda.synchronize()
    traverse.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render(spp=SPP)
        torch.cuda.synchronize()
        traced_ms = 1000.0 * (time.perf_counter() - t0) / SPP
    busy, n_ops = _busy_ms(prof.events())
    busy /= SPP
    own = {k: ms / SPP for k, ms in _port_kernel_ms(prof.events()).items()}
    ka = prof.key_averages()
    print(ka.table(sort_by="self_device_time_total", row_limit=25,
                   max_name_column_width=60))
    per_op = sorted(((e.self_device_time_total / 1000.0 / SPP, e.key)
                     for e in ka if e.device_type == DeviceType.CPU
                     and e.self_device_time_total > 0), reverse=True)
    median = statistics.median(wall)
    print("wall", json.dumps(dict(ms_per_spp=wall, median=median,
                                  peak_mem_gib=peak)))
    print("trace", json.dumps(dict(
        busy_ms_per_spp=busy, device_ops_per_spp=n_ops / SPP,
        traced_wall_ms_per_spp=traced_ms,
        idle_traced=1.0 - busy / traced_ms,
        idle_unprofiled=1.0 - busy / median)))
    print("ops", json.dumps({k: round(ms / busy, 4) for ms, k in per_op[:12]}))
    print("port_kernels", json.dumps(dict(
        case=case, ms_per_spp=own,
        share_of_busy=sum(own.values()) / busy)))
    if integrator == "wavefront":
        from ..integrator.wavefront import LAST_STATS

        print("wavefront_stats", json.dumps(LAST_STATS))
    if r.cfg.any_hit:
        print("alpha", json.dumps(dict(
            recast_loops_per_spp=traverse.alpha_recast.calls / SPP,
            recast_passes_per_spp=traverse.alpha_recast.passes / SPP)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
