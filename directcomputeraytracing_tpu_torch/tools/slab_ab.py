"""Does pool slab marching pay? An A/B of the wavefront's pool casts on
one GPU.

    python -m directcomputeraytracing_tpu_torch.tools.slab_ab [pairs] [spp]

Renders `sphere_grid(12, 12)` (211,972 triangles) at 1920x1080, max_bounce
4, through the wavefront integrator, one pool pass of `spp` samples
(default 2) per measurement, the default 2^18-path pool. For each pool
backend, "pallas_wl" (the work list's per-ray sweep), "pallas_wlg" (its
grouped sweep, the default) and "pallas_pair" (the pair sweep), it runs
one warm-up pass and then `pairs` (default 10) pairs of passes with slab
marching on (`slab_march=None`, the pool default of 0.03 of the scene
diagonal) and off (`slab_march=0.0`), alternating, the order within a
pair swapped every pair (on/off, off/on, ...) so that a drift of the host
or the card falls on both arms alike. Every pass uses the same seed, so
on and off trace the same paths. Needs a CUDA device; with none it exits
non-zero.

Prints the card's name and power limit, one JSON line per pass (ms/spp by
the host clock around the pass, ending in `torch.cuda.synchronize()`; the
pool iterations and casts per slab phase of `LAST_STATS`) and one summary
line per backend: the on and off ms/spp lists, their medians, the median
of the per-pair ratios on / off, and in how many pairs the slabs won.
"""

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

from ..integrator import wavefront as wf
from ..integrator.renderer import Renderer
from ..scene.presets import sphere_grid

BACKENDS = ("pallas_wl", "pallas_wlg", "pallas_pair")
WIDTH, HEIGHT, MAX_BOUNCE = 1920, 1080, 4


def _pass(r, march, spp):
    """ms/spp of one pool pass with slab_march=march, and its stats."""
    cfg = replace(r.cfg, slab_march=march)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.render_samples_wavefront(r.arrays, r.luts, r.camera, cfg, r._px,
                                r._py, 0, spp_batch=spp)
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0) / spp, dict(wf.LAST_STATS)


def main(argv):
    if not torch.cuda.is_available():
        print("slab_ab: no CUDA device", file=sys.stderr)
        return 1
    pairs = int(argv[0]) if argv else 10
    spp = int(argv[1]) if len(argv) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    scene, cam = sphere_grid(12, 12)
    for backend in BACKENDS:
        r = Renderer(scene, cam, WIDTH, HEIGHT, max_bounce=MAX_BOUNCE,
                     integrator="wavefront", device=dev, pool_backend=backend)
        _pass(r, None, spp)                      # warm-up
        times = {"on": [], "off": []}
        for k in range(pairs):
            order = ("on", "off") if k % 2 == 0 else ("off", "on")
            for arm in order:
                ms, stats = _pass(r, None if arm == "on" else 0.0, spp)
                times[arm].append(ms)
                print("pass", json.dumps(dict(
                    backend=backend, pair=k, slabs=arm, ms_per_spp=ms,
                    iterations=stats["iterations"],
                    closest_casts_per_phase=stats["closest_casts_per_phase"],
                    any_casts_per_phase=stats["any_casts_per_phase"])),
                    flush=True)
        ratios = [a / b for a, b in zip(times["on"], times["off"])]
        print("summary", backend, json.dumps(dict(
            spp=spp, pairs=pairs, on_ms_per_spp=times["on"],
            off_ms_per_spp=times["off"],
            on_median=statistics.median(times["on"]),
            off_median=statistics.median(times["off"]),
            ratio_on_off_median=statistics.median(ratios),
            slabs_won=sum(x < 1.0 for x in ratios))), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
