"""Entry points: one path-traced sample pass and its inputs, and
a multi-rank dry run.

Counterparts of the reference's `__graft_entry__.py`. `entry`: Cornell
glossy (`cornell_box(light="area", material_set="glossy")`) at 64x64,
max_bounce 3, seed 0, with the committed Kulla-Conty LUTs
(`bake_luts_cached`), traced by the megakernel's `render_samples`.

    fn, args = entry("cuda")
    positions, values = fn(*args)     # (4096, 2) jitter, (4096, 3) radiance

`dryrun_multichip(n, device)`: one distributed step of each integrator
on n spawned gloo ranks (`run_gloo_world`), Cornell glossy at 32x32.

    dryrun_multichip(4, "cpu")        # raises if a rank fails
"""

import os
import tempfile

import torch
import torch.distributed as dist

from .core.types import to_device
from .integrator.common import RenderConfig
from .integrator.megakernel import full_frame_pixels, render_samples
from .lut.bake import bake_luts_cached
from .parallel.dist import DistributedRenderer, make_mesh
from .scene.presets import cornell_box
from .scene.scene import flatten_scene


def _setup(device, width=64, height=64, max_bounce=3):
    """(scene tensors, LUTs, camera, RenderConfig) of the entry's Cornell
    box on `device`."""
    scene, cam = cornell_box(light="area", material_set="glossy")
    arrays, meta = flatten_scene(scene, device)
    cfg = RenderConfig(width=width, height=height, max_bounce=max_bounce,
                       light_count=meta.light_count, env_light_index=-1,
                       has_env_texture=False)
    return arrays, bake_luts_cached(device=device), to_device(cam, device), cfg


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) traces one sample a pixel of
    the whole frame and returns (sample positions (R, 2), sample values
    (R, 3)) on `device`."""
    device = torch.device(device)
    arrays, luts, cam, cfg = _setup(device)
    px, py = full_frame_pixels(cfg, device)

    def fn(arrays, luts, cam, px, py, seed):
        return render_samples(arrays, luts, cam, cfg, px, py, seed)

    return fn, (arrays, luts, cam, px, py, 0)


def _gloo_rank(rank, n, store, fn, args):
    """Rank `rank` of run_gloo_world: join the group, run fn, leave."""
    torch.set_num_threads(max(1, torch.get_num_threads() // n))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n, rank=rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_gloo_world(n, fn, *args):
    """Run fn(*args) on n spawned processes joined into one gloo process
    group (a file store in a temporary directory; ranks 0..n-1), each
    leaving the group when fn returns or raises. fn must be importable
    by name (a module-level function). A rank's exception is raised here
    (`torch.multiprocessing.ProcessRaisedException`), after the other
    ranks are stopped."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_gloo_rank, args=(n, os.path.join(d, "store"), fn, args),
                 nprocs=n, join=True, start_method="spawn")


def _dryrun_rank(device):
    n = dist.get_world_size()
    devices = None if torch.device(device).type == "cuda" else [device] * n
    mesh = make_mesh(spp_parallel=2 if n % 2 == 0 else 1, devices=devices)
    arrays, luts, cam, cfg = _setup(mesh.device, 32, 32, max_bounce=2)
    for integrator in ("megakernel", "wavefront"):
        r = DistributedRenderer(mesh, arrays, luts, cam, cfg,
                                integrator=integrator)
        r.render_step()
        img = r.image()
        if img.shape != (32, 32, 3) or not float(img.max()) > 0.0:
            raise RuntimeError(f"dryrun_multichip: the {integrator} image "
                               f"has shape {img.shape}, max {img.max()}")


def dryrun_multichip(n_devices, device="cuda"):
    """One distributed progressive step of each integrator (pixels split
    into bands over "tile", samples summed over "spp"; spp_parallel 2
    when n_devices is even, else 1) on n_devices gloo ranks, Cornell
    glossy at 32x32, max_bounce 2; every rank checks the gathered image's
    shape and that it is not black. device "cpu" runs the twins; on
    "cuda" the ranks share cuda:{rank % device_count}. Raises if any
    rank fails."""
    run_gloo_world(n_devices, _dryrun_rank, device)
