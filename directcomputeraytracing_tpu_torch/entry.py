"""Single-sample entry point: one path-traced sample pass and its inputs.

Counterpart of the reference's `__graft_entry__.py` `entry`: Cornell
glossy (`cornell_box(light="area", material_set="glossy")`) at 64x64,
max_bounce 3, seed 0, with the committed Kulla-Conty LUTs
(`bake_luts_cached`), traced by the megakernel's `render_samples`.

    fn, args = entry("cuda")
    positions, values = fn(*args)     # (4096, 2) jitter, (4096, 3) radiance
"""

import torch

from .core.types import to_device
from .integrator.common import RenderConfig
from .integrator.megakernel import full_frame_pixels, render_samples
from .lut.bake import bake_luts_cached
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
