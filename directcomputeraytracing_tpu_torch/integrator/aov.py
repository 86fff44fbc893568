"""AOV (debug output) passes.

Counterpart of `directcomputeraytracing_tpu.integrator.aov` (the
reference's megakernel debug variants OUTPUT_NORMAL / OUTPUT_TANGENT /
OUTPUT_ALBEDO / OUTPUT_NEGATIVE_NDOTV / OUTPUT_BACKFACE /
OUTPUT_ITERATION_COUNT): trace the camera ray only and emit a shading
input, or the traversal's per-ray count as a cost heatmap.
"""

import torch

from ..accel.traverse import _resolve_backend, intersect_closest
from ..camera.camera import generate_ray
from ..rng.xoshiro import init_rng, next_sample_2d, next_sample_3d
from ..sampling.montecarlo import dot
from .common import RenderConfig, shade_hit

AOV_KINDS = ("normal", "tangent", "albedo", "negative_ndotv", "backface",
             "iteration_count")

# cast kinds that count their own per-ray cost: the walker's steps and
# the work list's swept clusters; every other kind reports 0
_COUNTING_KINDS = ("walk", "wl", "wlg")


def render_aov(scene, cam, cfg: RenderConfig, pixel_x, pixel_y, frame_seed,
               kind="normal"):
    """One camera-ray pass -> (R, 3) AOV values for the (R,) pixels.
    "iteration_count" casts through cfg.traversal_backend where that
    counts (`_COUNTING_KINDS`), else through the walker, as the reference
    pins it, and is not masked: misses show their cost too."""
    if kind not in AOV_KINDS:
        raise ValueError(f"AOV kind {kind!r}: one of {AOV_KINDS}")
    rng = init_rng(pixel_x, pixel_y, frame_seed)
    rng, pixel_sample = next_sample_2d(rng)
    res = torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                       device=pixel_x.device)
    pix = torch.stack([pixel_x, pixel_y], dim=-1).to(torch.float32)
    rng, aperture_sample = next_sample_3d(rng)
    origin, wi = generate_ray(cam, (pixel_sample + pix) / res,
                              aperture_sample)

    backend = cfg.traversal_backend
    if (kind == "iteration_count"
            and _resolve_backend(scene, backend) not in _COUNTING_KINDS):
        backend = "jax"
    hit = intersect_closest(scene, origin, wi, backend=backend,
                            watertight=cfg.watertight)
    if kind == "iteration_count":
        return hit.iterations.to(torch.float32)[:, None].expand(-1, 3) \
            .contiguous()
    itx = shade_hit(scene, origin, wi, hit)
    red = torch.tensor([1.0, 0.0, 0.0], device=origin.device)
    if kind == "normal":
        v = itx.normal * 0.5 + 0.5
    elif kind == "tangent":
        v = itx.tangent * 0.5 + 0.5
    elif kind == "albedo":
        v = itx.albedo
    elif kind == "negative_ndotv":
        n_dot_v = dot(itx.normal, -wi)
        v = torch.where((n_dot_v < 0.0)[:, None], red, 0.0)
    else:
        v = torch.where(hit.backface[:, None], red, 0.0)
    return torch.where(hit.hit[:, None], v, 0.0)
