"""Megakernel integrator: the whole path loop over a batch of pixels.

Counterpart of `directcomputeraytracing_tpu.integrator.megakernel`. The
reference fuses the loop into one jitted program with a `fori_loop` over
bounces; here the bounce loop is a Python loop over masked tensors.
Terminated paths are masked out and stop drawing random numbers
(`_masked_1d` / `_masked_2d`), exactly as in the reference, so both
packages draw the same per-pixel streams.

Per sample pass: one closest-hit cast for the camera ray, then per bounce
one any-hit shadow cast (when the scene has lights) and one closest-hit
extension cast, i.e. (max_bounce + 2) closest and (max_bounce + 1) any-hit
casts. On scenes with work-list tables (`has_worklist_tables`) each
extension cast runs in coherence-sorted order and its hits are scattered
back (the reference's `sort_bounce_rays` branch, which its renderer turns
on for world-soup cluster tables on its accelerator; the port sorts on
instanced scenes too), so that a block of the work-list traversal holds
rays of like origin and direction. With `RenderConfig.slab_march` > 0 on
the work list or the pair sweep (`megakernel_slab_depth`) the camera cast
and the sorted extension casts march distance slabs in
`RenderConfig.slab_phases` phases (`intersect_closest_slab`), as the
reference's megakernel does; elsewhere the field is ignored.

Alpha-tested scenes (`RenderConfig.any_hit`) pre-draw one opacity sample
per cast where the reference does: the camera ray's right after the
aperture sample, the shadow ray's after the light sample (masked on the
active lanes), the extension ray's after the BSDF sample (masked on the
lanes whose path goes on), and pass it into every cast, the sorted and
slab-marched ones included.

Spans (`utils.trace`, while a profiler runs): `dcrt.integrator.camera`
(streams and camera rays), the camera cast, `dcrt.integrator.shade`
(`shade_hit`) and `dcrt.integrator.emission` (a light the camera sees),
then per bounce `dcrt.integrator.bounce` holding `dcrt.integrator.nee`
(light sample, shadow cast, BSDF evaluation, MIS weight),
`dcrt.integrator.bsdf_sample`, the extension cast (in
`dcrt.traversal.sort` where it is sorted), `dcrt.integrator.shade` and
`dcrt.integrator.emission` (the implicit light hit and the carry
update). The casts' own spans are `accel.traverse`'s.
"""

from typing import NamedTuple

import torch

from ..accel.traverse import (
    HitInfo,
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
)
from ..bsdf.dispatch import evaluate_bsdf, evaluate_bsdf_pdf, sample_bsdf
from ..camera.camera import generate_ray
from ..core.constants import LIGHT_INDEX_INVALID
from ..lights.lights import (
    evaluate_env,
    evaluate_light_direct,
    sample_light_direct,
)
from ..rng.xoshiro import (
    init_rng,
    next_sample_1d,
    next_sample_2d,
    next_sample_3d,
)
from ..sampling.montecarlo import dot, power_heuristic
from ..utils.trace import span
from .common import (
    RenderConfig,
    has_worklist_tables,
    megakernel_slab_depth,
    offset_ray_origin,
    park_rays,
    shade_hit,
    sort_order,
)


def _sel(mask, new, old):
    if new.dim() > mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(mask, new, old)


def _masked_1d(rng, active):
    rng2, u = next_sample_1d(rng)
    return _sel(active, rng2, rng), u


def _masked_2d(rng, active):
    rng2, u = next_sample_2d(rng)
    return _sel(active, rng2, rng), u


def _mesh_light_camera_eval(scene, light_index, wo, geometry_normal):
    """A mesh light seen directly by the camera."""
    idx = torch.clamp(light_index, 0, scene.light_radiance.shape[0] - 1)
    facing = dot(wo, geometry_normal) > 0.0
    return torch.where(facing[..., None], scene.light_radiance[idx], 0.0)


class _Carry(NamedTuple):
    rng: torch.Tensor
    l: torch.Tensor
    throughput: torch.Tensor
    wi: torch.Tensor
    itx: object
    active: torch.Tensor


def _closest(scene, cfg, depth, origin, direction, opacity_u, live=None):
    """A closest cast of the megakernel: slab-marched from phase-1 cap
    depth (live: the lanes whose result counts), or one cast for None;
    alpha-tested with opacity_u (None: opaque)."""
    alpha = dict(opacity_u=opacity_u, alpha_textures=cfg.any_hit_texture)
    if depth is None:
        return intersect_closest(scene, origin, direction,
                                 backend=cfg.traversal_backend,
                                 watertight=cfg.watertight, **alpha)
    return intersect_closest_slab(scene, origin, direction, depth,
                                  backend=cfg.traversal_backend,
                                  watertight=cfg.watertight, live=live,
                                  phases=cfg.slab_phases, **alpha)


def _sorted_closest(scene, cfg, depth, origin, direction, opacity_u, alive):
    """Extension cast in `ray_sort_key` order, hits returned in lane order.
    Dead lanes sort last and are parked, so they enter nothing."""
    with span("dcrt.traversal.sort", rays=origin.shape[0]):
        order = sort_order(scene, origin, direction, alive)
        o, d = park_rays(alive, origin, direction)
        hit = _closest(scene, cfg, depth, o[order], d[order],
                       None if opacity_u is None else opacity_u[order],
                       alive[order])
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return HitInfo(*(x[inv] for x in hit))


def _nee(scene, luts, cfg, c, wo, rng):
    """Next-event estimation with MIS: a light sample, its shadow cast and
    the BSDF's value and pdf. Returns (rng, radiance with it added)."""
    active, itx = c.active, c.itx
    rng, u_sel = _masked_1d(rng, active)
    rng, u_tri = _masked_1d(rng, active)
    rng, u2 = _masked_2d(rng, active)
    ls = sample_light_direct(scene, cfg.light_count, cfg.has_env_texture,
                             itx.position, u_sel, u_tri, u2)
    shadow_o = offset_ray_origin(itx.position, itx.geometry_normal, ls.wi)
    ou_s = None
    if cfg.any_hit:
        rng, ou_s = _masked_1d(rng, active)
    # inactive lanes cast a zero-length parked ray
    occluded = intersect_any(
        scene, *park_rays(active, shadow_o, ls.wi),
        torch.where(active, ls.distance, 0.0),
        backend=cfg.traversal_backend, watertight=cfg.watertight,
        opacity_u=ou_s, alpha_textures=cfg.any_hit_texture)
    f = evaluate_bsdf(luts, ls.wi, wo, itx, cfg.use_vndf)
    f_pdf = evaluate_bsdf_pdf(luts, ls.wi, wo, itx, cfg.use_vndf)
    n_dot_wi = torch.abs(dot(itx.normal, ls.wi))
    w = torch.where(ls.is_delta, 1.0,
                    power_heuristic(1, ls.pdf, 1, f_pdf))
    contrib = (c.throughput * ls.radiance * f
               * (n_dot_wi * w / torch.clamp(ls.pdf, min=1e-20))[..., None])
    ok = (active & ~occluded & (ls.pdf > 0.0)
          & (ls.radiance > 0.0).any(-1))
    return rng, c.l + _sel(ok, contrib, torch.zeros_like(contrib))


def _bounce(scene, luts, cfg, depth, c):
    """One bounce: NEE with MIS, BSDF sample, extension cast (slab phase-1
    cap depth), implicit light hit with MIS."""
    active, itx, rng = c.active, c.itx, c.rng
    wo = -c.wi
    l_acc = c.l
    if cfg.light_count > 0:
        with span("dcrt.integrator.nee"):
            rng, l_acc = _nee(scene, luts, cfg, c, wo, rng)

    with span("dcrt.integrator.bsdf_sample"):
        rng, u_sel_b = _masked_1d(rng, active)
        rng, u2_b = _masked_2d(rng, active)
        wi_new, f, f_pdf, is_delta = sample_bsdf(luts, wo, u2_b, u_sel_b,
                                                 itx, cfg.use_vndf)
        dead = (f == 0.0).all(-1) | (f_pdf == 0.0)
        n_dot_wi = torch.abs(dot(itx.normal, wi_new))
        throughput = c.throughput * f * (
            n_dot_wi / torch.clamp(f_pdf, min=1e-20))[..., None]
        alive = active & ~dead
        throughput = _sel(alive, throughput, c.throughput)

        ext_o = offset_ray_origin(itx.position, itx.geometry_normal, wi_new)
        ou_e = None
        if cfg.any_hit:
            # masked on alive: a path whose BSDF sample died casts no
            # extension ray and draws no sample (the wavefront's stream)
            rng, ou_e = _masked_1d(rng, alive)
    if has_worklist_tables(scene):
        hit2 = _sorted_closest(scene, cfg, depth, ext_o, wi_new, ou_e, alive)
    else:
        hit2 = _closest(scene, cfg, None, ext_o, wi_new, ou_e)
    with span("dcrt.integrator.shade"):
        itx2 = shade_hit(scene, ext_o, wi_new, hit2)

    with span("dcrt.integrator.emission"):
        env_idx = cfg.env_light_index if cfg.has_env_light \
            else LIGHT_INDEX_INVALID
        light_idx = torch.where(hit2.hit, itx2.light_index, env_idx)
        rad, l_pdf = evaluate_light_direct(
            scene, max(cfg.light_count, 1), cfg.has_env_texture, light_idx,
            itx2.triangle_index, itx2.geometry_normal, wi_new, hit2.t)
        w = torch.where(is_delta, 1.0, power_heuristic(1, f_pdf, 1, l_pdf))
        ok = alive & (l_pdf > 0.0)
        l_acc = l_acc + _sel(ok, throughput * rad * w[..., None],
                             torch.zeros_like(rad))

        itx_next = type(itx)(*(_sel(alive, new, old)
                               for new, old in zip(itx2, itx)))
        itx_next = itx_next._replace(
            position=_sel(alive & hit2.hit, itx2.position, itx.position))
        return _Carry(rng=rng, l=l_acc, throughput=throughput,
                      wi=_sel(alive, wi_new, c.wi), itx=itx_next,
                      active=alive & hit2.hit)


def render_samples(scene, luts, cam, cfg: RenderConfig, pixel_x, pixel_y,
                   frame_seed):
    """Trace one sample per pixel for a pixel batch on the pixels' device.

    pixel_x / pixel_y: (R,) int64. Returns (sample_position (R, 2) in-pixel
    jitter, sample_value (R, 3) radiance).
    """
    with span("dcrt.integrator.camera", rays=pixel_x.shape[0]):
        rng = init_rng(pixel_x, pixel_y, frame_seed)
        rng, pixel_sample = next_sample_2d(rng)
        res = torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                           device=pixel_x.device)
        pix = torch.stack([pixel_x, pixel_y], dim=-1).to(torch.float32)
        rng, aperture_sample = next_sample_3d(rng)
        origin, wi = generate_ray(cam, (pixel_sample + pix) / res,
                                  aperture_sample)
        ou = None
        if cfg.any_hit:
            rng, ou = next_sample_1d(rng)

    depth = megakernel_slab_depth(scene, cfg)
    hit = _closest(scene, cfg, depth, origin, wi, ou)
    with span("dcrt.integrator.shade"):
        itx = shade_hit(scene, origin, wi, hit)
        itx = itx._replace(position=_sel(hit.hit, itx.position, origin))

    with span("dcrt.integrator.emission"):
        l = torch.zeros_like(origin)
        if cfg.light_visible:
            cam_light = hit.hit & (itx.light_index != LIGHT_INDEX_INVALID)
            l = l + _sel(cam_light,
                         _mesh_light_camera_eval(scene, itx.light_index, -wi,
                                                 itx.geometry_normal),
                         torch.zeros_like(l))
            if cfg.has_env_light:
                l = _sel(~hit.hit, evaluate_env(scene, wi,
                                                cfg.env_light_index,
                                                cfg.has_env_texture), l)

    c = _Carry(rng=rng, l=l, throughput=torch.ones_like(origin), wi=wi,
               itx=itx, active=hit.hit)
    for b in range(cfg.max_bounce + 1):
        with span("dcrt.integrator.bounce", bounce=b):
            c = _bounce(scene, luts, cfg, depth, c)
    return pixel_sample, c.l


def render_samples_accumulated(scene, luts, cam, cfg: RenderConfig,
                               pixel_x, pixel_y, base_seed, n_samples):
    """Sum of n_samples passes with seeds base_seed + k (box-filter
    accumulation)."""
    total = torch.zeros((pixel_x.shape[0], 3), dtype=torch.float32,
                        device=pixel_x.device)
    for k in range(n_samples):
        total = total + render_samples(scene, luts, cam, cfg, pixel_x,
                                       pixel_y, base_seed + k)[1]
    return total


def full_frame_pixels(cfg: RenderConfig, device):
    """Raster-order (x, y) int64 pixel coordinates of a whole frame."""
    ys, xs = torch.meshgrid(torch.arange(cfg.height, device=device),
                            torch.arange(cfg.width, device=device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def tiled_frame_pixels(cfg: RenderConfig, device, tile_h=32, tile_w=32):
    """Tile-major (x, y) int64 pixel coordinates and the inverse
    permutation: values[inv] puts tile-order results in raster order.
    Square 32x32 tiles make each 1024-ray block of the work-list
    traversal one tile, the most compact frustum; edge tiles are clipped."""
    h, w = cfg.height, cfg.width
    order = torch.cat([
        (torch.arange(ty, min(ty + tile_h, h))[:, None] * w
         + torch.arange(tx, min(tx + tile_w, w))[None, :]).reshape(-1)
        for ty in range(0, h, tile_h) for tx in range(0, w, tile_w)])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(h * w)
    return (order % w).to(device), (order // w).to(device), inv.to(device)
