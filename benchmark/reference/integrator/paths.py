"""The reference's path loop: one sample of each lane, lane by lane.

A plain restatement of the program's megakernel (camera ray, then per
bounce next-event estimation with MIS, a BSDF sample and the extension
cast) with the same draws from the same per-pixel xoshiro streams, so a
lane's path is the program's path: a lane is a (pixel, frame seed) pair,
and lanes of many samples trace together. Casts go to
`reference.intersect.Caster`, in lane order, only for the lanes whose
path is live. `q` rounds the path state where one stage hands it to the
next: the identity for the reference, a rounding to a lower precision for
its control.
"""

import torch

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
from .common import offset_ray_origin, shade_hit


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


class _Hit:
    """A cast's result in lane order; lanes not cast miss."""

    def __init__(self, n, dev, dtype):
        self.t = torch.full((n,), float("inf"), dtype=dtype, device=dev)
        self.u = torch.zeros(n, dtype=dtype, device=dev)
        self.v = torch.zeros(n, dtype=dtype, device=dev)
        self.triangle = torch.zeros(n, dtype=torch.long, device=dev)
        self.instance = torch.zeros(n, dtype=torch.long, device=dev)
        self.backface = torch.zeros(n, dtype=torch.bool, device=dev)

    @property
    def hit(self):
        return torch.isfinite(self.t)


def _closest(caster, origin, direction, opacity_u, lanes, q):
    hit = _Hit(origin.shape[0], origin.device, origin.dtype)
    idx = torch.nonzero(lanes)[:, 0]
    if idx.numel():
        t, u, v, tri, inst, back = caster.closest(
            origin[idx], direction[idx], 0.0,
            None if opacity_u is None else opacity_u[idx])
        hit.t[idx], hit.u[idx], hit.v[idx] = q(t), q(u), q(v)
        hit.triangle[idx], hit.instance[idx] = tri, inst
        hit.backface[idx] = back
    return hit


def _occluded(caster, origin, direction, t_max, opacity_u, lanes):
    occ = torch.zeros(origin.shape[0], dtype=torch.bool,
                      device=origin.device)
    idx = torch.nonzero(lanes)[:, 0]
    if idx.numel():
        occ[idx] = caster.occluded(
            origin[idx], direction[idx], t_max[idx], 0.0,
            None if opacity_u is None else opacity_u[idx])
    return occ


def _shade(scene, origin, direction, hit, q):
    itx = shade_hit(scene, origin, direction, hit)
    return itx._replace(**{f: q(getattr(itx, f)) for f in (
        "albedo", "alpha", "position", "normal", "tangent",
        "geometry_normal", "ior")})


def _mesh_light_camera_eval(scene, light_index, wo, geometry_normal):
    idx = torch.clamp(light_index, 0, scene.light_radiance.shape[0] - 1)
    facing = dot(wo, geometry_normal) > 0.0
    return torch.where(facing[..., None], scene.light_radiance[idx], 0.0)


def trace_lanes(scene, luts, cam, cfg, caster, pixel_x, pixel_y, seeds, q):
    """One sample per lane: (in-pixel jitter (N, 2), radiance (N, 3)).
    pixel_x, pixel_y, seeds: (N,) int64 (seeds modulo 2^32)."""
    rng = init_rng(pixel_x, pixel_y, seeds)
    rng, pixel_sample = next_sample_2d(rng)
    res = torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                       device=pixel_x.device)
    pix = torch.stack([pixel_x, pixel_y], dim=-1).to(torch.float32)
    rng, aperture_sample = next_sample_3d(rng)
    origin, wi = generate_ray(cam, (pixel_sample + pix) / res,
                              aperture_sample)
    origin, wi = q(origin), q(wi)
    ou = None
    if cfg.any_hit:
        rng, ou = next_sample_1d(rng)
    everyone = torch.ones(origin.shape[0], dtype=torch.bool,
                          device=origin.device)
    hit = _closest(caster, origin, wi, ou, everyone, q)
    itx = _shade(scene, origin, wi, hit, q)
    itx = itx._replace(position=_sel(hit.hit, itx.position, origin))

    l = torch.zeros_like(origin)
    if cfg.light_visible:
        cam_light = hit.hit & (itx.light_index != LIGHT_INDEX_INVALID)
        l = l + _sel(cam_light,
                     _mesh_light_camera_eval(scene, itx.light_index, -wi,
                                             itx.geometry_normal),
                     torch.zeros_like(l))
        if cfg.has_env_light:
            l = _sel(~hit.hit, evaluate_env(scene, wi, cfg.env_light_index,
                                            cfg.has_env_texture), l)
    throughput = torch.ones_like(origin)
    active = hit.hit
    for _ in range(cfg.max_bounce + 1):
        rng, l, throughput, wi, itx, active = _bounce(
            scene, luts, cfg, caster, rng, l, throughput, wi, itx, active, q)
    return pixel_sample, l


def _bounce(scene, luts, cfg, caster, rng, l_acc, throughput, wi, itx,
            active, q):
    wo = -wi
    if cfg.light_count > 0:
        rng, u_sel = _masked_1d(rng, active)
        rng, u_tri = _masked_1d(rng, active)
        rng, u2 = _masked_2d(rng, active)
        ls = sample_light_direct(scene, cfg.light_count, cfg.has_env_texture,
                                 itx.position, u_sel, u_tri, u2)
        ls = ls._replace(radiance=q(ls.radiance), wi=q(ls.wi), pdf=q(ls.pdf),
                         distance=q(ls.distance))
        shadow_o = offset_ray_origin(itx.position, itx.geometry_normal, ls.wi)
        ou_s = None
        if cfg.any_hit:
            rng, ou_s = _masked_1d(rng, active)
        occluded = _occluded(caster, shadow_o, ls.wi,
                             torch.where(active, ls.distance, 0.0), ou_s,
                             active & (ls.distance > 0.0))
        f = q(evaluate_bsdf(luts, ls.wi, wo, itx, cfg.use_vndf))
        f_pdf = q(evaluate_bsdf_pdf(luts, ls.wi, wo, itx, cfg.use_vndf))
        n_dot_wi = torch.abs(dot(itx.normal, ls.wi))
        w = torch.where(ls.is_delta, 1.0,
                        power_heuristic(1, ls.pdf, 1, f_pdf))
        contrib = (throughput * ls.radiance * f
                   * (n_dot_wi * w / torch.clamp(ls.pdf, min=1e-20))[..., None])
        ok = (active & ~occluded & (ls.pdf > 0.0)
              & (ls.radiance > 0.0).any(-1))
        l_acc = q(l_acc + _sel(ok, contrib, torch.zeros_like(contrib)))

    rng, u_sel_b = _masked_1d(rng, active)
    rng, u2_b = _masked_2d(rng, active)
    wi_new, f, f_pdf, is_delta = sample_bsdf(luts, wo, u2_b, u_sel_b, itx,
                                             cfg.use_vndf)
    wi_new, f, f_pdf = q(wi_new), q(f), q(f_pdf)
    dead = (f == 0.0).all(-1) | (f_pdf == 0.0)
    n_dot_wi = torch.abs(dot(itx.normal, wi_new))
    new_tp = throughput * f * (
        n_dot_wi / torch.clamp(f_pdf, min=1e-20))[..., None]
    alive = active & ~dead
    throughput = q(_sel(alive, new_tp, throughput))

    ext_o = offset_ray_origin(itx.position, itx.geometry_normal, wi_new)
    ou_e = None
    if cfg.any_hit:
        rng, ou_e = _masked_1d(rng, alive)
    hit2 = _closest(caster, ext_o, wi_new, ou_e, alive, q)
    itx2 = _shade(scene, ext_o, wi_new, hit2, q)

    env_idx = cfg.env_light_index if cfg.has_env_light \
        else LIGHT_INDEX_INVALID
    light_idx = torch.where(hit2.hit, itx2.light_index, env_idx)
    rad, l_pdf = evaluate_light_direct(
        scene, max(cfg.light_count, 1), cfg.has_env_texture, light_idx,
        itx2.triangle_index, itx2.geometry_normal, wi_new, hit2.t)
    rad, l_pdf = q(rad), q(l_pdf)
    w = torch.where(is_delta, 1.0, power_heuristic(1, f_pdf, 1, l_pdf))
    ok = alive & (l_pdf > 0.0)
    l_acc = q(l_acc + _sel(ok, throughput * rad * w[..., None],
                           torch.zeros_like(rad)))

    itx_next = type(itx)(*(_sel(alive, new, old)
                           for new, old in zip(itx2, itx)))
    itx_next = itx_next._replace(
        position=_sel(alive & hit2.hit, itx2.position, itx.position))
    return (rng, l_acc, throughput, _sel(alive, wi_new, wi), itx_next,
            alive & hit2.hit)
