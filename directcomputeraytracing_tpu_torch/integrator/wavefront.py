"""Wavefront integrator: a path pool, masked stages, cursor refill.

Counterpart of `directcomputeraytracing_tpu.integrator.wavefront` (the
reference renderer's WavefrontPathTracer: a path pool driven by control,
new-path, material, extension-cast and shadow-cast stages). The pool is
P lanes of per-path state. One iteration of a Python `while` loop refills
idle lanes from a (pixel, sample) cursor, casts every lane's closest ray
(camera and extension rays together), adds light hits, does next-event
estimation with one shadow cast, samples the BSDF and writes finished
paths to the film. The loop ends when the cursor has passed the last
item and no lane is busy: one host read per iteration (the busy count,
which also moves the cursor).

Once the cursor has passed the last item the pool drains: an iteration
that refills no lane skips the new-path stage, and the pool sheds its
idle lanes (a gather of the busy ones, in lane order) whenever they are
half of it or more, so that the drain's casts and shading run on live
paths only. On a CUDA card the pool takes the whole pass up to
2^POOL_LOG2_CAP_CUDA lanes (`_pool_capacity`), so that few iterations
refill and the drain sheds; elsewhere it keeps the reference's size.

The per-path arithmetic (random-number draw order, NEE with MIS, BSDF
sampling, light hits) is the megakernel's op for op, and lane seeds are
pixel based, so at a fixed seed the two integrators give the same
samples. On scenes with work-list tables the pool is sorted by
`ray_sort_key` once per iteration (the reference's `sort_bounce_rays`,
which its renderer sets on its accelerator for world-soup cluster
tables; the port sorts instanced scenes too) and both casts run in that
lane order. The pool casts use `pool_cast_backend` (`RenderConfig.
pool_backend` when set, e.g. "pallas_pair"; else the grouped work-list
sweep by default on clustered scenes) and march distance slabs at
`pool_slab_march` of the scene diagonal (`RenderConfig.pool_slab_march`
or `slab_march`, 0.0 for none): the closest cast through
`accel.traverse.intersect_closest_slab` in `pool_slab_phases` phases,
the shadow cast in two windows (`_pool_any`).

`LAST_STATS` describes the last `render_samples_wavefront` call:
iterations, pool size, the lanes that cast summed over the iterations
(`busy_lane_iterations`: each iteration's paths carried in plus the
lanes it refilled), the iterations that began with the cursor past the
last item (`tail_iterations`: the pool's drain), the lanes the pool
held at each closest cast, summed (`cast_lane_iterations`, idle lanes
included), `spp_batch`, the pool
backend and slab depth,
casts per slab phase and rays re-cast in later phases, for the closest
and the shadow casts, and host reads. The reference's tunnel pacing
(bounded dispatches, pauses) is gone. `sample_slots=True` gives every
(pixel, sample) item its own output slot, as the splatting filters
need.

Alpha-tested scenes carry the reference's pre-drawn opacity sample per
lane (`PoolState.opacity_u`): drawn at refill right after the aperture
sample, for the shadow cast after the light sample and for the next
extension cast after the BSDF sample, at the megakernel's draw sites and
masks, so both integrators trace the same paths; every pool cast and its
slab phases take it.

Spans (`utils.trace`, while a profiler runs): `dcrt.integrator.wavefront`
around a pool pass (counts `pixels`, `spp_batch`, `iterations`,
`pool_lanes`, `busy_lane_iterations`, `tail_iterations`,
`cast_lane_iterations`: host numbers
the loop has, as in `LAST_STATS`; `closest_live_rays`, the live rays of
its closest casts, parked lanes left out: `busy_lane_iterations` plus
the rays later slab phases re-cast), the
casts' own (`accel.traverse`) and `dcrt.traversal.sort` around the
pool's sort.
"""

from typing import NamedTuple

import torch

from ..accel.traverse import (
    SlabStats,
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
)
from ..bsdf.fused import evaluate_bsdf_value_pdf, sample_bsdf
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
    offset_ray_origin,
    park_rays,
    pool_cast_backend,
    pool_slab_march,
    pool_slab_phases,
    shade_hit,
    slab_depth,
    sort_order,
)
from .megakernel import _mesh_light_camera_eval, _sel

# largest default pool, 2^18 paths (the reference's DCRT_POOL_LOG2 default)
POOL_LOG2_CAP = 18
# largest default pool on a CUDA card, 2^21 paths: ~0.9 KB a lane at an
# iteration's peak, 1.9 GB, where the reference's cap was its TPU's
POOL_LOG2_CAP_CUDA = 21

LAST_STATS = {}


class PoolState(NamedTuple):
    """Per-lane path state (the reference's ray, pixel, rng, throughput,
    radiance, flag buffers and pre-drawn alpha-test sample)."""
    rng: torch.Tensor         # (P, 4) xoshiro state
    pixel: torch.Tensor       # (P,) int64 (pixel, sample) item, -1 unset
    ray_o: torch.Tensor       # (P, 3)
    ray_d: torch.Tensor       # (P, 3)
    throughput: torch.Tensor  # (P, 3)
    li: torch.Tensor          # (P, 3)
    bsdf_pdf: torch.Tensor    # (P,) pdf of the sampled direction (MIS)
    is_delta: torch.Tensor    # (P,) bool
    bounce: torch.Tensor      # (P,) int64
    opacity_u: torch.Tensor   # (P,) f32 the next closest cast's sample
    busy: torch.Tensor        # (P,) bool: the lane holds a live path


def _pool_capacity(R, pool_size, cuda=False):
    """Pool lanes for R (pixel, sample) items: pool_size; on a CUDA card
    R rounded up to a power of two, at most 2^POOL_LOG2_CAP_CUDA (the
    whole pass where it fits: the drain sheds idle lanes, so a larger
    pool costs memory only); else, as the reference, a quarter of R
    rounded down to a power of two, clamped to [2^13, 2^POOL_LOG2_CAP]
    and to R rounded up to a power of two."""
    if pool_size is not None:
        return pool_size
    whole = 1 << (R - 1).bit_length()
    if cuda:
        return min(whole, 1 << POOL_LOG2_CAP_CUDA)
    quarter = max(R // 4, 1)
    P = 1 << max(13, min(POOL_LOG2_CAP, quarter.bit_length() - 1))
    return min(P, whole)


def _make_state(R, pool_size, spp_batch, device):
    P = _pool_capacity(R * spp_batch, pool_size,
                       cuda=torch.device(device).type == "cuda")
    zi = torch.zeros(P, dtype=torch.int64, device=device)
    zf3 = torch.zeros((P, 3), dtype=torch.float32, device=device)
    return PoolState(
        rng=init_rng(zi, zi, 0), pixel=torch.full_like(zi, -1), ray_o=zf3,
        ray_d=zf3.clone(), throughput=torch.ones_like(zf3),
        li=zf3.clone(),
        bsdf_pdf=torch.zeros(P, dtype=torch.float32, device=device),
        is_delta=torch.zeros(P, dtype=torch.bool, device=device),
        bounce=zi.clone(),
        opacity_u=torch.zeros(P, dtype=torch.float32, device=device),
        busy=torch.zeros(P, dtype=torch.bool, device=device))


class _Casts:
    """How the pool casts: backend, slab settings, and their stats."""

    def __init__(self, scene, cfg):
        self.backend = pool_cast_backend(cfg, scene)
        self.watertight = cfg.watertight
        self.alpha_textures = cfg.any_hit_texture
        march = pool_slab_march(scene, cfg, self.backend)
        self.slab = march > 0.0
        self.depth = slab_depth(scene, march) if self.slab else None
        self.phases = pool_slab_phases(cfg)
        self.closest = SlabStats(self.phases)
        self.any = SlabStats(2)


def _pool_closest(scene, casts, busy, ray_o, ray_d, opacity_u):
    """Closest cast over the pool in lane order; idle lanes are parked.
    With slabs, the cast marches distance windows; alpha-tested with
    opacity_u (None: opaque)."""
    ray_o, ray_d = park_rays(busy, ray_o, ray_d)
    kw = dict(backend=casts.backend, watertight=casts.watertight,
              opacity_u=opacity_u, alpha_textures=casts.alpha_textures)
    if not casts.slab:
        casts.closest.casts[0] += 1
        return intersect_closest(scene, ray_o, ray_d, **kw)
    return intersect_closest_slab(scene, ray_o, ray_d, casts.depth,
                                  live=busy, phases=casts.phases,
                                  stats=casts.closest, **kw)


def _pool_any(scene, casts, active, shadow_o, shadow_d, distance,
              opacity_u):
    """Shadow cast over the pool in lane order; inactive lanes park and
    cast a zero-length ray. With slabs it runs in two windows: phase 1
    over [0, min(dist, D)), then the unoccluded rays with dist > D are
    gathered (order kept) and re-cast over [D, dist). Exact: phase 1 is
    exhaustive below D."""
    dist = torch.where(active, distance, 0.0)
    o_s, d_s = park_rays(active, shadow_o, shadow_d)
    kw = dict(backend=casts.backend, watertight=casts.watertight,
              alpha_textures=casts.alpha_textures)
    casts.any.casts[0] += 1
    if not casts.slab:
        return intersect_any(scene, o_s, d_s, dist, opacity_u=opacity_u,
                             **kw)
    D = casts.depth
    occ1 = intersect_any(scene, o_s, d_s, torch.clamp_max(dist, D),
                         opacity_u=opacity_u, **kw)
    idx = torch.nonzero(active & ~occ1 & (dist > D))[:, 0]
    casts.any.host_reads += 1
    if not idx.numel():
        return occ1
    casts.any.casts[1] += 1
    casts.any.recast[0] += idx.numel()
    occ2 = intersect_any(scene, o_s[idx], d_s[idx], dist[idx], t_min=D,
                         opacity_u=None if opacity_u is None
                         else opacity_u[idx], **kw)
    return occ1.index_put((idx,), occ2)


def _permute_pool(scene, lanes):
    """Sort the pool's lanes into `ray_sort_key` order of their rays, idle
    lanes last: lanes = (busy, ray_o, ray_d, ...). Lane identity is
    invisible to the film, whose indices and seeds are pixel based."""
    busy, ray_o, ray_d = lanes[:3]
    with span("dcrt.traversal.sort", rays=busy.shape[0]):
        order = sort_order(scene, ray_o, ray_d, busy)
        return tuple(x[order] for x in lanes)


def _m1(rng, active):
    rng2, u = next_sample_1d(rng)
    return _sel(active, rng2, rng), u


def _m2(rng, active):
    rng2, u = next_sample_2d(rng)
    return _sel(active, rng2, rng), u


def _m3(rng, active):
    rng2, u = next_sample_3d(rng)
    return _sel(active, rng2, rng), u


class _Frame:
    """What every iteration reads: the scene, the pixel batch, the seed
    and the film (out_pos, out_val: OUT slots, one per pixel or, with
    sample_slots, one per (pixel, sample) item, and one dump row at
    index OUT)."""

    def __init__(self, scene, luts, cam, cfg, pixel_x, pixel_y, frame_seed,
                 spp_batch, sample_slots):
        self.scene, self.luts, self.cam, self.cfg = scene, luts, cam, cfg
        self.pixel_x, self.pixel_y = pixel_x, pixel_y
        self.frame_seed, self.spp_batch = int(frame_seed), spp_batch
        self.R = pixel_x.shape[0]
        self.RT = self.R * spp_batch
        self.slots = sample_slots
        self.OUT = self.RT if sample_slots else self.R
        dev = pixel_x.device
        self.res = torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                                device=dev)
        self.out_pos = torch.zeros((self.OUT + 1, 2), dtype=torch.float32,
                                   device=dev)
        self.out_val = torch.zeros((self.OUT + 1, 3), dtype=torch.float32,
                                   device=dev)
        self.env_idx = (cfg.env_light_index if cfg.has_env_light
                        else LIGHT_INDEX_INVALID)
        self.sort = has_worklist_tables(scene)


def _step(f: _Frame, casts: _Casts, s: PoolState, cursor, n_busy):
    """One pool iteration; returns the new state and cursor."""
    cfg, scene = f.cfg, f.scene
    # ---- NEW_PATH: refill idle lanes from the cursor (none in the drain,
    # which keeps every lane as it is)
    navail = max(f.RT - cursor, 0)
    refill = navail > 0 and n_busy < s.busy.shape[0]
    if refill:
        idle = ~s.busy
        rank = torch.cumsum(idle.long(), 0) - 1
        take = idle & (rank < navail)
        pixel_new = torch.where(take, cursor + rank, s.pixel)
        cursor = cursor + min(s.busy.shape[0] - n_busy, navail)
    else:
        take, pixel_new = torch.zeros_like(s.busy), s.pixel
    vidx = torch.clamp(pixel_new, 0, f.RT - 1)
    pidx = vidx // f.spp_batch
    rng, opacity_u, ray_o, ray_d = s.rng, s.opacity_u, s.ray_o, s.ray_d
    throughput, li, bounce, busy = s.throughput, s.li, s.bounce, s.busy
    if refill:
        px, py = f.pixel_x[pidx], f.pixel_y[pidx]
        seed = (f.frame_seed + vidx % f.spp_batch if f.spp_batch > 1
                else f.frame_seed)
        rng = _sel(take, init_rng(px, py, seed), rng)
        rng, pixel_sample = _m2(rng, take)
        pix = torch.stack([px, py], dim=-1).to(torch.float32)
        rng, aperture_sample = _m3(rng, take)
        cam_o, cam_d = generate_ray(f.cam, (pixel_sample + pix) / f.res,
                                    aperture_sample)
        if cfg.any_hit:
            rng, ou_new = _m1(rng, take)
            opacity_u = torch.where(take, ou_new, opacity_u)
        ray_o = _sel(take, cam_o, ray_o)
        ray_d = _sel(take, cam_d, ray_d)
        throughput = _sel(take, torch.ones_like(throughput), throughput)
        li = _sel(take, torch.zeros_like(li), li)
        bounce = torch.where(take, 0, bounce)
        busy = busy | take
        f.out_pos[torch.where(take, vidx if f.slots else pidx, f.OUT)] = \
            pixel_sample
    is_primary = take
    bsdf_pdf_prev, is_delta_prev = s.bsdf_pdf, s.is_delta

    # ---- one sort of the pool per iteration; both casts run in its order
    if f.sort:
        (busy, ray_o, ray_d, rng, pixel_new, pidx, throughput, li, bounce,
         is_primary, opacity_u, bsdf_pdf_prev, is_delta_prev) = _permute_pool(
            scene, (busy, ray_o, ray_d, rng, pixel_new, pidx, throughput, li,
                    bounce, is_primary, opacity_u, bsdf_pdf_prev,
                    is_delta_prev))

    # ---- EXTENSION_RAY_CAST: camera and extension rays together
    hit = _pool_closest(scene, casts, busy, ray_o, ray_d,
                        opacity_u if cfg.any_hit else None)
    itx = shade_hit(scene, ray_o, ray_d, hit)
    itx = itx._replace(position=_sel(hit.hit, itx.position, ray_o))

    # ---- light hits: camera view of lights, MIS-weighted for bounces
    light_idx = torch.where(hit.hit, itx.light_index, f.env_idx)
    if cfg.light_visible and refill:
        cam_light = is_primary & hit.hit & (itx.light_index
                                            != LIGHT_INDEX_INVALID)
        li = li + _sel(cam_light, _mesh_light_camera_eval(
            scene, itx.light_index, -ray_d, itx.geometry_normal),
            torch.zeros_like(li))
        if cfg.has_env_light:
            li = _sel(is_primary & ~hit.hit,
                      evaluate_env(scene, ray_d, cfg.env_light_index,
                                   cfg.has_env_texture), li)
    sec = busy & ~is_primary
    rad, l_pdf = evaluate_light_direct(
        scene, max(cfg.light_count, 1), cfg.has_env_texture, light_idx,
        itx.triangle_index, itx.geometry_normal, ray_d, hit.t)
    w = torch.where(is_delta_prev, 1.0,
                    power_heuristic(1, bsdf_pdf_prev, 1, l_pdf))
    ok = sec & (l_pdf > 0.0)
    li = li + _sel(ok, throughput * rad * w[..., None], torch.zeros_like(rad))

    # ---- retire misses and bounce-capped paths
    alive = busy & hit.hit & (bounce <= cfg.max_bounce)

    # ---- MATERIAL: NEE and a BSDF sample for the live lanes
    wo = -ray_d
    if cfg.light_count > 0:
        rng, u_sel = _m1(rng, alive)
        rng, u_tri = _m1(rng, alive)
        rng, u2 = _m2(rng, alive)
        ls = sample_light_direct(scene, cfg.light_count, cfg.has_env_texture,
                                 itx.position, u_sel, u_tri, u2)
        shadow_o = offset_ray_origin(itx.position, itx.geometry_normal, ls.wi)
        ou_s = None
        if cfg.any_hit:
            rng, ou_s = _m1(rng, alive)
        occluded = _pool_any(scene, casts, alive, shadow_o, ls.wi,
                             ls.distance, ou_s)
        fb, f_pdf = evaluate_bsdf_value_pdf(f.luts, ls.wi, wo, itx,
                                            cfg.use_vndf)
        n_dot_wi = torch.abs(dot(itx.normal, ls.wi))
        w_nee = torch.where(ls.is_delta, 1.0,
                            power_heuristic(1, ls.pdf, 1, f_pdf))
        contrib = (throughput * ls.radiance * fb
                   * (n_dot_wi * w_nee
                      / torch.clamp(ls.pdf, min=1e-20))[..., None])
        nee_ok = (alive & ~occluded & (ls.pdf > 0.0)
                  & (ls.radiance > 0.0).any(-1))
        li = li + _sel(nee_ok, contrib, torch.zeros_like(contrib))

    rng, u_sel_b = _m1(rng, alive)
    rng, u2_b = _m2(rng, alive)
    wi_new, fb, f_pdf, is_delta = sample_bsdf(f.luts, wo, u2_b, u_sel_b, itx,
                                              cfg.use_vndf)
    dead = (fb == 0.0).all(-1) | (f_pdf == 0.0)
    n_dot_wi = torch.abs(dot(itx.normal, wi_new))
    tp_new = throughput * fb * (
        n_dot_wi / torch.clamp(f_pdf, min=1e-20))[..., None]
    throughput = _sel(alive & ~dead, tp_new, throughput)
    ext_o = offset_ray_origin(itx.position, itx.geometry_normal, wi_new)
    still = alive & ~dead
    if cfg.any_hit:
        rng, ou_e = _m1(rng, still)
        opacity_u = torch.where(still, ou_e, opacity_u)
    ray_o = _sel(still, ext_o, ray_o)
    ray_d = _sel(still, wi_new, ray_d)

    # ---- CONTROL: finished paths to the film (one dump row at OUT)
    finish = busy & ~still
    slot = torch.clamp(pixel_new, 0, f.RT - 1) if f.slots else pidx
    f.out_val.index_add_(0, torch.where(finish, slot, f.OUT),
                         torch.where(finish[:, None], li, 0.0))
    return PoolState(
        rng=rng, pixel=pixel_new, ray_o=ray_o, ray_d=ray_d,
        throughput=throughput, li=li,
        bsdf_pdf=torch.where(still, f_pdf, bsdf_pdf_prev),
        is_delta=torch.where(still, is_delta, is_delta_prev),
        bounce=torch.where(still, bounce + 1, bounce), opacity_u=opacity_u,
        busy=still), cursor


def _shed(s: PoolState):
    """The pool cut to its busy lanes, in lane order: in the drain no lane
    is refilled, so an idle lane would only cast a parked ray."""
    keep = torch.nonzero(s.busy)[:, 0]
    return PoolState(*(x[keep] for x in s))


def render_samples_wavefront(scene, luts, cam, cfg: RenderConfig, pixel_x,
                             pixel_y, frame_seed, pool_size=None,
                             spp_batch=1, sample_slots=False):
    """Trace spp_batch samples per pixel through the path pool; the same
    contract as `megakernel.render_samples` for spp_batch = 1. Returns
    (sample_position (R, 2), summed sample_value (R, 3)).

    spp_batch > 1 interleaves S samples in one pool pass: the cursor walks
    R * S items pixel-major (sample s of pixel p is item p * S + s, lane
    seed frame_seed + s), so every path is the one S sequential passes
    would trace; the per-pixel sums differ from theirs by the order of
    float additions only. sample_position then holds one sample's
    jitter per pixel (the box film ignores it).

    sample_slots=True keeps every item's jitter and value in its own
    slot (slot = item = p * S + s, pixel-major): both outputs are then
    (R * S, 2) and (R * S, 3), for the splatting filters, which convolve
    each sample plane `[s::S]` on its own."""
    with span("dcrt.integrator.wavefront", pixels=pixel_x.shape[0],
              spp_batch=int(spp_batch)) as sp:
        f = _Frame(scene, luts, cam, cfg, pixel_x, pixel_y, frame_seed,
                   spp_batch, sample_slots)
        casts = _Casts(scene, cfg)
        s = _make_state(f.R, pool_size, spp_batch, pixel_x.device)
        pool_lanes = int(s.busy.shape[0])
        cursor, n_busy, iters, lane_iters, tail = 0, 0, 0, 0, 0
        cast_lanes = 0
        while cursor < f.RT or n_busy > 0:
            tail += cursor >= f.RT
            cast_lanes += s.busy.shape[0]
            start = cursor
            s, cursor = _step(f, casts, s, cursor, n_busy)
            # the lanes that cast this iteration: the paths carried in
            # and the lanes the cursor refilled
            lane_iters += n_busy + cursor - start
            n_busy = int(s.busy.sum())     # the iteration's one host read
            iters += 1
            if cursor >= f.RT and 0 < n_busy <= s.busy.shape[0] // 2:
                s = _shed(s)
        sp.add(iterations=iters, pool_lanes=pool_lanes,
               busy_lane_iterations=lane_iters, tail_iterations=tail,
               cast_lane_iterations=cast_lanes,
               closest_live_rays=lane_iters + sum(casts.closest.recast))
    LAST_STATS.clear()
    LAST_STATS.update(
        iterations=iters, pool_size=pool_lanes,
        busy_lane_iterations=lane_iters, tail_iterations=tail,
        cast_lane_iterations=cast_lanes,
        spp_batch=int(spp_batch), items=f.RT, slots=f.OUT,
        pool_backend=casts.backend,
        slab_depth=casts.depth,
        closest_casts_per_phase=list(casts.closest.casts),
        closest_recast=list(casts.closest.recast),
        any_casts_per_phase=list(casts.any.casts),
        any_recast=list(casts.any.recast),
        host_reads=iters + casts.closest.host_reads + casts.any.host_reads)
    return f.out_pos[:f.OUT], f.out_val[:f.OUT]
