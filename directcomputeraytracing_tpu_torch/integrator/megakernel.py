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

The pass is a generator over its casts (`_segments`); the code between
two casts is a segment, 2 * (max_bounce + 2) of them on scenes with
lights. `render_samples` runs the segments eagerly with the casts
between them. `PassGraphs` (which `Renderer` keeps on a CUDA device)
captures each segment into a CUDA graph on the second pass for a key
and replays the graphs on later passes, the casts still run eagerly
between them through their wrappers: the same ops in the same order,
and so the same bits, without the host issuing the segments' thousands
of ops one by one. A key used once (an edit or a camera move a pass)
never pays for a capture.

Spans (`utils.trace`, while a profiler runs): each segment in a
`dcrt.integrator.segment` (counts `segment`, its index in the pass, and
`replayed`, 1 under a graph). Inside an eager segment:
`dcrt.integrator.camera` (streams and camera rays),
`dcrt.integrator.shade` (`shade_hit`) and `dcrt.integrator.emission` (a
light the camera sees, or the implicit light hit and the carry update),
`dcrt.integrator.nee` (the light sample and shadow ray before the shadow
cast, the BSDF evaluation and MIS weight after it),
`dcrt.integrator.bsdf_sample`, and `dcrt.traversal.sort` (the order and
parked rays before a sorted extension cast, the scatter back after it).
The casts' own spans are `accel.traverse`'s; under a replay the segment
span stands for the spans inside it.
"""

import gc
import itertools
from typing import NamedTuple

import torch

from ..accel.traverse import (
    HitInfo,
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
    constant,
    has_worklist_tables,
    megakernel_slab_depth,
    offset_ray_origin,
    park_rays,
    shade_hit,
    sort_order,
)


SEGMENT = "dcrt.integrator.segment"


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


class _Closest(NamedTuple):
    """A closest cast between two segments: slab-marched from phase-1
    cap depth (live: the lanes whose result counts), or one cast for
    depth None; alpha-tested with opacity_u (None: opaque)."""
    origin: torch.Tensor
    direction: torch.Tensor
    opacity_u: object
    depth: object = None
    live: object = None


class _Any(NamedTuple):
    """An occlusion cast between two segments."""
    origin: torch.Tensor
    direction: torch.Tensor
    t_max: torch.Tensor
    opacity_u: object


def _cast(scene, cfg, c):
    """Run the cast c (`_Closest` or `_Any`): a HitInfo or the (R,) bool
    occlusion."""
    alpha = dict(opacity_u=c.opacity_u, alpha_textures=cfg.any_hit_texture)
    if isinstance(c, _Any):
        return intersect_any(scene, c.origin, c.direction, c.t_max,
                             backend=cfg.traversal_backend,
                             watertight=cfg.watertight, **alpha)
    if c.depth is None:
        return intersect_closest(scene, c.origin, c.direction,
                                 backend=cfg.traversal_backend,
                                 watertight=cfg.watertight, **alpha)
    return intersect_closest_slab(scene, c.origin, c.direction, c.depth,
                                  backend=cfg.traversal_backend,
                                  watertight=cfg.watertight, live=c.live,
                                  phases=cfg.slab_phases, **alpha)


def _sorted_closest(scene, depth, origin, direction, opacity_u, alive):
    """Extension cast in `ray_sort_key` order, hits returned in lane order.
    Dead lanes sort last and are parked, so they enter nothing."""
    with span("dcrt.traversal.sort", rays=origin.shape[0]):
        order = sort_order(scene, origin, direction, alive)
        o, d = park_rays(alive, origin, direction)
        cast = _Closest(o[order], d[order],
                        None if opacity_u is None else opacity_u[order],
                        depth, alive[order])
    hit = yield cast
    with span("dcrt.traversal.sort", rays=origin.shape[0]):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return HitInfo(*(x[inv] for x in hit))


def _nee(scene, luts, cfg, c, wo, rng):
    """Next-event estimation with MIS: a light sample, its shadow cast and
    the BSDF's value and pdf. Returns (rng, radiance with it added)."""
    active, itx = c.active, c.itx
    with span("dcrt.integrator.nee"):
        rng, u_sel = _masked_1d(rng, active)
        rng, u_tri = _masked_1d(rng, active)
        rng, u2 = _masked_2d(rng, active)
        ls = sample_light_direct(scene, cfg.light_count,
                                 cfg.has_env_texture, itx.position, u_sel,
                                 u_tri, u2)
        shadow_o = offset_ray_origin(itx.position, itx.geometry_normal,
                                     ls.wi)
        ou_s = None
        if cfg.any_hit:
            rng, ou_s = _masked_1d(rng, active)
        # inactive lanes cast a zero-length parked ray
        cast = _Any(*park_rays(active, shadow_o, ls.wi),
                    torch.where(active, ls.distance, 0.0), ou_s)
    occluded = yield cast
    with span("dcrt.integrator.nee"):
        f, f_pdf = evaluate_bsdf_value_pdf(luts, ls.wi, wo, itx,
                                           cfg.use_vndf)
        n_dot_wi = torch.abs(dot(itx.normal, ls.wi))
        w = torch.where(ls.is_delta, 1.0,
                        power_heuristic(1, ls.pdf, 1, f_pdf))
        contrib = (c.throughput * ls.radiance * f
                   * (n_dot_wi * w / torch.clamp(ls.pdf, min=1e-20))[...,
                                                                      None])
        ok = (active & ~occluded & (ls.pdf > 0.0)
              & (ls.radiance > 0.0).any(-1))
        return rng, c.l + _sel(ok, contrib, torch.zeros_like(contrib))


def _bounce(scene, luts, cfg, depth, c):
    """One bounce: NEE with MIS, BSDF sample, extension cast (slab phase-1
    cap depth where it is sorted), implicit light hit with MIS."""
    active, itx, rng = c.active, c.itx, c.rng
    wo = -c.wi
    l_acc = c.l
    if cfg.light_count > 0:
        rng, l_acc = yield from _nee(scene, luts, cfg, c, wo, rng)

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
        hit2 = yield from _sorted_closest(scene, depth, ext_o, wi_new, ou_e,
                                          alive)
    else:
        hit2 = yield _Closest(ext_o, wi_new, ou_e)
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


def _segments(scene, luts, cam, cfg, pixel_x, pixel_y, frame_seed, depth):
    """One sample pass as a generator over its casts: it yields each cast
    (`_Closest`, `_Any`), is sent the cast's result, and returns
    (sample_position, sample_value). The code between two casts is a
    segment: the camera; per bounce the shading and emission of the last
    cast, NEE's draws, the light sample and the shadow ray, then the
    BSDF's value and pdf, MIS, the BSDF sample and the extension ray;
    last the shading and emission of the last cast. A segment reads the
    device and nothing else (no host read, no host-to-device copy), so a
    CUDA graph can capture it. Spans open and close inside a segment."""
    with span("dcrt.integrator.camera", rays=pixel_x.shape[0]):
        rng = init_rng(pixel_x, pixel_y, frame_seed)
        rng, pixel_sample = next_sample_2d(rng)
        res = constant((cfg.width, cfg.height), torch.float32,
                       pixel_x.device)
        pix = torch.stack([pixel_x, pixel_y], dim=-1).to(torch.float32)
        rng, aperture_sample = next_sample_3d(rng)
        origin, wi = generate_ray(cam, (pixel_sample + pix) / res,
                                  aperture_sample)
        ou = None
        if cfg.any_hit:
            rng, ou = next_sample_1d(rng)

    hit = yield _Closest(origin, wi, ou, depth)
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
    for _ in range(cfg.max_bounce + 1):
        c = yield from _bounce(scene, luts, cfg, depth, c)
    return pixel_sample, c.l


def _step(steps, sent):
    """Run the next segment of `_segments`: (the cast after it, None), or
    (None, the pass's result) after the last."""
    try:
        return steps.send(sent), None
    except StopIteration as stop:
        return None, stop.value


_COUNTS = dict(captures=0, replays=0, eager_segments=0)


def graph_counters():
    """Segments captured into CUDA graphs, segment graphs replayed and
    segments run eagerly, since the process started."""
    return dict(_COUNTS)


def _run_eager(steps, cast):
    """Run a pass's segments eagerly, each in a `dcrt.integrator.segment`
    span (counts `segment`, `replayed` 0), and cast(request) between
    them; the pass's result."""
    result = None
    for k in itertools.count():
        with span(SEGMENT, segment=k, replayed=0):
            request, out = _step(steps, result)
        _COUNTS["eager_segments"] += 1
        if request is None:
            return out
        result = cast(request)


def render_samples(scene, luts, cam, cfg: RenderConfig, pixel_x, pixel_y,
                   frame_seed):
    """Trace one sample per pixel for a pixel batch on the pixels' device.

    pixel_x / pixel_y: (R,) int64. Returns (sample_position (R, 2) in-pixel
    jitter, sample_value (R, 3) radiance). Runs the pass's segments
    eagerly, with the casts between them.
    """
    steps = _segments(scene, luts, cam, cfg, pixel_x, pixel_y, frame_seed,
                      megakernel_slab_depth(scene, cfg))
    return _run_eager(steps, lambda c: _cast(scene, cfg, c))


class PassKey:
    """What a captured pass depends on: the chunk's length and the config
    by value, the scene, LUTs and camera by identity (an edit or a new
    camera makes new ones; a tensor edited in place is read in place)."""

    __slots__ = ("n", "cfg", "refs")

    def __init__(self, n, cfg, scene, luts, cam):
        self.n, self.cfg, self.refs = int(n), cfg, (scene, luts, cam)

    def __eq__(self, other):
        return (isinstance(other, PassKey) and self.n == other.n
                and self.cfg == other.cfg
                and all(a is b for a, b in zip(self.refs, other.refs)))


def _empty_like(result):
    """Buffers shaped like a cast's result (a HitInfo or a tensor)."""
    if isinstance(result, HitInfo):
        return HitInfo(*(torch.empty_like(x) for x in result))
    return torch.empty_like(result)


def _copy_into(dst, src):
    """Copy a cast's result into buffers from `_empty_like`."""
    if isinstance(src, HitInfo):
        for d, x in zip(dst, src):
            d.copy_(x)
    else:
        dst.copy_(src)


class _Segment:
    """A captured segment: its graph, the cast after it (None after the
    last), and the static buffers its successor reads that cast's result
    from."""

    __slots__ = ("graph", "cast", "result")


class _GraphedPass:
    """One key's pass as CUDA graphs, one a segment, in one private
    memory pool. Its static inputs are the pixel chunk and the frame seed
    (a device int64, which `init_rng` takes as a tensor). Each cast runs
    eagerly between two replays, through its wrapper, which counts it,
    and its result is copied into the next segment's static buffers. The
    BSDF kernels inside the graphs are not counted by their wrappers
    (`bsdf.fused` counts eager launches alone); the profiler's device
    events show them at each replay."""

    def __init__(self, key, depth, device):
        self.key, self.depth = key, depth
        self.scene, self.luts, self.cam = key.refs
        self.cfg = key.cfg
        self.pixel_x = torch.empty(key.n, dtype=torch.int64, device=device)
        self.pixel_y = torch.empty_like(self.pixel_x)
        self.seed = torch.zeros((), dtype=torch.int64, device=device)
        self.segments = []
        self.out = None

    def capture(self, results):
        """Capture the segments in pass order, into one pool, running
        nothing: the k-th cast's result reaches segment k + 1 through
        results[k] (`_empty_like` of the casts of an eager pass)."""
        steps = _segments(self.scene, self.luts, self.cam, self.cfg,
                          self.pixel_x, self.pixel_y, self.seed, self.depth)
        stream = torch.cuda.Stream(self.pixel_x.device)
        torch.cuda.synchronize(self.pixel_x.device)
        # CUDA graphs or their pools freed by the collector while a capture
        # runs (a dropped renderer caught in a reference cycle) would
        # invalidate the capture: collect now, and not during it
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        pool, sent = None, None
        try:
            for k in itertools.count():
                seg = _Segment()
                seg.graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(stream):
                    seg.graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local")
                    try:
                        seg.cast, out = _step(steps, sent)
                    finally:
                        seg.graph.capture_end()
                pool = seg.graph.pool()
                _COUNTS["captures"] += 1
                self.segments.append(seg)
                if seg.cast is None:
                    self.out = out
                    return
                seg.result = sent = results[k]
        finally:
            if enabled:
                gc.enable()

    def replay(self, pixel_x, pixel_y, frame_seed):
        """The pass for these pixels and seed: each segment's graph, each
        in a `dcrt.integrator.segment` span (`replayed` 1) that also
        holds the copy of its inputs, and the casts between them.
        Returns fresh tensors."""
        got = None
        for k, seg in enumerate(self.segments):
            with span(SEGMENT, segment=k, replayed=1):
                if k == 0:
                    self.pixel_x.copy_(pixel_x)
                    self.pixel_y.copy_(pixel_y)
                    self.seed.fill_(frame_seed)
                else:
                    _copy_into(self.segments[k - 1].result, got)
                seg.graph.replay()
            _COUNTS["replays"] += 1
            if seg.cast is not None:
                got = _cast(self.scene, self.cfg, seg.cast)
        return tuple(x.clone() for x in self.out)


class PassGraphs:
    """The megakernel's sample passes as CUDA graphs, for a caller that
    traces on a CUDA device and keeps this object (`Renderer`). `run`
    takes `render_samples`'s arguments and gives its result, bit for bit.
    The first pass for a key (`PassKey`) runs eagerly and only notes the
    key, so a key used once costs no capture. The second runs eagerly
    too, which has loaded every kernel and filled every cache the
    segments read (a capture can do neither), and then captures its
    segments; later passes for the key replay them. It keeps the graphs
    of at most MAX_KEYS keys, and as many keys seen once, and drops the
    least recently used of either to make room."""

    MAX_KEYS = 2

    def __init__(self):
        self.passes = []    # _GraphedPass, the most recently used last
        self.seen = []      # PassKey run once, the most recently used last

    def run(self, scene, luts, cam, cfg, pixel_x, pixel_y, frame_seed):
        key = PassKey(pixel_x.shape[0], cfg, scene, luts, cam)
        for i, p in enumerate(self.passes):
            if p.key == key:
                self.passes.append(self.passes.pop(i))
                return p.replay(pixel_x, pixel_y, frame_seed)
        if key not in self.seen:
            del self.seen[:len(self.seen) + 1 - self.MAX_KEYS]
            self.seen.append(key)
            return render_samples(scene, luts, cam, cfg, pixel_x, pixel_y,
                                  frame_seed)
        self.seen.remove(key)
        # make room: free the least recently used key's graphs
        del self.passes[:len(self.passes) + 1 - self.MAX_KEYS]
        results = []

        def cast(c):
            got = _cast(scene, cfg, c)
            results.append(_empty_like(got))
            return got

        depth = megakernel_slab_depth(scene, cfg)
        out = _run_eager(_segments(scene, luts, cam, cfg, pixel_x, pixel_y,
                                   frame_seed, depth), cast)
        p = _GraphedPass(key, depth, pixel_x.device)
        p.capture(results)
        self.passes.append(p)
        return out


def render_samples_accumulated(scene, luts, cam, cfg: RenderConfig,
                               pixel_x, pixel_y, base_seed, n_samples,
                               trace=render_samples):
    """Sum of n_samples passes with seeds base_seed + k (box-filter
    accumulation), each traced by trace (`render_samples`, or a
    `PassGraphs`' `run`)."""
    total = torch.zeros((pixel_x.shape[0], 3), dtype=torch.float32,
                        device=pixel_x.device)
    for k in range(n_samples):
        total = total + trace(scene, luts, cam, cfg, pixel_x, pixel_y,
                              base_seed + k)[1]
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
