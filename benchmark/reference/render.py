"""The reference's film over a few tiles of the frame.

`render_tiles` traces, for every sample that the timed passes took, the
pixels that reach the given tiles through the film's filter, and
accumulates them pass by pass as the program's film does (the box film
adds each pass into its pixel; a splatting filter convolves each sample
plane, `film.filters.convolve_sample_pass`, over the tile and a border of
the filter's reach). It returns the resolved radiance of the tiles.
"""

import math

import torch

from .core.constants import LIGHT_INDEX_INVALID, MATERIAL_TYPE_DIFFUSE
from .core.types import to_device
from .film.filters import FilterParams, convolve_sample_pass
from .integrator.common import RenderConfig
from .integrator.paths import trace_lanes
from .intersect import Caster
from .lut.textures import load_luts, placeholder_luts
from .scene.scene import flatten

LANES = 1 << 15           # lanes traced together


def _round_tables(arrays, q):
    return arrays._replace(**{
        f: q(v) for f, v in arrays._asdict().items()
        if torch.is_tensor(v) and v.is_floating_point()})


def render_tiles(scene, camera, width, height, max_bounce, filter_params,
                 tiles, passes, device, q=lambda x: x):
    """Resolved radiance (th, tw, 3) of each tile (x0, y0, tw, th), after
    the passes: a list of frame-seed lists, one list a pass, in order. q
    rounds the tables and the path state (the identity for the reference
    itself)."""
    fp = FilterParams(*filter_params)
    box = fp.kind == "box" and fp.radius <= 0.5
    reach = 0 if box else max(-math.floor(0.5 - fp.radius),
                              math.floor(0.5 + fp.radius))
    non_diffuse = any(m.mtype != MATERIAL_TYPE_DIFFUSE
                      for m in scene.materials)
    arrays, meta = flatten(scene, device)
    arrays = _round_tables(arrays, q)
    luts = load_luts(device) if non_diffuse else placeholder_luts(device)
    luts = type(luts)(*(q(x) for x in luts))
    cam = to_device(camera, device)
    env = (meta.env_light_index
           if meta.env_light_index != LIGHT_INDEX_INVALID else -1)
    cfg = RenderConfig(width=width, height=height, max_bounce=max_bounce,
                       light_count=meta.light_count, env_light_index=env,
                       has_env_texture=meta.has_env_texture,
                       any_hit=meta.any_non_opaque,
                       any_hit_texture=meta.any_opacity_texture)
    caster = Caster(arrays, cfg.any_hit_texture)
    seeds = [s for p in passes for s in p]
    seed_t = torch.tensor(seeds, dtype=torch.long, device=device)
    planes, lanes = [], []
    for x0, y0, tw, th in tiles:
        sx0, sy0 = max(x0 - reach, 0), max(y0 - reach, 0)
        sx1, sy1 = min(x0 + tw + reach, width), min(y0 + th + reach, height)
        ys, xs = torch.meshgrid(torch.arange(sy0, sy1, device=device),
                                torch.arange(sx0, sx1, device=device),
                                indexing="ij")
        n = xs.numel()
        planes.append((sx0, sy0, sx1 - sx0, sy1 - sy0))
        lanes.append((xs.reshape(-1).repeat(len(seeds)),
                      ys.reshape(-1).repeat(len(seeds)),
                      seed_t.repeat_interleave(n)))
    lane_px, lane_py, lane_seed = (torch.cat(c) for c in zip(*lanes))
    pos, val = [], []
    for s in range(0, lane_px.shape[0], LANES):
        p, v = trace_lanes(arrays, luts, cam, cfg, caster,
                           lane_px[s:s + LANES], lane_py[s:s + LANES],
                           lane_seed[s:s + LANES], q)
        pos.append(p)
        val.append(v)
    pos, val = torch.cat(pos), torch.cat(val)
    out, start = [], 0
    for (x0, y0, tw, th), (sx0, sy0, w, h) in zip(tiles, planes):
        end = start + len(seeds) * h * w
        tpos = pos[start:end].reshape(len(seeds), h, w, 2)
        tval = val[start:end].reshape(len(seeds), h, w, 3)
        start = end
        value = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
        weight = torch.zeros((h, w), dtype=torch.float32, device=device)
        k = 0
        for p in passes:
            if box:
                total = tval[k]
                for j in range(1, len(p)):
                    total = total + tval[k + j]
                value = value + total
                weight = weight + float(len(p))
            else:
                for j in range(len(p)):
                    v, wt = convolve_sample_pass(tpos[k + j], tval[k + j], fp)
                    value, weight = value + v, weight + wt
            k += len(p)
        img = value / torch.clamp(weight[..., None], min=1e-10)
        out.append(img[y0 - sy0:y0 - sy0 + th, x0 - sx0:x0 - sx0 + tw])
    return out
