"""Progressive renderer: scene + camera + config -> image, on one device.

Counterpart of `directcomputeraytracing_tpu.integrator.renderer` for the
megakernel and wavefront integrators and the splatting film. For the
megakernel a pixel chunk (`CHUNK_PIXELS`, 2^20) bounds the memory of one
pass: a 1024x1024 frame runs as one chunk, a larger frame as several.
The wavefront runs the whole frame through one path pool, whose size
bounds its memory, and fuses progressive samples into one pool pass
(`spp_batch`). Scenes with work-list tables (world-soup clusters or
instanced) trace in 32x32 pixel tiles and sort their bounce rays, as the
reference does on its accelerator for world-soup tables (it tiles
instanced scenes but leaves their bounces unsorted): a 1024-ray block of
the work-list traversal is then one tile, a compact frustum with a short
item list. Values are scattered back to raster
order before the film; the per-pixel random streams make the image
independent of the order. The reference's tunnel pacing and its
2^18-pixel dispatch budget are gone.

Checkpoints (`save_checkpoint` / `load_checkpoint`) keep the film and
the sample count in the reference's npz format (`value`, `weight`,
`spp`), so either package resumes the other's.

Scene edits (`set_material`, `set_light`, `set_instance_override`,
`set_emitter_radiance`) update the flattened scene in place of a
re-flatten (`scene.edit`) and restart the film, as the reference's dirty
flag does; `frame_index` survives. `preview` traces a reduced-size frame
through the megakernel without touching the film.

Spans (`utils.trace`, recorded only while a profiler runs):
`dcrt.renderer.render` (counts `spp`, `first_sample`), one
`dcrt.renderer.pass` per sample pass or fused group, the megakernel's
`dcrt.integrator.chunk` per pixel chunk, `dcrt.renderer.film` (the
pass's values into the film), `dcrt.renderer.image` (resolve and the
copy to the host) and `dcrt.renderer.preview`. Set-up records, always
kept: `dcrt.setup.flatten` and `dcrt.setup.luts` in the constructor,
`dcrt.setup.first_pass` around each renderer's first `render` call,
which ends in the image's copy to the host.

`traversal_backend`, `pool_backend` and `slab_march` pass through to the
integrators in the `RenderConfig`; alpha-tested scenes set `any_hit` and
`any_hit_texture` from the scene's meta. `device` defaults to "cuda";
pass "cpu" for the twins.

The film: a box filter of radius <= 0.5 adds each pass's values straight
into their pixels (`_box_fast_path`), and progressive samples fuse in
groups as above. Any other filter (`filter_params`, else the config's
`filter_type` / `filter_radius`) convolves one sample plane at a time
(`film.filters.convolve_sample_pass`), with each sample's jitter: the
megakernel then traces one sample per pass, and the wavefront fuses a
group of samples into one pool pass with per-sample output slots
(`sample_slots`), whose planes it convolves in sample order, as the
reference does.
"""

import dataclasses

import numpy as np
import torch

from ..core.constants import (
    LIGHT_INDEX_INVALID,
    MATERIAL_TYPE_DIFFUSE,
)
from ..core.types import to_device
from ..film.film import Film, accumulate_box, create_film, resolve
from ..film.filters import FilterParams, convolve_sample_pass
from ..lut.textures import load_luts, placeholder_luts
from ..post.pipeline import PostParams, post_process
from ..scene.scene import flatten_scene
from ..utils.trace import setup, span
from .common import RenderConfig, has_worklist_tables
from .megakernel import (
    full_frame_pixels,
    render_samples,
    render_samples_accumulated,
    tiled_frame_pixels,
)
from .wavefront import render_samples_wavefront

# pixels per pass chunk, a bound on the device memory of one pass
CHUNK_PIXELS = 1 << 20

SEED_SAMPLE_COUNT = "sample_count"   # seed = accumulated sample index
SEED_FIXED = "fixed"                 # pinned seed (deterministic retrace)
SEED_FRAME_INDEX = "frame_index"     # seed = frame counter that survives
                                     # film resets


def _frame_pixels(scene, cfg, device):
    """The frame's (x, y) pixels in the trace order and the permutation
    back to raster order: 32x32 tiles on work-list scenes, else raster
    order and None."""
    if has_worklist_tables(scene):
        return tiled_frame_pixels(cfg, device)
    return (*full_frame_pixels(cfg, device), None)


def _pixel_chunks(px, py):
    """(px, py) in slices of at most CHUNK_PIXELS pixels."""
    for i in range(0, px.shape[0], CHUNK_PIXELS):
        yield px[i:i + CHUNK_PIXELS], py[i:i + CHUNK_PIXELS]


def _each_chunk(px, py, fn):
    """[fn(cx, cy)] over the chunks of (px, py), each in a
    `dcrt.integrator.chunk` span."""
    out = []
    for k, (cx, cy) in enumerate(_pixel_chunks(px, py)):
        with span("dcrt.integrator.chunk", chunk=k, pixels=cx.shape[0]):
            out.append(fn(cx, cy))
    return out


def _accumulate_filtered(film, pos, values, fp: FilterParams, height, width):
    """Convolve one raster-ordered sample plane ((H*W, 2) jitter, (H*W, 3)
    values) under fp and add it to the film."""
    v, w = convolve_sample_pass(pos.reshape(height, width, 2),
                                values.reshape(height, width, 3), fp)
    return Film(value=film.value + v, weight=film.weight + w)


class Renderer:
    def __init__(self, scene, camera, width, height, max_bounce=4,
                 luts=None, integrator="megakernel", filter_params=None,
                 post_params=None, *, device="cuda", **cfg_overrides):
        self.device = torch.device(device)
        if integrator not in ("megakernel", "wavefront"):
            raise ValueError(f"integrator {integrator!r}: 'megakernel' or "
                             "'wavefront'")
        self.integrator = integrator
        with setup("dcrt.setup.flatten"):
            self.arrays, self.meta = flatten_scene(scene, self.device)
        self.camera = to_device(camera, self.device)
        with setup("dcrt.setup.luts"):
            if luts is None:
                # placeholder (unit-energy) LUTs zero the plastic diffuse
                # lobe, so any non-diffuse material loads the committed bake
                luts = (load_luts(self.device)
                        if any(m.mtype != MATERIAL_TYPE_DIFFUSE
                               for m in scene.materials)
                        else placeholder_luts(self.device))
            self.luts = to_device(luts, self.device)
        env_idx = (self.meta.env_light_index
                   if self.meta.env_light_index != LIGHT_INDEX_INVALID
                   else -1)
        cfg_kwargs = dict(width=width, height=height, max_bounce=max_bounce,
                          light_count=self.meta.light_count,
                          env_light_index=env_idx,
                          has_env_texture=self.meta.has_env_texture,
                          any_hit=self.meta.any_non_opaque,
                          any_hit_texture=self.meta.any_opacity_texture)
        cfg_kwargs.update(cfg_overrides)
        self.cfg = RenderConfig(**cfg_kwargs)
        self.filter_params = filter_params or FilterParams(
            kind=self.cfg.filter_type, radius=self.cfg.filter_radius)
        self.post_params = post_params or PostParams()
        self.film = create_film(height, width, self.device)
        self.spp = 0
        self.frame_index = 0    # advances per sample pass, survives reset()
        self._first_render = True
        self._px, self._py, self._inv = _frame_pixels(self.arrays, self.cfg,
                                                      self.device)

    @property
    def _box_fast_path(self):
        return (self.filter_params.kind == "box"
                and self.filter_params.radius <= 0.5)

    @property
    def n_chunks(self):
        """Pixel chunks per sample pass."""
        return -(-self._px.shape[0] // CHUNK_PIXELS)

    def reset(self):
        """Restart progressive accumulation; frame_index survives (the
        SEED_FRAME_INDEX mode's defining behaviour)."""
        self.film = create_film(self.cfg.height, self.cfg.width, self.device)
        self.spp = 0

    def _raster(self, values):
        """Per-pixel values in the trace order -> raster order."""
        return values if self._inv is None else values[self._inv]

    def _wavefront(self, frame_seed, spp_batch=1, sample_slots=False):
        """The whole frame through one path pool: (positions, values) in
        the trace order, (R, .) summed per pixel or, with sample_slots,
        (R * spp_batch, .) one slot per (pixel, sample)."""
        return render_samples_wavefront(
            self.arrays, self.luts, self.camera, self.cfg, self._px,
            self._py, frame_seed, spp_batch=spp_batch,
            sample_slots=sample_slots)

    def _filter_planes(self, pos, values, fuse):
        """Convolve the fused pass's sample planes (slots in the trace
        order, pixel-major) into the film, sample by sample."""
        if self._inv is not None:
            # slots are pixel-major in trace order; expand the raster
            # inverse permutation to slot granularity
            inv = (self._inv[:, None] * fuse
                   + torch.arange(fuse, device=self.device)).reshape(-1)
            pos, values = pos[inv], values[inv]
        with span("dcrt.renderer.film"):
            for s in range(fuse):
                self.film = _accumulate_filtered(
                    self.film, pos[s::fuse], values[s::fuse],
                    self.filter_params, self.cfg.height, self.cfg.width)

    def render_sample(self, frame_seed):
        """Trace one sample per pixel and accumulate it into the film."""
        with span("dcrt.renderer.pass", samples=1):
            if self.integrator == "wavefront":
                pos, values = self._wavefront(frame_seed)
            else:
                parts = _each_chunk(
                    self._px, self._py,
                    lambda px, py: render_samples(
                        self.arrays, self.luts, self.camera, self.cfg, px,
                        py, frame_seed))
                pos = torch.cat([p for p, _ in parts])
                values = torch.cat([v for _, v in parts])
            with span("dcrt.renderer.film"):
                if self._box_fast_path:
                    self.film = accumulate_box(
                        self.film, self._raster(values), self.cfg.height,
                        self.cfg.width)
                else:
                    self.film = _accumulate_filtered(
                        self.film, self._raster(pos), self._raster(values),
                        self.filter_params, self.cfg.height, self.cfg.width)
        self.spp += 1
        self.frame_index += 1

    def render(self, spp, seed_mode=SEED_SAMPLE_COUNT, fixed_seed=0,
               samples_per_dispatch=None):
        """Accumulate spp samples and return image(). With progressive
        seeds, passes are summed in groups of samples_per_dispatch
        (default min(spp, 8)) before they reach the film, as the
        reference's fused dispatches do; the wavefront traces such a
        group in one pool pass (spp_batch). A splatting filter fuses
        only the wavefront's passes (per-sample slots); the megakernel
        then traces one sample per pass. A renderer's first call leaves
        the `dcrt.setup.first_pass` set-up record."""
        if self._first_render:
            self._first_render = False
            with setup("dcrt.setup.first_pass", spp=spp):
                return self.render(spp, seed_mode, fixed_seed,
                                   samples_per_dispatch)
        with span("dcrt.renderer.render", spp=spp, first_sample=self.spp):
            self._render(spp, seed_mode, fixed_seed, samples_per_dispatch)
            return self.image()

    def _render(self, spp, seed_mode, fixed_seed, samples_per_dispatch):
        fuse = (samples_per_dispatch if samples_per_dispatch is not None
                else min(spp, 8))
        can_fuse = (seed_mode == SEED_SAMPLE_COUNT and fuse > 1
                    and (self._box_fast_path
                         or self.integrator == "wavefront"))
        remaining = spp
        while remaining > 0:
            if can_fuse and remaining >= fuse:
                with span("dcrt.renderer.pass", samples=fuse):
                    self._fused_pass(fuse)
                self.spp += fuse
                self.frame_index += fuse
                remaining -= fuse
                continue
            if seed_mode == SEED_FIXED:
                seed = fixed_seed
            elif seed_mode == SEED_FRAME_INDEX:
                seed = self.frame_index
            else:
                seed = self.spp
            self.render_sample(seed)
            remaining -= 1

    def _fused_pass(self, fuse):
        """fuse progressive samples from `spp` in one pass into the film."""
        if not self._box_fast_path:
            self._filter_planes(*self._wavefront(self.spp, fuse, True), fuse)
            return
        if self.integrator == "wavefront":
            total = self._wavefront(self.spp, fuse)[1]
        else:
            total = torch.cat(_each_chunk(
                self._px, self._py,
                lambda px, py: render_samples_accumulated(
                    self.arrays, self.luts, self.camera, self.cfg, px, py,
                    self.spp, fuse)))
        with span("dcrt.renderer.film"):
            self.film = accumulate_box(self.film, self._raster(total),
                                       self.cfg.height, self.cfg.width,
                                       float(fuse))

    def image(self):
        """Resolved linear radiance, (H, W, 3) numpy array."""
        with span("dcrt.renderer.image"):
            return resolve(self.film).cpu().numpy()

    def preview(self, spp=1, scale=4):
        """A reduced-size render (the reference's quarter-size interactive
        preview, LaunchRendererLoop.cpp:206-237): seeds 0..spp-1 through
        the megakernel, whatever the integrator, at (H//scale, W//scale),
        in tiles on work-list scenes as the main path traces. Returns the
        mean radiance, a (H//scale, W//scale, 3) numpy array; the film and
        `spp` stay as they are. With spp=1 it equals a fresh Renderer's
        `render(1, seed_mode="fixed")` at that size with the box film."""
        if spp < 1:
            raise ValueError(f"preview spp {spp}: at least 1")
        cfg = dataclasses.replace(self.cfg,
                                  width=max(self.cfg.width // scale, 1),
                                  height=max(self.cfg.height // scale, 1))
        with span("dcrt.renderer.preview", spp=spp, scale=scale):
            px, py, inv = _frame_pixels(self.arrays, cfg, self.device)
            acc = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                              device=self.device)
            for seed in range(spp):
                acc = acc + torch.cat(_each_chunk(
                    px, py, lambda cx, cy: render_samples(
                        self.arrays, self.luts, self.camera, cfg, cx, cy,
                        seed)[1]))
            if inv is not None:
                acc = acc[inv]
            return (acc / spp).reshape(cfg.height, cfg.width,
                                       3).cpu().numpy()

    def postprocessed(self):
        """Display-ready sRGB image through exposure and tone mapping. A
        thin-lens camera's f-number follows from the camera itself:
        N = f / (2 * aperture_radius), f from the thin-lens equation."""
        radius = float(self.camera.aperture_radius)
        pinhole = radius == 0.0
        params = self.post_params
        if not pinhole and params.ev100_from_camera:
            fd = float(self.camera.film_distance)
            s = float(self.camera.focal_distance)
            if s > fd > 0.0:
                f = fd * s / (s - fd)
                params = params._replace(relative_aperture=f / (2.0 * radius))
        return post_process(self.film.value, self.film.weight, params,
                            aperture_is_pinhole=pinhole).cpu().numpy()

    # scene edits (reference: the editor's buffer-region writes,
    # Source/Scene.cpp:672-807): tensor updates, no re-flatten; each
    # restarts the film

    def set_material(self, index, **fields):
        """Edit a material (albedo, ior, roughness, tiling, opacity)."""
        from ..scene.edit import update_material

        self.arrays = update_material(self.arrays, index, **fields)
        self.reset()

    def set_light(self, index, radiance=None, position=None):
        """Edit a light's radiance or position (direction)."""
        from ..scene.edit import update_light

        self.arrays = update_light(self.arrays, index, radiance=radiance,
                                   position=position)
        self.reset()

    def set_instance_override(self, index, material_override):
        """Set, or clear with -1, an instance's material override."""
        from ..scene.edit import update_instance_override

        self.arrays = update_instance_override(self.arrays, index,
                                               material_override)
        self.reset()

    def set_emitter_radiance(self, instance_index, radiance):
        """Edit an emissive instance's radiance."""
        from ..scene.edit import update_emitter_radiance

        self.arrays = update_emitter_radiance(self.arrays, instance_index,
                                              radiance)
        self.reset()

    def save_checkpoint(self, path):
        """The film and the sample count into an npz (the reference's
        format)."""
        np.savez_compressed(path, value=self.film.value.cpu().numpy(),
                            weight=self.film.weight.cpu().numpy(),
                            spp=self.spp)

    def load_checkpoint(self, path):
        """Resume from a checkpoint of this frame size: its film goes to
        the renderer's device, its count to `spp`."""
        with np.load(path) as data:
            value, weight = data["value"], data["weight"]
            if value.shape != (self.cfg.height, self.cfg.width, 3):
                raise ValueError(f"checkpoint film {value.shape} does not "
                                 f"fit a {self.cfg.width}x{self.cfg.height} "
                                 "frame")
            self.film = Film(
                value=torch.from_numpy(np.asarray(value, np.float32))
                .to(self.device),
                weight=torch.from_numpy(np.asarray(weight, np.float32))
                .to(self.device))
            self.spp = int(data["spp"])
