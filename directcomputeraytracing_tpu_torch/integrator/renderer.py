"""Progressive renderer: scene + camera + config -> image, on one device.

Counterpart of `directcomputeraytracing_tpu.integrator.renderer` for the
megakernel and wavefront integrators and the box film. For the
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

`traversal_backend`, `pool_backend` and `slab_march` pass through to the
integrators in the `RenderConfig`; alpha-tested scenes set `any_hit` and
`any_hit_texture` from the scene's meta. Splatting filters raise
NotImplementedError (ROADMAP queue 1). `device` defaults to "cuda"; pass
"cpu" for the twins.
"""

import torch

from ..core.constants import (
    LIGHT_INDEX_INVALID,
    MATERIAL_TYPE_DIFFUSE,
)
from ..core.types import to_device
from ..film.film import accumulate_box, create_film, resolve
from ..lut.textures import load_luts, placeholder_luts
from ..post.pipeline import PostParams, post_process
from ..scene.scene import flatten_scene
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


class Renderer:
    def __init__(self, scene, camera, width, height, max_bounce=4,
                 luts=None, integrator="megakernel", filter_params=None,
                 post_params=None, *, device="cuda", **cfg_overrides):
        self.device = torch.device(device)
        if integrator not in ("megakernel", "wavefront"):
            raise ValueError(f"integrator {integrator!r}: 'megakernel' or "
                             "'wavefront'")
        self.integrator = integrator
        if filter_params is not None and (filter_params.kind != "box"
                                          or filter_params.radius > 0.5):
            raise NotImplementedError(
                "splatting reconstruction filters: ROADMAP queue 1, item 6")
        self.arrays, self.meta = flatten_scene(scene, self.device)
        self.camera = to_device(camera, self.device)
        if luts is None:
            # placeholder (unit-energy) LUTs zero the plastic diffuse lobe,
            # so any non-diffuse material loads the committed bake
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
        if self.cfg.filter_type != "box" or self.cfg.filter_radius > 0.5:
            raise NotImplementedError(
                "splatting reconstruction filters: ROADMAP queue 1, item 6")
        self.post_params = post_params or PostParams()
        self.film = create_film(height, width, self.device)
        self.spp = 0
        self.frame_index = 0    # advances per sample pass, survives reset()
        if has_worklist_tables(self.arrays):
            self._px, self._py, self._inv = tiled_frame_pixels(self.cfg,
                                                               self.device)
        else:
            self._px, self._py = full_frame_pixels(self.cfg, self.device)
            self._inv = None

    @property
    def n_chunks(self):
        """Pixel chunks per sample pass."""
        return -(-self._px.shape[0] // CHUNK_PIXELS)

    def _chunks(self):
        for i in range(0, self._px.shape[0], CHUNK_PIXELS):
            yield (self._px[i:i + CHUNK_PIXELS], self._py[i:i + CHUNK_PIXELS])

    def reset(self):
        """Restart progressive accumulation; frame_index survives (the
        SEED_FRAME_INDEX mode's defining behaviour)."""
        self.film = create_film(self.cfg.height, self.cfg.width, self.device)
        self.spp = 0

    def _raster(self, values):
        """Per-pixel values in the trace order -> raster order."""
        return values if self._inv is None else values[self._inv]

    def _wavefront(self, frame_seed, spp_batch=1):
        """The whole frame through one path pool: (R, 3) summed values in
        the trace order."""
        return render_samples_wavefront(
            self.arrays, self.luts, self.camera, self.cfg, self._px,
            self._py, frame_seed, spp_batch=spp_batch)[1]

    def render_sample(self, frame_seed):
        """Trace one sample per pixel and accumulate it into the film."""
        if self.integrator == "wavefront":
            values = self._raster(self._wavefront(frame_seed))
        else:
            values = self._raster(torch.cat([
                render_samples(self.arrays, self.luts, self.camera, self.cfg,
                               px, py, frame_seed)[1]
                for px, py in self._chunks()]))
        self.film = accumulate_box(self.film, values, self.cfg.height,
                                   self.cfg.width)
        self.spp += 1
        self.frame_index += 1

    def render(self, spp, seed_mode=SEED_SAMPLE_COUNT, fixed_seed=0,
               samples_per_dispatch=None):
        """Accumulate spp samples and return image(). With progressive
        seeds, passes are summed in groups of samples_per_dispatch
        (default min(spp, 8)) before they reach the film, as the
        reference's fused dispatches do; the wavefront traces such a
        group in one pool pass (spp_batch)."""
        fuse = (samples_per_dispatch if samples_per_dispatch is not None
                else min(spp, 8))
        can_fuse = seed_mode == SEED_SAMPLE_COUNT and fuse > 1
        remaining = spp
        while remaining > 0:
            if can_fuse and remaining >= fuse:
                if self.integrator == "wavefront":
                    total = self._raster(self._wavefront(self.spp, fuse))
                else:
                    total = self._raster(torch.cat([
                        render_samples_accumulated(
                            self.arrays, self.luts, self.camera, self.cfg,
                            px, py, self.spp, fuse)
                        for px, py in self._chunks()]))
                self.film = accumulate_box(self.film, total, self.cfg.height,
                                           self.cfg.width, float(fuse))
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
        return self.image()

    def image(self):
        """Resolved linear radiance, (H, W, 3) numpy array."""
        return resolve(self.film).cpu().numpy()

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

