"""The port's megakernel and Renderer against the reference's, on the CPU.

Both packages get identical scene tables (the port's through
`from_reference`) and draw identical per-pixel random streams, so every
path takes the same branches and the images agree up to float rounding.

Tolerances: per pixel, |port - reference| <= 1e-4 (1 + |reference|) for
all but 1 pixel in 256 (measured: none beyond 2e-5). The float32 chains
of up to five bounces differ by ulps between XLA's and PyTorch's CPU
kernels; a single flipped branch (a shadow ray grazing an edge, a lobe
choice at a threshold) changes one whole path, so a pixel may rarely
diverge. Images: RMSE <= 1e-3 (measured ~1e-6), which one diverged path
in a 32x32 frame would already exceed.

The small sphere grid (`sphere_grid(3, 3, stacks=12, slices=16)`, 3172
world triangles) runs through the port's work-list traversal and, in the
reference on the CPU, through its exact dense sweep: Baldwin-Weber and
Moeller round t, u and v differently (~1e-7 relative), which moves hit
points and so every later bounce by as much. Tolerance there: per pixel
1e-4 (1 + |reference|) for all but 1 pixel in 64 (measured: 2 of 1024
beyond 1e-4, none beyond 1e-3), image RMSE <= 1e-3 (measured 3.3e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu.integrator.common import (
    RenderConfig as RefConfig,
)
from directcomputeraytracing_tpu.integrator.megakernel import (
    full_frame_pixels as ref_pixels,
)
from directcomputeraytracing_tpu.integrator.megakernel import (
    render_samples as ref_render_samples,
)
from directcomputeraytracing_tpu.integrator.renderer import (
    Renderer as RefRenderer,
)
from directcomputeraytracing_tpu.lut.bake import bake_luts_cached
from directcomputeraytracing_tpu.scene.presets import cornell_box as ref_cornell
from directcomputeraytracing_tpu.scene.presets import sphere_grid as ref_grid
from directcomputeraytracing_tpu.scene.scene import flatten_scene as ref_flatten
from directcomputeraytracing_tpu_torch.core.types import from_reference
from directcomputeraytracing_tpu_torch.film.filters import FilterParams
from directcomputeraytracing_tpu_torch.integrator.common import RenderConfig
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    full_frame_pixels,
    render_samples,
    tiled_frame_pixels,
)
from directcomputeraytracing_tpu_torch.integrator import renderer as renderer_mod
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene.presets import (
    cornell_box,
    sphere_grid,
)
from directcomputeraytracing_tpu_torch.scene.scene import Material

W = H = 32
CPU = torch.device("cpu")
PIXEL_TOL = 1e-4
MAX_DIVERGED = 1 / 256
GATE_RMSE = 1e-3


GRID_ARGS = (3, 3)
GRID_KW = dict(stacks=12, slices=16)
GRID_MAX_DIVERGED = 1 / 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_pixels_close(want, got, max_diverged=MAX_DIVERGED):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max(-1) / (1 + np.abs(want).max(-1))
    assert (rel > PIXEL_TOL).mean() <= max_diverged, rel.max()
    assert np.sqrt(((got - want) ** 2).mean()) <= GATE_RMSE


@pytest.mark.parametrize("light,material_set", [("area", "glossy"),
                                                ("point", "dielectric"),
                                                ("area", "diffuse")])
def test_render_samples_match_reference(light, material_set):
    scene, cam = ref_cornell(light, material_set)
    arrays, meta = ref_flatten(scene)
    luts = bake_luts_cached()
    ref_cfg = RefConfig(width=W, height=H, max_bounce=4,
                        stack_size=meta.stack_size,
                        light_count=meta.light_count,
                        traversal_backend="brute")
    px, py = ref_pixels(ref_cfg)
    pos_r, val_r = ref_render_samples(arrays, luts, cam, ref_cfg, px, py,
                                      jnp.uint32(3))
    p_scene, p_luts, p_cam = from_reference(arrays, luts, cam, CPU)
    cfg = RenderConfig(width=W, height=H, max_bounce=4,
                       light_count=meta.light_count)
    tpx, tpy = full_frame_pixels(cfg, CPU)
    np.testing.assert_array_equal(np.asarray(px), tpx.numpy())
    pos_p, val_p = render_samples(p_scene, p_luts, p_cam, cfg, tpx, tpy, 3)
    np.testing.assert_array_equal(np.asarray(pos_r), pos_p.numpy())
    _assert_pixels_close(val_r, val_p.numpy())
    assert val_p.numpy().mean() > 0


@pytest.mark.parametrize("seed_mode,spp", [("sample_count", 4),
                                           ("fixed", 2),
                                           ("frame_index", 2)])
def test_renderer_matches_reference(seed_mode, spp):
    ref = RefRenderer(*ref_cornell("area", "glossy"), W, H, max_bounce=4,
                      traversal_backend="brute")
    port = Renderer(*cornell_box("area", "glossy"), W, H, max_bounce=4,
                    device=CPU)
    kw = dict(seed_mode=seed_mode, fixed_seed=5)
    _assert_pixels_close(ref.render(spp, **kw), port.render(spp, **kw))
    assert port.spp == ref.spp == spp
    _assert_pixels_close(ref.postprocessed(), port.postprocessed())
    if seed_mode == "frame_index":
        ref.reset()
        port.reset()
        _assert_pixels_close(ref.render(1, **kw), port.render(1, **kw))


def _grid_cfg(meta, **kw):
    return RenderConfig(width=W, height=H, max_bounce=4,
                        light_count=meta.light_count, **kw)


def test_sphere_grid_render_samples_match_reference():
    """The work-list twins under the megakernel, against the reference's
    exact dense sweep, raster order on both sides."""
    scene, cam = ref_grid(*GRID_ARGS, **GRID_KW)
    arrays, meta = ref_flatten(scene)
    luts = bake_luts_cached()
    ref_cfg = RefConfig(width=W, height=H, max_bounce=4,
                        stack_size=meta.stack_size,
                        light_count=meta.light_count,
                        traversal_backend="brute")
    px, py = ref_pixels(ref_cfg)
    _, val_r = ref_render_samples(arrays, luts, cam, ref_cfg, px, py,
                                  jnp.uint32(3))
    p_scene, p_luts, p_cam = from_reference(arrays, luts, cam, CPU)
    assert p_scene.cluster_bbox.shape[0] > 1
    tpx, tpy = full_frame_pixels(_grid_cfg(meta), CPU)
    _, val_p = render_samples(p_scene, p_luts, p_cam, _grid_cfg(meta), tpx,
                              tpy, 3)
    _assert_pixels_close(val_r, val_p.numpy(), GRID_MAX_DIVERGED)
    assert val_p.numpy().mean() > 0


def test_tiled_sorted_order_gives_the_raster_image(monkeypatch):
    """Tiles trace the same paths as raster order: the per-pixel random
    streams do not depend on the order, nor does the (sorted) grouping
    of bounce rays into blocks, up to near-ties. 64-ray blocks and 8x8
    tiles, so that the two orders group rays into different blocks."""
    from directcomputeraytracing_tpu_torch.accel import worklist

    monkeypatch.setattr(worklist, "RB", 64)
    r = Renderer(*sphere_grid(*GRID_ARGS, **GRID_KW), W, H, max_bounce=4,
                 device=CPU)
    assert r._inv is not None
    cfg = _grid_cfg(r.meta)
    tpx, tpy, inv = tiled_frame_pixels(cfg, CPU, 8, 8)
    assert not torch.equal(tpx, full_frame_pixels(cfg, CPU)[0])
    tiled = render_samples(r.arrays, r.luts, r.camera, cfg, tpx, tpy, 4)[1]
    raster = render_samples(r.arrays, r.luts, r.camera, cfg,
                            *full_frame_pixels(cfg, CPU), 4)[1]
    np.testing.assert_array_equal(tiled[inv].numpy(), raster.numpy())


def test_sphere_grid_renderer_matches_reference():
    ref = RefRenderer(*ref_grid(*GRID_ARGS, **GRID_KW), W, H, max_bounce=4,
                      traversal_backend="brute")
    port = Renderer(*sphere_grid(*GRID_ARGS, **GRID_KW), W, H, max_bounce=4,
                    device=CPU)
    _assert_pixels_close(ref.render(2), port.render(2), GRID_MAX_DIVERGED)


def test_renderer_chunks_give_the_same_image(monkeypatch):
    """The pixel chunk only bounds memory: 4 chunks render what 1 does."""
    scene, cam = cornell_box("area", "glossy")
    one = Renderer(scene, cam, W, H, max_bounce=2, device=CPU)
    four = Renderer(scene, cam, W, H, max_bounce=2, device=CPU)
    assert one.n_chunks == 1
    one.render(3)
    monkeypatch.setattr(renderer_mod, "CHUNK_PIXELS", W * H // 4)
    assert four.n_chunks == 4
    four.render(3)
    np.testing.assert_array_equal(one.image(), four.image())


def test_zero_spp_image_is_black():
    r = Renderer(*cornell_box("area", "diffuse"), 8, 8, device=CPU)
    assert np.array_equal(r.image(), np.zeros((8, 8, 3), np.float32))


@pytest.mark.parametrize("case", ["wavefront", "filter", "slab_march",
                                  "backend", "alpha"])
def test_unported_options_raise(case):
    scene, cam = cornell_box("area", "diffuse")
    kw = {}
    if case in ("wavefront", "filter"):
        # the splatting film renders through both integrators (queue 1,
        # item 6); tests/test_torch_splat.py holds it to the reference
        integrator = "wavefront" if case == "wavefront" else "megakernel"
        img = Renderer(scene, cam, 8, 8, device=CPU, integrator=integrator,
                       filter_params=FilterParams(kind="gaussian",
                                                  radius=1.5)).render(2)
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
        assert img.mean() > 0
        return
    elif case == "slab_march":
        # slab marching runs on the work list and is ignored elsewhere,
        # the stack walker included
        kw = dict(slab_march=0.03, traversal_backend="jax")
    elif case == "backend":
        kw = dict(traversal_backend="jax")
    else:
        # alpha-tested scenes render (queue 1, item 4)
        scene.materials[0] = Material(opacity=0.5)
        img = Renderer(scene, cam, 8, 8, device=CPU).render(1)
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
        return
    # the stack walker renders (queue 1, item 8): the dense sweep's image
    # but for float rounding (test_torch_alpha.py's render gates)
    img = Renderer(scene, cam, 8, 8, device=CPU, **kw).render(1)
    want = Renderer(scene, cam, 8, 8, device=CPU).render(1)
    assert np.isfinite(img).all() and img.mean() > 0
    rel = np.abs(img - want).max(-1) / (1 + np.abs(want).max(-1))
    assert (rel > 1e-4).mean() <= 1 / 64
    assert np.sqrt(((img - want) ** 2).mean()) <= 1e-3
