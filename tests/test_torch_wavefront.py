"""The port's wavefront integrator: against the port's megakernel, against
the reference's wavefront and Renderer, and its pool mechanics, on the
CPU.

The two integrators of one package draw the same per-pixel random
streams and run the same per-path arithmetic, so they agree up to float
rounding: rtol 1e-5, atol 1e-6, as the reference's own
`tests/test_wavefront.py` holds its pair (measured: bit-equal). The
reference's wavefront on the small sphere grid runs its work list in
interpret mode (`pallas_wl_interpret` camera casts, `pallas_wlg_interpret`
pool casts, sorted pool); the two packages' casts round t, u and v
differently (~1e-7 relative), which moves hit points and later bounces
by as much, so the tolerance there is the megakernel tests' one for the
grid: per pixel 1e-4 (1 + |reference|) for all but 1 pixel in 64, image
RMSE <= 1e-3. `spp_batch` sums a pixel's samples in the order its lanes
retire, not in sample order: atol 1e-5 against a sequential sum (a few
float32 ulps of sums up to ~10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.core.types import to_device
from directcomputeraytracing_tpu_torch.integrator import wavefront as wf
from directcomputeraytracing_tpu_torch.integrator.common import RenderConfig
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    full_frame_pixels,
    render_samples,
)
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.lut.textures import (
    load_luts,
    placeholder_luts,
)
from directcomputeraytracing_tpu_torch.scene.presets import (
    cornell_box,
    sphere_grid,
)
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

CPU = torch.device("cpu")
GRID = ((3, 3), dict(stacks=12, slices=16))
PIXEL_TOL = 1e-4
GRID_MAX_DIVERGED = 1 / 64
GATE_RMSE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, size, max_bounce=3, **cfg_kw):
    if name == "grid":
        scene, cam = sphere_grid(*GRID[0], **GRID[1])
    else:
        scene, cam = cornell_box(*name.split("-"))
    arrays, meta = flatten_scene(scene, CPU)
    luts = (placeholder_luts(CPU) if name in ("grid", "area-diffuse")
            else load_luts(CPU))
    cfg = RenderConfig(width=size, height=size, max_bounce=max_bounce,
                       light_count=meta.light_count, **cfg_kw)
    px, py = full_frame_pixels(cfg, CPU)
    return arrays, luts, to_device(cam, CPU), cfg, px, py


def _assert_pixels_close(want, got, max_diverged):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max(-1) / (1 + np.abs(want).max(-1))
    assert (rel > PIXEL_TOL).mean() <= max_diverged, rel.max()
    assert np.sqrt(((got - want) ** 2).mean()) <= GATE_RMSE


@pytest.mark.parametrize("name,size", [("area-diffuse", 24),
                                       ("area-glossy", 24),
                                       ("point-dielectric", 16),
                                       ("grid", 32),
                                       ("grid-noslab", 32)])
def test_wavefront_matches_megakernel(name, size):
    """"grid-noslab": slab_march=0.0 turns the pool casts' slab marching
    off, one cast per pool cast, the same image."""
    grid = name.startswith("grid")
    kw = dict(slab_march=0.0) if name == "grid-noslab" else {}
    arrays, luts, cam, cfg, px, py = _setup("grid" if grid else name, size,
                                            **kw)
    pos_m, val_m = render_samples(arrays, luts, cam, cfg, px, py, 3)
    pos_w, val_w = wf.render_samples_wavefront(arrays, luts, cam, cfg, px,
                                               py, 3)
    np.testing.assert_array_equal(pos_w.numpy(), pos_m.numpy())
    np.testing.assert_allclose(val_w.numpy(), val_m.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert val_w.mean() > 0
    stats = wf.LAST_STATS
    assert stats["iterations"] >= cfg.max_bounce + 2
    assert stats["pool_backend"] == ("pallas_wlg" if grid else "auto")
    if name == "grid":
        assert stats["slab_depth"] > 0 and stats["closest_recast"][0] > 0
    else:
        assert stats["slab_depth"] is None
        assert stats["closest_casts_per_phase"] == [stats["iterations"], 0]
        assert stats["host_reads"] == stats["iterations"]


def test_wavefront_matches_reference_on_the_grid():
    """The reference's accelerator configuration, its kernels interpreted:
    bundle-sweep camera casts, grouped pool casts, a sorted pool and
    slab marching, against the port's defaults on the same scene."""
    from directcomputeraytracing_tpu.integrator.common import (
        RenderConfig as RefConfig,
    )
    from directcomputeraytracing_tpu.integrator.megakernel import (
        full_frame_pixels as ref_pixels,
    )
    from directcomputeraytracing_tpu.integrator.wavefront import (
        render_samples_wavefront as ref_wavefront,
    )
    from directcomputeraytracing_tpu.lut.textures import (
        placeholder_luts as ref_luts,
    )
    from directcomputeraytracing_tpu.scene.presets import (
        sphere_grid as ref_grid,
    )
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    size, bounces = 16, 2
    scene, cam = ref_grid(*GRID[0], **GRID[1])
    arrays, meta = ref_flatten(scene)
    ref_cfg = RefConfig(width=size, height=size, max_bounce=bounces,
                        stack_size=meta.stack_size,
                        light_count=meta.light_count,
                        traversal_backend="pallas_wl_interpret",
                        pool_backend="pallas_wlg_interpret",
                        sort_bounce_rays=True)
    px, py = ref_pixels(ref_cfg)
    _, want = ref_wavefront(arrays, ref_luts(), cam, ref_cfg, px, py,
                            jnp.uint32(3))
    p_arrays, luts, p_cam, cfg, tpx, tpy = _setup("grid", size, bounces)
    _, got = wf.render_samples_wavefront(p_arrays, luts, p_cam, cfg, tpx,
                                         tpy, 3)
    _assert_pixels_close(want, got.numpy(), GRID_MAX_DIVERGED)
    assert got.mean() > 0


@pytest.mark.parametrize("name", ["area-diffuse", "grid"])
def test_spp_batch_matches_sequential_passes(name):
    arrays, luts, cam, cfg, px, py = _setup(name, 16)
    _, batched = wf.render_samples_wavefront(arrays, luts, cam, cfg, px, py,
                                             5, pool_size=256, spp_batch=3)
    seq = sum(render_samples(arrays, luts, cam, cfg, px, py, 5 + k)[1]
              for k in range(3))
    np.testing.assert_allclose(batched.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert wf.LAST_STATS["spp_batch"] == 3 and wf.LAST_STATS["items"] == 768


@pytest.mark.parametrize("pool_size", [128, 1000])
def test_small_pool_streams_every_pixel(pool_size):
    """A pool smaller than the frame: the cursor must stream every pixel
    through it (the reference's block-cursor pull loop)."""
    arrays, luts, cam, cfg, px, py = _setup("point-diffuse", 24)
    pos_m, val_m = render_samples(arrays, luts, cam, cfg, px, py, 7)
    pos_w, val_w = wf.render_samples_wavefront(arrays, luts, cam, cfg, px,
                                               py, 7, pool_size=pool_size)
    np.testing.assert_array_equal(pos_w.numpy(), pos_m.numpy())
    np.testing.assert_allclose(val_w.numpy(), val_m.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert wf.LAST_STATS["pool_size"] == pool_size
    assert wf.LAST_STATS["iterations"] > 576 // pool_size


def test_pool_capacity_equals_the_reference():
    from directcomputeraytracing_tpu.integrator import wavefront as ref_wf

    for r in (1, 2, 100, 576, 8191, 8192, 40_000, 1 << 20,
              1920 * 1080, 1920 * 1080 * 8):
        assert wf._pool_capacity(r, None) == ref_wf._pool_capacity(r, None)
        assert wf._pool_capacity(r, 300) == 300
    assert wf._pool_capacity(1920 * 1080 * 8, None) == 1 << wf.POOL_LOG2_CAP


@pytest.mark.parametrize("spp", [1, 4])
def test_renderer_matches_reference(spp):
    """Renderer(integrator="wavefront") against the reference's, Cornell
    glossy, progressive seeds: spp 4 runs one fused pool pass of 4
    samples on both sides."""
    from directcomputeraytracing_tpu.integrator.renderer import (
        Renderer as RefRenderer,
    )
    from directcomputeraytracing_tpu.scene.presets import (
        cornell_box as ref_cornell,
    )

    ref = RefRenderer(*ref_cornell("area", "glossy"), 32, 32, max_bounce=4,
                      integrator="wavefront", traversal_backend="brute")
    port = Renderer(*cornell_box("area", "glossy"), 32, 32, max_bounce=4,
                    integrator="wavefront", device=CPU)
    _assert_pixels_close(ref.render(spp), port.render(spp), 1 / 256)
    assert port.spp == spp
    assert wf.LAST_STATS["spp_batch"] == spp


def test_wavefront_renderer_matches_megakernel_renderer():
    scene, cam = sphere_grid(*GRID[0], **GRID[1])
    imgs = [Renderer(scene, cam, 24, 24, max_bounce=3, integrator=i,
                     device=CPU).render(2)
            for i in ("megakernel", "wavefront")]
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=1e-5, atol=1e-6)


def test_unported_wavefront_options_raise():
    arrays, luts, cam, cfg, px, py = _setup("area-diffuse", 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wf.render_samples_wavefront(arrays, luts, cam, cfg, px, py, 0,
                                    sample_slots=True)
    with pytest.raises(ValueError, match="integrator"):
        Renderer(*cornell_box("area", "diffuse"), 8, 8, integrator="bdpt",
                 device=CPU)
