"""The splatting film: the wavefront's per-sample slots and the Renderer's
filtered film, against the reference on the CPU.

Scenes: Cornell glossy, the small stand-in (`write_standin_scene(d,
nx=2, nz=2, stacks=8, slices=12)`, 676 triangles: the dense sweep, the
`mask` BSDF's bitmap opacity, a bitmap albedo, loaded through each
package's XML loader) and the small sphere grid (`sphere_grid(3, 3,
stacks=12, slices=16)`, 3172 triangles), which the port traces in 32x32
tiles: its slots come back in tile order and the Renderer expands the
raster inverse permutation to slot granularity, so only a comparison
with the reference at a fixed seed shows a wrong expansion. The
reference renders with its `brute` backend.

Tolerances:
- slots (`render_samples_wavefront(..., sample_slots=True)` at
  `spp_batch` 1 and 4): positions equal bit for bit (the same xoshiro
  draws); values, one path each, within rtol 1e-5, atol 1e-6 on Cornell
  (float32 chains of up to four bounces round by ulps between XLA's and
  PyTorch's CPU kernels). On the stand-in's spheres the two dense
  sweeps round t, u and v apart by ulps, which the interpolated normals
  of later bounces carry on: every slot within 1e-4 (1 + |reference|),
  the renders' per-pixel gate (measured: 4 of 768 values beyond rtol
  1e-5, largest difference 1.05e-5).
- Renderer images with the Gaussian film (radius 2), both integrators,
  32x18, 4 spp (2 on the stand-in), against the reference's: the gates
  of `test_torch_alpha.py`, per pixel 1e-4 (1 + |reference|) for all
  but 1 pixel in 64, image RMSE <= 1e-3.
- the port's fused filtered wavefront against its own megakernel,
  which traces one sample per pass: rtol 1e-5, atol 1e-6
  (`test_torch_wavefront.py`'s pair gate).
- `cuda`: the fused filtered pass on the card against the same pass on
  the port's CPU, under `chip_smoke.py`'s image gate.

The reference is imported inside the fixtures, so the `cuda` case runs
on a machine without JAX (`python -m pytest --noconftest -m cuda
tests/test_torch_splat.py`).
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.film.filters import FilterParams
from directcomputeraytracing_tpu_torch.integrator import wavefront as wf
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene.standin import (
    write_standin_scene,
)
from directcomputeraytracing_tpu_torch.scene.xml_loader import (
    load_mitsuba_xml,
)

CPU = torch.device("cpu")
SMALL_STANDIN = dict(nx=2, nz=2, stacks=8, slices=12)
GRID = ((3, 3), dict(stacks=12, slices=16))
GAUSS = ("gaussian", 2.0)
W, H = 32, 18
BOUNCES = 3
PIXEL_TOL, MAX_DIVERGED, GATE_RMSE = 1e-4, 1 / 64, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def standin_xml(tmp_path_factory):
    return write_standin_scene(str(tmp_path_factory.mktemp("standin")),
                               **SMALL_STANDIN)


def _port_scene(name, xml):
    if name == "cornell":
        return presets.cornell_box("area", "glossy")
    if name == "grid":
        return presets.sphere_grid(*GRID[0], **GRID[1])
    scene, settings = load_mitsuba_xml(xml)
    return scene, settings.camera


def _ref_scene(name, xml):
    from directcomputeraytracing_tpu.scene.presets import (
        cornell_box,
        sphere_grid,
    )
    from directcomputeraytracing_tpu.scene.xml_loader import (
        load_mitsuba_xml as ref_load,
    )

    if name == "cornell":
        return cornell_box("area", "glossy")
    if name == "grid":
        return sphere_grid(*GRID[0], **GRID[1])
    scene, settings = ref_load(xml)
    return scene, settings.camera


def _ref_renderer(name, xml, integrator="megakernel", width=W, height=H):
    from directcomputeraytracing_tpu.film.filters import (
        FilterParams as RefFilter,
    )
    from directcomputeraytracing_tpu.integrator.renderer import (
        Renderer as RefRenderer,
    )

    return RefRenderer(*_ref_scene(name, xml), width, height,
                       max_bounce=BOUNCES, integrator=integrator,
                       filter_params=RefFilter(*GAUSS),
                       traversal_backend="brute")


def _port_renderer(name, xml, integrator="megakernel", width=W, height=H,
                   device=CPU):
    return Renderer(*_port_scene(name, xml), width, height,
                    max_bounce=BOUNCES, integrator=integrator,
                    filter_params=FilterParams(*GAUSS), device=device)


def _assert_image_close(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max(-1) / (1 + np.abs(want).max(-1))
    assert (rel > PIXEL_TOL).mean() <= MAX_DIVERGED, rel.max()
    assert np.sqrt(((got - want) ** 2).mean()) <= GATE_RMSE


@pytest.mark.parametrize("spp_batch", [1, 4])
@pytest.mark.parametrize("name", ["cornell", "standin"])
def test_sample_slots_match_reference(name, spp_batch, standin_xml):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.integrator.wavefront import (
        render_samples_wavefront as ref_wavefront,
    )

    size = 16
    ref = _ref_renderer(name, standin_xml, "wavefront", size, size)
    want_pos, want_val = ref_wavefront(
        ref.arrays, ref.luts, ref.camera, ref.cfg, ref._px, ref._py,
        jnp.uint32(5), spp_batch=spp_batch, sample_slots=True)
    port = _port_renderer(name, standin_xml, "wavefront", size, size)
    assert port._inv is None
    pos, val = wf.render_samples_wavefront(
        port.arrays, port.luts, port.camera, port.cfg, port._px, port._py,
        5, spp_batch=spp_batch, sample_slots=True)
    n = size * size * spp_batch
    assert pos.shape == (n, 2) and val.shape == (n, 3)
    assert wf.LAST_STATS["slots"] == n and wf.LAST_STATS["items"] == n
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    want_val, val = np.asarray(want_val), val.numpy()
    if name == "cornell":
        np.testing.assert_allclose(val, want_val, rtol=1e-5, atol=1e-6)
    else:
        assert (np.abs(val - want_val)
                <= PIXEL_TOL * (1 + np.abs(want_val))).all()
    assert val.sum() > 0


def test_slots_sum_to_the_pixel_pass():
    """Summed over a pixel's samples, the slots give the pixel pass's
    values (which sums in lane retirement order: atol 1e-5); each sample's
    jitter lies in [0, 1)."""
    port = _port_renderer("cornell", None, "wavefront", 12, 12)
    args = (port.arrays, port.luts, port.camera, port.cfg, port._px,
            port._py, 2)
    pos, val = wf.render_samples_wavefront(*args, spp_batch=4,
                                           sample_slots=True)
    _, total = wf.render_samples_wavefront(*args, spp_batch=4)
    assert total.shape == (144, 3) and wf.LAST_STATS["slots"] == 144
    np.testing.assert_allclose(val.reshape(144, 4, 3).sum(1).numpy(),
                               total.numpy(), atol=1e-5)
    assert ((pos >= 0) & (pos < 1)).all()


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
@pytest.mark.parametrize("name", ["cornell", "standin", "grid"])
def test_filtered_renderer_matches_reference(name, integrator, standin_xml):
    spp = 2 if name == "standin" else 4
    want = _ref_renderer(name, standin_xml, integrator).render(spp)
    port = _port_renderer(name, standin_xml, integrator)
    assert (port._inv is not None) == (name == "grid")
    got = port.render(spp)
    assert port.spp == spp and not port._box_fast_path
    _assert_image_close(want, got)
    assert got.mean() > 0


@pytest.mark.parametrize("name", ["standin", "grid"])
def test_filtered_wavefront_matches_megakernel(name, standin_xml):
    imgs = [_port_renderer(name, standin_xml, i).render(4)
            for i in ("megakernel", "wavefront")]
    assert wf.LAST_STATS["spp_batch"] == 4
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=1e-5, atol=1e-6)


def test_filter_from_config_and_box_fast_path():
    scene, cam = presets.cornell_box("area", "diffuse")
    r = Renderer(scene, cam, 8, 8, device=CPU, filter_type="triangle",
                 filter_radius=1.5)
    assert r.filter_params == FilterParams("triangle", 1.5)
    assert not r._box_fast_path
    box = Renderer(scene, cam, 8, 8, device=CPU)
    assert box.filter_params == FilterParams("box", 0.5)
    assert box._box_fast_path
    img = r.render(2)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


@pytest.mark.cuda
def test_cuda_filtered_wavefront_matches_cpu(standin_xml):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    imgs = [_port_renderer("standin", standin_xml, "wavefront",
                           device=d).render(2)
            for d in ("cuda", "cpu")]
    rel = np.abs(imgs[0] - imgs[1]).max(-1) / (1 + np.abs(imgs[1]).max(-1))
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    assert (rel > PIXEL_TOL).mean() <= MAX_DIVERGED, rel.max()
    assert np.sqrt(((imgs[0] - imgs[1]) ** 2).mean()) <= GATE_RMSE
