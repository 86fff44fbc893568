"""The AOV passes, the debug tracer, the BVH dump and the film
checkpoints, against the reference on the CPU.

Gates:
- `render_aov`, every kind, 32x32 on Cornell and the small sphere grid
  with traversal_backend="jax", against the reference's jitted
  `render_aov`: floats within 1e-5, `iteration_count` bit for bit.
- `trace_ray` on `tests/test_tools.py`'s 64 rays against the reference's
  (the same float64 numpy walk over equal tables): hit, t, triangle and
  all four counters equal.
- `serialize_bvh_to_xml`, through the port's numpy builder and through
  its C++ builder, string-equal to the reference's (with its numpy
  builder, `DCRT_NATIVE_BVH=0`) on Cornell and on the small stand-in
  (`write_standin_scene(d, nx=2, nz=2, stacks=8, slices=12)`, loaded by
  each package's XML loader).
- checkpoints: a round trip, a resume that continues to spp 3 (as
  `tests/test_tools.py` does), and an npz written by either package
  loaded by the other: film and spp equal.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel.build import serialize_bvh_to_xml
from directcomputeraytracing_tpu_torch.accel.traverse import intersect_closest
from directcomputeraytracing_tpu_torch.integrator.aov import (
    AOV_KINDS,
    render_aov,
)
from directcomputeraytracing_tpu_torch.integrator.common import RenderConfig
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    full_frame_pixels,
)
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
from directcomputeraytracing_tpu_torch.utils.debug_trace import (
    screen_to_camera_ray,
    trace_ray,
)

CPU = torch.device("cpu")
W = H = 32
AOV_TOL = 1e-5
SCENES = ("cornell", "grid")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(name):
    """(port (Scene, camera), reference (Scene, camera))."""
    from directcomputeraytracing_tpu.scene import presets as ref_presets

    if name == "cornell":
        return (presets.cornell_box("area"), ref_presets.cornell_box("area"))
    kw = dict(stacks=12, slices=16)
    return (presets.sphere_grid(3, 3, **kw),
            ref_presets.sphere_grid(3, 3, **kw))


@pytest.fixture(scope="module")
def flat():
    """name -> (port tensors, meta, camera, reference arrays, meta,
    camera)."""
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    out = {}
    for name in SCENES:
        (scene, cam), (ref_scene, ref_cam) = _scenes(name)
        arrays, meta = flatten_scene(scene, CPU)
        ref, ref_meta = ref_flatten(ref_scene)
        out[name] = (arrays, meta, cam, ref, ref_meta, ref_cam)
    return out


@pytest.mark.parametrize("kind", AOV_KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_aov_matches_the_reference(flat, name, kind):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.integrator.aov import (
        render_aov as ref_aov,
    )
    from directcomputeraytracing_tpu.integrator.common import (
        RenderConfig as RefConfig,
    )
    from directcomputeraytracing_tpu.integrator.megakernel import (
        full_frame_pixels as ref_pixels,
    )

    arrays, meta, cam, ref, ref_meta, ref_cam = flat[name]
    cfg = RenderConfig(width=W, height=H, max_bounce=2,
                       light_count=meta.light_count, traversal_backend="jax")
    ref_cfg = RefConfig(width=W, height=H, max_bounce=2,
                        stack_size=ref_meta.stack_size,
                        light_count=ref_meta.light_count,
                        traversal_backend="jax")
    px, py = full_frame_pixels(cfg, CPU)
    got = render_aov(arrays, cam, cfg, px, py, 0, kind=kind).numpy()
    want = np.asarray(ref_aov(ref, ref_cam, ref_cfg, *ref_pixels(ref_cfg),
                              jnp.uint32(0), kind=kind))
    assert got.shape == want.shape == (W * H, 3) and np.isfinite(got).all()
    if kind == "iteration_count":
        np.testing.assert_array_equal(got, want)
        assert got.max() >= 3
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=AOV_TOL)
    if kind in ("normal", "albedo"):
        assert got.max() > 0.1


def test_iteration_count_pins_the_walker(flat):
    """On the grid "auto" is the work list, which counts swept clusters;
    a kind without counts ("pallas_cluster") casts through the walker."""
    arrays, meta, cam = flat["grid"][:3]
    px, py = full_frame_pixels(RenderConfig(width=W, height=H), CPU)

    def aov(backend):
        cfg = RenderConfig(width=W, height=H, light_count=meta.light_count,
                           traversal_backend=backend)
        return render_aov(arrays, cam, cfg, px, py, 0, "iteration_count")

    walker = aov("jax")
    assert torch.equal(aov("pallas_cluster"), walker)
    assert torch.equal(aov("pallas_pair"), walker)
    wl = aov("auto")
    assert not torch.equal(wl, walker) and wl.max() > 0


def _tool_rays():
    rng = np.random.default_rng(3)
    origins = rng.uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    origins[:, 1] += 1.0
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


def test_trace_ray_matches_the_reference(flat):
    from directcomputeraytracing_tpu.utils.debug_trace import (
        trace_ray as ref_trace,
    )

    arrays, _, _, ref, _, _ = flat["cornell"]
    origins, dirs = _tool_rays()
    hi = intersect_closest(arrays, torch.from_numpy(origins),
                           torch.from_numpy(dirs), backend="jax")
    hits = 0
    for i in range(64):
        got = trace_ray(arrays, origins[i], dirs[i])
        want = ref_trace(ref, origins[i], dirs[i])
        assert (got.hit, got.t, got.triangle, got.instance) \
            == (want.hit, want.t, want.triangle, want.instance)
        assert vars(got.counters) == vars(want.counters)
        assert got.hit == bool(hi.hit[i])
        if got.hit:
            hits += 1
            np.testing.assert_allclose(got.t, float(hi.t[i]), rtol=1e-4,
                                       atol=1e-5)
            assert got.triangle == int(hi.triangle[i])
        assert got.counters.box_tests > 0
    assert hits > 32


def test_screen_ray_hits_scene(flat):
    arrays, meta, cam = flat["cornell"][:3]
    cfg = RenderConfig(width=W, height=H, light_count=meta.light_count)
    o, d = screen_to_camera_ray(cam, cfg, 16, 16)
    h = trace_ray(arrays, o, d)
    assert h.hit and h.counters.triangle_tests > 0


def _standin_scenes(tmp_path):
    from directcomputeraytracing_tpu.scene.xml_loader import (
        load_mitsuba_xml as ref_load,
    )
    from directcomputeraytracing_tpu_torch.scene.standin import (
        write_standin_scene,
    )
    from directcomputeraytracing_tpu_torch.scene.xml_loader import (
        load_mitsuba_xml,
    )

    xml = write_standin_scene(str(tmp_path), nx=2, nz=2, stacks=8,
                              slices=12)
    return load_mitsuba_xml(xml)[0], ref_load(xml)[0]


@pytest.mark.parametrize("native", ["0", "1"])
@pytest.mark.parametrize("name", ["cornell", "standin"])
def test_bvh_dump_equals_the_reference(tmp_path, monkeypatch, name, native):
    """The port's dump through its numpy builder (DCRT_NATIVE_BVH=0) or
    its C++ builder (=1) against the reference's numpy builder's: the
    reference's C++ builder (its default where it compiles) may write +0
    where numpy's min and max keep -0 in a box, which the dump prints as
    "-0", and its double SAH area may split near-ties otherwise."""
    import xml.etree.ElementTree as ET

    from directcomputeraytracing_tpu.accel.build import (
        serialize_bvh_to_xml as ref_dump,
    )

    if name == "cornell":
        (scene, _), (ref_scene, _) = _scenes("cornell")
    else:
        scene, ref_scene = _standin_scenes(tmp_path)
    monkeypatch.setenv("DCRT_NATIVE_BVH", native)
    got = serialize_bvh_to_xml(scene)
    monkeypatch.setenv("DCRT_NATIVE_BVH", "0")
    assert got == ref_dump(ref_scene)
    assert got.count("<Node") > 10 and "CombinedTLASPlusBLAS" in got
    ET.fromstring(got)


def test_checkpoint_roundtrip(tmp_path):
    scene, cam = presets.cornell_box("area")
    r = Renderer(scene, cam, width=16, height=16, max_bounce=2, device=CPU)
    r.render(2)
    p = tmp_path / "film.npz"
    r.save_checkpoint(p)
    r2 = Renderer(scene, cam, width=16, height=16, max_bounce=2, device=CPU)
    r2.load_checkpoint(p)
    assert r2.spp == 2
    np.testing.assert_array_equal(r2.image(), r.image())
    # resuming continues the accumulation
    r2.render_sample(r2.spp)
    r.render_sample(r.spp)
    assert r2.spp == 3
    np.testing.assert_array_equal(r2.image(), r.image())
    with pytest.raises(ValueError):
        Renderer(scene, cam, width=8, height=16, max_bounce=2,
                 device=CPU).load_checkpoint(p)


def test_checkpoints_cross_packages(tmp_path):
    """An npz written by either package resumes in the other."""
    from directcomputeraytracing_tpu.integrator.renderer import (
        Renderer as RefRenderer,
    )
    from directcomputeraytracing_tpu.scene.presets import (
        cornell_box as ref_cornell,
    )

    ref = RefRenderer(*ref_cornell("area"), width=16, height=16,
                      max_bounce=2)
    ref.render(2)
    ref.save_checkpoint(tmp_path / "ref.npz")
    port = Renderer(*presets.cornell_box("area"), width=16, height=16,
                    max_bounce=2, device=CPU)
    port.load_checkpoint(tmp_path / "ref.npz")
    assert port.spp == 2
    np.testing.assert_array_equal(port.film.value.numpy(),
                                  np.asarray(ref.film.value))
    np.testing.assert_array_equal(port.film.weight.numpy(),
                                  np.asarray(ref.film.weight))
    port.render_sample(port.spp)
    port.save_checkpoint(tmp_path / "port.npz")
    back = RefRenderer(*ref_cornell("area"), width=16, height=16,
                       max_bounce=2)
    back.load_checkpoint(tmp_path / "port.npz")
    assert back.spp == 3
    np.testing.assert_array_equal(np.asarray(back.film.value),
                                  port.film.value.numpy())
    np.testing.assert_array_equal(back.image(), port.image())
