"""Alpha-tested scenes: the port's alpha tables, `effective_opacity`, the
recast loop over the opaque/masked split and the renders, against the
reference on the CPU.

Scenes: the reference tests' split scene, `sphere_grid(3, 3, stacks=12,
slices=16)` (3172 world triangles) with the spheres of override 1
see-through at opacity 0.4, and its textured variant (opacity 1 and the
dot-grid mask over lat-long UVs): `presets.set_alpha_material` on both
packages' scenes; the reference tests' panel over a floor (4 triangles,
the dense sweep), scalar and textured; the split grid forced onto the
instanced tables (the reference's with `DCRT_INSTANCED=1`). Rays and
opacity samples from a numpy seed.

Tolerances against the reference:
- flatten: every field equal through `from_reference` (the same numpy
  arithmetic), the instanced flatten's soup-only fields being
  placeholders, as above 2^20 world triangles.
- `effective_opacity`: the opaque flag equal; opacity within 1e-6 (the
  texture's bilinear weights round alike in both, measured equal).
- alpha casts on the split grid, against the reference's work list in
  interpret mode: hit masks equal; triangle ids equal except at
  near-ties (two hits within 2^-12 relative, counted, at most 1 %); t
  within rtol 1e-5 on same-triangle hits (each pass's t rounds like the
  opaque casts', and the advanced origins add an ulp a pass); occlusion
  equal on at least 99.5 % of rays (a ray grazing a rejected surface's
  edge may end on the other side of the 1e-5 advance). The instanced
  casts are held to the same reference results with the instanced-vs-soup
  tolerance of `test_torch_instanced.py`: t rtol 3e-5.
- on the panel, against the reference's dense sweep (its `brute`, which
  tests alpha inside the sweep rather than by re-casting): hits, ids and
  occlusion equal, t within rtol 1e-5.
- renders, 32x32, 4 spp, max_bounce 4, against the reference's megakernel
  (its `brute` backend): the gates of `test_torch_render.py`, per pixel
  1e-4 (1 + |reference|) for all but 1 pixel in 256 on the panel (1 in 64
  on the grid, whose casts round t, u, v differently), image RMSE
  <= 1e-3. The port's wavefront equals its megakernel within rtol 1e-5,
  atol 1e-6 (`test_torch_wavefront.py`'s pair gate).
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import traverse
from directcomputeraytracing_tpu_torch.accel import worklist as wl
from directcomputeraytracing_tpu_torch.accel.traverse import (
    effective_opacity,
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
)
from directcomputeraytracing_tpu_torch.core.types import (
    SceneTensors,
    from_reference,
)
from directcomputeraytracing_tpu_torch.integrator.common import RenderConfig
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    full_frame_pixels,
    render_samples_accumulated,
)
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.integrator.wavefront import (
    render_samples_wavefront,
)
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod

GRID = (3, 3)
GRID_KW = dict(stacks=12, slices=16)
N_RAYS = 512
T_RTOL, TIE = 1e-5, 2.0 ** -12
W = H = 32
SPP = 4
PIXEL_TOL, GATE_RMSE = 1e-4, 1e-3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_scene(name):
    """The reference's (Scene, camera) of a scene of this file."""
    from directcomputeraytracing_tpu.scene import scene as rs
    from directcomputeraytracing_tpu.scene.presets import sphere_grid

    if name.startswith("grid"):
        scene, cam = sphere_grid(*GRID, **GRID_KW)
        presets.set_alpha_material(scene, rs.Material,
                                   name.endswith("textured"), **GRID_KW)
        return scene, cam
    from directcomputeraytracing_tpu.camera.camera import look_at_transform
    from directcomputeraytracing_tpu.core.types import CameraParams
    from directcomputeraytracing_tpu.scene.presets import _quad

    port, _ = _port_scene(name)
    meshes = [rs.Mesh(positions=m.positions, indices=m.indices,
                      texcoords=m.texcoords, material_ids=m.material_ids,
                      name=m.name) for m in port.meshes]
    assert np.array_equal(meshes[0].positions,
                          _quad([-2, 0, -2], [2, 0, -2], [2, 0, 2],
                                [-2, 0, 2])[0])
    mats = [rs.Material(albedo=m.albedo, opacity=m.opacity,
                        opacity_texture=m.opacity_texture, name=m.name)
            for m in port.materials]
    scene = rs.Scene(meshes=meshes,
                     instances=[rs.Instance(mesh=0), rs.Instance(mesh=1)],
                     materials=mats, textures=port.textures,
                     lights=[rs.PunctualLight(kind="point",
                                              radiance=(20, 20, 20),
                                              position=(0.0, 3.0, 0.0))])
    cam = CameraParams.create(
        transform=look_at_transform((0, 2.5, -4.0), (0, 0, 0)),
        fov_x=np.deg2rad(45.0))
    return scene, cam


def _port_scene(name):
    textured = name.endswith("textured")
    if name.startswith("grid"):
        return presets.alpha_sphere_grid(*GRID, **GRID_KW, textured=textured)
    return presets.alpha_panel(textured=textured)


@pytest.fixture(scope="module")
def ref_flat():
    """name -> (reference SceneArrays, meta, camera, the port's tensors
    of them)."""
    from directcomputeraytracing_tpu.lut.textures import placeholder_luts
    from directcomputeraytracing_tpu.scene.scene import flatten_scene

    out = {}
    for name in ("grid", "grid_textured", "panel", "panel_textured"):
        scene, cam = _ref_scene(name)
        arrays, meta = flatten_scene(scene)
        out[name] = (arrays, meta, cam,
                     from_reference(arrays, placeholder_luts(), cam, CPU))
    return out


@pytest.mark.parametrize("name", ["grid", "grid_textured", "panel",
                                  "panel_textured"])
def test_flatten_matches_reference(ref_flat, name):
    _, ref_meta, _, (want, _, _) = ref_flat[name]
    got, meta = scene_mod.flatten_scene(_port_scene(name)[0], CPU)
    for f in SceneTensors._fields:
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
    assert meta.any_non_opaque and ref_meta.any_non_opaque
    assert meta.any_opacity_texture == ref_meta.any_opacity_texture \
        == name.endswith("textured")
    split = name.startswith("grid")
    assert (got.mclu_bbox.shape[0] > 1) == (got.oclu_bbox.shape[0] > 1) \
        == split
    if split:
        # the 4 (of 9) spheres of override 1 alpha-test, the rest do not
        flags = got.instance_flags.numpy()
        assert (flags == 0).sum() == 4 and flags[0] == 1


@pytest.fixture(scope="module")
def instanced(ref_flat):
    """The split grid forced onto the instanced tables: (port flatten,
    reference flatten with DCRT_INSTANCED=1 through from_reference)."""
    from directcomputeraytracing_tpu.lut.textures import placeholder_luts
    from directcomputeraytracing_tpu.scene.scene import flatten_scene

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCRT_INSTANCED", "1")
        mp.setattr(scene_mod, "SOUP_MAX_TRIS", 256)
        scene, cam = _ref_scene("grid")
        ref = from_reference(flatten_scene(scene)[0], placeholder_luts(), cam,
                             CPU)[0]
        port = scene_mod.flatten_scene(_port_scene("grid")[0], CPU)[0]
    return port, ref


def test_flatten_instanced_matches_reference(instanced):
    """The alpha fields of the instanced flatten equal the reference's;
    its soup, the soup's opacities and the split are placeholders (the
    reference builds its split from the soup it keeps beside the
    instanced tables, and casts instanced tables without it)."""
    port, ref = instanced
    assert port.isup_inst.shape[0] > 1 and ref.mclu_bbox.shape[0] > 1
    soup = ("world_tris", "world_tri_meta", "cluster_tris", "cluster_bw",
            "cluster_bbox", "world_tri_opacity") + scene_mod._SPLIT_FIELDS
    for f in SceneTensors._fields:
        x, y = getattr(ref, f), getattr(port, f)
        if f in soup:
            assert y.shape[0] in (1, 16), f
            continue
        assert torch.equal(x, y), f
    assert torch.equal(port.world_tri_opacity, torch.ones(1))


def _rays(n=N_RAYS, seed=0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 4.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rs.random(n, dtype=np.float32)


@pytest.mark.parametrize("name", ["grid_textured", "panel_textured", "grid"])
def test_effective_opacity_matches_reference(ref_flat, name):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        effective_opacity as ref_opacity,
    )

    arrays, _, _, (port, _, _) = ref_flat[name]
    rs = np.random.default_rng(3)
    n = 4096
    prim = rs.integers(0, port.triangles.shape[0], n).astype(np.int32)
    inst = rs.integers(0, port.instance_flags.shape[0], n).astype(np.int32)
    u = rs.random(n, dtype=np.float32)
    v = (rs.random(n, dtype=np.float32) * (1 - u)).astype(np.float32)
    textured = name.endswith("textured")
    want = ref_opacity(arrays, jnp.asarray(prim), jnp.asarray(inst),
                       jnp.asarray(u), jnp.asarray(v), textured)
    got = effective_opacity(port, *(torch.from_numpy(x)
                                    for x in (prim, inst, u, v)), textured)
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    o = got[0].numpy()
    assert o.max() == 1.0 and (o < 1.0).any()
    if textured:       # the mask's holes occur
        assert (o == 0.0).any()


@pytest.fixture(scope="module")
def ref_casts(ref_flat):
    """The reference's alpha casts on the split grids, its work list in
    interpret mode: name -> (closest HitInfo, occlusion), numpy."""
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_any as ref_any,
    )
    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_closest as ref_closest,
    )

    out = {}
    for name in ("grid", "grid_textured"):
        arrays, meta, _, _ = ref_flat[name]
        o, d, u = (jnp.asarray(x) for x in _rays())
        textured = name.endswith("textured")
        hit = ref_closest(arrays, o, d, meta.stack_size,
                          backend="pallas_wl_interpret", opacity_u=u,
                          alpha_textures=textured)
        occ = ref_any(arrays, o, d, jnp.float32(3.0), meta.stack_size,
                      backend="pallas_wl_interpret", opacity_u=u,
                      alpha_textures=textured)
        out[name] = (type(hit)(*(np.asarray(x) for x in hit)),
                     np.asarray(occ))
    return out


def _assert_hits_close(want, got, t_rtol=T_RTOL):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(hit, got.hit.numpy())
    assert 0.2 < hit.mean() < 1.0
    t_w, t_g = np.asarray(want.t)[hit], got.t.numpy()[hit]
    tri_w, tri_g = np.asarray(want.triangle)[hit], got.triangle.numpy()[hit]
    same = tri_w == tri_g
    tie = np.abs(t_w - t_g) <= TIE * t_w
    assert (~same <= tie).all() and (~same).mean() <= 0.01
    np.testing.assert_allclose(t_g[same], t_w[same], rtol=t_rtol)


@pytest.mark.parametrize("backend", ["auto", "pallas_wlg", "pallas_pair"])
@pytest.mark.parametrize("name", ["grid", "grid_textured"])
def test_split_casts_match_reference(ref_flat, ref_casts, name, backend):
    """Every work-list backend's alpha casts over the split (one opaque
    cast, the recast loop on the masked side) give the reference's."""
    port = ref_flat[name][3][0]
    o, d, u = (torch.from_numpy(x) for x in _rays())
    textured = name.endswith("textured")
    traverse.reset_counters()
    hit = intersect_closest(port, o, d, backend=backend, opacity_u=u,
                            alpha_textures=textured)
    occ = intersect_any(port, o, d, 3.0, backend=backend, opacity_u=u,
                        alpha_textures=textured)
    want_hit, want_occ = ref_casts[name]
    _assert_hits_close(want_hit, hit)
    assert (occ.numpy() == want_occ).mean() >= 0.995
    assert 0.0 < want_occ.mean() < 1.0
    # each cast recast its masked side at least twice (a rejected hit)
    assert traverse.alpha_recast.calls == 2
    assert traverse.alpha_recast.passes >= 4


def test_instanced_casts_match_reference(instanced, ref_casts):
    """On the instanced tables (no split: the whole scene re-casts) the
    alpha casts give the split soup's hits."""
    port, _ = instanced
    o, d, u = (torch.from_numpy(x) for x in _rays())
    hit = intersect_closest(port, o, d, opacity_u=u)
    occ = intersect_any(port, o, d, 3.0, opacity_u=u)
    want_hit, want_occ = ref_casts["grid"]
    _assert_hits_close(want_hit, hit, t_rtol=3e-5)
    assert (occ.numpy() == want_occ).mean() >= 0.995
    assert not hit.iterations.any()


@pytest.mark.parametrize("textured", [False, True])
def test_panel_casts_match_reference_dense_sweep(ref_flat, textured):
    """The dense sweep re-cast around the alpha test against the
    reference's in-sweep alpha test (`brute`; textured: its stack
    walker)."""
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_any as ref_any,
    )
    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_closest as ref_closest,
    )

    name = "panel_textured" if textured else "panel"
    arrays, meta, _, (port, _, _) = ref_flat[name]
    rs = np.random.default_rng(1)
    n = 2048
    o = np.zeros((n, 3), np.float32)
    o[:, 0], o[:, 2] = rs.uniform(-0.95, 0.95, (2, n))
    o[:, 1] = rs.uniform(1.5, 2.5, n)
    d = rs.normal(0, 0.2, (n, 3)).astype(np.float32)
    d[:, 1] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u = rs.random(n, dtype=np.float32)
    backend = "jax" if textured else "brute"
    want = ref_closest(arrays, jnp.asarray(o), jnp.asarray(d),
                       meta.stack_size, backend=backend,
                       opacity_u=jnp.asarray(u), alpha_textures=textured)
    got = intersect_closest(port, *(torch.from_numpy(x) for x in (o, d)),
                            opacity_u=torch.from_numpy(u),
                            alpha_textures=textured)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(hit, got.hit.numpy())
    np.testing.assert_array_equal(np.asarray(want.triangle)[hit],
                                  got.triangle.numpy()[hit])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=T_RTOL)
    # the panel lets some rays through to the floor, not all
    on_floor = got.triangle.numpy() < 2
    assert 0.2 < on_floor.mean() < 0.9
    occ_w = ref_any(arrays, jnp.asarray(o), jnp.asarray(d), jnp.float32(1.2),
                    meta.stack_size, backend=backend,
                    opacity_u=jnp.asarray(u), alpha_textures=textured)
    occ = intersect_any(port, *(torch.from_numpy(x) for x in (o, d)), 1.2,
                        opacity_u=torch.from_numpy(u),
                        alpha_textures=textured)
    np.testing.assert_array_equal(np.asarray(occ_w), occ.numpy())


def test_capped_and_slab_marched_casts(ref_flat):
    """t_cap through the split: hits below the cap are the full cast's,
    a capped miss has no accepted hit below it; slab marching gives the
    full cast's hits."""
    port = ref_flat["grid"][3][0]
    o, d, u = (torch.from_numpy(x) for x in _rays(seed=11))
    full = intersect_closest(port, o, d, opacity_u=u)
    cap_d = float(full.t[full.hit].median())
    capped = intersect_closest(port, o, d, opacity_u=u, t_cap=cap_d)
    below = capped.hit & (capped.t < cap_d)
    assert below.sum() > 30
    assert torch.equal(capped.t[below], full.t[below])
    assert torch.equal(capped.triangle[below], full.triangle[below])
    assert not (full.hit & ~capped.hit & (full.t < cap_d * (1 - 2e-4))).any()
    slab = intersect_closest_slab(port, o, d, 0.3, opacity_u=u)
    for a, b in zip(slab[:7], full[:7]):
        assert torch.equal(a, b)


def _ref_render(ref_flat, name, integrator="megakernel"):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.integrator.common import (
        RenderConfig as RefConfig,
    )
    from directcomputeraytracing_tpu.integrator.megakernel import (
        full_frame_pixels as ref_pixels,
    )
    from directcomputeraytracing_tpu.integrator.megakernel import (
        render_samples_accumulated as ref_accumulated,
    )
    from directcomputeraytracing_tpu.lut.textures import placeholder_luts

    arrays, meta, cam, _ = ref_flat[name]
    cfg = RefConfig(width=W, height=H, max_bounce=4,
                    stack_size=meta.stack_size, light_count=meta.light_count,
                    any_hit=True, traversal_backend="brute")
    px, py = ref_pixels(cfg)
    return np.asarray(ref_accumulated(arrays, placeholder_luts(), cam, cfg,
                                      px, py, jnp.uint32(0), SPP)) / SPP


@pytest.fixture(scope="module")
def renders(ref_flat):
    """name -> (reference megakernel, port megakernel, port wavefront)
    mean sample values, raster order."""
    out = {}
    for name in ("panel", "grid"):
        _, meta, _, (scene, luts, cam) = ref_flat[name]
        cfg = RenderConfig(width=W, height=H, max_bounce=4,
                           light_count=meta.light_count, any_hit=True)
        px, py = full_frame_pixels(cfg, CPU)
        mk = render_samples_accumulated(scene, luts, cam, cfg, px, py, 0,
                                        SPP) / SPP
        wf = render_samples_wavefront(scene, luts, cam, cfg, px, py, 0,
                                      spp_batch=SPP)[1] / SPP
        out[name] = (_ref_render(ref_flat, name), mk.numpy(), wf.numpy())
    return out


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
@pytest.mark.parametrize("name", ["panel", "grid"])
def test_render_matches_reference(renders, name, integrator):
    want, mk, wf = renders[name]
    got = mk if integrator == "megakernel" else wf
    assert np.isfinite(got).all() and got.mean() > 0
    rel = np.abs(got - want).max(-1) / (1 + np.abs(want).max(-1))
    assert (rel > PIXEL_TOL).mean() <= (1 / 256 if name == "panel"
                                        else 1 / 64), rel.max()
    assert np.sqrt(((got - want) ** 2).mean()) <= GATE_RMSE


@pytest.mark.parametrize("name", ["panel", "grid"])
def test_wavefront_equals_megakernel(renders, name):
    _, mk, wf = renders[name]
    np.testing.assert_allclose(wf, mk, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_renderer_sets_the_alpha_config(integrator):
    """The Renderer takes any_hit and any_hit_texture from the scene and
    renders an alpha-tested clustered scene on the instanced tables."""
    scene, cam = presets.alpha_sphere_grid(*GRID, **GRID_KW, textured=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene_mod, "SOUP_MAX_TRIS", 256)
        r = Renderer(scene, cam, 16, 16, max_bounce=2, device=CPU,
                     integrator=integrator)
    assert r.cfg.any_hit and r.cfg.any_hit_texture
    assert wl.instanced(r.arrays)
    img = r.render(1)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0
