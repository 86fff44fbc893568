"""The stack walker: the two-level build and node table, the walker's
casts and renders, against the reference's `backend="jax"` on the CPU.

Scenes: Cornell, the reference BVH tests' two-instance scene
(`test_bvh.make_two_instance_scene`), the small sphere grid
(`sphere_grid(3, 3, stacks=12, slices=16)`), the same grid forced onto
the instanced tables (`SOUP_MAX_TRIS` lowered: the walker runs on every
flattened scene) and `walker_grid(129, 128)` (1,056,768 world triangles
from a 64-triangle mesh: the node table alone). Rays from a numpy seed.

Tolerances against the reference:
- `build_two_level`, the node table and the leaf-ordered triangles
  (`node_tables`, built on first use beside a flattened scene) equal bit
  for bit (the same numpy arithmetic), and so does the stack bound.
- casts: hit masks and occlusion equal. `triangle`, `instance`,
  `backface` and `iterations` equal but on rays the test names, at most
  1 % of them: XLA rounds the reference's triangle test and instance
  transforms differently (it contracts products into FMAs), so t differs
  in its last bits on some rays; a ray may then enter one more or one
  fewer box before its closest hit (its `iterations` differ only where
  its t is not bit-equal), and ids differ only at near-ties (two hits
  within 2^-12 relative). t within 1e-5 (1 + t) (the intersect tests'
  bound), and u and v too: a far ray's origin in the instance's space
  keeps fewer digits (the big grid's camera rays start ~400 sphere radii
  away), which the barycentrics inherit.
- renders, 32x32, 2 spp, max_bounce 4, against the reference's
  megakernel through "jax": `test_torch_alpha.py`'s gates (per pixel
  1e-4 (1 + |reference|) for all but 1 pixel in 64, image RMSE <= 1e-3);
  the port's wavefront equals its megakernel within rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import build as port_build
from directcomputeraytracing_tpu_torch.accel import traverse
from directcomputeraytracing_tpu_torch.accel.traverse import (
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
    node_tables,
)
from directcomputeraytracing_tpu_torch.core.constants import (
    BVHNODE_MISC_COUNT_SHIFT,
    BVHNODE_MISC_HAS_BLAS,
)
from directcomputeraytracing_tpu_torch.core.types import from_reference
from directcomputeraytracing_tpu_torch.integrator.common import RenderConfig
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    full_frame_pixels,
    render_samples_accumulated,
)
from directcomputeraytracing_tpu_torch.integrator.wavefront import (
    render_samples_wavefront,
)
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod

CPU = torch.device("cpu")
T_RTOL, UV_TOL, TIE = 1e-5, 1e-5, 2.0 ** -12
MAX_DIFF_SHARE = 0.01
N_RAYS, N_BIG_RAYS = 1024, 256
FORCE = 2048
W = H = 32
SPP = 2
PIXEL_TOL, GATE_RMSE = 1e-4, 1e-3
CASES = ("cornell", "two_instance", "grid", "grid_forced", "big")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _convert(scene, mod):
    """The same scene as `mod`'s dataclasses (either package's)."""
    return mod.Scene(
        meshes=[mod.Mesh(positions=m.positions, indices=m.indices,
                         normals=m.normals, tangents=m.tangents,
                         texcoords=m.texcoords, material_ids=m.material_ids,
                         name=m.name) for m in scene.meshes],
        instances=[mod.Instance(mesh=i.mesh, transform=i.transform,
                                material_override=i.material_override,
                                is_emitter=i.is_emitter, radiance=i.radiance,
                                name=i.name) for i in scene.instances],
        materials=[mod.Material(**vars(m)) for m in scene.materials],
        lights=[mod.PunctualLight(kind=li.kind, radiance=li.radiance,
                                  position=li.position)
                for li in scene.lights],
        env_texture=scene.env_texture, textures=list(scene.textures))


def _port_scene(name):
    """(port Scene, camera or None) of a case."""
    if name == "cornell":
        return presets.cornell_box("area", "glossy")
    if name == "two_instance":
        from directcomputeraytracing_tpu.scene import scene as ref_mod
        from test_bvh import make_two_instance_scene

        assert ref_mod is not scene_mod
        return _convert(make_two_instance_scene(), scene_mod), None
    if name == "big":
        return presets.walker_grid(129, 128)
    return presets.sphere_grid(3, 3, stacks=12, slices=16)


def _flatten_port(name, scene):
    with pytest.MonkeyPatch.context() as mp:
        if name == "grid_forced":
            mp.setattr(scene_mod, "SOUP_MAX_TRIS", FORCE)
        return scene_mod.flatten_scene(scene, CPU)


@pytest.fixture(scope="module")
def flat():
    """name -> (port tensors, port meta, reference arrays, reference meta,
    port Scene, camera)."""
    from directcomputeraytracing_tpu.scene import scene as ref_mod

    out = {}
    for name in CASES:
        scene, cam = _port_scene(name)
        arrays, meta = _flatten_port(name, scene)
        ref, ref_meta = ref_mod.flatten_scene(_convert(scene, ref_mod))
        out[name] = (arrays, meta, ref, ref_meta, scene, cam)
    return out


@pytest.mark.parametrize("name", CASES)
def test_node_tables_equal_the_reference(flat, name):
    from directcomputeraytracing_tpu.accel import build as ref_build

    arrays, meta, ref, ref_meta, scene, _ = flat[name]
    tables = node_tables(arrays)
    for f in ("node_table", "tri_verts"):
        np.testing.assert_array_equal(getattr(tables, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert tables.stack_size == ref_meta.stack_size
    assert port_build.stack_bound(np.asarray(ref.node_table)) \
        == ref_meta.stack_size
    instanced, soup = arrays.isup_inst.shape[0] > 1, \
        arrays.world_tris.shape[0] > 1
    assert (instanced, soup) == {"grid_forced": (True, False),
                                 "big": (False, False)}.get(name,
                                                            (False, True))
    if name == "big":
        assert sum(scene.meshes[i.mesh].indices.shape[0]
                   for i in scene.instances) == 1_056_768
        assert traverse._resolve_backend(arrays, "auto") == "walk"
        return
    # build_two_level itself, on the reference's BLASes
    blas = [ref_build.build_bvh(*scene_mod.triangle_bounds(m.positions,
                                                           m.indices),
                                max_prims_in_node=2, use_native=False)
            for m in scene.meshes]
    offsets = np.cumsum([0] + [m.indices.shape[0]
                               for m in scene.meshes])[:-1]
    args = (blas, offsets, [i.mesh for i in scene.instances],
            np.stack([i.transform for i in scene.instances]))
    want, want_order = ref_build.build_two_level(*args)
    got, got_order = port_build.build_two_level(*args)
    for f in ("bbox_min", "bbox_max", "right_or_prim", "misc"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert want.max_stack == got.max_stack
    np.testing.assert_array_equal(want_order, got_order)


def _rays(arrays, n, seed, cam=None):
    """Camera rays (cam given) or rays from inside the root box."""
    rs = np.random.default_rng(seed)
    if cam is not None:
        from directcomputeraytracing_tpu_torch.camera.camera import (
            generate_ray,
        )

        o, d = generate_ray(cam, torch.from_numpy(
            rs.random((n, 2), dtype=np.float32)), torch.zeros(n, 3))
        return o.numpy(), d.numpy()
    root = node_tables(arrays).node_table[0].numpy()
    o = rs.uniform(root[0:3], root[3:6], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def assert_walks_match(want, got, what=""):
    """The gate of the module docstring: want the reference's HitInfo
    (numpy), got the port's."""
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(hit, got.hit.numpy(), err_msg=what)
    t_w, t_g = np.asarray(want.t), got.t.numpy()
    bits = t_w == t_g
    tie = np.zeros_like(hit)
    tie[hit] = np.abs(t_w[hit] - t_g[hit]) <= TIE * np.abs(t_w[hit])
    named = set()
    for f in ("triangle", "instance", "backface"):
        diff = np.asarray(getattr(want, f)) != getattr(got, f).numpy()
        diff &= hit
        assert not (diff & ~tie).any(), (what, f, np.nonzero(diff & ~tie))
        named |= set(np.nonzero(diff)[0].tolist())
    it_diff = np.asarray(want.iterations) != got.iterations.numpy()
    assert not (it_diff & bits).any(), (what, np.nonzero(it_diff & bits))
    named |= set(np.nonzero(it_diff)[0].tolist())
    assert len(named) <= MAX_DIFF_SHARE * hit.size, (what, sorted(named))
    same = hit & (np.asarray(want.triangle) == got.triangle.numpy())
    assert np.all(np.abs(t_g[same] - t_w[same])
                  <= T_RTOL * (1 + np.abs(t_w[same]))), what
    for f in ("u", "v"):
        diff = np.abs(getattr(got, f).numpy()[same]
                      - np.asarray(getattr(want, f))[same])
        assert np.all(diff <= UV_TOL * (1 + np.abs(t_w[same]))), (what, f)
    assert got.triangle.dtype == got.instance.dtype == torch.int32
    return sorted(named)


def _ref_closest(ref, meta, o, d, **kw):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import intersect_closest

    hit = intersect_closest(ref, jnp.asarray(o), jnp.asarray(d),
                            meta.stack_size, backend="jax", **kw)
    return type(hit)(*(np.asarray(x) for x in hit))


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["moeller", "watertight"])
@pytest.mark.parametrize("name", CASES)
def test_walker_matches_the_reference(flat, name, watertight):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_any as ref_any,
    )

    arrays, meta, ref, ref_meta, _, cam = flat[name]
    n = N_BIG_RAYS if name == "big" else N_RAYS
    if name == "two_instance":
        from test_bvh import aimed_rays

        o, d = aimed_rays(np.random.default_rng(5), n)
    else:
        o, d = _rays(arrays, n, 5, cam if name == "big" else None)
    span = (50.0, 250.0) if name == "big" else (0.2, 4.0)
    t_max = np.random.default_rng(6).uniform(*span, n).astype(np.float32)
    got = intersect_closest(arrays, torch.from_numpy(o), torch.from_numpy(d),
                            1e-4, backend="jax", watertight=watertight)
    want = _ref_closest(ref, ref_meta, o, d, t_min=1e-4,
                        watertight=watertight)
    assert 0.05 < np.asarray(want.hit).mean()
    assert_walks_match(want, got, name)
    occ = intersect_any(arrays, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(t_max), 1e-4, backend="jax",
                        watertight=watertight)
    occ_w = np.asarray(ref_any(ref, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_max), ref_meta.stack_size,
                               t_min=1e-4, backend="jax",
                               watertight=watertight))
    np.testing.assert_array_equal(occ.numpy(), occ_w)
    assert occ_w.any()


@pytest.mark.parametrize("every", [1, 3, 8])
def test_done_check_interval_changes_nothing(flat, every):
    """Reading done.all() every k steps gives the result of every step."""
    arrays = flat["grid"][0]
    o, d = (torch.from_numpy(x) for x in _rays(arrays, 256, 7))
    want = traverse.walk(arrays, o, d, 0.0, float("inf"), False,
                         check_every=1)
    got = traverse.walk(arrays, o, d, 0.0, float("inf"), False,
                        check_every=every)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert traverse.walk.host_reads == -(-traverse.walk.steps // every) \
        + (traverse.walk.steps % every == 0)


@pytest.fixture(scope="module")
def alpha_flat():
    """textured -> (port tensors, reference arrays, reference meta) of
    the alpha panel."""
    from directcomputeraytracing_tpu.scene import scene as ref_mod

    out = {}
    for textured in (False, True):
        scene, _ = presets.alpha_panel(textured=textured)
        arrays, _ = scene_mod.flatten_scene(scene, CPU)
        ref, ref_meta = ref_mod.flatten_scene(_convert(scene, ref_mod))
        out[textured] = (arrays, ref, ref_meta)
    return out


@pytest.mark.parametrize("textured", [False, True],
                         ids=["scalar", "textured"])
def test_alpha_walks_match_the_reference(alpha_flat, textured):
    """Alpha inline in the walk (per candidate hit), plain and textured,
    on the panel over a floor."""
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_any as ref_any,
    )

    arrays, ref, ref_meta = alpha_flat[textured]
    rs = np.random.default_rng(8)
    o = rs.uniform(-3, 3, (N_RAYS, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 4.0, N_RAYS)
    d = rs.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u = rs.random(N_RAYS, dtype=np.float32)
    got = intersect_closest(arrays, torch.from_numpy(o), torch.from_numpy(d),
                            backend="jax", opacity_u=torch.from_numpy(u),
                            alpha_textures=textured)
    want = _ref_closest(ref, ref_meta, o, d, opacity_u=jnp.asarray(u),
                        alpha_textures=textured)
    assert_walks_match(want, got, "alpha")
    # the samples reject some hits: the alpha test ran
    plain = intersect_closest(arrays, torch.from_numpy(o),
                              torch.from_numpy(d), backend="jax")
    assert (plain.hit & ~got.hit).any() or (plain.t < got.t).any()
    occ = intersect_any(arrays, torch.from_numpy(o), torch.from_numpy(d),
                        3.0, backend="jax", opacity_u=torch.from_numpy(u),
                        alpha_textures=textured)
    occ_w = np.asarray(ref_any(ref, jnp.asarray(o), jnp.asarray(d),
                               jnp.float32(3.0), ref_meta.stack_size,
                               backend="jax", opacity_u=jnp.asarray(u),
                               alpha_textures=textured))
    np.testing.assert_array_equal(occ.numpy(), occ_w)


def test_slab_cast_through_the_walker(flat):
    """intersect_closest_slab on the walker: windows from the TLAS root
    box; the walk ignores the cap, so phase 1 is the whole cast and the
    later phase re-casts the rays beyond the cap from the floor."""
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_closest_slab as ref_slab,
    )

    arrays, _, ref, ref_meta, _, _ = flat["cornell"]
    o, d = _rays(arrays, N_RAYS, 9)
    got = intersect_closest_slab(arrays, torch.from_numpy(o),
                                 torch.from_numpy(d), 0.3, backend="jax")
    want = ref_slab(ref, jnp.asarray(o), jnp.asarray(d), ref_meta.stack_size,
                    0.3, backend="jax")
    assert_walks_match(type(want)(*(np.asarray(x) for x in want)), got,
                       "slab")
    full = intersect_closest(arrays, torch.from_numpy(o),
                             torch.from_numpy(d), backend="jax")
    assert torch.equal(full.t, got.t)
    assert (got.iterations >= full.iterations).all()


def _ref_render(flat, name):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.core.types import (
        CameraParams as RefCamera,
    )
    from directcomputeraytracing_tpu.integrator.common import (
        RenderConfig as RefConfig,
    )
    from directcomputeraytracing_tpu.integrator.megakernel import (
        full_frame_pixels as ref_pixels,
    )
    from directcomputeraytracing_tpu.integrator.megakernel import (
        render_samples_accumulated as ref_accumulated,
    )
    from directcomputeraytracing_tpu.lut.bake import bake_luts_cached

    _, _, ref, ref_meta, _, cam = flat[name]
    cfg = RefConfig(width=W, height=H, max_bounce=4,
                    stack_size=ref_meta.stack_size,
                    light_count=ref_meta.light_count,
                    traversal_backend="jax")
    px, py = ref_pixels(cfg)
    ref_cam = RefCamera(*(jnp.asarray(x.numpy()) for x in cam))
    return np.asarray(ref_accumulated(ref, bake_luts_cached(), ref_cam, cfg,
                                      px, py, jnp.uint32(0), SPP)) / SPP


@pytest.fixture(scope="module")
def renders(flat):
    """name -> (reference megakernel, port megakernel, port wavefront)
    mean sample values through the walker, raster order."""
    from directcomputeraytracing_tpu_torch.lut.textures import load_luts

    out = {}
    for name in ("cornell", "grid"):
        arrays, meta, _, _, _, cam = flat[name]
        cfg = RenderConfig(width=W, height=H, max_bounce=4,
                           light_count=meta.light_count,
                           traversal_backend="jax")
        px, py = full_frame_pixels(cfg, CPU)
        luts = load_luts(CPU)
        mk = render_samples_accumulated(arrays, luts, cam, cfg, px, py, 0,
                                        SPP) / SPP
        wf = render_samples_wavefront(arrays, luts, cam, cfg, px, py, 0,
                                      spp_batch=SPP)[1] / SPP
        out[name] = (_ref_render(flat, name), mk.numpy(), wf.numpy())
    return out


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
@pytest.mark.parametrize("name", ["cornell", "grid"])
def test_walker_render_matches_the_reference(renders, name, integrator):
    want, mk, wf = renders[name]
    got = mk if integrator == "megakernel" else wf
    assert np.isfinite(got).all() and got.mean() > 0
    rel = np.abs(got - want).max(-1) / (1 + np.abs(want).max(-1))
    assert (rel > PIXEL_TOL).mean() <= 1 / 64, rel.max()
    assert np.sqrt(((got - want) ** 2).mean()) <= GATE_RMSE
    np.testing.assert_allclose(wf, mk, rtol=1e-5, atol=1e-6)


def test_big_scene_renders_through_the_walker(flat):
    """The 1M-triangle walker grid renders (8x8, 1 spp) on the CPU."""
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    scene, cam = flat["big"][4], flat["big"][5]
    r = Renderer(scene, cam, 8, 8, max_bounce=1, device=CPU)
    img = r.render(1)
    assert np.isfinite(img).all() and img.mean() > 0
    assert r._inv is None


# --- the reference's BVH tests (tests/test_bvh.py) on the port ---------

def test_bvh_build_invariants():
    from test_bvh import random_mesh

    mesh = random_mesh(np.random.default_rng(0), 300)
    bmin, bmax = scene_mod.triangle_bounds(mesh.positions, mesh.indices)
    bvh = port_build.build_bvh(bmin, bmax, max_prims_in_node=2)
    assert sorted(bvh.prim_order.tolist()) == list(range(300))
    counts = (bvh.misc >> BVHNODE_MISC_COUNT_SHIFT).astype(int)
    assert counts.max() <= 2
    covered = np.zeros(300, bool)
    for n in range(bvh.num_nodes):
        if counts[n] > 0:
            lo = int(bvh.right_or_prim[n])
            assert not covered[lo:lo + counts[n]].any()
            covered[lo:lo + counts[n]] = True
            for s in range(lo, lo + counts[n]):
                p = bvh.prim_order[s]
                assert (bvh.bbox_min[n] <= bmin[p] + 1e-5).all()
                assert (bvh.bbox_max[n] >= bmax[p] - 1e-5).all()
        else:
            r = int(bvh.right_or_prim[n])
            assert n + 1 < bvh.num_nodes and n + 1 < r < bvh.num_nodes
            for c in (n + 1, r):
                assert (bvh.bbox_min[n] <= bvh.bbox_min[c] + 1e-5).all()
                assert (bvh.bbox_max[n] >= bvh.bbox_max[c] - 1e-5).all()
    assert covered.all()
    assert bvh.max_depth <= 40


@pytest.mark.parametrize("seed", range(4))
def test_build_bvh_bits_equal_the_reference(seed):
    """The builder's SAH buckets (one scatter, the costs as arrays) give
    the reference's numpy builder's nodes bit for bit, signed zeros in
    the boxes included, on boxes with many -0 and +0 faces."""
    from directcomputeraytracing_tpu.accel import build as ref_build

    rs = np.random.default_rng(seed)
    n = int(rs.integers(50, 600))
    lo = rs.normal(size=(n, 3)).astype(np.float32)
    lo[rs.random((n, 3)) < 0.3] = -0.0
    hi = lo + np.abs(rs.normal(size=(n, 3))).astype(np.float32)
    hi[rs.random((n, 3)) < 0.3] = 0.0
    hi = np.maximum(hi, lo)
    want = ref_build.build_bvh(lo, hi, 2, use_native=False)
    got = port_build.build_bvh(lo, hi, 2)
    for f in ("bbox_min", "bbox_max", "right_or_prim", "misc", "prim_order",
              "leaf_depths"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    assert want.max_depth == got.max_depth


def test_bvh_degenerate_all_same_centroid():
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    bvh = port_build.build_bvh(np.repeat(tri.min(0)[None], 20, 0),
                               np.repeat(tri.max(0)[None], 20, 0),
                               max_prims_in_node=2)
    assert ((bvh.misc >> BVHNODE_MISC_COUNT_SHIFT).astype(int)).max() <= 2


def _brute_force(flat_entry, origins, dirs):
    from test_bvh import brute_force_closest

    arrays, _, ref, _, scene, _ = flat_entry
    vp = arrays.vtx_position.numpy()
    tris = arrays.triangles.numpy()
    per_mesh, cursor = [], 0
    for mesh in scene.meshes:
        per_mesh.append((cursor, cursor + mesh.indices.shape[0]))
        cursor += mesh.indices.shape[0]
    ranges = [per_mesh[i.mesh] for i in scene.instances]
    rows = arrays.inst_rows.numpy()
    inv = np.concatenate([rows[:, 0:9], rows[:, 9:12]], 1).reshape(-1, 4, 3)
    return brute_force_closest((vp, tris, ranges, inv), origins, dirs)


@pytest.mark.parametrize("backend", ["jax", "brute"])
def test_closest_hit_matches_brute_force(flat, backend):
    from test_bvh import aimed_rays

    arrays = flat["two_instance"][0]
    origins, dirs = aimed_rays(np.random.default_rng(7), 512)
    hi = intersect_closest(arrays, torch.from_numpy(origins),
                           torch.from_numpy(dirs), backend=backend)
    bt, _, binst = _brute_force(flat["two_instance"], origins, dirs)
    want_hit = np.isfinite(bt)
    np.testing.assert_array_equal(hi.hit.numpy(), want_hit)
    assert want_hit.sum() > 50
    np.testing.assert_allclose(hi.t.numpy()[want_hit], bt[want_hit],
                               rtol=1e-4, atol=1e-5)
    assert (hi.instance.numpy()[want_hit] == binst[want_hit]).mean() > 0.99


@pytest.mark.parametrize("backend", ["jax", "brute"])
def test_anyhit_matches_brute_force(flat, backend):
    from test_bvh import aimed_rays

    arrays = flat["two_instance"][0]
    rng = np.random.default_rng(8)
    origins, dirs = aimed_rays(rng, 512)
    t_max = rng.uniform(0.5, 6.0, size=512).astype(np.float32)
    occ = intersect_any(arrays, torch.from_numpy(origins),
                        torch.from_numpy(dirs), torch.from_numpy(t_max),
                        backend=backend)
    bt, _, _ = _brute_force(flat["two_instance"], origins, dirs)
    np.testing.assert_array_equal(occ.numpy(), np.isfinite(bt) & (bt < t_max))


def test_miss_rays(flat):
    arrays = flat["two_instance"][0]
    hi = intersect_closest(arrays, torch.full((4, 3), 100.0),
                           torch.tensor([[1.0, 0.0, 0.0]]).repeat(4, 1),
                           backend="jax")
    assert not hi.hit.any()


def test_tlas_leaf_packing(flat):
    arrays, _, _, _, scene, _ = flat["two_instance"]
    misc = node_tables(arrays).node_table[:, 7].numpy().astype(np.int64)
    has_blas = (misc & BVHNODE_MISC_HAS_BLAS) != 0
    assert has_blas.sum() == len(scene.instances)
    assert sorted((misc[has_blas] >> BVHNODE_MISC_COUNT_SHIFT).tolist()) \
        == [0, 1, 2]


def test_from_reference_keeps_the_walker_tables(flat):
    """A scene made by `from_reference` keeps the reference's node table
    and triangles, its stack bound read back from the table."""
    from directcomputeraytracing_tpu.lut.textures import placeholder_luts

    _, _, ref, ref_meta, _, cam = flat["grid"]
    arrays = from_reference(ref, placeholder_luts(),
                            presets.sphere_grid(3, 3, stacks=12,
                                                slices=16)[1], CPU)[0]
    tables = node_tables(arrays)
    assert tables.stack_size == ref_meta.stack_size
    assert torch.equal(tables.node_table,
                       torch.from_numpy(np.asarray(ref.node_table)))


def test_node_tables_are_built_on_first_use():
    """A scene with another traversal leaves a builder, which the first
    walk runs once; a walker-only scene has its tables at once; views of
    a scene (`_replace`) share them; a scene of neither raises."""
    arrays, _ = scene_mod.flatten_scene(
        presets.sphere_grid(3, 3, stacks=12, slices=16)[0], CPU)
    assert not isinstance(traverse._NODE_TABLES[arrays.inst_rows],
                          traverse.NodeTables)
    o, d = (torch.from_numpy(x) for x in _rays_box(arrays))
    intersect_closest(arrays, o, d, backend="jax")
    built = traverse._NODE_TABLES[arrays.inst_rows]
    assert isinstance(built, traverse.NodeTables)
    assert node_tables(arrays._replace(cluster_bbox=arrays.mclu_bbox)) \
        is built
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene_mod, "SOUP_MAX_TRIS", 100)
        walker, _ = scene_mod.flatten_scene(presets.walker_grid(2, 2)[0],
                                            CPU)
    assert isinstance(traverse._NODE_TABLES[walker.inst_rows],
                      traverse.NodeTables)
    with pytest.raises(ValueError, match="node tables"):
        node_tables(arrays._replace(inst_rows=arrays.inst_rows.clone()))


def _rays_box(arrays, n=64):
    rs = np.random.default_rng(13)
    root = node_tables(arrays).node_table[0].numpy()
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return (rs.uniform(root[0:3], root[3:6], (n, 3)).astype(np.float32),
            d / np.linalg.norm(d, axis=1, keepdims=True))


@pytest.mark.cuda
def test_cuda_walk_matches_cpu():
    """The walker on the card against the CPU on the same tables (the
    forced instanced grid): integer fields bit for bit, t within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    arrays = _flatten_port("grid_forced", _port_scene("grid_forced")[0])[0]
    o, d = (torch.from_numpy(x) for x in _rays(arrays, 4096, 11))
    want = intersect_closest(arrays, o, d, backend="jax")
    card = type(arrays)(*(x.to(dev) for x in arrays))
    tables = node_tables(arrays)
    traverse.register_node_tables(card, traverse.NodeTables(
        tables.node_table.to(dev), tables.tri_verts.to(dev),
        tables.stack_size))
    got = intersect_closest(card, o.to(dev), d.to(dev), backend="jax")
    for f in ("triangle", "instance", "backface", "iterations", "hit"):
        assert torch.equal(getattr(want, f), getattr(got, f).cpu()), f
    torch.testing.assert_close(got.t.cpu(), want.t, rtol=1e-5, atol=0)
