"""The instanced work-list path: the port's instanced tables, casts and
renders against the reference's on the CPU, and the two instanced CUDA
kernels against their twins on a card.

Scenes, both forced onto the instanced tables (the port's by lowering
`scene.SOUP_MAX_TRIS`, the reference's with `DCRT_INSTANCED=1`, which
keeps its world soup beside them): `sphere_grid(3, 3, stacks=12,
slices=16)` (3172 world triangles, 11 instance-supers) and a two-mesh
scene with a non-uniformly scaled, rotated instance and two
negative-determinant ones. Rays from a numpy seed.

Tolerances against the reference:
- local cluster slabs and their Baldwin-Weber rows, instance-supers,
  `inst_rows`, ray rows, scene exit, the cull, the refine and the
  (block, super, t_ent) items: bit-equal (the same numpy and float32
  operations in the same order).
- closest hits, against the reference's instanced work list (its Pallas
  kernels in interpret mode) and against its stack walker: hit masks
  equal; t within rtol 3e-5 plus atol 1e-6 (the port tests triangles in
  mesh-local space, the stack walker and the soup in their own rounding,
  so t differs by a few ulps of the scene's coordinates, which is more
  than 3e-5 of t only for hits within ~0.03 of the origin); triangle and
  instance ids equal except at a near-tie, two hits whose t agree within
  2^-12 relative; u, v within 2e-3 (rtol) and 2e-4 (atol) of the same
  triangle's; back-face flags equal on 99 % of hits (against the
  reference's instanced kernel, inverted on mirrored instances: it XORs
  the instance's flip into the mesh-local flag, which its stack walker
  and its soup, and the port, do not). `iters` is not compared: the
  port counts clusters per ray, the reference per block.
- occlusion: equal.
The port's instanced casts are held to its own world-soup casts of the
same scene under the same tolerances. Renders: the gates of
`test_torch_render.py`'s sphere-grid tests, against the reference's
exact dense sweep on its forced flatten. On a card, the kernels must
equal their twins bit for bit (built without FMA contraction):
`python -m pytest --noconftest -m cuda tests/test_torch_instanced.py`.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import cluster
from directcomputeraytracing_tpu_torch.accel import worklist as wl
from directcomputeraytracing_tpu_torch.accel.traverse import (
    _resolve_backend,
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
)
from directcomputeraytracing_tpu_torch.core.types import SceneTensors
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod

GRID = (3, 3)
GRID_KW = dict(stacks=12, slices=16)
FORCE = 256              # SOUP_MAX_TRIS below both scenes' world triangles
T_RTOL, T_ATOL = 3e-5, 1e-6
TIE = 2.0 ** -12
SOUP_FIELDS = ("world_tris", "world_tri_meta", "cluster_tris", "cluster_bw",
               "cluster_bbox")
INST_FIELDS = ("icl_slab", "icl_bw", "isup_cbox", "isup_sbox", "isup_local",
               "isup_inst", "inst_rows")
W = H = 32
PIXEL_TOL, GATE_RMSE, MAX_DIVERGED = 1e-4, 1e-3, 1 / 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_y(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


def _two_mesh_scene(mod):
    """A sphere and a cloud of small triangles, each twice: a
    non-uniformly scaled and rotated sphere, a mirrored sphere and a
    mirrored, rotated cloud (determinant < 0). `mod` is the port's or the
    reference's scene module."""
    sv, si = presets.uv_sphere(8, 12)
    rs = np.random.default_rng(4)
    cen = rs.uniform(-0.5, 0.5, (80, 3))
    cloud = (cen[:, None, :] + rs.uniform(-0.12, 0.12, (80, 3, 3)))

    def tf(a, t):
        return np.concatenate([a, np.asarray(t)[None]]).astype(np.float32)

    meshes = [mod.Mesh(positions=sv, indices=si),
              mod.Mesh(positions=cloud.reshape(-1, 3).astype(np.float32),
                       indices=np.arange(240).reshape(80, 3))]
    instances = [
        mod.Instance(mesh=0, transform=tf(np.diag([1.2, 0.5, 0.7])
                                          @ _rot_y(30.0), [1.6, 0.6, 0.3])),
        mod.Instance(mesh=0, transform=tf(np.diag([-0.6, 0.6, 0.6]),
                                          [-1.6, 0.7, -0.5])),
        mod.Instance(mesh=1, transform=tf(np.diag([1.0, 1.0, -1.0])
                                          @ _rot_y(-40.0), [0.2, 0.9, 1.4])),
    ]
    return mod.Scene(meshes=meshes, instances=instances,
                     materials=[mod.Material()])


def _port_scene(name):
    if name == "grid":
        return presets.sphere_grid(*GRID, **GRID_KW)[0]
    return _two_mesh_scene(scene_mod)


def _ref_scene(name):
    from directcomputeraytracing_tpu.scene import scene as ref_scene_mod
    from directcomputeraytracing_tpu.scene.presets import sphere_grid

    if name == "grid":
        return sphere_grid(*GRID, **GRID_KW)[0]
    return _two_mesh_scene(ref_scene_mod)


def _flatten_forced(scene, device="cpu"):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene_mod, "SOUP_MAX_TRIS", FORCE)
        return scene_mod.flatten_scene(scene, device)[0]


@pytest.fixture(scope="module")
def scenes():
    """name -> (port instanced flatten, port soup flatten, reference
    forced flatten, reference meta)."""
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCRT_INSTANCED", "1")
        for name in ("grid", "two_mesh"):
            ref, meta = ref_flatten(_ref_scene(name))
            out[name] = (_flatten_forced(_port_scene(name)),
                         scene_mod.flatten_scene(_port_scene(name), "cpu")[0],
                         ref, meta)
    return out


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 4.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 3.0, n).astype(np.float32)
    return o, d, t_max


def _half_occluded_rays(n_warps, seed):
    """Warps of 32 rays from y = 3 above the small grid's sphere centres:
    lanes pointing straight down (t_max 5) are occluded at the first
    sphere their block enters; lanes 16-31 of every odd warp point
    straight up (t_max 1, short of the lamp at y = 7) and are never
    occluded, so those warps walk on half occluded; every 5th lane of
    every third warp has t_max 0 and the next t_max 1e-4 (= t_min): no hit
    lies in [t_min, t_max)."""
    rs = np.random.default_rng(seed)
    n = n_warps * 32
    xz = np.repeat(rs.integers(-1, 2, (n_warps, 2)) * 1.5, 32, axis=0) \
        + rs.uniform(-0.1, 0.1, (n, 2))
    o = np.stack([xz[:, 0], np.full(n, 3.0), xz[:, 1]], 1)
    d = np.tile([0.0, -1.0, 0.0], (n, 1))
    t_max = np.full(n, 5.0)
    lane, warp = np.arange(n) % 32, np.arange(n) // 32
    up = (warp % 2 == 1) & (lane >= 16)
    d[up] = (0.0, 1.0, 0.0)
    t_max[up] = 1.0
    dead = (warp % 3 == 0) & (lane % 5 == 0)
    t_max[dead] = 0.0
    t_max[np.roll(dead, 1)] = 1e-4
    return (o.astype(np.float32), d.astype(np.float32),
            t_max.astype(np.float32))


def _local_inputs(arrays, scene):
    """build_local_clusters' and build_instanced_supers' inputs from a
    port flatten."""
    tri_verts = arrays.vtx_position[arrays.triangles].reshape(-1, 9).numpy()
    counts = [m.indices.shape[0] for m in scene.meshes]
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    inst_tf = np.stack([i.transform for i in scene.instances])
    return tri_verts, offsets, counts, [i.mesh for i in scene.instances], \
        inst_tf


@pytest.mark.parametrize("name", ["grid", "two_mesh"])
def test_local_clusters_and_supers_match_reference(scenes, name):
    from directcomputeraytracing_tpu.accel import cluster as rcluster

    scene = _port_scene(name)
    tri_verts, offsets, counts, inst_mesh, inst_tf = _local_inputs(
        scenes[name][0], scene)
    want = rcluster.build_local_clusters(tri_verts, offsets, counts)
    got = cluster.build_local_clusters(tri_verts, offsets, counts)
    want_sup = rcluster.build_instanced_supers(*want[1:], inst_mesh, inst_tf)
    got_sup = cluster.build_instanced_supers(*got[1:], inst_mesh, inst_tf)
    for w, g in zip(want + want_sup + (rcluster.baldwin_table(want[0]),),
                    got + got_sup + (cluster.baldwin_table(got[0]),)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)
    # every instance has its supers
    assert sorted(set(got_sup[3].tolist())) == list(range(len(scene.instances)))
    assert (got[1][:, 0] > got[1][:, 3]).any()           # padding clusters


@pytest.mark.parametrize("name", ["grid", "two_mesh"])
def test_instanced_admission_boxes(scenes, name):
    """The instanced tables carry the closest sweep's admission boxes: per
    (instance, local super) the min/max of its world child boxes as a
    slab test reads them (a padding child's inverted box as the cube
    [-1, 1]^3), isup_sbox itself on supers without padding; so a ray that
    enters a child box under a cap enters the admission box under it."""
    tables = wl.scene_tables(scenes[name][0])
    assert tables.inst_rows is not None
    cs = tables.sbox.shape[0]
    assert tables.abox.shape == (cs, 8) and tables.abox.is_contiguous()
    child = tables.cbox3
    lo = torch.minimum(child[..., 0:3], child[..., 3:6])
    hi = torch.maximum(child[..., 0:3], child[..., 3:6])
    assert (tables.abox[:, None, 0:3] <= lo).all()
    assert (tables.abox[:, None, 3:6] >= hi).all()
    padded = (child[..., 0] > child[..., 3]).any(1)
    assert padded.any()
    assert torch.equal(tables.abox[~padded], tables.sbox[~padded])
    o, d, t_max = (torch.from_numpy(x) for x in _rays(4096, 61))
    od, _, _ = wl.prep_rays(o, d)
    ray = torch.arange(od.shape[1]).repeat_interleave(cs)
    sup = torch.arange(cs).repeat(od.shape[1])
    cap = torch.cat([t_max, torch.full((od.shape[1] - 4096,), 1e-3)])[ray]
    enter, _ = wl._fine_cull(child[sup], od[:, ray], cap, 1e-4)
    adm, _ = wl._fine_cull(tables.abox[sup][:, None, :], od[:, ray], cap,
                           1e-4)
    entered = enter.any(1)
    assert not (entered & ~adm[:, 0]).any()
    assert entered.sum() > 100 and adm.sum() < adm.numel()


@pytest.mark.parametrize("name", ["grid", "two_mesh"])
def test_flatten_matches_the_reference_forced_flatten(scenes, name):
    """Every field the port builds equals the reference's forced flatten,
    through `from_reference`; the world soup and its opacities are the
    reference's placeholders, as above 2^20 world triangles."""
    from directcomputeraytracing_tpu.lut.textures import placeholder_luts
    from directcomputeraytracing_tpu.scene.presets import sphere_grid
    from directcomputeraytracing_tpu_torch.core.types import from_reference

    port, _, ref, _ = scenes[name]
    want = from_reference(ref, placeholder_luts(),
                          sphere_grid(1, 1)[1], "cpu")[0]
    assert port.isup_inst.shape[0] > 1
    for f in SceneTensors._fields:
        x, y = getattr(want, f), getattr(port, f)
        if f in SOUP_FIELDS:
            assert y.shape[0] in (1, 16) and not y.any(), f
            continue
        if f == "world_tri_opacity":
            assert torch.equal(y, torch.ones(1)), f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
    for f in INST_FIELDS:
        src = np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(getattr(want, f).numpy(),
                                      src.astype(getattr(want, f).numpy()
                                                 .dtype), err_msg=f)
    flips = port.inst_rows[:, 12]
    assert (flips == 1.0).any() == (name == "two_mesh")


def test_flatten_refuses_few_local_triangles(monkeypatch):
    """Above SOUP_MAX_TRIS world triangles from at most 64 local ones the
    scene gets the stack walker's node table only, as in the reference:
    no soup, no cluster or instanced tables; its node table, leaf-ordered
    triangles and stack bound equal the reference's."""
    from directcomputeraytracing_tpu.scene import scene as ref_scene
    from directcomputeraytracing_tpu_torch.accel.build import stack_bound
    from directcomputeraytracing_tpu_torch.accel.traverse import node_tables

    monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", 100)
    rs = np.random.default_rng(1)
    pos = rs.random((192, 3), dtype=np.float32)
    tf = np.concatenate([np.eye(3), [[1.5, 0.0, 0.0]]]).astype(np.float32)
    scene = scene_mod.Scene(meshes=[scene_mod.Mesh(
        positions=pos, indices=np.arange(192).reshape(64, 3))], instances=[
        scene_mod.Instance(mesh=0), scene_mod.Instance(mesh=0, transform=tf)])
    port, _ = scene_mod.flatten_scene(scene, "cpu")
    assert port.world_tris.shape[0] == port.cluster_bbox.shape[0] == 1
    assert port.isup_inst.shape[0] == 1
    ref, ref_meta = ref_scene.flatten_scene(ref_scene.Scene(
        meshes=[ref_scene.Mesh(positions=pos,
                               indices=np.arange(192).reshape(64, 3))],
        instances=[ref_scene.Instance(mesh=0),
                   ref_scene.Instance(mesh=0, transform=tf)]))
    tables = node_tables(port)
    for f in ("node_table", "tri_verts"):
        np.testing.assert_array_equal(getattr(tables, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert tables.stack_size == ref_meta.stack_size \
        == stack_bound(np.asarray(ref.node_table))


def _both_preps(o, d, t_max=None):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import worklist as rwl

    od_r, tm_r, _ = rwl._prep_rays_wl(
        jnp.asarray(o), jnp.asarray(d),
        None if t_max is None else jnp.asarray(t_max))
    od, tm, _ = wl.prep_rays(torch.from_numpy(o), torch.from_numpy(d),
                             None if t_max is None
                             else torch.from_numpy(t_max))
    return (od_r, tm_r), (od, tm)


@pytest.mark.parametrize("hier", [False, True], ids=["dense", "hyper"])
@pytest.mark.parametrize("name", ["grid", "two_mesh"])
def test_tables_cull_and_items_match_reference(scenes, monkeypatch, name,
                                               hier):
    from directcomputeraytracing_tpu.accel import worklist as rwl

    monkeypatch.setattr(rwl, "HIER_MIN", 2 if hier else 10 ** 9)
    monkeypatch.setattr(wl, "HIER_MIN", 2 if hier else 10 ** 9)
    port, _, ref, _ = scenes[name]
    o, d, t_max = _rays(2 * wl.RB + 31, seed=5)
    o[7] = np.nan                     # parked on the far ray
    (od_r, tm_r), (od, tm) = _both_preps(o, d, t_max)
    rp = od.shape[1]
    np.testing.assert_array_equal(np.asarray(od_r)[:, :rp], od.numpy())
    np.testing.assert_array_equal(np.asarray(tm_r)[0, :rp], tm.numpy())
    tables = wl.scene_tables(port)
    assert tables.inst_rows is not None
    assert (tables.hbox is not None) == hier
    tabs, cbox3, sbox_r, _, cs, hyper = rwl._pad_tables_instanced(ref)
    for want, got in ((tabs[0], tables.ctab), (tabs[1], tables.bwtab),
                      (cbox3, tables.cbox3), (np.asarray(sbox_r)[:cs],
                                              tables.sbox)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if hier:
        np.testing.assert_array_equal(np.asarray(hyper[0]),
                                      tables.hsup.numpy())
        np.testing.assert_array_equal(np.asarray(hyper[1])[:hyper[2]],
                                      tables.hbox.numpy())
    np.testing.assert_array_equal(
        np.asarray(rwl._scene_exit(ref, od_r))[0, :rp],
        wl.scene_exit(tables, od).numpy())
    ref_items = rwl._phases(ref, od_r, tm_r, interpret=True)
    bf, sup_r, t_r = (np.asarray(x) for x in ref_items[2:5])
    valid = (bf & 1) == 1
    want = sorted(zip((bf[valid] >> rwl._BLOCK_SHIFT).tolist(),
                      t_r[valid].tolist(), sup_r[valid].tolist()))
    items = wl.phases(tables, od, tm, plain=True)
    counts = (items.seg[1:] - items.seg[:-1]).long()
    blk = torch.repeat_interleave(torch.arange(counts.shape[0]), counts)
    got = list(zip(blk.tolist(), items.t_ent.tolist(), items.sup.tolist()))
    assert len(got) > 2 * counts.shape[0] and got == want
    np.testing.assert_array_equal(np.asarray(ref_items[6])[:counts.shape[0]],
                                  items.block_any.numpy())


def _assert_closest_close(want, got, inverted=None):
    """inverted (I,) bool: instances whose back-face flag `want` gives
    inverted (the reference's instanced kernel on mirrored instances)."""
    t_w, u_w, v_w, tri_w, inst_w, back_w = (np.asarray(x) for x in want[:6])
    t_g, u_g, v_g, tri_g, inst_g, back_g = (np.asarray(x) for x in got[:6])
    if inverted is not None:
        back_w = back_w ^ (np.asarray(inverted)[inst_w] & np.isfinite(t_w))
    hit = np.isfinite(t_w)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    assert 40 < hit.sum() < hit.size
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=T_RTOL, atol=T_ATOL)
    for w, g in ((tri_w, tri_g), (inst_w, inst_g)):
        diff = np.nonzero(hit & (w != g))[0]
        assert (np.abs(t_g[diff] - t_w[diff]) <= TIE * t_w[diff]).all()
    same = hit & (tri_w == tri_g) & (inst_w == inst_g)
    np.testing.assert_allclose(u_g[same], u_w[same], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(v_g[same], v_w[same], rtol=2e-3, atol=2e-4)
    assert (back_g[same] == back_w[same]).mean() > 0.99


def _ref_hit(ref, meta, o, d, backend, watertight):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_closest as ref_closest,
    )

    h = ref_closest(ref, jnp.asarray(o), jnp.asarray(d), meta.stack_size,
                    backend=backend, watertight=watertight)
    return h.t, h.u, h.v, h.triangle, h.instance, h.backface


REFS = ["pallas_wl_interpret", "jax"]


@pytest.mark.parametrize("backend", REFS, ids=["worklist", "stack"])
@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
@pytest.mark.parametrize("name", ["grid", "two_mesh"])
def test_closest_matches_reference(scenes, name, watertight, backend):
    """Against the reference's instanced work list, back-face flags on
    mirrored instances are compared inverted: its kernel XORs the
    instance's flip into the mesh-local test's flag, which its stack
    walker and its soup do not (module docstring of `accel.worklist`)."""
    port, _, ref, meta = scenes[name]
    o, d, _ = _rays(1024, seed=21)
    want = _ref_hit(ref, meta, o, d, backend, watertight)
    got = wl.worklist_closest_torch(port, torch.from_numpy(o),
                                    torch.from_numpy(d), 0.0, watertight)
    mirrored = port.inst_rows[:, 12].numpy() > 0.5
    _assert_closest_close(want, got,
                          mirrored if backend == "pallas_wl_interpret"
                          else None)
    assert (got[6].numpy()[np.isfinite(got[0].numpy())] > 0).all()
    if name == "two_mesh":   # a mirrored instance's front faces are hit
        inst = got[4].numpy()[np.isfinite(got[0].numpy())]
        assert set(inst.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("backend", REFS, ids=["worklist", "stack"])
@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
@pytest.mark.parametrize("name", ["grid", "two_mesh"])
def test_any_matches_reference(scenes, name, watertight, backend):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_any as ref_any,
    )

    port, _, ref, meta = scenes[name]
    o, d, t_max = _rays(1024, seed=22)
    want = np.asarray(ref_any(ref, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), meta.stack_size,
                              backend=backend, watertight=watertight))
    got = wl.worklist_any_torch(port, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(t_max),
                                0.0, watertight).numpy()
    np.testing.assert_array_equal(want, got)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
@pytest.mark.parametrize("name", ["grid", "two_mesh"])
def test_instanced_casts_match_the_soup(scenes, name, watertight):
    """The same scene through the instanced tables and through the world
    soup's cluster tables: two kernel families, one geometry."""
    port, soup, _, _ = scenes[name]
    assert soup.cluster_bbox.shape[0] > 1 or name == "two_mesh"
    o, d, t_max = (torch.from_numpy(x) for x in _rays(2048, seed=23))
    wl.reset_counters()
    got = intersect_closest(port, o, d, watertight=watertight)
    want = intersect_closest(soup, o, d, watertight=watertight)
    _assert_closest_close(want, got)
    np.testing.assert_array_equal(
        intersect_any(soup, o, d, t_max, watertight=watertight).numpy(),
        intersect_any(port, o, d, t_max, watertight=watertight).numpy())
    assert wl.counters() == dict.fromkeys(wl.counters(), 0)


def test_backends_resolve_to_the_instanced_sweep(scenes):
    """"auto", "pallas_wl" and "pallas_wlg" take the per-ray instanced
    sweep (grouped=True casts the same); "pallas_cluster" needs the world
    soup's cluster tables and raises."""
    port = scenes["grid"][0]
    for name in ("auto", "pallas_wl", "pallas_wlg"):
        assert _resolve_backend(port, name) == "wl"
    with pytest.raises(ValueError):
        _resolve_backend(port, "pallas_cluster")
    o, d, t_max = (torch.from_numpy(x) for x in _rays(1500, seed=24))
    plain = wl.worklist_closest_torch(port, o, d)
    for a, b in zip(plain, wl.worklist_closest_torch(port, o, d,
                                                     grouped=True)):
        assert torch.equal(a, b)
    hit = intersect_closest(port, o, d, backend="pallas_wlg")
    for a, b in zip(plain, hit[:6] + (hit.iterations,)):
        assert torch.equal(a, b)
    assert torch.equal(wl.worklist_any_torch(port, o, d, t_max),
                       wl.worklist_any_torch(port, o, d, t_max, grouped=True))


def test_slab_marching_on_instanced_tables(scenes):
    """Distance slabs through the instanced tables give the single cast's
    hits, up to packed-argmin ties at the window boundaries."""
    port = scenes["grid"][0]
    o, d, _ = (torch.from_numpy(x) for x in _rays(1024, seed=25))
    full = intersect_closest(port, o, d)
    depth = float(full.t[full.hit].median())
    slab = intersect_closest_slab(port, o, d, depth)
    assert torch.equal(slab.hit, full.hit)
    np.testing.assert_allclose(slab.t[full.hit].numpy(),
                               full.t[full.hit].numpy(), rtol=1e-6)
    assert torch.equal(slab.triangle[full.hit], full.triangle[full.hit])
    assert torch.equal(slab.instance[full.hit], full.instance[full.hit])


def _assert_pixels_close(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max(-1) / (1 + np.abs(want).max(-1))
    assert (rel > PIXEL_TOL).mean() <= MAX_DIVERGED, rel.max()
    assert np.sqrt(((got - want) ** 2).mean()) <= GATE_RMSE


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_renderer_matches_reference(monkeypatch, integrator):
    """The forced small grid end to end through the instanced tables (32x32
    tiles, sorted bounces and pool), against the reference's render of
    its forced flatten through its exact dense sweep."""
    from directcomputeraytracing_tpu.integrator.renderer import (
        Renderer as RefRenderer,
    )
    from directcomputeraytracing_tpu.scene.presets import sphere_grid

    monkeypatch.setenv("DCRT_INSTANCED", "1")
    ref = RefRenderer(*sphere_grid(*GRID, **GRID_KW), W, H, max_bounce=4,
                      traversal_backend="brute")
    assert ref.arrays.isup_inst.shape[0] > 1
    monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", FORCE)
    port = Renderer(*presets.sphere_grid(*GRID, **GRID_KW), W, H,
                    max_bounce=4, integrator=integrator,
                    device=torch.device("cpu"))
    assert port.arrays.isup_inst.shape[0] > 1 and port._inv is not None
    _assert_pixels_close(ref.render(2), port.render(2))
    assert port.image().mean() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
def test_cuda_kernels_match_twins(watertight, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    monkeypatch.setattr(wl, "HIER_MIN", 2)       # the refine runs too
    arrays = _flatten_forced(_port_scene("grid"), dev)
    o, d, t_max = (torch.from_numpy(x).to(dev)
                   for x in _rays(100_003, seed=11))
    wl.reset_counters()
    got = wl.worklist_closest(arrays, o, d, 1e-4, watertight)
    want = wl.worklist_closest_torch(arrays, o, d, 1e-4, watertight)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    occ = wl.worklist_any(arrays, o, d, t_max, 1e-4, watertight)
    assert torch.equal(occ, wl.worklist_any_torch(arrays, o, d, t_max, 1e-4,
                                                  watertight))
    torch.cuda.synchronize()
    c = wl.counters()
    assert c["sweep_closest_inst"] == c["sweep_any_inst"] == 1
    assert c["sweep_closest"] == c["sweep_any"] == 0
    assert c["refine"] == 2
    # a per-ray t_cap: the kernel's warp vote is the twin's, every field
    tables = wl.scene_tables(arrays)
    od, tm, r = wl.prep_rays(o, d)
    cap = wl._cap(t_max, wl.scene_exit(tables, od), r)
    texp, tm = torch.minimum(wl.scene_exit(tables, od), cap), \
        torch.minimum(tm, cap)
    items = wl.phases(tables, od, tm)
    got = wl.sweep_closest_inst(tables, items, od, texp, 1e-4, watertight)
    want = wl.sweep_closest_inst_torch(tables, items, od, texp, 1e-4,
                                       watertight)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # any-hit warps occluded at their first item, whole or half, and
    # lanes with t_max <= t_min; a partial last ray block
    o, d, t_max = (torch.from_numpy(x).to(dev)
                   for x in _half_occluded_rays(3 * 32 * 11 + 3, 12))
    od, tm, r = wl.prep_rays(o, d, t_max)
    items = wl.phases(tables, od, tm)
    occ = wl.sweep_any_inst(tables, items, od, tm, 1e-4, watertight)
    assert torch.equal(occ, wl.sweep_any_inst_torch(tables, items, od, tm,
                                                    1e-4, watertight))
    warps = occ[:r - r % 32].view(-1, 32)
    assert warps[0::2].sum() > 0.5 * warps[0::2].numel()
    assert warps[1::2, :16].any() and not warps[1::2, 16:].any()
    assert not occ[:r][~(t_max > 1e-4)].any()
