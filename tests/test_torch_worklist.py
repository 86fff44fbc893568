"""The work-list traversal: the port's twins against the reference's work
list (Pallas kernels in interpret mode, or their XLA mirrors, on the CPU),
and the CUDA kernels against the twins on a card.

Scene: `sphere_grid(3, 3, stacks=12, slices=16)`, 3172 world triangles in
256 clusters and 8 supers; rays from a numpy seed.

Tolerances against the reference:
- cluster tables, ray rows, scene exit, the cull, the refine and the
  (block, super, t_ent) items: bit-equal. Both run the same float32
  operations in the same order.
- closest hits: hit masks equal; t within rtol 3e-5; triangle and
  instance ids equal except at a near-tie, two hits whose t agree within
  2^-12 relative (the packed argmin truncates t to ~2^-14 relative, and
  the two visit clusters in different orders); u, v within 2e-3 (rtol)
  and 2e-4 (atol) of the same triangle's; back-face flags equal on
  99 % of hits (grazing-edge sign flips). `iters` is not compared: the
  reference counts clusters per block, the port per ray.
- occlusion: equal.
Against the twins, the CUDA kernels must agree bit for bit (built without
FMA contraction). The reference is imported inside the tests that use
it, so that on a card's machine, which has no jax, the `cuda` test runs:
`python -m pytest --noconftest -m cuda tests/test_torch_worklist.py`.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import cluster
from directcomputeraytracing_tpu_torch.accel import worklist as wl
from directcomputeraytracing_tpu_torch.accel.traverse import (
    intersect_any,
    intersect_closest,
)
from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
from directcomputeraytracing_tpu_torch.scene.scene import (
    Instance,
    Mesh,
    Scene,
    flatten_scene,
)

GRID = (3, 3)
GRID_KW = dict(stacks=12, slices=16)
T_RTOL = 3e-5
TIE = 2.0 ** -12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_scene():
    arrays, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], "cpu")
    assert arrays.cluster_bbox.shape[0] > 1
    return arrays


@pytest.fixture(scope="module")
def ref_scene():
    from directcomputeraytracing_tpu.scene.presets import (
        sphere_grid as ref_grid,
    )
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    return ref_flatten(ref_grid(*GRID, **GRID_KW)[0])[0]


def _rays(n, seed=0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 4.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 3.0, n).astype(np.float32)
    return o, d, t_max


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


def _set_hier_min(monkeypatch, value):
    from directcomputeraytracing_tpu.accel import worklist as rwl

    monkeypatch.setattr(rwl, "HIER_MIN", value)
    monkeypatch.setattr(wl, "HIER_MIN", value)


@pytest.mark.parametrize("grid", [(3, 3), (6, 6)])
def test_cluster_tables_match_reference(grid):
    from directcomputeraytracing_tpu.accel import cluster as rcluster

    arrays, _ = flatten_scene(sphere_grid(*grid, **GRID_KW)[0], "cpu")
    tris, meta = arrays.world_tris.numpy(), arrays.world_tri_meta.numpy()
    want_tab, want_box = rcluster.build_clusters(tris, meta)
    got_tab, got_box = cluster.build_clusters(tris, meta)
    for want, got in ((want_tab, got_tab), (want_box, got_box),
                      (rcluster.baldwin_table(want_tab),
                       cluster.baldwin_table(got_tab))):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(arrays.cluster_bw.numpy(),
                                  cluster.baldwin_table(got_tab))


@pytest.mark.parametrize("capped", [False, True], ids=["closest", "shadow"])
def test_prep_exit_and_cull_match_reference(port_scene, ref_scene, capped):
    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, t_max = _rays(3 * wl.RB + 17, seed=9)
    o[5] = np.nan                     # parked on the far ray
    d[6] = 0.0
    (od_r, tm_r), (od, tm) = _both_preps(o, d, t_max if capped else None)
    rp = od.shape[1]
    np.testing.assert_array_equal(np.asarray(od_r)[:, :rp], od.numpy())
    np.testing.assert_array_equal(np.asarray(tm_r)[0, :rp], tm.numpy())
    tables = wl.scene_tables(port_scene)
    np.testing.assert_array_equal(np.asarray(rwl._scene_exit(ref_scene,
                                                             od_r))[0, :rp],
                                  wl.scene_exit(tables, od).numpy())
    _, cbox3, sbox_r, _, cs, _ = rwl._pad_tables(ref_scene)
    np.testing.assert_array_equal(np.asarray(cbox3), tables.cbox3.numpy())
    want = np.asarray(rwl._exact_tlo_super(sbox_r, od_r, tm_r))
    got = wl.cull_boxes_torch(tables.sbox, od, tm).numpy()
    np.testing.assert_array_equal(want[:got.shape[0], :cs], got)
    assert (got < wl.BIG).any() and (got >= wl.BIG).any()


def test_refine_matches_reference(port_scene, ref_scene, monkeypatch):
    from directcomputeraytracing_tpu.accel import worklist as rwl

    _set_hier_min(monkeypatch, 2)
    o, d, _ = _rays(2 * wl.RB, seed=3)
    (od_r, tm_r), (od, tm) = _both_preps(o, d)
    _, _, _, _, cs, hyper = rwl._pad_tables(ref_scene)
    hsup_r, hbox_r, nh, hs = hyper
    tables = wl.scene_tables(port_scene)
    np.testing.assert_array_equal(np.asarray(hsup_r), tables.hsup.numpy())
    np.testing.assert_array_equal(np.asarray(hbox_r)[:nh], tables.hbox.numpy())
    nb_r = od_r.shape[1] // rwl.RB
    cap_h = int(min(max(nb_r * 8, 1024), rwl.MAX_HYPER, nb_r * nh))
    bfh, hyp_r, _, total, _ = rwl._compact_pairs(
        rwl._cull_super(hbox_r, od_r, tm_r, interpret=True), nh, cap_h)
    want = np.asarray(rwl._refine_items(hsup_r, hs, bfh, hyp_r, od_r, tm_r,
                                        cap_h, interpret=True))
    blk, hyp, _ = wl.compact_pairs(wl.cull_boxes_torch(tables.hbox, od, tm))
    assert int(total) == blk.shape[0] > 0
    np.testing.assert_array_equal(np.asarray(bfh)[:int(total)] >> 2,
                                  blk.numpy())
    np.testing.assert_array_equal(np.asarray(hyp_r)[:int(total)],
                                  hyp.numpy())
    got = wl.refine_torch(tables.hsup, blk, hyp, od, tm).numpy()
    np.testing.assert_array_equal(want[:int(total)], got)


@pytest.mark.parametrize("hier", [False, True], ids=["dense", "hyper"])
def test_items_match_reference_phases(port_scene, ref_scene, monkeypatch,
                                      hier):
    from directcomputeraytracing_tpu.accel import worklist as rwl

    _set_hier_min(monkeypatch, 2 if hier else 10 ** 9)
    o, d, _ = _rays(2 * wl.RB, seed=5)
    (od_r, tm_r), (od, tm) = _both_preps(o, d)
    ref = rwl._phases(ref_scene, od_r, tm_r, interpret=True)
    bf, sup_r, t_r = (np.asarray(x) for x in ref[2:5])
    valid = (bf & 1) == 1
    want = sorted(zip((bf[valid] >> rwl._BLOCK_SHIFT).tolist(),
                      t_r[valid].tolist(), sup_r[valid].tolist()))
    tables = wl.scene_tables(port_scene)
    assert (tables.hbox is not None) == hier
    items = wl.phases(tables, od, tm, plain=True)
    counts = (items.seg[1:] - items.seg[:-1]).long()
    blk = torch.repeat_interleave(torch.arange(counts.shape[0]), counts)
    got = list(zip(blk.tolist(), items.t_ent.tolist(), items.sup.tolist()))
    assert got == sorted(got)             # per block, front to back
    assert got == want
    np.testing.assert_array_equal(np.asarray(ref[6])[:counts.shape[0]],
                                  items.block_any.numpy())


def _assert_closest_close(want, got):
    t_w, u_w, v_w, tri_w, inst_w, back_w = (np.asarray(x) for x in want[:6])
    t_g, u_g, v_g, tri_g, inst_g, back_g = (x.numpy() for x in got[:6])
    hit = np.isfinite(t_w)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    assert 40 < hit.sum() < hit.size
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=T_RTOL, atol=0)
    for w, g in ((tri_w, tri_g), (inst_w, inst_g)):
        diff = np.nonzero(hit & (w != g))[0]
        assert (np.abs(t_g[diff] - t_w[diff]) <= TIE * t_w[diff]).all()
    same = hit & (tri_w == tri_g)
    np.testing.assert_allclose(u_g[same], u_w[same], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(v_g[same], v_w[same], rtol=2e-3, atol=2e-4)
    assert (back_g[same] == back_w[same]).mean() > 0.99
    iters = got[6].numpy()
    assert (iters[hit] > 0).all() and iters.max() < 4 * 256


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
@pytest.mark.parametrize("n_rays", [256, 2048])
def test_closest_matches_reference(port_scene, ref_scene, watertight,
                                   n_rays):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, _ = _rays(n_rays, seed=n_rays)
    want = rwl.worklist_closest_pallas(ref_scene, jnp.asarray(o),
                                       jnp.asarray(d), 0.0, interpret=True,
                                       watertight=watertight)
    got = wl.worklist_closest_torch(port_scene, torch.from_numpy(o),
                                    torch.from_numpy(d), 0.0, watertight)
    _assert_closest_close(want, got)


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
@pytest.mark.parametrize("t_max", ["per_ray", "0.25", "1.0"])
def test_any_matches_reference(port_scene, ref_scene, watertight, t_max):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, per_ray = _rays(2048, seed=2)
    tm = per_ray if t_max == "per_ray" else np.full(2048, float(t_max),
                                                   np.float32)
    want = np.asarray(rwl.worklist_any_pallas(
        ref_scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), 0.0,
        interpret=True, watertight=watertight))
    got = wl.worklist_any_torch(port_scene, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(tm),
                                0.0, watertight).numpy()
    np.testing.assert_array_equal(want, got)
    assert 0 < got.sum() < got.size


def test_hyper_entered_but_supers_all_culled_is_a_miss(monkeypatch):
    """A block whose hyper box is entered but whose member supers are all
    refined away has no item: its rays decode as misses. One hyper holds
    all 8 supers here, so that its box spans the gap the rays cross."""
    rs = np.random.default_rng(17)

    def tri_group(n, x0):
        cen = rs.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
        cen[:, 0] += x0
        v = (cen[:, None, :]
             + rs.uniform(-0.05, 0.05, (n, 3, 3))).astype(np.float32)
        return Mesh(positions=v.reshape(-1, 3),
                    indices=np.arange(3 * n).reshape(n, 3),
                    material_ids=np.zeros(n, np.int64), name=f"g{x0}")

    # two 1536-triangle groups far apart along x: the first median split
    # separates them, so supers stay group-local
    arrays, _ = flatten_scene(
        Scene(meshes=[tri_group(1536, 0.0), tri_group(1536, 30.0)],
              instances=[Instance(mesh=0), Instance(mesh=1)]), "cpu")
    monkeypatch.setattr(wl, "HIER_MIN", 2)
    monkeypatch.setattr(wl, "hyper_fanout", lambda cs: cs)
    tables = wl.scene_tables(arrays)
    assert tables.hbox.shape[0] == 1 and tables.sbox.shape[0] == 8
    n = wl.RB
    o = np.tile(np.asarray([[15.5, 0.5, -5.0]], np.float32), (n, 1))
    d = np.stack([rs.uniform(-0.01, 0.01, n), rs.uniform(-0.01, 0.01, n),
                  np.ones(n)], axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    od, tm, _ = wl.prep_rays(o, d)
    assert (wl.cull_boxes_torch(tables.hbox, od, tm) < wl.BIG).any()
    assert wl.phases(tables, od, tm, plain=True) is None
    hit = wl.worklist_closest_torch(arrays, o, d)
    assert not torch.isfinite(hit[0]).any() and not hit[6].any()
    assert not wl.worklist_any_torch(arrays, o, d, 50.0).any()


def test_cpu_intersector_runs_the_work_list_twins(port_scene):
    """On CPU tensors a clustered scene goes to the work-list twins, and
    nothing is launched."""
    o, d, t_max = (torch.from_numpy(x) for x in _rays(1500, seed=7))
    wl.reset_counters()
    hit = intersect_closest(port_scene, o, d)
    twin = wl.worklist_closest_torch(port_scene, o, d)
    for a, b in zip((hit.t, hit.u, hit.v, hit.triangle, hit.instance,
                     hit.backface, hit.iterations), twin):
        assert torch.equal(a, b)
    assert torch.equal(hit.hit, torch.isfinite(twin[0]))
    assert (hit.iterations[hit.hit] > 0).all()
    occ = intersect_any(port_scene, o, d, t_max)
    assert torch.equal(occ, wl.worklist_any_torch(port_scene, o, d, t_max))
    assert wl.counters() == dict.fromkeys(wl.counters(), 0)


def test_empty_casts_return_misses(port_scene):
    """Rays that enter no super: no items, no sweep, all misses."""
    n = 64
    o = torch.tensor([[0.0, 50.0, 0.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 1.0, 0.0]]).repeat(n, 1)
    wl.reset_counters()
    t, u, v, tri, inst, back, iters = wl.worklist_closest(port_scene, o, d)
    assert torch.isinf(t).all() and not back.any() and not iters.any()
    assert not wl.worklist_any(port_scene, o, d, 10.0).any()
    assert wl.counters()["closest_empty"] == wl.counters()["any_empty"] == 1
    none = torch.zeros((0, 3))
    assert wl.worklist_closest(port_scene, none, none)[0].shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
def test_cuda_kernels_match_twins(watertight, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    monkeypatch.setattr(wl, "HIER_MIN", 2)       # the refine runs too
    arrays, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], dev)
    o, d, t_max = (torch.from_numpy(x).to(dev) for x in _rays(100_003, 11))
    od, tm, _ = wl.prep_rays(o, d)
    tables = wl.scene_tables(arrays)
    wl.reset_counters()
    tlo = wl.cull_boxes(tables.hbox, od, tm)
    assert torch.equal(tlo, wl.cull_boxes_torch(tables.hbox, od, tm))
    blk, hyp, _ = wl.compact_pairs(tlo)
    assert torch.equal(wl.refine(tables.hsup, blk, hyp, od, tm),
                       wl.refine_torch(tables.hsup, blk, hyp, od, tm))
    got = wl.worklist_closest(arrays, o, d, 1e-4, watertight)
    want = wl.worklist_closest_torch(arrays, o, d, 1e-4, watertight)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    occ = wl.worklist_any(arrays, o, d, t_max, 1e-4, watertight)
    assert torch.equal(occ, wl.worklist_any_torch(arrays, o, d, t_max, 1e-4,
                                                  watertight))
    torch.cuda.synchronize()
    c = wl.counters()
    assert c["cull_boxes"] == 3 and c["refine"] == 3
    assert c["sweep_closest"] == c["sweep_any"] == 1
