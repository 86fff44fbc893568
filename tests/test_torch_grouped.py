"""The grouped work-list sweep, capped casts and slab marching: the port's
twins against the reference (Pallas kernels in interpret mode on the
CPU), against the port's per-ray twins, and the CUDA kernels against the
twins on a card.

Scene: `sphere_grid(3, 3, stacks=12, slices=16)`, 3172 world triangles in
256 clusters and 8 supers; rays from a numpy seed.

Tolerances against the reference: hit masks equal; t within rtol 3e-5
(XLA and PyTorch round the Baldwin-Weber chain differently: measured up
to 1.2e-5); triangle and instance ids
equal except at a near-tie, two hits whose t agree within 2^-12 relative (the packed
argmin truncates t to ~2^-14 relative and the two packages visit
clusters in different orders); u, v within 2e-3 (rtol) and 2e-4 (atol)
of the same triangle's; back-face flags equal on 99 % of hits (grazing
edges); occlusion equal. `iters` is not compared with the reference: its
grouped kernel counts 2 per step of a 128-lane group, the port the
clusters its 32-lane group swept while the ray took part. Against the
per-ray twins the grouped closest twin must agree bit for bit, `iters`
aside (the grouped any-hit sweep's twin is the per-ray one,
`sweep_any_torch`); the CUDA kernels must equal their twins bit for bit,
`iters` included
(`python -m pytest --noconftest -m cuda tests/test_torch_grouped.py` on
a card).
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import worklist as wl
from directcomputeraytracing_tpu_torch.accel.traverse import (
    SlabStats,
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
)
from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

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
    return flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], "cpu")[0]


@pytest.fixture(scope="module")
def ref_scene():
    from directcomputeraytracing_tpu.scene.presets import (
        sphere_grid as ref_grid,
    )
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    return ref_flatten(ref_grid(*GRID, **GRID_KW)[0])


def _rays(n, seed=0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 4.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 3.0, n).astype(np.float32)
    return o, d, t_max


def _assert_closest_close(want, got, min_hits=40):
    t_w, u_w, v_w, tri_w, inst_w, back_w = (np.asarray(x) for x in want[:6])
    t_g, u_g, v_g, tri_g, inst_g, back_g = (np.asarray(x) for x in got[:6])
    hit = np.isfinite(t_w)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    assert min_hits < hit.sum() < hit.size
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=T_RTOL, atol=0)
    for w, g in ((tri_w, tri_g), (inst_w, inst_g)):
        diff = np.nonzero(hit & (w != g))[0]
        assert (np.abs(t_g[diff] - t_w[diff]) <= TIE * t_w[diff]).all()
    same = hit & (tri_w == tri_g)
    np.testing.assert_allclose(u_g[same], u_w[same], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(v_g[same], v_w[same], rtol=2e-3, atol=2e-4)
    assert (back_g[same] == back_w[same]).mean() > 0.99


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
def test_grouped_closest_matches_reference(port_scene, ref_scene, watertight):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, _ = _rays(2048, seed=31)
    want = rwl.worklist_closest_pallas(ref_scene[0], jnp.asarray(o),
                                       jnp.asarray(d), 1e-4, interpret=True,
                                       watertight=watertight, grouped=True)
    got = wl.worklist_closest_torch(port_scene, torch.from_numpy(o),
                                    torch.from_numpy(d), 1e-4, watertight,
                                    grouped=True)
    _assert_closest_close(want, [x.numpy() for x in got])
    iters = got[6].numpy()
    assert (iters[np.isfinite(got[0].numpy())] > 0).all()


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
def test_grouped_any_matches_reference(port_scene, ref_scene, watertight):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, t_max = _rays(2048, seed=32)
    want = np.asarray(rwl.worklist_any_pallas(
        ref_scene[0], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        1e-4, interpret=True, watertight=watertight, grouped=True))
    got = wl.worklist_any_torch(port_scene, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(t_max),
                                1e-4, watertight, grouped=True).numpy()
    np.testing.assert_array_equal(want, got)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
@pytest.mark.parametrize("cap", [None, "scalar", "per_ray"])
def test_grouped_twins_equal_per_ray_twins(port_scene, watertight, cap):
    """The group order changes which clusters are swept, never the hit:
    sweep state and decoded hits equal bit for bit, `iters` aside."""
    o, d, t_max = (torch.from_numpy(x) for x in _rays(3 * wl.RB + 77, 33))
    t_cap = {None: None, "scalar": 1.5, "per_ray": t_max}[cap]
    per_ray = wl.worklist_closest_torch(port_scene, o, d, 1e-4, watertight,
                                        t_cap=t_cap)
    grouped = wl.worklist_closest_torch(port_scene, o, d, 1e-4, watertight,
                                        grouped=True, t_cap=t_cap)
    for a, b in zip(per_ray[:6], grouped[:6]):
        assert torch.equal(a, b)
    assert torch.isfinite(per_ray[0]).sum() > 100
    hit = torch.isfinite(grouped[0])
    assert (grouped[6][hit] >= per_ray[6][hit]).float().mean() > 0.9


@pytest.mark.parametrize("cap", ["scalar", "per_ray"])
@pytest.mark.parametrize("grouped", [False, True], ids=["bundle", "grouped"])
def test_t_cap_matches_reference(port_scene, ref_scene, cap, grouped):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, per_ray = _rays(2048, seed=34)
    t_cap = np.float32(1.2) if cap == "scalar" else per_ray
    want = rwl.worklist_closest_pallas(
        ref_scene[0], jnp.asarray(o), jnp.asarray(d), 1e-4, interpret=True,
        grouped=grouped, t_cap=jnp.asarray(t_cap))
    got = wl.worklist_closest_torch(
        port_scene, torch.from_numpy(o), torch.from_numpy(d), 1e-4,
        grouped=grouped, t_cap=torch.as_tensor(t_cap))
    _assert_closest_close(want, [x.numpy() for x in got])
    # the window contract: a capped hit below the cap is the full cast's
    full = wl.worklist_closest_torch(port_scene, torch.from_numpy(o),
                                     torch.from_numpy(d), 1e-4)
    t_c, t_f = got[0].numpy(), full[0].numpy()
    below = np.isfinite(t_c) & (t_c < t_cap)
    assert below.sum() > 30
    np.testing.assert_array_equal(t_c[below], t_f[below])
    assert not (np.isfinite(t_f) & ~np.isfinite(t_c)
                & (t_f < t_cap * (1 - TIE))).any()


@pytest.mark.parametrize("phases", [2, 3])
def test_slab_matches_reference_and_single_cast(port_scene, ref_scene,
                                                phases):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.traverse import (
        intersect_closest_slab as ref_slab,
    )

    o, d, _ = _rays(1024, seed=35 + phases)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    full = intersect_closest(port_scene, to, td, backend="pallas_wlg")
    # 40th percentile of the hit distances, moved off the hit it names:
    # a hit exactly at a window boundary may fall between two phases
    depth = float(np.percentile(full.t[full.hit].numpy(), 40)) * (1 + 1e-4)
    stats = SlabStats(phases)
    slab = intersect_closest_slab(port_scene, to, td, depth,
                                  backend="pallas_wlg", phases=phases,
                                  stats=stats)
    assert stats.casts[:2] == [1, 1] and stats.recast[0] > 0
    assert stats.host_reads >= 2
    assert torch.equal(slab.hit, full.hit)
    m = full.hit
    np.testing.assert_allclose(slab.t[m].numpy(), full.t[m].numpy(),
                               rtol=1e-6)
    near = (slab.triangle != full.triangle) & m
    assert ((slab.t - full.t).abs()[near] <= TIE * full.t[near]).all()
    assert (slab.iterations[m] > 0).all()
    want = ref_slab(ref_scene[0], jnp.asarray(o), jnp.asarray(d),
                    ref_scene[1].stack_size, jnp.float32(depth),
                    backend="pallas_wlg_interpret", phases=phases)
    _assert_closest_close(
        (want.t, want.u, want.v, want.triangle, want.instance,
         want.backface),
        [x.numpy() for x in slab[:6]])


def test_backend_names(port_scene):
    """'pallas_wl' is the bundle sweep, 'pallas_wlg' the grouped one; the
    intersector counts their launches on a card only. The stack walker
    ('jax') is not ported."""
    o, d, t_max = (torch.from_numpy(x) for x in _rays(600, seed=36))
    a = intersect_closest(port_scene, o, d, backend="pallas_wl")
    b = intersect_closest(port_scene, o, d, backend="auto")
    c = intersect_closest(port_scene, o, d, backend="pallas_wlg")
    for x, y, z in zip(a[:7], b[:7], c[:7]):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert torch.equal(intersect_any(port_scene, o, d, t_max,
                                     backend="pallas_wlg"),
                       intersect_any(port_scene, o, d, t_max))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        intersect_closest(port_scene, o, d, backend="jax")


@pytest.mark.cuda
@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
def test_cuda_grouped_kernels_match_twins(watertight):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    arrays, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], dev)
    o, d, t_max = (torch.from_numpy(x).to(dev) for x in _rays(100_003, 37))
    tables = wl.scene_tables(arrays)
    od, tm, _ = wl.prep_rays(o, d, t_max)
    items = wl.phases(tables, od, tm)
    texp = wl.scene_exit(tables, od)
    wl.reset_counters()
    got = wl.sweep_closest_grouped(tables, items, od, texp, 1e-4, watertight)
    want = wl.sweep_closest_grouped_torch(tables, items, od, texp, 1e-4,
                                          watertight)
    per_ray = wl.sweep_closest(tables, items, od, texp, 1e-4, watertight)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, c in zip(got[:7], per_ray[:7]):
        assert torch.equal(a, c)
    occ = wl.sweep_any_grouped(tables, items, od, tm, 1e-4, watertight)
    assert torch.equal(occ, wl.sweep_any_torch(tables, items, od, tm, 1e-4,
                                               watertight))
    assert torch.equal(occ, wl.sweep_any(tables, items, od, tm, 1e-4,
                                         watertight))
    cap = wl.worklist_closest(arrays, o, d, 1e-4, watertight, grouped=True,
                              t_cap=t_max)
    cap_twin = wl.worklist_closest_torch(arrays, o, d, 1e-4, watertight,
                                         grouped=True, t_cap=t_max)
    for a, b in zip(cap, cap_twin):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    c = wl.counters()
    assert c["sweep_closest_grouped"] == 2 and c["sweep_any_grouped"] == 1
