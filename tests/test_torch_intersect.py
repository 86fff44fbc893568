"""The dense sweep: the port's PyTorch twins against the reference's Pallas
kernels (run in interpret mode on the CPU), and the CUDA kernels against
the twins on a card.

Tolerance against the reference: hit/miss, triangle id, instance id,
back-face flag and occlusion equal exactly on these seeded rays; t within
1e-5 (1 + t), u and v within 1e-5. The float tolerance is there because
XLA may fuse or reorder the float32 products of the interpret-mode kernel
(observed differences are below 1e-6); the seeded rays land no closer
than that to a triangle edge, so no hit flips.

Against the twin, the CUDA kernels are built without FMA contraction and
must agree bit for bit on integer fields and within the same 1e-5 bounds
on floats. The reference is imported inside the test that uses it, so
that on a card's machine, which has no jax, the `cuda` tests still run:
`python -m pytest --noconftest -m cuda tests/test_torch_intersect.py`.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import brute
from directcomputeraytracing_tpu_torch.accel.traverse import (
    intersect_any,
    intersect_closest,
    node_tables,
)
from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

TOL = 1e-5
T_MIN = 1e-4


class Soup(NamedTuple):
    """The two scene fields the dense sweep reads (a pytree for jax)."""
    world_tris: object
    world_tri_meta: object


def _cornell_soup():
    arrays, _ = flatten_scene(cornell_box("area", "glossy")[0], "cpu")
    return arrays.world_tris.numpy(), arrays.world_tri_meta.numpy()


def _random_soup(n=300, seed=4):
    rs = np.random.default_rng(seed)
    v0 = rs.uniform(-1.0, 1.0, (n, 3))
    tris = np.concatenate([v0, v0 + rs.normal(0, 0.3, (n, 3)),
                           v0 + rs.normal(0, 0.3, (n, 3))], axis=1)
    meta = np.stack([np.arange(n), rs.integers(0, 3, n),
                     rs.integers(0, 2, n)], axis=1)
    return tris.astype(np.float32), meta.astype(np.float32)


SOUPS = {"cornell": _cornell_soup, "soup300": _random_soup}


def _rays(n=2048, seed=1):
    """Rays from inside the Cornell box / around the random soup."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 3.0, n)
    return o.astype(np.float32), d.astype(np.float32), \
        t_max.astype(np.float32)


def _assert_closest_equal(want, got):
    t_w, u_w, v_w, tri_w, inst_w, back_w = (np.asarray(x) for x in want)
    t_g, u_g, v_g, tri_g, inst_g, back_g = (x.numpy() for x in got)
    hit = np.isfinite(t_w)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    assert hit.any() and not hit.all()
    for w, g in ((tri_w, tri_g), (inst_w, inst_g), (back_w, back_g)):
        np.testing.assert_array_equal(w[hit], g[hit])
    assert tri_g.dtype == inst_g.dtype == np.int32 and back_g.dtype == bool
    assert np.all(np.abs(t_w[hit] - t_g[hit]) <= TOL * (1 + np.abs(t_w[hit])))
    np.testing.assert_allclose(u_g[hit], u_w[hit], rtol=0, atol=TOL)
    np.testing.assert_allclose(v_g[hit], v_w[hit], rtol=0, atol=TOL)


@pytest.mark.parametrize("watertight", [False, True],
                         ids=["moeller", "watertight"])
@pytest.mark.parametrize("soup", list(SOUPS))
def test_twins_match_pallas(soup, watertight):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel.pallas_brute import (
        brute_any_pallas,
        brute_closest_pallas,
    )

    tris, meta = SOUPS[soup]()
    o, d, t_max = _rays()
    ref_scene = Soup(jnp.asarray(tris), jnp.asarray(meta))
    tab = torch.from_numpy(np.concatenate([tris, meta], axis=1))
    want = brute_closest_pallas(ref_scene, jnp.asarray(o), jnp.asarray(d),
                                T_MIN, interpret=True, watertight=watertight)
    got = brute.brute_closest_torch(tab, torch.from_numpy(o),
                                    torch.from_numpy(d), T_MIN, watertight)
    _assert_closest_equal(want, got)
    occ_w = np.asarray(brute_any_pallas(
        ref_scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), T_MIN,
        interpret=True, watertight=watertight))
    occ_g = brute.brute_any_torch(tab, torch.from_numpy(o),
                                  torch.from_numpy(d),
                                  torch.from_numpy(t_max), T_MIN,
                                  watertight).numpy()
    np.testing.assert_array_equal(occ_w, occ_g)
    assert 0 < occ_g.sum() < occ_g.size


def test_cpu_wrappers_run_the_twins():
    """On CPU tensors the wrappers are the twins and launch nothing."""
    tris, meta = _cornell_soup()
    scene = Soup(torch.from_numpy(tris), torch.from_numpy(meta))
    o, d, t_max = (torch.from_numpy(x) for x in _rays(512))
    before = brute.brute_closest.launches, brute.brute_any.launches
    hit = intersect_closest(scene_with_tables(scene), o, d, T_MIN)
    twin = brute.brute_closest_torch(brute.build_table(scene), o, d, T_MIN)
    for a, b in zip((hit.t, hit.u, hit.v, hit.triangle, hit.instance,
                     hit.backface), twin):
        assert torch.equal(a, b)
    assert torch.equal(hit.hit, torch.isfinite(twin[0]))
    occ = intersect_any(scene_with_tables(scene), o, d, t_max, T_MIN)
    assert torch.equal(occ, brute.brute_any_torch(brute.build_table(scene), o,
                                                  d, t_max, T_MIN))
    assert (brute.brute_closest.launches, brute.brute_any.launches) == before


class _Tables(NamedTuple):
    world_tris: torch.Tensor
    world_tri_meta: torch.Tensor
    cluster_bbox: torch.Tensor
    isup_inst: torch.Tensor


def scene_with_tables(soup, clusters=1, supers=1):
    return _Tables(soup.world_tris, soup.world_tri_meta,
                   torch.zeros(clusters, 8), torch.zeros(supers,
                                                         dtype=torch.int64))


def _walker_scene(case, monkeypatch):
    """The flattened scene of a walker case: Cornell (the dense sweep's),
    the small sphere grid (world-soup cluster tables: the work list's) or
    the same grid forced onto the instanced tables."""
    from directcomputeraytracing_tpu_torch.scene import scene as scene_mod
    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid

    if case == "backend":
        return flatten_scene(cornell_box("area", "glossy")[0], "cpu")[0]
    if case == "instanced":
        monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", 2048)
    return flatten_scene(sphere_grid(3, 3, stacks=12, slices=16)[0],
                         "cpu")[0]


def _box_rays(arrays, n, seed):
    """Rays from inside the scene's root box in random directions."""
    rs = np.random.default_rng(seed)
    root = node_tables(arrays).node_table[0].numpy()
    o = rs.uniform(root[0:3], root[3:6], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("case", ["clustered", "instanced", "backend",
                                  "alpha", "dtype"])
def test_unported_paths_raise(case, monkeypatch):
    """backend="jax" casts through the stack walker on every flattened
    scene: on Cornell (case "backend") against the dense sweep, on the
    clustered grid against the work list, on the instanced grid against
    the instanced sweep, all watertight: hit masks and t (1e-5 (1 + t))
    agree, ids but at near-ties (two hits within 2^-12 relative), and
    occlusion agrees. Alpha-tested casts run; a float64 ray raises."""
    if case in ("clustered", "instanced", "backend"):
        arrays = _walker_scene(case, monkeypatch)
        kinds = {"clustered": (False, True), "instanced": (True, False),
                 "backend": (False, False)}[case]
        assert (arrays.isup_inst.shape[0] > 1,
                arrays.cluster_bbox.shape[0] > 1) == kinds
        o, d = _box_rays(arrays, 512, 3)
        t_max = torch.full((512,), 0.5)
        walk = intersect_closest(arrays, o, d, T_MIN, backend="jax",
                                 watertight=True)
        other = intersect_closest(arrays, o, d, T_MIN, watertight=True)
        assert torch.equal(walk.hit, other.hit) and walk.hit.any()
        h = walk.hit
        assert torch.all(torch.abs(walk.t[h] - other.t[h])
                         <= TOL * (1 + other.t[h].abs()))
        same = (walk.triangle == other.triangle) & (
            walk.instance == other.instance)
        tie = torch.abs(walk.t - other.t) <= 2.0 ** -12 * other.t.abs()
        assert torch.all(same[h] | tie[h]), torch.nonzero(h & ~same & ~tie)
        assert (walk.iterations[h] > 0).all()
        occ_w = intersect_any(arrays, o, d, t_max, T_MIN, backend="jax",
                              watertight=True)
        occ_o = intersect_any(arrays, o, d, t_max, T_MIN, watertight=True)
        assert torch.equal(occ_w, occ_o) and occ_w.any() and not occ_w.all()
        return
    tris, meta = _cornell_soup()
    soup = Soup(torch.from_numpy(tris), torch.from_numpy(meta))
    o, d, _ = (torch.from_numpy(x) for x in _rays(8))
    if case == "alpha":
        # alpha-tested casts run (queue 1, item 4): samples of 0 accept
        # every hit of a half-transparent scene, so the opaque hit returns
        cornell = cornell_box("area", "glossy")[0]
        cornell.materials[0].opacity = 0.5
        arrays, meta = flatten_scene(cornell, "cpu")
        assert meta.any_non_opaque
        got = intersect_closest(arrays, o, d, opacity_u=torch.zeros(8))
        want = intersect_closest(arrays, o, d)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        return
    with pytest.raises(ValueError):
        intersect_closest(scene_with_tables(soup), o.double(), d)


@pytest.mark.cuda
@pytest.mark.parametrize("watertight", [False, True],
                         ids=["moeller", "watertight"])
def test_cuda_kernels_match_twins(watertight):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    tris, meta = _random_soup(2048)
    scene = Soup(torch.from_numpy(tris).to(dev), torch.from_numpy(meta).to(dev))
    o, d, t_max = (torch.from_numpy(x).to(dev) for x in _rays(100_003))
    tab = brute.build_table(scene)
    n_closest, n_any = brute.brute_closest.launches, brute.brute_any.launches
    got = brute.brute_closest(scene, o, d, T_MIN, watertight)
    want = brute.brute_closest_torch(tab, o, d, T_MIN, watertight)
    occ = brute.brute_any(scene, o, d, t_max, T_MIN, watertight)
    occ_twin = brute.brute_any_torch(tab, o, d, t_max, T_MIN, watertight)
    torch.cuda.synchronize()
    assert brute.brute_closest.launches == n_closest + 1
    assert brute.brute_any.launches == n_any + 1
    _assert_closest_equal([x.cpu().numpy() for x in want],
                          [x.cpu() for x in got])
    assert torch.equal(occ, occ_twin)
