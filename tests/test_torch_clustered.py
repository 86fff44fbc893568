"""The clustered cull-and-sweep (`traversal_backend="pallas_cluster"`): the
port's twins against the reference's clustered kernels (Pallas in
interpret mode on the CPU) and its dense sweep, and the CUDA kernels
against the twins on a card.

Scene: `sphere_grid(3, 3, stacks=12, slices=16)`, 3172 world triangles in
256 clusters (16 groups); rays from a numpy seed: random rays from inside
the scene box, 32x32-tiled camera rays, and camera rays with parked lanes
(2e9 along +x), a NaN ray and a zero direction.

Tolerances:
- cull masks: bit-equal to the reference's interval cull on blocks whose
  1024 rays are all real and reach the scene (the port leaves the others
  out of a block's bounds, the reference pads with zero rays and takes
  every ray), and a superset of the reference's exact per-ray mask on
  every block. Both run the same float32 operations in the same order.
- casts, against the reference's clustered path and its dense sweep:
  hit masks and occlusion equal; t within 2e-6 relative (Moeller) and
  5e-6 (watertight): XLA's CPU code rounds the tests otherwise, measured
  up to 1.1e-6 and 3.3e-6; u and v within 1e-5 but for at
  most 1 hit in 100, none beyond 2e-4 (camera rays that graze the 9x9
  ground quad far off take u and v from cancelling products of large
  terms: measured at most 10 of 1780 camera hits beyond 1e-5, at most
  1.0e-4);
  triangle and
  instance ids equal except at exact-t ties (t within that tolerance,
  counted): the dense sweep visits the soup in another order than the
  cluster table. The reference's interpret path sweeps
  its exact masks, the port its interval masks under the warp admission
  (`tests/test_torch_cluster_admission.py`): both sweep every cluster
  whose box the ray's own slab test enters, so they could part only at
  an edge graze, which these sets do not hold.
- renders, 32x32 at 2 spp, against the reference's CPU renderer (its
  exact dense Moeller sweep): per pixel |port - reference| <= 2e-5
  (1 + |reference|) but for at most 2 of 1024 pixels, none beyond 1e-4
  but those 2; the port's wavefront and megakernel within 1e-6.
Against the twins, the CUDA kernels must agree bit for bit (built without
FMA contraction). The reference is imported inside the tests that use it,
so that on a card's machine, which has no jax, the `cuda` test runs:
`python -m pytest --noconftest -m cuda tests/test_torch_clustered.py`.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import brute
from directcomputeraytracing_tpu_torch.accel import clustered as cl
from directcomputeraytracing_tpu_torch.accel.traverse import (
    _resolve_backend,
    intersect_any,
    intersect_closest,
)
from directcomputeraytracing_tpu_torch.camera.camera import generate_ray
from directcomputeraytracing_tpu_torch.integrator.common import (
    RenderConfig,
    park_rays,
    pool_slab_march,
)
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    tiled_frame_pixels,
)
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod
from directcomputeraytracing_tpu_torch.scene.presets import (
    cornell_box,
    sphere_grid,
)
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

GRID = (3, 3)
GRID_KW = dict(stacks=12, slices=16)
CPU = torch.device("cpu")
N_RAYS = 2048
T_RTOL = {False: 2e-6, True: 5e-6}    # by watertight
UV_TOL, UV_MAX, UV_OFF = 1e-5, 2e-4, 1 / 100
RENDER = dict(width=32, height=32, max_bounce=4)
SPP = 2
PIXEL_TOL, PIXEL_MAX, MAX_DIVERGED = 2e-5, 1e-4, 2
WF_TOL = 1e-6
TESTS = pytest.mark.parametrize("watertight", [False, True],
                                ids=["moeller", "watertight"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid():
    scene, cam = sphere_grid(*GRID, **GRID_KW)
    arrays, _ = flatten_scene(scene, CPU)
    assert arrays.cluster_bbox.shape[0] > 1
    return arrays, cam


@pytest.fixture(scope="module")
def ref_grid():
    from directcomputeraytracing_tpu.scene.presets import (
        sphere_grid as ref_sphere_grid,
    )
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    return ref_flatten(ref_sphere_grid(*GRID, **GRID_KW)[0])


def _camera_rays(cam, n):
    """n pixel-centre camera rays of a 32-pixel-high frame in 32x32 tile
    order, so that a 1024-ray block is one tile."""
    cfg = RenderConfig(width=-(-n // 32), height=32)
    px, py, _ = tiled_frame_pixels(cfg, CPU)
    film = torch.stack([(px + 0.5) / cfg.width, (py + 0.5) / cfg.height], 1)
    o, d = generate_ray(cam, film.float()[:n], torch.zeros(n, 3))
    return o.contiguous(), d.contiguous()


def _rays(name, arrays, cam, n=N_RAYS):
    rs = np.random.default_rng(len(name) + n)
    if name == "random":
        lo = arrays.cluster_bbox[:, 0:3].amin(0).numpy()
        hi = arrays.cluster_bbox[:, 3:6].amax(0).numpy()
        o = rs.uniform(lo, hi, (n, 3))
        d = rs.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    else:
        o, d = _camera_rays(cam, n)
    if name == "parked":
        o, d = park_rays(torch.from_numpy(rs.random(n) < 0.7), o, d)
        o[3], d[4] = float("nan"), 0.0
    t_max = torch.from_numpy(rs.uniform(0.5, 30.0, n).astype(np.float32))
    return o.contiguous(), d.contiguous(), t_max


SETS = ("random", "camera", "parked")


def _far_padded(o, d):
    """(3, Rp) rows for the reference's mask functions, padded to 8 blocks
    with far rays along +x (its own zero padding enters clusters)."""
    import jax.numpy as jnp

    rp = -(-o.shape[0] // (8 * cl.RAY_BLOCK)) * 8 * cl.RAY_BLOCK
    pad = rp - o.shape[0]
    o = torch.cat([o, torch.full((pad, 3), 2e9)])
    d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]]).expand(pad, 3)])
    return jnp.asarray(o.T.numpy()), jnp.asarray(d.T.numpy())


def test_cluster_tables_match_reference(grid, ref_grid):
    from directcomputeraytracing_tpu.accel import pallas_brute as pb

    arrays, _ = grid
    ctab_r, cbox_r, n_groups = pb._pad_cluster_tables(ref_grid[0])
    tables = cl.pad_cluster_tables(arrays)
    assert tables is cl.pad_cluster_tables(arrays)      # cached
    assert tables.n_groups == n_groups == 16
    cg = tables.cbox.shape[0]
    np.testing.assert_array_equal(np.asarray(ctab_r)[:, :12],
                                  tables.ctab.numpy())
    np.testing.assert_array_equal(np.asarray(cbox_r).T[:cg],
                                  tables.cbox.numpy())


@pytest.mark.parametrize("name", SETS)
def test_cull_matches_reference(grid, ref_grid, name):
    from directcomputeraytracing_tpu.accel import pallas_brute as pb

    arrays, cam = grid
    o, d, _ = _rays(name, arrays, cam, N_RAYS + 300)   # a partial block
    tables = cl.pad_cluster_tables(arrays)
    cmask, gmask = cl.cull_masks_torch(tables, o, d)
    nb, cg = cmask.shape
    assert nb == 3 and gmask.shape == (3, tables.n_groups)
    ot, dt = _far_padded(o, d)
    want, gwant = (np.asarray(x)[:nb] for x in pb._cull_masks(
        pb._pad_cluster_tables(ref_grid[0]), ot, dt, interpret=True))
    reach = cl.reach_mask(tables, o, d)
    full = torch.nn.functional.pad(reach, (0, nb * cl.RAY_BLOCK - reach.shape[0]))
    live = full.view(nb, -1).all(1).numpy()
    if name == "random":
        assert live.tolist() == [True, True, False]
    np.testing.assert_array_equal(want[live, :cg], cmask.numpy()[live])
    np.testing.assert_array_equal(gwant[live], gmask.numpy()[live])
    # sound on every block: a superset of the exact per-ray mask
    exact, gexact = pb._exact_masks(ref_grid[0], ot, dt, tables.n_groups)
    exact = np.asarray(exact)[:nb]
    np.testing.assert_array_equal(exact, cl.exact_masks_torch(arrays, o,
                                                              d)[0].numpy())
    assert (cmask.numpy() >= exact).all()
    assert (gmask.numpy() >= np.asarray(gexact)[:nb]).all()
    if name != "random":      # coherent tiles cull most clusters
        assert cmask.float().mean() < 0.5 and exact.sum() > 0


def _assert_casts_close(want, got, occ_want, occ_got, rtol):
    """The cast tolerances; returns the number of exact-t ties."""
    t_w, u_w, v_w, tri_w, inst_w, back_w = (np.asarray(x) for x in want)
    t_g, u_g, v_g, tri_g, inst_g, back_g = (x.numpy() for x in got)
    hit = np.isfinite(t_w)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    assert 100 < hit.sum() < hit.size
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=rtol, atol=0)
    ids = hit & ((tri_w != tri_g) | (inst_w != inst_g))
    assert (np.abs(t_g[ids] - t_w[ids]) <= rtol * t_w[ids]).all()
    same = hit & ~ids
    duv = np.maximum(np.abs(u_g - u_w), np.abs(v_g - v_w))[same]
    assert (duv > UV_TOL).mean() <= UV_OFF and duv.max() <= UV_MAX
    np.testing.assert_array_equal(back_g[same], back_w[same])
    np.testing.assert_array_equal(np.asarray(occ_want), occ_got.numpy())
    return int(ids.sum())


@TESTS
@pytest.mark.parametrize("name", SETS)
def test_casts_match_reference(grid, ref_grid, name, watertight):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import pallas_brute as pb
    from directcomputeraytracing_tpu.accel import traverse as rtr

    arrays, cam = grid
    o, d, t_max = _rays(name, arrays, cam)
    got = cl.clustered_closest_torch(arrays, o, d, 1e-4, watertight)
    occ = cl.clustered_any_torch(arrays, o, d, t_max, 1e-4, watertight)
    assert 0 < occ.sum() < occ.numel()
    oj, dj, tj = (jnp.asarray(x.numpy()) for x in (o, d, t_max))
    want = pb.clustered_closest_pallas(ref_grid[0], oj, dj, 1e-4,
                                       interpret=True, watertight=watertight)
    occ_w = pb.clustered_any_pallas(ref_grid[0], oj, dj, tj, 1e-4,
                                    interpret=True, watertight=watertight)
    rtol = T_RTOL[watertight]
    assert _assert_casts_close(want, got, occ_w, occ, rtol) == 0
    stack = ref_grid[1].stack_size
    hit = rtr.intersect_closest(ref_grid[0], oj, dj, stack, 1e-4,
                                backend="brute", watertight=watertight)
    occ_b = rtr.intersect_any(ref_grid[0], oj, dj, tj, stack, 1e-4,
                              backend="brute", watertight=watertight)
    ties = _assert_casts_close(hit[:6], got, occ_b, occ, rtol)
    assert ties <= 4
    # and the port's own dense sweep over the soup, bit for bit on t
    dense = brute.brute_closest_torch(brute.build_table(arrays), o, d, 1e-4,
                                      watertight)
    assert torch.equal(dense[0], got[0])


def test_cpu_intersector_runs_the_twins(grid):
    """On CPU tensors "pallas_cluster" runs the twins and launches
    nothing; `iterations` is 0."""
    arrays, cam = grid
    o, d, t_max = _rays("camera", arrays, cam)
    cl.reset_counters()
    hit = intersect_closest(arrays, o, d, backend="pallas_cluster")
    twin = cl.clustered_closest_torch(arrays, o, d)
    for a, b in zip(hit[:6], twin):
        assert torch.equal(a, b)
    assert torch.equal(hit.hit, torch.isfinite(twin[0]))
    assert not hit.iterations.any()
    occ = intersect_any(arrays, o, d, t_max, backend="pallas_cluster")
    assert torch.equal(occ, cl.clustered_any_torch(arrays, o, d, t_max))
    assert cl.counters() == dict.fromkeys(cl.counters(), 0)


def test_backend_resolution(grid, monkeypatch):
    """"pallas_cluster" needs world-soup cluster tables: a dense scene and
    instanced tables raise ValueError. Its pool casts march no slabs."""
    arrays, _ = grid
    assert _resolve_backend(arrays, "pallas_cluster") == "cluster"
    dense, _ = flatten_scene(cornell_box("area", "glossy")[0], CPU)
    monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", 2048)
    inst, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], CPU)
    assert inst.isup_inst.shape[0] > 1
    for scene in (dense, inst):
        with pytest.raises(ValueError):
            _resolve_backend(scene, "pallas_cluster")
    cfg = RenderConfig(width=8, height=8)
    assert pool_slab_march(arrays, cfg, "pallas_cluster") == 0.0
    assert pool_slab_march(arrays, cfg, "pallas_wlg") > 0.0


@pytest.fixture(scope="module")
def ref_image():
    from directcomputeraytracing_tpu.integrator.renderer import (
        Renderer as RefRenderer,
    )
    from directcomputeraytracing_tpu.scene.presets import (
        sphere_grid as ref_sphere_grid,
    )

    ref = RefRenderer(*ref_sphere_grid(*GRID, **GRID_KW), RENDER["width"],
                      RENDER["height"], max_bounce=RENDER["max_bounce"],
                      traversal_backend="brute")
    return ref.render(SPP)


@pytest.fixture(scope="module")
def port_images():
    """The port's megakernel and wavefront images through "pallas_cluster"
    (rendered once), and the wavefront's LAST_STATS."""
    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    imgs = {}
    for integrator in ("megakernel", "wavefront"):
        r = Renderer(*sphere_grid(*GRID, **GRID_KW), RENDER["width"],
                     RENDER["height"], max_bounce=RENDER["max_bounce"],
                     integrator=integrator, device=CPU,
                     traversal_backend="pallas_cluster")
        assert r._inv is not None           # tiles, sorted bounces
        imgs[integrator] = r.render(SPP)
    return imgs, dict(wf.LAST_STATS)


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_renders_match_reference(ref_image, port_images, integrator):
    imgs, stats = port_images
    img = imgs[integrator]
    assert np.isfinite(img).all() and img.mean() > 0
    rel = (np.abs(img - ref_image).max(-1)
           / (1 + np.abs(ref_image).max(-1)))
    assert (rel > PIXEL_TOL).sum() <= MAX_DIVERGED, np.sort(rel.ravel())[-4:]
    assert (rel > PIXEL_MAX).sum() <= MAX_DIVERGED
    if integrator == "wavefront":
        assert stats["pool_backend"] == "pallas_cluster"
        assert stats["slab_depth"] is None
        np.testing.assert_allclose(img, imgs["megakernel"], rtol=0,
                                   atol=WF_TOL)


@pytest.mark.cuda
@TESTS
def test_cuda_kernels_match_twins(watertight):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    scene, cam = sphere_grid(*GRID, **GRID_KW)
    arrays, _ = flatten_scene(scene, dev)
    cpu_arrays, _ = flatten_scene(scene, CPU)
    o, d, t_max = (x.to(dev) for x in _rays("parked", cpu_arrays, cam,
                                              100_003))
    tables = cl.pad_cluster_tables(arrays)
    cl.reset_counters()
    cmask, gmask = cl.cull_masks(tables, o, d)
    want = cl.cull_masks_torch(tables, o, d)
    assert torch.equal(cmask, want[0]) and torch.equal(gmask, want[1])
    got = cl.sweep_closest(tables, cmask, gmask, o, d, 1e-4, watertight)
    twin = cl.sweep_closest_torch(tables, cmask, gmask, o, d, 1e-4,
                                  watertight)
    for a, b in zip(got, twin):
        assert torch.equal(a, b)
    occ = cl.sweep_any(tables, cmask, gmask, o, d, t_max, 1e-4, watertight)
    assert torch.equal(occ, cl.sweep_any_torch(tables, cmask, gmask, o, d,
                                               t_max, 1e-4, watertight))
    torch.cuda.synchronize()
    assert cl.counters() == dict(cluster_cull=1, cluster_closest=1,
                                 cluster_any=1)
