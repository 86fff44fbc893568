"""The pair sweep (`traversal_backend="pallas_pair"`, `pool_backend=
"pallas_pair"`): the port's twins against the reference's pair path
(Pallas in interpret mode on the CPU) and against the port's work list,
and the CUDA kernels against the twins on a card.

Scene: `sphere_grid(3, 3, stacks=12, slices=16)`, 3172 world triangles in
256 clusters and 8 supers; 512 rays from a numpy seed (as the reference's
own pair tests), Baldwin-Weber and watertight.

Tolerances:
- emission: the grid's rows equal the reference's `_pair_prep` rows, bit
  for bit, matched by (block, super): both run the same float32 slab
  test, and a ray that enters a super box does so before its scene exit,
  so the port's cap (the candidate window of bits(texp) | _LOWM) and the
  reference's (texp) admit the same rays.
- against the reference's casts: hit masks and occlusion equal; t within
  1e-6 relative with the watertight test (measured 4.8e-7) and 2e-5 with
  Baldwin-Weber (XLA and PyTorch round its chain apart: measured 6.4e-6
  here, up to 1.2e-5 on `tests/test_torch_grouped.py`'s rays); triangle
  and instance ids and back-face flags equal but at near-ties (t within
  2^-12 relative: the two packages order equal truncated keys
  differently).
- against the port's work list: every hit field bit for bit without
  t_cap; with a per-ray t_cap and a t_min floor, bit for bit on the hits
  below the cap; `iters` at least the work list's and equal to the plain
  cast's.
- renders, 32x32: the pair path's images equal the default path's within
  1e-6, slab-marched or not.
The reference is imported inside the tests that use it, so that on a
card's machine, which has no jax, the `cuda` test runs:
`python -m pytest --noconftest -m cuda tests/test_torch_pairsweep.py`.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
from directcomputeraytracing_tpu_torch.accel import worklist as wl
from directcomputeraytracing_tpu_torch.accel.traverse import (
    _resolve_backend,
    intersect_any,
    intersect_closest,
)
from directcomputeraytracing_tpu_torch.integrator import wavefront as wf
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
N_RAYS = 512
T_MIN = 1e-4
T_RTOL = {False: 2e-5, True: 1e-6}     # by watertight
TIE = 2.0 ** -12
RENDER = dict(width=32, height=32, max_bounce=4)
SPP = 2
IMG_TOL = 1e-6
KINDS = ("closest", "any")
TESTS = pytest.mark.parametrize("watertight", [False, True],
                                ids=["baldwin_weber", "watertight"])


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
    arrays, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], CPU)
    assert arrays.cluster_bbox.shape[0] > 1
    return arrays


@pytest.fixture(scope="module")
def ref_grid():
    from directcomputeraytracing_tpu.scene.presets import (
        sphere_grid as ref_sphere_grid,
    )
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    return ref_flatten(ref_sphere_grid(*GRID, **GRID_KW)[0])[0]


def _rays(n=N_RAYS, seed=0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 4.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 3.0, n).astype(np.float32)
    return o, d, t_max


def _torch_rays(seed=0):
    return tuple(torch.from_numpy(x) for x in _rays(seed=seed))


@pytest.fixture(scope="module")
def ref_casts(ref_grid):
    """The reference's pair casts (interpret mode), once per kind and
    test: {(kind, watertight): result}."""
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import pairsweep as rps

    o, d, t_max = (jnp.asarray(x) for x in _rays(seed=1))
    out = {}
    for wt in (False, True):
        out["closest", wt] = [np.asarray(x) for x in rps.pair_closest_pallas(
            ref_grid, o, d, T_MIN, interpret=True, watertight=wt)]
        out["any", wt] = np.asarray(rps.pair_any_pallas(
            ref_grid, o, d, t_max, T_MIN, interpret=True, watertight=wt))
    return out


def _port_cells(grid, kind, seed=2):
    """The port's emission on the test rays: (items, grid, od)."""
    o, d, t_max = _torch_rays(seed)
    tables = wl.scene_tables(grid)
    od, tm, _ = wl.prep_rays(o, d, None if kind == "closest" else t_max)
    texp = wl.scene_exit(tables, od)
    cap = wl._window(wl._float_bits(texp) | wl._LOWM) if kind == "closest" \
        else tm
    items = wl.phases(tables, od, tm)
    return items, ps.emit_pairs(tables, items, od, cap, T_MIN), od


@pytest.mark.parametrize("kind", KINDS)
def test_emission_matches_reference(grid, ref_grid, kind):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import pairsweep as rps

    o, d, t_max = (jnp.asarray(x) for x in _rays(seed=2))
    prep = rps._pair_prep(ref_grid, o, d, T_MIN, None, True,
                          t_max=None if kind == "closest" else t_max)
    blkflags, sup, fits, eb = (np.asarray(prep[i]) for i in (8, 9, 10, 13))
    assert fits
    valid = (blkflags & 1) == 1
    want = {(int(b), int(s)): row for b, s, row in
            zip(blkflags[valid] >> 2, sup[valid], eb[valid])}
    items, cells, _ = _port_cells(grid, kind)
    blk = ps.item_blocks(items).numpy()
    got = {(int(b), int(s)): row for b, s, row in
           zip(blk, items.sup.numpy(), cells.numpy())}
    assert got.keys() == want.keys() and len(got) > 4
    for key, row in got.items():
        np.testing.assert_array_equal(row, want[key], err_msg=str(key))
    assert 100 < cells.sum() < cells.numel()


@pytest.mark.parametrize("kind", KINDS)
def test_pair_layout(grid, kind):
    """Every set cell of the grid is exactly one pair, with its ray and its
    item's super; the launch list covers each super's run once in chunks;
    a super box holds each of its child boxes."""
    items, cells, _ = _port_cells(grid, kind)
    tables = wl.scene_tables(grid)
    it, lane = torch.nonzero(cells, as_tuple=True)
    pairs = ps.pair_list(tables, items, it, lane)
    blk = ps.item_blocks(items)
    want = sorted(zip((blk[it] * wl.RB + lane).tolist(),
                      items.sup[it].tolist()))
    assert sorted(zip(pairs.ray.tolist(), pairs.sup.tolist())) == want
    assert len(want) == int(cells.sum()) > 100
    assert torch.equal(pairs.sup, torch.sort(pairs.sup, stable=True)[0])
    np.testing.assert_array_equal(pairs.order.sort()[0].numpy(),
                                  np.arange(len(want)))
    size = ps.chunk(CPU)
    seen = torch.zeros(len(want), dtype=torch.int64)
    for s, f, c in zip(pairs.chunk_sup.tolist(), pairs.chunk_first.tolist(),
                       pairs.chunk_count.tolist()):
        assert 0 <= c <= size
        assert (pairs.sup[f:f + c] == s).all()
        seen[f:f + c] += 1
    assert (seen == 1).all()
    cbox, sbox = tables.cbox3, tables.sbox
    real = cbox[:, :, 0] <= cbox[:, :, 3]
    assert ((sbox[:, None, 0:3] <= cbox[:, :, 0:3]).all(2) | ~real).all()
    assert ((sbox[:, None, 3:6] >= cbox[:, :, 3:6]).all(2) | ~real).all()


@pytest.mark.parametrize("kind", KINDS)
@TESTS
def test_casts_match_reference(grid, ref_casts, kind, watertight):
    o, d, t_max = _torch_rays(seed=1)
    if kind == "any":
        got = ps.pair_any(grid, o, d, t_max, T_MIN, watertight)
        np.testing.assert_array_equal(got.numpy(), ref_casts[kind,
                                                             watertight])
        assert 0 < got.sum() < got.numel()
        return
    want = ref_casts[kind, watertight]
    t_w, tri_w, inst_w, back_w = want[0], want[3], want[4], want[5]
    got = [x.numpy() for x in ps.pair_closest(grid, o, d, T_MIN, watertight)]
    hit = np.isfinite(t_w)
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    assert 80 < hit.sum() < hit.size
    np.testing.assert_allclose(got[0][hit], t_w[hit], rtol=T_RTOL[watertight],
                               atol=0)
    with np.errstate(invalid="ignore"):
        near = hit & (np.abs(got[0] - t_w) <= TIE * np.abs(t_w))
    for w, g in ((tri_w, got[3]), (inst_w, got[4]), (back_w, got[5])):
        assert (hit & (w != g) & ~near).sum() == 0
    assert (got[6][hit] > 0).all()


@pytest.mark.parametrize("kind", KINDS)
@TESTS
def test_casts_equal_worklist(grid, kind, watertight):
    """Without t_cap the pair casts give the work list's hits bit for bit;
    `iters` is at least the work list's (no best across supers) and the
    plain cast's."""
    o, d, t_max = _torch_rays(seed=3)
    if kind == "any":
        got = ps.pair_any(grid, o, d, t_max, T_MIN, watertight)
        assert torch.equal(got, wl.worklist_any(grid, o, d, t_max, T_MIN,
                                                watertight))
        assert torch.equal(got, ps.pair_any_torch(grid, o, d, t_max, T_MIN,
                                                  watertight))
        assert 0 < got.sum() < got.numel()
        return
    got = ps.pair_closest(grid, o, d, T_MIN, watertight)
    want = wl.worklist_closest(grid, o, d, T_MIN, watertight)
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a, b)
    assert torch.isfinite(got[0]).sum() > 80
    assert (got[6] >= want[6]).all() and (got[6] > want[6]).any()
    plain = ps.pair_closest_torch(grid, o, d, T_MIN, watertight)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@TESTS
def test_capped_casts_equal_worklist_below_cap(grid, watertight):
    """With a per-ray t_cap and a t_min floor, the hits strictly below the
    cap are the work list's, bit for bit, and a miss of either is a miss
    below the cap of both."""
    o, d, t_cap = _torch_rays(seed=4)
    floor = 0.05
    got = ps.pair_closest(grid, o, d, floor, watertight, t_cap=t_cap)
    want = wl.worklist_closest(grid, o, d, floor, watertight, t_cap=t_cap)
    below_g, below_w = got[0] < t_cap, want[0] < t_cap
    assert torch.equal(below_g, below_w) and below_g.sum() > 30
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a[below_g], b[below_g])
    full = wl.worklist_closest(grid, o, d, floor, watertight)
    assert torch.equal(got[0][below_g], full[0][below_g])
    assert (got[0][below_g] >= floor).all()


@pytest.mark.parametrize("kind", KINDS)
def test_cut_casts_equal_whole_casts(grid, monkeypatch, kind):
    """A cast cut into emission ranges of two ray blocks and block-aligned
    pair ranges of ~200 pairs returns what the whole cast does (a ray's
    pairs stay in one range)."""
    o, d, t_max = (torch.from_numpy(x) for x in _rays(5 * wl.RB + 77, 8))
    if kind == "closest":
        def cast():
            return ps.pair_closest(grid, o, d, T_MIN)
    else:
        def cast():
            return (ps.pair_any(grid, o, d, t_max, T_MIN),)
    whole = cast()
    calls = []
    real = ps.pair_list

    def counted(*args):
        calls.append(args[2].shape[0])
        return real(*args)

    monkeypatch.setattr(ps, "GRID_CELLS", 2 * wl.SUPER // 4 * wl.RB)
    monkeypatch.setattr(ps, "RANGE_PAIRS", 200)
    monkeypatch.setattr(ps, "pair_list", counted)
    for a, b in zip(whole, cast()):
        assert torch.equal(a, b)
    assert len(calls) >= 4 and sum(calls) > 1000


def test_instanced_tables_take_the_instanced_sweep(monkeypatch):
    """On instanced tables "pallas_pair" resolves to the instanced sweep
    (the reference downgrades to its bundle sweep there): the same hits as
    "pallas_wl"; the pair casts themselves refuse those tables."""
    monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", 2048)
    inst, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], CPU)
    assert inst.isup_inst.shape[0] > 1
    assert _resolve_backend(inst, "pallas_pair") == "wl"
    o, d, t_max = _torch_rays(seed=5)
    a = intersect_closest(inst, o, d, backend="pallas_pair")
    b = intersect_closest(inst, o, d, backend="pallas_wl")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.hit.sum() > 80
    assert torch.equal(intersect_any(inst, o, d, t_max, backend="pallas_pair"),
                       intersect_any(inst, o, d, t_max, backend="pallas_wl"))
    with pytest.raises(ValueError, match="world-soup"):
        ps.pair_closest(inst, o, d)


def test_dense_scene_raises():
    dense, _ = flatten_scene(cornell_box("area", "glossy")[0], CPU)
    assert dense.cluster_bbox.shape[0] <= 1
    with pytest.raises(ValueError, match="cluster tables"):
        _resolve_backend(dense, "pallas_pair")


def test_empty_casts_return_misses(grid):
    """Rays that miss the scene box find no item: misses, no sweep, the
    casts counted empty; rays whose items hold no pair count as no-pair
    casts."""
    n = 300
    o = torch.tensor([[0.0, 50.0, 0.0]]).expand(n, 3).contiguous()
    d = torch.tensor([[0.0, 1.0, 0.0]]).expand(n, 3).contiguous()
    ps.reset_counters()
    t, u, v, tri, inst, back, iters = ps.pair_closest(grid, o, d)
    assert torch.isinf(t).all() and not back.any() and not iters.any()
    assert not (u.any() or v.any() or tri.any() or inst.any())
    assert not ps.pair_any(grid, o, d, 10.0).any()
    # rays inside the box whose t_min floor lies past every super
    o2, d2, _ = _torch_rays(seed=6)
    far = ps.pair_closest(grid, o2, d2, t_min=1e4)
    assert torch.isinf(far[0]).all()
    c = ps.counters()
    assert c["pair_closest_empty"] == 2 and c["pair_any_empty"] == 1
    assert c["pair_closest_no_pair"] == 1 and c["pair_any_no_pair"] == 0
    assert c["pair_emit"] == c["pair_sweep_closest"] == 0   # CPU: twins


@pytest.fixture(scope="module")
def images():
    """32x32 renders of the small grid at a fixed seed: the megakernel
    through the default work list and "pallas_pair", the wavefront's pool
    casts through the default grouped sweep and pool_backend="pallas_pair",
    each with slab marching on (0.03) and off."""
    out, stats = {}, {}
    scene, cam = sphere_grid(*GRID, **GRID_KW)
    for integrator, key, kw in (
            ("megakernel", "default", {}),
            ("megakernel", "pair", dict(traversal_backend="pallas_pair")),
            ("wavefront", "default", {}),
            ("wavefront", "pair", dict(pool_backend="pallas_pair"))):
        for slabs in ("on", "off"):
            march = 0.03 if slabs == "on" else (
                None if integrator == "megakernel" else 0.0)
            r = Renderer(scene, cam, RENDER["width"], RENDER["height"],
                         max_bounce=RENDER["max_bounce"],
                         integrator=integrator, device=CPU,
                         slab_march=march, **kw)
            out[integrator, key, slabs] = r.render(SPP)
            if integrator == "wavefront":
                stats[key, slabs] = dict(wf.LAST_STATS)
    return out, stats


@pytest.mark.parametrize("slabs", ["on", "off"])
@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_pair_renders_equal_default(images, integrator, slabs):
    imgs, stats = images
    a, b = imgs[integrator, "default", slabs], imgs[integrator, "pair", slabs]
    assert np.isfinite(b).all() and b.mean() > 0
    np.testing.assert_allclose(b, a, rtol=0, atol=IMG_TOL)
    if integrator == "wavefront":
        st = stats["pair", slabs]
        assert st["pool_backend"] == "pallas_pair"
        assert (st["slab_depth"] is not None) == (slabs == "on")
        if slabs == "on":
            assert st["closest_casts_per_phase"][1] > 0


@pytest.mark.parametrize("key", ["default", "pair"])
def test_slab_marched_megakernel_matches_unmarched(images, key):
    """slab_march=0.03 marches the megakernel's camera and bounce casts on
    the work list and the pair sweep (`tests/test_torch_backends.py`
    counts them): the image is the unmarched one within 1e-6 relative."""
    imgs, _ = images
    on, off = imgs["megakernel", key, "on"], imgs["megakernel", key, "off"]
    assert off.mean() > 0
    np.testing.assert_allclose(on, off, rtol=IMG_TOL, atol=0)


@pytest.mark.cuda
@TESTS
def test_cuda_kernels_match_twins(watertight):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    arrays, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], dev)
    tables = wl.scene_tables(arrays)
    rs = np.random.default_rng(7)
    n = 100_003
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(0.2, 4.0, n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 3.0, n).astype(np.float32)
    o, d, t_max = (torch.from_numpy(x).to(dev) for x in (o, d, t_max))
    ps.reset_counters()
    for kind in KINDS:
        od, tm, _ = wl.prep_rays(o, d, None if kind == "closest" else t_max)
        texp = wl.scene_exit(tables, od)
        cap = wl._window(wl._float_bits(texp) | wl._LOWM) \
            if kind == "closest" else tm
        items = wl.phases(tables, od, tm)
        cells = ps.emit_pairs(tables, items, od, cap, T_MIN)
        assert torch.equal(cells, ps.emit_pairs_torch(tables, items, od, cap,
                                                      T_MIN))
        pairs = ps.pair_list(tables, items,
                             *torch.nonzero(cells, as_tuple=True))
        if kind == "closest":
            got = ps.pair_sweep_closest(tables, pairs, od, texp, T_MIN,
                                        watertight)
            want = ps.pair_sweep_closest_torch(tables, pairs, od, texp, T_MIN,
                                               watertight)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            cast = ps.pair_closest(arrays, o, d, T_MIN, watertight)
            ref = wl.worklist_closest(arrays, o, d, T_MIN, watertight)
            for a, b in zip(cast[:6], ref[:6]):
                assert torch.equal(a, b)
        else:
            got = ps.pair_sweep_any(tables, pairs, od, tm, T_MIN, watertight)
            assert torch.equal(got, ps.pair_sweep_any_torch(
                tables, pairs, od, tm, T_MIN, watertight))
            assert torch.equal(ps.pair_any(arrays, o, d, t_max, T_MIN,
                                           watertight),
                               wl.worklist_any(arrays, o, d, t_max, T_MIN,
                                               watertight))
    torch.cuda.synchronize()
    c = ps.counters()
    assert c["pair_emit"] == 4 and c["pair_sweep_closest"] == 2
    assert c["pair_sweep_any"] == 2
