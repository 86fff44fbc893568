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


# ---------------------------------------------------------------------------
# the emission's launch shape, the census (CPU) and the redesigned kernels
# (card)
# ---------------------------------------------------------------------------

# items per ray block: none, one, two, hundreds, a single block, and a
# cast like the sorted pool's (0-450 items a block, 512 supers)
SEG_COUNTS = {
    "empty": [0, 0, 0],
    "ones": [1] * 5,
    "twos": [2, 0, 2, 0, 2],
    "hundreds": [300, 0, 450, 17, 16, 32, 0],
    "single": [437],
    "pool_like": np.random.default_rng(11).integers(0, 451, 256).tolist(),
}


def _emit_tiles(seg, split):
    """The emission kernel's work as csrc/pairsweep.cu's emit_kernel walks
    it: CUDA block (b, y) takes slices y, y + split, ... of EMIT_SLICE
    items of ray block b's list (seg, the (nb + 1,) item offsets) and
    exits before reading anything where it has none -> (ray block,
    blockIdx.y, first item, items) per slice."""
    seg = [int(x) for x in seg]
    out = []
    for b in range(len(seg) - 1):
        n = seg[b + 1] - seg[b]
        for k in range(-(-n // ps.EMIT_SLICE)):
            out.append((b, k % split, seg[b] + k * ps.EMIT_SLICE,
                        min(ps.EMIT_SLICE, n - k * ps.EMIT_SLICE)))
    return out


@pytest.mark.parametrize("shape", list(SEG_COUNTS))
def test_emit_tiles_cover_every_item_once(shape):
    """The emission's tiles (ray block, blockIdx.y, first item, items)
    under `emit_shape`'s split: every item exactly once, each tile inside
    its ray block's list and at most a slice long, no tile for a ray
    block without items, blockIdx.y below the split; a CUDA block takes
    one slice of a list up to EMIT_SKEW times the mean, the split fills
    the card on casts of few ray blocks and never exceeds the slices of
    the longest list a cast can hold."""
    counts = SEG_COUNTS[shape]
    seg = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nb, n = len(counts), int(seg[-1])
    n_supers, sms = 512, 132
    split = ps.emit_shape(nb, n, n_supers, sms)
    most = -(-min(n, n_supers) // ps.EMIT_SLICE)
    assert 1 <= split <= max(1, most)
    assert split >= min(most, -(-ps.EMIT_FILL * sms // nb))
    tiles = _emit_tiles(torch.from_numpy(seg), split)
    seen = np.zeros(n, dtype=np.int64)
    for b, y, first, count in tiles:
        assert counts[b] > 0 and 0 <= y < split
        assert 1 <= count <= ps.EMIT_SLICE
        assert seg[b] <= first and first + count <= seg[b + 1]
        seen[first:first + count] += 1
    assert (seen == 1).all()
    assert {t[0] for t in tiles} == {b for b, c in enumerate(counts) if c}
    # a CUDA block's share: its ray block's slices y, y + split, ...
    per_block = {}
    for b, y, _, count in tiles:
        per_block[b, y] = per_block.get((b, y), 0) + count
    for (b, _), items in per_block.items():
        assert items <= -(-counts[b] // (ps.EMIT_SLICE * split)) \
            * ps.EMIT_SLICE
        if counts[b] <= ps.EMIT_SKEW * -(-n // nb) + ps.EMIT_SLICE:
            assert items <= ps.EMIT_SLICE


def _tile_grid(tables, items, od, cap, t_min):
    """The enter grid built tile by tile, as the kernel walks its work:
    each tile's rays against its slice's super boxes."""
    split = ps.emit_shape(items.seg.shape[0] - 1, items.sup.shape[0],
                          tables.sbox.shape[0], 132)
    out = torch.zeros((items.sup.shape[0], wl.RB), dtype=torch.uint8)
    lane = torch.arange(wl.RB)
    for b, _, first, count in _emit_tiles(items.seg, split):
        rays = b * wl.RB + lane
        box = tables.sbox[items.sup[first:first + count].long()]
        t_lo = torch.full((count, wl.RB), -wl.BIG)
        t_hi = torch.full_like(t_lo, wl.BIG)
        for ax in range(3):
            t_lo, t_hi = wl._slab(box[:, ax, None], box[:, 3 + ax, None],
                                  od[ax][rays], od[6 + ax][rays], t_lo, t_hi)
        out[first:first + count] = ((t_hi >= t_lo) & (t_hi >= 0.0)
                                    & (t_lo < cap[rays]) & (t_hi >= t_min))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_emission_by_tiles_and_ranges_equals_reference_grid(grid, kind,
                                                            monkeypatch):
    """The grid built tile by tile (`_emit_tiles`), and `emit_pairs` on
    the per-block offsets of each emission range of a cast cut into ranges
    of one ray block (`_grid_ranges`, seg renumbered from the range's
    first block), equal `emit_pairs_torch`'s grid, which equals the
    reference's rows (`test_emission_matches_reference`)."""
    o, d, t_max = (torch.from_numpy(x) for x in _rays(3 * wl.RB + 77, 9))
    tables = wl.scene_tables(grid)
    od, tm, _ = wl.prep_rays(o, d, None if kind == "closest" else t_max)
    texp = wl.scene_exit(tables, od)
    cap = wl._window(wl._float_bits(texp) | wl._LOWM) if kind == "closest" \
        else tm
    items = wl.phases(tables, od, tm)
    want = ps.emit_pairs_torch(tables, items, od, cap, T_MIN)
    assert torch.equal(_tile_grid(tables, items, od, cap, T_MIN), want)
    assert torch.equal(ps.emit_pairs(tables, items, od, cap, T_MIN), want)
    monkeypatch.setattr(ps, "GRID_CELLS", wl.RB)
    ranges = ps._grid_ranges(items)
    assert len(ranges) == 4
    got = []
    for b0, sub in ranges:
        assert sub.seg.dtype == torch.int32 and int(sub.seg[0]) == 0
        r0, r1 = b0 * wl.RB, (b0 + sub.seg.shape[0] - 1) * wl.RB
        got.append(ps.emit_pairs(tables, sub, od[:, r0:r1].contiguous(),
                                 cap[r0:r1].contiguous(), T_MIN))
    assert torch.equal(torch.cat(got), want)
    assert 100 < int(want.sum()) < want.numel()


def _plain_census(tables, pairs, od, cap, tm, watertight, texp=None):
    """pair_census's per-pair and per-warp numbers by a loop over the
    launch list's chunks, warps and pairs, the balanced walk played out
    round by round, and (texp) each pair's nearest-first walk."""
    tab = tables.ctab if watertight else tables.bwtab

    def hits(ray, sup, k):
        rows = (sup * wl.SUPER + k) * 16 + torch.arange(16)
        return bool(wl._tri_rows(
            tab[rows][None], od[0:3, ray][None, None],
            od[3:6, ray][None, None], T_MIN, tm[ray:ray + 1][:, None],
            watertight)[4].any())

    def walk(ray, sup, mask, tl, best):
        """The twin's nearest-first walk of one pair, each cluster tested
        under the window of the current best: the clusters it sweeps."""
        rows16 = torch.arange(16)
        n = 0
        for k in sorted(mask, key=lambda k: (float(tl[k]), k)):
            window = wl._window(best)
            if not bool(tl[k] < window):
                break
            n += 1
            rows = (sup * wl.SUPER + k) * 16 + rows16
            t, _, _, _, ok = wl._tri_rows(
                tab[rows][None], od[0:3, ray][None, None],
                od[3:6, ray][None, None], T_MIN, window[:, None], watertight)
            key = (wl._float_bits(t[0]) & ~wl._LOWM) \
                | ((k << 4) + rows16).to(torch.int32)
            cand = torch.where(ok[0], key, wl._I32_MAX).min()
            best = torch.minimum(best, cand[None])
        return n

    enters, lanes, unions, walked, rounds, tested = [], [], [], 0, [], 0
    swept, longest, rounds_a = [], [], []
    for f, c in zip(pairs.chunk_first.tolist(), pairs.chunk_count.tolist()):
        for w0 in range(f, f + c, 32):
            masks, tasks, walks = [], [], []
            for j in range(w0, min(w0 + 32, f + c)):
                ray, sup = int(pairs.ray[j]), int(pairs.sup[j])
                enter, tl = wl._fine_cull(tables.cbox3[sup:sup + 1],
                                          od[:, ray:ray + 1],
                                          cap[ray:ray + 1], T_MIN)
                mask = [k for k in range(wl.SUPER) if bool(enter[0, k])]
                masks.append(mask)
                if texp is not None:
                    walks.append(walk(ray, sup, mask, tl[0], wl._float_bits(
                        texp[ray:ray + 1]) | wl._LOWM))
                if tm is None or not float(tm[ray]) > T_MIN:
                    continue
                for k in mask:
                    walked += 1
                    if hits(ray, sup, k):
                        break
                tasks += [(j, ray, sup, k) for k in mask]
            enters += [len(m) for m in masks]
            lanes.append(max(len(m) for m in masks))
            unions.append(len(set().union(*masks)))
            if texp is not None:
                swept += walks
                longest.append(max(walks))
                rounds_a.append(-(-sum(len(m) for m in masks) // 32))
            done = set()
            rounds.append(-(-len(tasks) // 32))
            for r0 in range(0, len(tasks), 32):
                found = set()
                for j, ray, sup, k in tasks[r0:r0 + 32]:
                    if j not in done:
                        tested += 1
                        if hits(ray, sup, k):
                            found.add(j)
                done |= found
    out = dict(clusters_per_pair=np.mean(enters), warp_max_lane=np.mean(lanes),
               warp_union=np.mean(unions), warps=len(lanes))
    if texp is not None:
        out.update(closest_swept_per_pair=np.mean(swept),
                   closest_warp_longest=np.mean(longest),
                   closest_rounds_a=np.mean(rounds_a))
    if tm is not None:
        out.update(any_walked=walked,
                   any_clusters_per_pair=walked / len(enters),
                   any_warp_rounds=np.mean(rounds),
                   any_tested_per_pair=tested / len(enters))
    return out


@pytest.mark.parametrize("kind,watertight", [
    ("closest", False), ("closest", True), ("any", False), ("any", True)])
def test_pair_census_matches_plain_loop(grid, kind, watertight):
    """`tools/pair_ab.py` `pair_census` against a loop over the launch
    list's warps and their pairs (the fine cull of each pair; closest:
    its nearest-first walk, row 16's two schedules; any-hit: its walk up
    to its first hit, the balanced walk's rounds and tasks), on the small
    grid's test rays."""
    from directcomputeraytracing_tpu_torch.tools.pair_ab import pair_census

    o, d, t_max = _torch_rays(seed=2)
    t_max[::17] = 0.0          # empty windows: no walk
    tables = wl.scene_tables(grid)
    od, tm, _ = wl.prep_rays(o, d, None if kind == "closest" else t_max)
    texp = wl.scene_exit(tables, od)
    cap = wl._window(wl._float_bits(texp) | wl._LOWM) if kind == "closest" \
        else tm
    items = wl.phases(tables, od, tm)
    cells = ps.emit_pairs(tables, items, od, cap, T_MIN)
    pairs = ps.pair_list(tables, items, *torch.nonzero(cells, as_tuple=True))
    closest = texp if kind == "closest" else None
    got = pair_census(tables, items, pairs, od, cap, T_MIN, o.shape[0],
                      tm if kind == "any" else None, watertight, closest)
    want = _plain_census(tables, pairs, od, cap,
                         tm if kind == "any" else None, watertight, closest)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key
    seg = items.seg.long()
    assert got["pairs"] == int(cells.sum()) == pairs.ray.shape[0] > 100
    assert got["items_per_block_max"] == int((seg[1:] - seg[:-1]).max())
    assert got["set_cell_share"] == pytest.approx(
        float(cells.double().mean()), rel=1e-12)
    assert 0 < got["full_chunk_share"] <= 1 or got["pairs"] < 256
    if kind == "any":
        assert 0 < got["any_walked"] <= got["any_tested_per_pair"] \
            * got["pairs"] <= got["clusters_per_pair"] * got["pairs"]
        assert got["any_rows_per_pair"] == 16 * got["any_tested_per_pair"]
    else:
        assert 0 < got["closest_swept_per_pair"] < got["clusters_per_pair"]
        assert got["closest_warp_longest"] >= 1 <= got["closest_rounds_a"]


def _closest_pairs(grid):
    """The closest cast's pair list on the test rays: (tables, o, d, od,
    texp, items, pairs)."""
    o, d, _ = _torch_rays(seed=2)
    tables = wl.scene_tables(grid)
    od, tm, _ = wl.prep_rays(o, d)
    texp = wl.scene_exit(tables, od)
    items = wl.phases(tables, od, tm)
    cells = ps.emit_pairs(tables, items, od, wl._window(
        wl._float_bits(texp) | wl._LOWM), T_MIN)
    pairs = ps.pair_list(tables, items, *torch.nonzero(cells, as_tuple=True))
    return tables, o, d, od, texp, items, pairs


@TESTS
def test_closest_replay_matches_twin_and_worklist(grid, watertight):
    """Row 16's schedule (`tools/pair_ab.py` `closest_replay`: least keys
    per entered cluster under the initial window, then the replay) equals
    `pair_sweep_closest_torch` in all 8 per-pair outputs bit for bit, on
    the grid's closest pairs with some rays' texp at +inf or cut to a
    third (their walks stop early), and through `reduce_closest` equals
    `worklist_closest` in every hit field."""
    from directcomputeraytracing_tpu_torch.tools import pair_ab

    tables, o, d, od, texp, items, pairs = _closest_pairs(grid)
    cut = texp.clone()
    cut[::11] = float("inf")
    cut[5::11] *= 1.0 / 3.0
    want = ps.pair_sweep_closest_torch(tables, pairs, od, cut, T_MIN,
                                       watertight)
    got = pair_ab.closest_replay(tables, pairs, od, cut, T_MIN, watertight)
    for name, a, b in zip(("best", "t", "u", "v", "tri", "inst", "back",
                           "iters"), got, want):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b), name
    # the cases: texp +inf, empty masks, walks that stop before their last
    # entered cluster, and walks of several clusters
    b0, enter, _, _ = pair_ab._closest_keys(tables, pairs.ray.long(),
                                           pairs.sup.long(), od, cut, T_MIN,
                                           watertight)
    inf = torch.isinf(cut[pairs.ray.long()])
    n_enter = enter.sum(1).to(torch.int32)
    assert inf.any() and (n_enter[inf] == 0).all()
    assert ((n_enter == 0) & ~inf).any()
    assert (want[7] < n_enter).any() and (want[7] >= 2).any()
    assert (want[7] > 0).any() and (want[0] < b0).any()
    # through the reduction, with the cast's own texp
    state = ps._initial_state(texp)
    ps.reduce_closest(state, pair_ab.closest_replay(
        tables, pairs, od, texp, T_MIN, watertight), pairs, texp)
    cast = wl.decode_closest(state, texp, items.block_any, o.shape[0])
    ref = wl.worklist_closest(grid, o, d, T_MIN, watertight)
    for name, a, b in zip(("t", "u", "v", "tri", "inst", "back"), cast, ref):
        assert torch.equal(a, b), name
    assert torch.isfinite(ref[0]).sum() > 50


@pytest.fixture(scope="module")
def cuda_tables():
    """sphere_grid(12, 12)'s tables on the card (512 supers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    arrays, _ = flatten_scene(sphere_grid(12, 12)[0], torch.device("cuda"))
    return wl.scene_tables(arrays)


def _edge_rays(tables, n, seed):
    """n rays inside the grid's box (numpy seed), with parked lanes past
    n, origins on child-box planes, zero direction components, and
    t_max at, below and on t_min and NaN."""
    rs = np.random.default_rng(seed)
    lo, hi = (tables.bounds[i].cpu().numpy() for i in (0, 1))
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 30.0, n).astype(np.float32)
    boxes = tables.cbox3.reshape(-1, 8).cpu().numpy()
    real = boxes[boxes[:, 0] <= boxes[:, 3]]
    pick = real[rs.integers(0, real.shape[0], n // 8)]
    on = rs.choice(n, n // 8, replace=False)
    ax = rs.integers(0, 3, n // 8)
    o[on, ax] = pick[np.arange(n // 8), ax]          # on a lo plane
    o[on[::2], ax[::2]] = pick[np.arange(0, n // 8, 2), 3 + ax[::2]]
    d[rs.choice(n, n // 16, replace=False), rs.integers(0, 3)] = 0.0
    t_max[::29] = 0.0
    t_max[1::29] = T_MIN
    t_max[2::29] = T_MIN / 2
    t_max[3::29] = np.nan
    return tuple(torch.from_numpy(x).cuda() for x in (o, d, t_max))


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[0, 1, 37, 16, 0, 5], [0, 0, 1],
                                    [200, 3, 0, 17]],
                         ids=["mixed", "sparse", "long"])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_emission_matches_twin_on_item_lists(cuda_tables, counts,
                                                  kind):
    """The emission kernel against its twin, bit for bit, on item lists
    of chosen lengths (ray blocks of 0 and 1 items, longer than a slice,
    n_items not a multiple of the slice), rays with parked lanes, origins
    on box planes and empty windows."""
    tables = cuda_tables
    nb = len(counts)
    o, d, t_max = _edge_rays(tables, nb * wl.RB - 300, 21)
    od, tm, _ = wl.prep_rays(o, d, None if kind == "closest" else t_max)
    texp = wl.scene_exit(tables, od)
    cap = wl._window(wl._float_bits(texp) | wl._LOWM) if kind == "closest" \
        else tm
    # block b's list: the supers its rays enter (the cull's), then others
    rs = np.random.default_rng(5)
    cs = tables.sbox.shape[0]
    real = wl.phases(tables, od, tm)
    real_blk = ps.item_blocks(real).cpu().numpy()
    real_sup = real.sup.cpu().numpy()
    sup = []
    for b, c in enumerate(counts):
        mine = real_sup[real_blk == b]
        rest = np.setdiff1d(np.arange(cs), mine)
        sup.append(np.concatenate([mine, rs.permutation(rest)])[:c])
    sup = np.concatenate(sup)
    seg = np.concatenate([[0], np.cumsum(counts)])
    items = wl.Items(torch.tensor(seg, dtype=torch.int32, device="cuda"),
                     torch.tensor(sup, dtype=torch.int32, device="cuda"),
                     torch.zeros(len(sup), device="cuda"),
                     torch.tensor(counts, device="cuda") > 0)
    ps.reset_counters()
    got = ps.emit_pairs(tables, items, od, cap, T_MIN)
    torch.cuda.synchronize()
    assert ps.counters()["pair_emit"] == 1
    want = ps.emit_pairs_torch(tables, items, od, cap, T_MIN)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0
    with pytest.raises(ValueError):
        ps.emit_pairs(tables, items, od[:, :-wl.RB].contiguous(),
                      cap[:-wl.RB].contiguous(), T_MIN)


def _chunk_pairs(tables, od, tm, cap, sizes, rs):
    """A pair list whose supers hold `sizes` pairs: the cull's items whose
    super the most rays enter, one a size, each taking the rays that enter
    its super box first, then others; the last ray block's item also
    takes parked lanes."""
    real = wl.phases(tables, od, tm)
    enters = ps.emit_pairs_torch(tables, real, od, cap, T_MIN)
    top, seen = [], set()
    for i in torch.argsort(enters.sum(1), descending=True).tolist():
        if int(real.sup[i]) not in seen and len(top) < len(sizes):
            top.append(i)
            seen.add(int(real.sup[i]))
    top = torch.tensor(sorted(top), device="cuda")
    blk = ps.item_blocks(real)[top]
    seg = torch.zeros(od.shape[1] // wl.RB + 1, dtype=torch.int32,
                      device="cuda")
    seg[1:] = torch.cumsum(torch.bincount(blk, minlength=seg.shape[0] - 1),
                           0)
    items = wl.Items(seg, real.sup[top].contiguous(), real.t_ent[top],
                     seg[1:] > seg[:-1])
    enters = enters[top].cpu().numpy()
    it, lane = [], []
    last = int(blk.max())
    for i, size in enumerate(rs.permutation(sizes)):
        inside = np.flatnonzero(enters[i])
        rest = np.setdiff1d(np.arange(wl.RB), inside)
        pick = np.concatenate([rs.permutation(inside),
                               rs.permutation(rest)])[:size]
        if int(blk[i]) == last and last == od.shape[1] // wl.RB - 1:
            pick[-4:] = wl.RB - 1 - np.arange(4)
        it.append(np.full(size, i))
        lane.append(pick)
    it, lane = np.concatenate(it), np.concatenate(lane)
    return ps.pair_list(tables, items, torch.tensor(it, device="cuda"),
                        torch.tensor(lane, device="cuda"))


@pytest.mark.cuda
@TESTS
def test_cuda_any_sweep_matches_twin_on_chunks(cuda_tables, watertight):
    """The any-hit kernel against its twin, bit for bit, on pair lists
    whose supers hold 1, 31, 32, 33, 256 and 300 pairs (chunks of 1-256
    pairs, halves of a chunk empty or partial), rays with parked lanes,
    origins on box planes and empty or NaN windows."""
    tables = cuda_tables
    o, d, t_max = _edge_rays(tables, 4 * wl.RB - 100, 22)
    od, tm, _ = wl.prep_rays(o, d, t_max)
    pairs = _chunk_pairs(tables, od, tm, tm, [1, 31, 32, 33, 256, 300],
                         np.random.default_rng(6))
    got_counts = sorted(pairs.chunk_count[pairs.chunk_count > 0].tolist())
    assert got_counts == sorted([1, 31, 32, 33, 256, 256, 44])
    want = ps.pair_sweep_any_torch(tables, pairs, od, tm, T_MIN, watertight)
    ps.reset_counters()
    got = ps.pair_sweep_any(tables, pairs, od, tm, T_MIN, watertight)
    torch.cuda.synchronize()
    assert ps.counters()["pair_sweep_any"] == 1
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.cuda
@TESTS
def test_cuda_closest_sweep_matches_twin_on_chunks(cuda_tables, watertight):
    """The closest kernel against its twin, bit for bit in all 8 per-pair
    outputs, on pair lists whose supers hold 1, 31, 32, 33, 128, 129 and
    300 pairs (chunks of 1, 31, 32, 33, 44, 128, 129 and 256 pairs), rays
    with parked lanes, origins on box planes and zero direction
    components, some rays' texp at +inf (nothing entered) or cut (walks
    that stop early), and pairs whose walk sweeps several clusters."""
    tables = cuda_tables
    o, d, _ = _edge_rays(tables, 4 * wl.RB - 100, 23)
    od, tm, _ = wl.prep_rays(o, d)
    texp = wl.scene_exit(tables, od)
    cap = wl._window(wl._float_bits(texp) | wl._LOWM)
    pairs = _chunk_pairs(tables, od, tm, cap, [1, 31, 32, 33, 128, 129, 300],
                         np.random.default_rng(7))
    got_counts = sorted(pairs.chunk_count[pairs.chunk_count > 0].tolist())
    assert got_counts == sorted([1, 31, 32, 33, 44, 128, 129, 256])
    texp[::13] = float("inf")
    texp[6::13] *= 0.5
    want = ps.pair_sweep_closest_torch(tables, pairs, od, texp, T_MIN,
                                       watertight)
    ps.reset_counters()
    got = ps.pair_sweep_closest(tables, pairs, od, texp, T_MIN, watertight)
    torch.cuda.synchronize()
    assert ps.counters()["pair_sweep_closest"] == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)
    inf = torch.isinf(texp[pairs.ray.long()])
    assert inf.any() and (want[7][inf] == 0).all()
    assert (want[7] >= 2).any()
    assert (want[0] < (wl._float_bits(texp) | wl._LOWM)[
        pairs.ray.long()]).any()
