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

The grouped kernels skip an item for a warp whose rays all miss the
item's admission box (`wl.admission_boxes`); the tests below hold that
box to containing every child box as a slab test reads it, hold a plain
model of the per-warp admission (`wl.warp_admitted`) to refusing no
(item, warp) in which some ray's fine cull enters a child, and hold the
grouped twin with the admission to the twin without it in every field.
Scenes there: the grid, both sides of `alpha_sphere_grid(3, 3, stacks=12,
slices=16)`'s opaque/masked split, and a seeded 2,100-triangle random
soup (180 clusters: its last super holds padding).
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import worklist as wl
from directcomputeraytracing_tpu_torch.accel.traverse import (
    SlabStats,
    _split_view,
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
)
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod
from directcomputeraytracing_tpu_torch.scene.presets import (
    alpha_sphere_grid,
    sphere_grid,
)
from directcomputeraytracing_tpu_torch.scene.scene import (
    Instance,
    Mesh,
    Scene,
    flatten_scene,
)
from directcomputeraytracing_tpu_torch.tools import worklist_ab

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


def _shadow_rays(n, seed):
    """Rays from under the spheres' tops towards a lamp point above the
    grid, t_max short of the lamp."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-3.0, 0.01, -3.0], [3.0, 1.0, 3.0], (n, 3))
    to_lamp = rs.uniform([-1.0, 6.0, -1.0], [1.0, 6.0, 1.0], (n, 3)) - o
    dist = np.linalg.norm(to_lamp, axis=1)
    return (o.astype(np.float32), (to_lamp / dist[:, None]).astype(np.float32),
            (0.999 * dist).astype(np.float32))


def _random_soup(n=2100, seed=5):
    """A seeded soup of n small triangles in [0, 2]^3 (2,100: 180
    clusters, so the last super holds 12 padding children)."""
    rs = np.random.default_rng(seed)
    cen = rs.uniform(0.0, 2.0, (n, 3))
    v = cen[:, None, :] + rs.uniform(-0.08, 0.08, (n, 3, 3))
    return flatten_scene(Scene(
        meshes=[Mesh(positions=v.reshape(-1, 3).astype(np.float32),
                     indices=np.arange(3 * n).reshape(n, 3),
                     material_ids=np.zeros(n, np.int64), name="soup")],
        instances=[Instance(mesh=0)]), "cpu")[0]


@pytest.fixture(scope="module")
def scenes(port_scene):
    """name -> a scene with work-list tables: world-soup cluster tables
    but for "instanced", the grid forced onto the instanced tables (its
    flattening's SOUP_MAX_TRIS lowered, as the instanced tests do)."""
    alpha = flatten_scene(alpha_sphere_grid(*GRID, **GRID_KW)[0], "cpu")[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene_mod, "SOUP_MAX_TRIS", 256)
        inst = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], "cpu")[0]
    return {"grid": port_scene, "alpha_opaque": _split_view(alpha, False),
            "alpha_masked": _split_view(alpha, True),
            "soup": _random_soup(), "instanced": inst}


@pytest.mark.parametrize("name", ["grid", "alpha_opaque", "alpha_masked",
                                  "soup", "instanced"])
def test_super_box_contains_its_children(scenes, name):
    """sbox holds each real child box bit for bit (lo <= the child's lo,
    hi >= its hi); abox, the kernels' admission box, holds every child box
    as a slab test reads it (padding's inverted box is the cube [-1, 1]^3)
    and is sbox itself on supers without padding. On instanced tables the
    children are the world boxes of each (instance, local super) pair."""
    scene = scenes[name]
    tables = wl.scene_tables(scene)
    cs = tables.sbox.shape[0]
    child = tables.cbox3.reshape(-1, 8)
    sup = torch.arange(cs * wl.SUPER) // wl.SUPER
    if name == "instanced":
        assert tables.inst_rows is not None
        assert torch.equal(tables.cbox3, scene.isup_cbox)
        real = child[:, 0] <= child[:, 3]
        assert (child[~real, 0:6] == torch.tensor(
            [1.0, 1.0, 1.0, -1.0, -1.0, -1.0])).all()
    else:
        c = scene.cluster_bbox.shape[0]
        real = torch.arange(cs * wl.SUPER) < c
        assert torch.equal(child[:c], scene.cluster_bbox)
    assert (tables.sbox[sup[real], 0:3] <= child[real, 0:3]).all()
    assert (tables.sbox[sup[real], 3:6] >= child[real, 3:6]).all()
    lo = torch.minimum(child[:, 0:3], child[:, 3:6])
    hi = torch.maximum(child[:, 0:3], child[:, 3:6])
    assert (tables.abox[sup, 0:3] <= lo).all()
    assert (tables.abox[sup, 3:6] >= hi).all()
    padded = ~real.view(cs, wl.SUPER).all(1)
    assert torch.equal(tables.abox[~padded], tables.sbox[~padded])
    assert bool(padded.any()) == (name in ("soup", "instanced"))


def _pairs(tables, items):
    """Every (item, ray) of the items' blocks: the rays (n_items, RB) and
    the item index of each."""
    counts = (items.seg[1:] - items.seg[:-1]).long()
    blk = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    rays = blk[:, None] * wl.RB + torch.arange(wl.RB)
    item = torch.arange(blk.numel())[:, None].expand_as(rays)
    return rays, item


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("rays", ["random", "shadow"])
@pytest.mark.parametrize("name", ["grid", "soup", "instanced"])
def test_warp_admission_refuses_no_entered_child(scenes, name, rays, kind):
    """The plain model of the kernels' super-box admission never refuses
    an (item, warp) in which some ray's fine cull enters a child, under
    the closest sweeps' first window (the scene exit's) and under the
    any-hit t_max; it does refuse some."""
    scene = scenes[name]
    tables = wl.scene_tables(scene)
    o, d, t_max = _rays(4 * wl.RB + 5, 51) if rays == "random" \
        else _shadow_rays(4 * wl.RB + 5, 52)
    if name == "soup":
        o = o * 0.5 + 0.5
        if rays == "shadow":
            o[:, 1] = np.abs(o[:, 1]) * 0.5
    o, d, t_max = (torch.from_numpy(x) for x in (o, d, t_max))
    od, tm, _ = wl.prep_rays(o, d, t_max if kind == "any" else None)
    items = wl.phases(tables, od, tm, plain=True)
    cap = tm if kind == "any" else wl._window(
        wl._float_bits(wl.scene_exit(tables, od)) | wl._LOWM)
    ray, item = (x.reshape(-1) for x in _pairs(tables, items))
    sup = items.sup[item].long()
    adm = wl.warp_admitted(tables.abox[sup], od[:, ray], cap[ray], 1e-4)
    enter, _ = wl._fine_cull(tables.cbox3[sup], od[:, ray], cap[ray], 1e-4)
    fine = enter.any(1).view(-1, wl.GL).any(1)
    adm = adm.view(-1, wl.GL)[:, 0]
    assert not (fine & ~adm).any()
    assert fine.sum() > 0 and adm.sum() < adm.numel()


@pytest.mark.parametrize("cap", [None, "per_ray"])
@pytest.mark.parametrize("name", ["grid", "soup"])
def test_admission_changes_no_field(scenes, monkeypatch, name, cap):
    """The grouped twin with the super-box admission equals the twin with
    every (item, warp) admitted in every field of the sweep state,
    `iters` included; its census counts what the admission refused."""
    scene = scenes[name]
    tables = wl.scene_tables(scene)
    o, d, t_max = _rays(3 * wl.RB + 77, 53)
    if name == "soup":
        o = o * 0.5 + 0.5
    o, d, t_max = (torch.from_numpy(x) for x in (o, d, t_max))
    od, tm, r = wl.prep_rays(o, d)
    texp = wl.scene_exit(tables, od)
    if cap:
        c = wl._cap(t_max, texp, r)
        texp, tm = torch.minimum(texp, c), torch.minimum(tm, c)
    items = wl.phases(tables, od, tm, plain=True)
    got = wl.sweep_closest_grouped_torch(tables, items, od, texp, 1e-4,
                                         False)
    census = worklist_ab.closest_census(tables, items, od, texp, 1e-4, False)
    with monkeypatch.context() as m:
        m.setattr(wl, "warp_admitted", lambda abox, od_r, c, t: torch.ones(
            od_r.shape[1], dtype=torch.bool))
        want = wl.sweep_closest_grouped_torch(tables, items, od, texp, 1e-4,
                                              False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (census["pairs"] >= census["block_voted"] >= census["warp_voted"]
            > census["admitted"] > 0)
    assert torch.isfinite(wl.decode_closest(got, texp, items.block_any,
                                            r)[0]).sum() > 100


@pytest.mark.parametrize("name", ["grid", "soup", "instanced"])
def test_any_census_counts_the_walk(scenes, name):
    """The any-hit census walks the twin's own steps: its walk gives the
    twin's answer (`sweep_any_inst_torch` on instanced tables), it counts
    every (item, warp) pair of the cast, the admission refuses some of
    the pairs the warps visit (but on the soup, whose supers each span
    its whole box, so that every ray enters every super box: there the
    warps of parked padding rays, done from the start, are not visited),
    and the rays that enter a child are rays of admitted pairs."""
    scene = scenes[name]
    tables = wl.scene_tables(scene)
    assert (tables.inst_rows is not None) == (name == "instanced")
    o, d, t_max = _shadow_rays(3 * wl.RB + 77, 54)
    if name == "soup":
        o = o * 0.5 + 0.5
        o[:, 1] = np.abs(o[:, 1]) * 0.5
    o, d, t_max = (torch.from_numpy(x) for x in (o, d, t_max))
    od, tm, _ = wl.prep_rays(o, d, t_max)
    items = wl.phases(tables, od, tm, plain=True)
    occ, census = worklist_ab.any_census(tables, items, od, tm, 1e-4, False)
    assert torch.equal(occ, wl.sweep_any_inst_torch(tables, items, od, tm,
                                                    1e-4, False))
    assert occ.any() and not occ.all()
    counts = (items.seg[1:] - items.seg[:-1]).long()
    assert census["pairs"] == int(counts.sum()) * (wl.RB // wl.GL)
    assert census["pairs"] >= census["visited"] >= census["admitted"] > 0
    if name == "soup":
        padding_warps = (od.shape[1] - o.shape[0]) // wl.GL
        assert census["visited"] <= census["pairs"] - padding_warps * (
            int(counts[-1]))
    else:
        assert census["visited"] > census["admitted"]
    assert 0 < census["entered"] <= census["admitted"] * wl.GL
    summary = worklist_ab.census_summary({}, census, od.shape[1])
    assert 0 < summary["any_admitted_share"] < 1
    assert (summary["any_fine_tests_per_ray"]
            < summary["any_fine_tests_per_ray_block_walk"])


def _any_warp_walk(tables, items, od, tm, t_min, watertight):
    """A plain model of `any_ray_kernel`'s walk, warp by warp: each warp
    of GL rays walks its block's items in order and stops once every ray
    is done (occluded, or from the start where t_max <= t_min); per item
    it skips unless some ray enters the item's admission box under its
    cap (-BIG for a ray that is done), and the rays not yet done take the
    twin's step (`wl.any_step`). Returns (occ, the warps that stopped
    before their block's last item, the (item, warp) pairs admitted)."""
    rp = od.shape[1]
    occ = torch.zeros(rp, dtype=torch.bool)
    dead = ~(tm > t_min)
    lanes = torch.arange(wl.GL)
    stopped = admitted = 0
    for w in range(rp // wl.GL):
        rays = w * wl.GL + lanes
        blk = w * wl.GL // wl.RB
        for k in range(int(items.seg[blk]), int(items.seg[blk + 1])):
            done = occ[rays] | dead[rays]
            if done.all():
                stopped += 1
                break
            sup = items.sup[k].long()
            cap = torch.where(done, -wl.BIG, tm[rays])
            if not wl.warp_admitted(tables.abox[sup].expand(wl.GL, 8),
                                    od[:, rays], cap, t_min)[0]:
                continue
            admitted += 1
            live = rays[~done]
            wl.any_step(tables, items, od, tm, t_min, watertight, occ, live,
                        torch.full_like(live, k))
    return occ, stopped, admitted


def _half_occluded_rays(world_tris, n_warps, seed):
    """Aimed shadow warps (`_aimed_shadow_rays`): every odd warp sends
    lanes 16-31 straight up from their origins with t_max 1, short of the
    lamp (y = 7), so that its other lanes are occluded at their first
    sphere and it walks on; every
    5th lane of every third warp gets t_max 0 and its neighbour t_max
    t_min (1e-4): no hit lies in [t_min, t_max)."""
    o, d, t_max = _aimed_shadow_rays(world_tris, n_warps, seed)
    lane = np.arange(o.shape[0]) % wl.GL
    warp = np.arange(o.shape[0]) // wl.GL
    up = (warp % 2 == 1) & (lane >= 16)
    d[up] = (0.0, 1.0, 0.0)
    t_max[up] = 1.0
    dead = (warp % 3 == 0) & (lane % 5 == 0)
    t_max[dead] = 0.0
    t_max[np.roll(dead, 1)] = 1e-4
    return o, d, t_max


@pytest.mark.parametrize("rays", ["random", "half_occluded"])
@pytest.mark.parametrize("name", ["grid", "instanced"])
def test_any_warp_walk_matches_twin(scenes, name, rays):
    """`any_ray_kernel`'s walk, modelled warp by warp, gives the twin's
    occlusion on every ray: the admission skips only items that no ray
    of the warp would enter, a warp stops only once all its rays are
    done, and rays with t_max <= t_min, which enter nothing, are not
    occluded and do not hold the warp. Random rays with per-ray t_max
    (some at 0 and at t_min; 4,101 rays, so the last block holds parked
    padding rays), and aimed shadow warps, half of them half occluded at
    their first item; on the soup and on the instanced tables."""
    tables = wl.scene_tables(scenes[name])
    if rays == "random":
        o, d, t_max = _rays(4 * wl.RB + 5, 56)
        t_max[::9] = 0.0
        t_max[1::9] = 1e-4
    else:
        o, d, t_max = _half_occluded_rays(scenes["grid"].world_tris, 96, 57)
    o, d, t_max = (torch.from_numpy(x) for x in (o, d, t_max))
    od, tm, r = wl.prep_rays(o, d, t_max)
    items = wl.phases(tables, od, tm, plain=True)
    occ, stopped, admitted = _any_warp_walk(tables, items, od, tm, 1e-4,
                                            False)
    want = wl.sweep_any_torch(tables, items, od, tm, 1e-4, False)
    assert torch.equal(occ, want)
    assert not occ[r:].any() and not occ[:r][~(t_max > 1e-4)].any()
    assert want[:r].any() and not want[:r].all()
    assert admitted > 0
    if rays == "half_occluded":
        per_warp = occ[:r].view(-1, wl.GL)
        assert (per_warp[1::2, :16].all(1) & ~per_warp[1::2, 16:].any(1)
                ).float().mean() > 0.5
        assert stopped > 0


def _block_vote(monkeypatch, fn, *args):
    """fn(*args) with the closest twins' vote taken per 1024-ray block, as
    the first per-ray kernels took it."""
    voted = wl._voted
    with monkeypatch.context() as m:
        m.setattr(wl, "_voted", lambda items, rays, item, best, group=None:
                  voted(items, rays, item, best))
        return fn(*args)


@pytest.mark.parametrize("cap", [None, "scalar", "per_ray"])
@pytest.mark.parametrize("name", ["grid", "instanced"])
def test_per_ray_warp_vote_matches_block_vote(scenes, monkeypatch, name,
                                              cap):
    """The per-ray twin (and so `closest_ray_kernel`) votes per warp; the
    first per-ray kernel voted per 1024-ray block. Without a t_cap the two
    give the same sweep state but for `iters`, which the block vote raises
    by exactly the empty padding clusters `padding_iters` counts; with one
    the decoded hits agree. The census walk and `padding_iters` walk the
    twin: their state is the twin's, and the census counts what the warp
    vote and the admission refused."""
    scene = scenes[name]
    tables = wl.scene_tables(scene)
    o, d, t_max = (torch.from_numpy(x) for x in _rays(3 * wl.RB + 77, 55))
    od, tm, r = wl.prep_rays(o, d)
    texp = wl.scene_exit(tables, od)
    if cap:
        c = wl._cap(1.2 if cap == "scalar" else t_max, texp, r)
        texp, tm = torch.minimum(texp, c), torch.minimum(tm, c)
    items = wl.phases(tables, od, tm, plain=True)
    warp = wl.sweep_closest_torch(tables, items, od, texp, 1e-4, False)
    state, census = worklist_ab.ray_census(tables, items, od, texp, 1e-4,
                                           False)
    padded, gap = worklist_ab.padding_iters(tables, items, od, texp, 1e-4,
                                            False)
    block = _block_vote(monkeypatch, wl.sweep_closest_torch, tables, items,
                        od, texp, 1e-4, False)
    for a, b, c in zip(warp, state, padded):
        assert torch.equal(a, b) and torch.equal(a, c)
    decoded = [wl.decode_closest(x, texp, items.block_any, r)
               for x in (warp, block)]
    for a, b in zip(*decoded):
        assert torch.equal(a, b)
    if not cap:
        diffs = worklist_ab.block_vote_diffs(block, warp, gap)
        assert not any(diffs.values()), diffs
    assert torch.isfinite(decoded[0][0]).sum() > 100
    assert (census["pairs"] >= census["block_voted"]
            >= census["warp_voted"] > census["admitted"] > 0)
    assert census["entered"] <= census["admitted"] * wl.GL
    summary = worklist_ab.ray_census_summary(census, od.shape[1])
    assert (summary["fine_tests_per_ray"]
            < summary["fine_tests_per_ray_block_walk"])


@pytest.mark.parametrize("name", ["grid", "instanced"])
def test_padding_iters_explains_only_padding(scenes, monkeypatch, name):
    """`padding_iters` counts exactly the empty padding clusters that the
    block vote sweeps and the warp vote does not. One 1024-ray block: 16
    warps fall onto the centre sphere from above through the cube
    [-1, 1]^3 (how a slab test reads a padding child's inverted box) and
    hit it before the ground's entry distance, so their warps refuse the
    ground; 16 warps fall onto the ground between the spheres, so the
    block keeps it. On the instanced tables the ground is one cluster of
    a super padded with 31, and the block vote sweeps those 31 for each
    ray of the first 16 warps. `block_vote_diffs` then finds nothing, and
    finds a fault of one cluster in any ray's `iters`."""
    tables = wl.scene_tables(scenes[name])
    g = torch.arange(wl.RB // 2, dtype=torch.float32)
    jx, jz = (g % 16) / 16 - 0.5, (g // 16) / 32 - 0.5
    o = torch.cat([torch.stack([0.2 * jx, torch.full_like(g, 3.0),
                                0.2 * jz], 1),
                   torch.stack([0.75 + 0.1 * jx, torch.full_like(g, 3.0),
                                0.75 + 0.1 * jz], 1)])
    d = torch.tensor([0.01, -1.0, 0.013]).expand(wl.RB, 3)
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    od, tm, r = wl.prep_rays(o, d)
    texp = wl.scene_exit(tables, od)
    items = wl.phases(tables, od, tm, plain=True)
    warp, gap = worklist_ab.padding_iters(tables, items, od, texp, 1e-4,
                                          False)
    block = _block_vote(monkeypatch, wl.sweep_closest_torch, tables, items,
                        od, texp, 1e-4, False)
    hit = wl.decode_closest(warp, texp, items.block_any, r)
    assert torch.isfinite(hit[0]).all()
    assert (hit[0][:wl.RB // 2] < 2.9).all()          # the sphere's top
    assert not any(worklist_ab.block_vote_diffs(block, warp, gap).values())
    assert not gap[1].any()
    if name == "instanced":
        assert (gap[0][:wl.RB // 2] == 31).all()
        assert not gap[0][wl.RB // 2:].any()
    for ray in (0, wl.RB - 1):
        fault = list(block)
        fault[7] = block[7].clone()
        fault[7][ray] += 1
        diffs = worklist_ab.block_vote_diffs(fault, warp, gap)
        assert diffs["iters"] == 1 and sum(diffs.values()) == 1


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


def _aimed_shadow_rays(world_tris, n_warps, seed):
    """Warps of 32 shadow rays, each warp aimed from above at one random
    triangle's centroid from nearby origins, t_max a little past it: whole
    warps are occluded at the first sphere they enter."""
    rs = np.random.default_rng(seed)
    tris = world_tris.cpu().numpy().reshape(-1, 3, 3)
    target = tris[rs.integers(0, tris.shape[0], n_warps)].mean(1)
    target = np.repeat(target, wl.GL, axis=0)
    o = target + rs.uniform([-0.3, 4.0, -0.3], [0.3, 4.5, 0.3],
                            target.shape)
    d = target - o
    dist = np.linalg.norm(d, axis=1)
    return (o.astype(np.float32), (d / dist[:, None]).astype(np.float32),
            (dist + 0.5).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("watertight", [False, True],
                         ids=["baldwin_weber", "watertight"])
def test_cuda_grouped_kernels_match_twins(watertight):
    """On unsorted random rays (100,003: a multiple of neither 32 nor the
    kernels' 128-thread blocks; the warps of a block enter different
    items) and on aimed shadow rays (whole warps occluded at their first
    sphere): kernel and twin equal in every field, `iters` included, and
    the per-ray sweep in every hit field; the same for casts with a
    per-ray t_cap (decoded) and for slab-marched casts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    arrays, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], dev)
    tables = wl.scene_tables(arrays)
    sets = {"random": _rays(100_003, 37),
            "aimed_shadow": _aimed_shadow_rays(arrays.world_tris, 1000, 38)}
    wl.reset_counters()
    for name, rays in sets.items():
        o, d, t_max = (torch.from_numpy(x).to(dev) for x in rays)
        od, tm, r = wl.prep_rays(o, d, t_max)
        items = wl.phases(tables, od, tm)
        texp = wl.scene_exit(tables, od)
        got = wl.sweep_closest_grouped(tables, items, od, texp, 1e-4,
                                       watertight)
        want = wl.sweep_closest_grouped_torch(tables, items, od, texp, 1e-4,
                                              watertight)
        per_ray = wl.sweep_closest(tables, items, od, texp, 1e-4, watertight)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
        for a, c in zip(got[:7], per_ray[:7]):
            assert torch.equal(a, c), name
        occ = wl.sweep_any_grouped(tables, items, od, tm, 1e-4, watertight)
        assert torch.equal(occ, wl.sweep_any_torch(tables, items, od, tm,
                                                   1e-4, watertight)), name
        assert torch.equal(occ, wl.sweep_any(tables, items, od, tm, 1e-4,
                                             watertight)), name
        if name == "aimed_shadow":
            warp_occ = occ[:r].view(-1, wl.GL).all(1)
            assert warp_occ.float().mean() > 0.5
        cap = wl.worklist_closest(arrays, o, d, 1e-4, watertight,
                                  grouped=True, t_cap=t_max)
        cap_twin = wl.worklist_closest_torch(arrays, o, d, 1e-4, watertight,
                                             grouped=True, t_cap=t_max)
        cap_per_ray = wl.worklist_closest(arrays, o, d, 1e-4, watertight,
                                          t_cap=t_max)
        for a, b in zip(cap, cap_twin):
            assert torch.equal(a, b), name
        for a, c in zip(cap[:6], cap_per_ray[:6]):
            assert torch.equal(a, c), name
    torch.cuda.synchronize()
    c = wl.counters()
    assert c["sweep_closest_grouped"] == 4 and c["sweep_any_grouped"] == 2
    o, d, _ = (torch.from_numpy(x).to(dev) for x in sets["random"])
    full = intersect_closest(arrays, o, d, backend="pallas_wl")
    # 40th percentile of the hit distances, moved off the hit it names
    depth = float(torch.quantile(full.t[full.hit], 0.4)) * (1 + 1e-4)
    stats = SlabStats(3)
    slab = intersect_closest_slab(arrays, o, d, depth, backend="pallas_wlg",
                                  watertight=watertight, phases=3,
                                  stats=stats)
    slab_per_ray = intersect_closest_slab(arrays, o, d, depth,
                                          backend="pallas_wl",
                                          watertight=watertight, phases=3)
    assert stats.casts[:2] == [1, 1]
    for a, b in zip(slab[:6], slab_per_ray[:6]):
        assert torch.equal(a, b)
    assert wl.counters()["sweep_closest_grouped"] > 4


# csrc/worklist.cu's kernels as nvcc 12.8 names them in its ptxas lines
# for sm_90a (anonymous namespace, then the kernel and its template
# arguments), with the short name `worklist_ab._short` gives each (None:
# not a warp-walk sweep)
_NS = "_ZN44_GLOBAL__N__ff7794f1_11_worklist_cu_501dc527"
_BW, _WT = "IN4dcrt12BaldwinWeberE", "IN4dcrt13RawWatertightE"
_CLOSEST = "PKiS4_PKfS6_S6_S6_S6_S6_iifNS1_10ClosestOutE"
_RAY_CLOSEST = "PKiS4_PKfS6_S6_S6_S4_S4_S6_S6_S6_iifNS1_10ClosestOutE"
_ANY = "PKiS4_PKfS6_S6_S6_S6_iifPh"
_RAY_ANY = "PKiS4_PKfS6_S6_S4_S4_S6_S6_S6_iifPh"
_ENTRIES = {
    f"{_NS}22closest_grouped_kernel{_BW}EEv{_CLOSEST}": "closest_bw",
    f"{_NS}22closest_grouped_kernel{_WT}EEv{_CLOSEST}": "closest_wt",
    f"{_NS}18any_grouped_kernel{_BW}EEv{_ANY}": "any_bw",
    f"{_NS}18any_grouped_kernel{_WT}EEv{_ANY}": "any_wt",
    f"{_NS}18closest_ray_kernel{_BW}Lb0EEEv{_RAY_CLOSEST}": "ray_closest_bw",
    f"{_NS}18closest_ray_kernel{_WT}Lb0EEEv{_RAY_CLOSEST}": "ray_closest_wt",
    f"{_NS}18closest_ray_kernel{_BW}Lb1EEEv{_RAY_CLOSEST}": "inst_closest_bw",
    f"{_NS}18closest_ray_kernel{_WT}Lb1EEEv{_RAY_CLOSEST}": "inst_closest_wt",
    f"{_NS}14any_ray_kernel{_BW}Lb0EEEv{_RAY_ANY}": "ray_any_bw",
    f"{_NS}14any_ray_kernel{_WT}Lb0EEEv{_RAY_ANY}": "ray_any_wt",
    f"{_NS}14any_ray_kernel{_BW}Lb1EEEv{_RAY_ANY}": "inst_any_bw",
    f"{_NS}14any_ray_kernel{_WT}Lb1EEEv{_RAY_ANY}": "inst_any_wt",
    f"{_NS}11cull_kernelEPKfiS1_S1_iPf": None,
    f"{_NS}13refine_kernelEPKfiPKiS3_S1_S1_iPf": None,
}


def _ptxas_log():
    """A ptxas report (`nvcc -Xptxas -v`) of the kernels of _ENTRIES, the
    j-th with 40 + j registers, 8 * j bytes of stack and spill."""
    lines = []
    for j, entry in enumerate(_ENTRIES):
        lines += [
            f"ptxas info    : Compiling entry function '{entry}' for "
            "'sm_90a'",
            f"ptxas info    : Function properties for {entry}",
            f"    {8 * j} bytes stack frame, {8 * j} bytes spill stores, "
            f"{8 * j} bytes spill loads",
            f"ptxas info    : Used {40 + j} registers, used 0 barriers, "
            f"{1024 * j} bytes smem",
            "ptxas info    : Compile time = 255.933 ms"]
    return "\n".join(lines)


@pytest.mark.parametrize("entry", list(_ENTRIES),
                         ids=[v or "other" for v in _ENTRIES.values()])
def test_ptxas_report_names_the_warp_kernels(entry):
    """`ptxas_report` files each kernel's registers, shared memory, stack
    and spills under the short name `_short` gives its entry, one of the
    12 names of `wl.WARP_KERNELS` (the order of `warp_resources`), and
    skips the kernels that do not walk by warps."""
    assert len(wl.WARP_KERNELS) == len(set(wl.WARP_KERNELS)) == 12
    short, j = _ENTRIES[entry], list(_ENTRIES).index(entry)
    assert worklist_ab._short(entry) == short
    rep = worklist_ab.ptxas_report(_ptxas_log())
    assert set(rep) == set(wl.WARP_KERNELS)
    if short is not None:
        assert rep[short] == dict(registers=40 + j, smem=1024 * j,
                                  stack=8 * j, spill_stores=8 * j,
                                  spill_loads=8 * j)
