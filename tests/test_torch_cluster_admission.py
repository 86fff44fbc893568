"""The clustered sweeps' warp admission (`traversal_backend=
"pallas_cluster"`, kernel rows 4 and 5): the rule, its twins, its
census, and on a card the kernels bit for bit against the twins.

The rule (`accel/clustered.py`, `csrc/clustered.cu`): ray i tests the 16
rows of cluster c exactly when its ray block's cull mask holds c and a
ray of its warp (the 32 rays i // 32; rays past the cast vote no) votes
for c: its own slab test enters c's box (`_safe_inv` reciprocals, no t
range); a ray with a non-finite origin or direction component votes no.

Scenes: `sphere_grid(3, 3, stacks=12, slices=16)` (256 clusters, 16
groups), `sphere_grid(2, 3, ...)` (196 clusters padded to 208: 12
padding clusters with inverted boxes) and a synthetic table for the
group-box tests. Rays from a numpy seed: random rays from inside the
scene box, 32x32-tiled camera rays, camera rays with parked lanes (2e9
along +x), a NaN ray and a zero direction, and a cast whose last warp is
short.

Tolerances: the admission, the census and the group boxes are exact
(integer and boolean results of the same float32 operations, compared
with an independent numpy loop). The new twins against a sweep of the
whole block mask (the first design's rule, swept here by the dense twin
on each block's masked clusters in table order): equal in every bit but
for rays the admission may lose, edge grazes (the block rule's hit lies
in a cluster whose box the ray's own slab test misses; at most 2 a set,
each explained by `tools/clustered_ab.py` `graze_diffs`). The `cuda`
tests hold the kernels to the twins bit for bit:
`python -m pytest --noconftest -m cuda tests/test_torch_cluster_admission.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import brute
from directcomputeraytracing_tpu_torch.accel import clustered as cl
from directcomputeraytracing_tpu_torch.camera.camera import generate_ray
from directcomputeraytracing_tpu_torch.integrator.common import (
    RenderConfig,
    park_rays,
)
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    tiled_frame_pixels,
)
from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
from directcomputeraytracing_tpu_torch.tools import clustered_ab as cab
from directcomputeraytracing_tpu_torch.tools.brute_ab import closest_diffs

CPU = torch.device("cpu")
GRID_KW = dict(stacks=12, slices=16)
T_MIN = 1e-4
N_RAYS = 2048
SHORT = 1024 + 300 + 17          # a partial ray block, a short last warp
MAX_GRAZES = 2
SETS = ("random", "camera", "parked")
TESTS = pytest.mark.parametrize("watertight", [False, True],
                                ids=["moeller", "watertight"])
BIG = np.float32(3.0e38)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(shape, device=CPU):
    scene, cam = sphere_grid(*shape, **GRID_KW)
    arrays, _ = flatten_scene(scene, device)
    return arrays, cam


@pytest.fixture(scope="module")
def grid():
    return _grid((3, 3))


@pytest.fixture(scope="module")
def padded():
    arrays, cam = _grid((2, 3))
    assert arrays.cluster_bbox.shape[0] % cl.CLUSTER_GROUP != 0
    return arrays, cam


def _camera_rays(cam, n, device=CPU):
    cfg = RenderConfig(width=-(-n // 32), height=32)
    px, py, _ = tiled_frame_pixels(cfg, device)
    film = torch.stack([(px + 0.5) / cfg.width, (py + 0.5) / cfg.height], 1)
    o, d = generate_ray(cam, film.float()[:n], torch.zeros(n, 3))
    return o.contiguous(), d.contiguous()


def _rays(name, arrays, cam, n=N_RAYS):
    rs = np.random.default_rng(len(name) * 7 + n)
    if name == "random":
        lo = arrays.cluster_bbox[:, 0:3].amin(0).numpy()
        hi = arrays.cluster_bbox[:, 3:6].amax(0).numpy()
        d = rs.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (torch.from_numpy(x.astype(np.float32))
                for x in (rs.uniform(lo, hi, (n, 3)), d))
    else:
        o, d = _camera_rays(cam, n)
    if name == "parked":
        o, d = park_rays(torch.from_numpy(rs.random(n) < 0.7), o, d)
        o[3], d[4] = float("nan"), 0.0
        d[5, 1] = 0.0                 # a zero component: 1e30 reciprocal
    t_max = torch.from_numpy(rs.uniform(0.5, 30.0, n).astype(np.float32))
    return o.contiguous(), d.contiguous(), t_max


# ---------------------------------------------------------------------------
# the numpy reference of the rule
# ---------------------------------------------------------------------------

def _np_votes(boxes, o, d):
    """(R, K) bool, one ray at a time: the slab test of the rule in
    numpy float32, a non-finite ray voting no."""
    boxes, o, d = (np.asarray(x, np.float32) for x in (boxes, o, d))
    tiny = np.float32(1e-30)
    out = np.zeros((o.shape[0], boxes.shape[0]), bool)
    with np.errstate(over="ignore"):
        for i in range(o.shape[0]):
            out[i] = _np_ray_votes(boxes, o[i], d[i], tiny)
    return out


def _np_ray_votes(boxes, o, d, tiny):
    """(K,) bool: one ray's votes, or False for a non-finite ray."""
    if not (np.isfinite(o).all() and np.isfinite(d).all()):
        return False
    den = np.where(np.abs(d) < tiny, np.where(d >= 0, tiny, -tiny), d)
    inv = np.float32(1.0) / den.astype(np.float32)
    t_lo = np.full(boxes.shape[0], -BIG, np.float32)
    t_hi = np.full(boxes.shape[0], BIG, np.float32)
    for ax in range(3):
        a = (boxes[:, ax] - o[ax]) * inv[ax]
        b = (boxes[:, 3 + ax] - o[ax]) * inv[ax]
        t_lo = np.maximum(t_lo, np.minimum(a, b))
        t_hi = np.minimum(t_hi, np.maximum(a, b))
    return (t_hi >= t_lo) & (t_hi >= 0)


def _np_admission(cbox, cmask, o, d):
    """(R, Cg) bool: the rule by a loop over warps of the numpy votes."""
    votes = _np_votes(cbox, o, d)
    r = o.shape[0]
    adm = np.zeros_like(votes)
    for w in range(0, r, 32):
        adm[w:w + 32] = votes[w:w + 32].any(0)
    blocks = np.arange(r) // cl.RAY_BLOCK
    return adm & cmask.numpy()[blocks].astype(bool)


# ---------------------------------------------------------------------------
# CPU: the rule and its twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", [("random", N_RAYS), ("camera", N_RAYS),
                                    ("parked", N_RAYS), ("camera", SHORT)],
                         ids=["random", "camera", "parked", "short"])
def test_admission_matches_slab_loop(grid, name, n):
    """`admission_torch` and the rows the twins sweep (`_group_rays`, per
    group) equal a per-ray numpy slab loop OR-ed over 32 lanes."""
    arrays, cam = grid
    o, d, _ = _rays(name, arrays, cam, n)
    tables = cl.pad_cluster_tables(arrays)
    cmask, gmask = cl.cull_masks_torch(tables, o, d)
    want = _np_admission(tables.cbox, cmask, o.numpy(), d.numpy())
    assert 0 < want.sum() < cmask.sum() * cl.RAY_BLOCK
    np.testing.assert_array_equal(
        cl.admission_torch(tables, cmask, o, d).numpy(), want)
    swept = np.zeros_like(want)
    for g in range(tables.n_groups):
        rays, cols = cl._group_rays(tables, cmask, gmask, g, o, d)
        assert cols.any(1).all()
        swept[rays.numpy(), g * 16:(g + 1) * 16] = \
            cols[:, ::cl.CLUSTER_SIZE].numpy()
    np.testing.assert_array_equal(swept, want)


def _adversarial_rays(boxes):
    """Rays aimed at the corners, edge midpoints and face centres of each
    box, from 1 away along axis, diagonal and zero-component directions,
    and rays lying in each face plane, parallel to it."""
    dirs = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
            (0, 0, -1), (1, 1, 0), (0, -1, 1), (1, 1, 1), (-1, 1e-31, 0),
            (1e-31, -0.0, 1)]
    o, d = [], []
    for b in boxes.numpy():
        lo, hi = np.minimum(b[0:3], b[3:6]), np.maximum(b[0:3], b[3:6])
        mid = (lo + hi) / 2
        pts = [np.where([i & 1, i & 2, i & 4], hi, lo) for i in range(8)]
        for ax in range(3):
            for side in (lo, hi):
                f = mid.copy()
                f[ax] = side[ax]
                pts.append(f)
                for ax2 in range(3):
                    if ax2 != ax:
                        e = f.copy()
                        e[ax2] = lo[ax2]
                        pts.append(e)
        for p in pts:
            for dv in dirs:
                dv = np.asarray(dv, np.float64)
                o.append(p - dv / max(np.linalg.norm(dv), 1e-30))
                d.append(dv)
        for ax in range(3):              # in the face plane, parallel to it
            for side in (lo, hi):
                p = mid.copy()
                p[ax] = side[ax]
                dv = np.zeros(3)
                dv[(ax + 1) % 3] = 1.0
                o.append(p - 2 * dv * (hi - lo).max())
                d.append(dv)
    return (torch.tensor(np.asarray(o), dtype=torch.float32),
            torch.tensor(np.asarray(d), dtype=torch.float32))


def _synthetic_tables():
    """Tables of 37 clusters (3 padding ones): random boxes, some flat
    along an axis, and zero rows."""
    rs = np.random.default_rng(13)
    lo = rs.uniform(-3, 3, (37, 3))
    hi = lo + rs.uniform(0, 2, (37, 3)) * (rs.random((37, 3)) > 0.2)
    cbox = np.concatenate([lo, hi, np.zeros((37, 2))], 1).astype(np.float32)
    tris = np.zeros((37 * 16, 13), np.float32)
    scene = SimpleNamespace(cluster_bbox=torch.from_numpy(cbox),
                            cluster_tris=torch.from_numpy(tris))
    return cl.pad_cluster_tables(scene)


@pytest.mark.parametrize("which", ["padded_grid", "synthetic"])
def test_group_boxes_hold_members(padded, which):
    """Every group box holds its member boxes as a slab test reads them
    (an inverted padding box as the cube [-1, 1]^3), and on rays aimed
    at the members' faces, edges and corners every ray that votes for a
    member box votes for its group box."""
    tables = (cl.pad_cluster_tables(padded[0]) if which == "padded_grid"
              else _synthetic_tables())
    cg = tables.cbox.shape[0]
    assert (tables.cbox[cg - 1, :6] == torch.tensor(
        [1.0, 1.0, 1.0, -1.0, -1.0, -1.0])).all()        # padding
    lo = torch.minimum(tables.cbox[:, 0:3], tables.cbox[:, 3:6])
    hi = torch.maximum(tables.cbox[:, 0:3], tables.cbox[:, 3:6])
    grp = torch.arange(cg) // cl.CLUSTER_GROUP
    assert (tables.gbox[grp, 0:3] <= lo).all()
    assert (tables.gbox[grp, 3:6] >= hi).all()
    assert (tables.gbox[:, 6:] == 0).all()
    aimed = torch.cat([torch.arange(2 * cl.CLUSTER_GROUP),
                       torch.arange(cg - cl.CLUSTER_GROUP, cg)])
    o, d = _adversarial_rays(tables.cbox[aimed])
    member = cl.ray_votes(tables.cbox, o, d)
    group = cl.ray_votes(tables.gbox, o, d)[:, grp]
    assert member.sum() > o.shape[0]
    assert not (member & ~group).any()
    np.testing.assert_array_equal(member[::4].numpy(),
                                  _np_votes(tables.cbox, o[::4], d[::4]))


@pytest.mark.parametrize("name", SETS)
def test_own_entered_clusters_are_swept(grid, name):
    """Every cluster whose box the ray's own slab test enters is admitted
    for the ray (the cull's mask holds it)."""
    arrays, cam = grid
    o, d, _ = _rays(name, arrays, cam)
    tables = cl.pad_cluster_tables(arrays)
    cmask, _ = cl.cull_masks_torch(tables, o, d)
    own = cl.ray_votes(tables.cbox, o, d)
    adm = cl.admission_torch(tables, cmask, o, d)
    assert own.any(1).float().mean() > 0.1
    assert not (own & ~adm).any()
    # the warp's set lies between the ray's own and its block's exact set
    exact = cl.exact_masks_torch(arrays, o, d)[0].bool()
    assert not (adm & ~exact[torch.arange(o.shape[0]) // cl.RAY_BLOCK]).any()


def _block_rule(tables, cmask, o, d, t_max, watertight):
    """The first design's sweep: every ray tests every row of every
    cluster its block's mask holds, in table order (the dense twin on
    each block's masked rows)."""
    r = o.shape[0]
    out = [torch.empty(r, dtype=dt) for dt in (
        torch.float32, torch.float32, torch.float32, torch.int32,
        torch.int32, torch.bool)]
    occ = torch.zeros(r, dtype=torch.bool)
    for b in range(cmask.shape[0]):
        sl = slice(b * cl.RAY_BLOCK, min(r, (b + 1) * cl.RAY_BLOCK))
        clusters = torch.nonzero(cmask[b])[:, 0]
        rows = (clusters[:, None] * cl.CLUSTER_SIZE
                + torch.arange(cl.CLUSTER_SIZE)).reshape(-1)
        tab = tables.ctab[rows]
        for x, y in zip(out, brute.brute_closest_torch(
                tab, o[sl], d[sl], T_MIN, watertight)):
            x[sl] = y
        occ[sl] = brute.brute_any_torch(tab, o[sl], d[sl], t_max[sl], T_MIN,
                                        watertight)
    return out, occ


@TESTS
@pytest.mark.parametrize("name", SETS)
def test_twins_match_block_rule_but_grazes(grid, name, watertight):
    """The new twins against the whole block mask's sweep: every ray
    equal in every bit, but for edge grazes, each explained."""
    arrays, cam = grid
    o, d, t_max = _rays(name, arrays, cam)
    tables = cl.pad_cluster_tables(arrays)
    cmask, gmask = cl.cull_masks_torch(tables, o, d)
    new = cl.sweep_closest_torch(tables, cmask, gmask, o, d, T_MIN,
                                 watertight)
    occ = cl.sweep_any_torch(tables, cmask, gmask, o, d, t_max, T_MIN,
                             watertight)
    ref, occ_ref = _block_rule(tables, cmask, o, d, t_max, watertight)
    assert 100 < torch.isfinite(ref[0]).sum() and 0 < occ_ref.sum()
    rep = cab.graze_diffs(tables, cmask, o, d, new, ref, occ, occ_ref,
                          t_max, T_MIN, watertight)
    assert cab.graze_ok(rep), rep
    assert rep["hit_diff"] + rep["occ_diff"] <= MAX_GRAZES, rep
    assert rep["id_ties"] == 0
    grazes = torch.zeros(o.shape[0], dtype=torch.bool)
    grazes[[x["ray"] for x in rep["hit_diff_rays"]]] = True
    for a, b in zip(new, ref):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert not ((a != b) & ~grazes).any()


def test_graze_diffs_explain_only_grazes(grid):
    """`graze_diffs` explains a lost hit only where the ray's own slab
    test misses the box of the reference's hit cluster, and a lost
    occlusion only where it misses every cluster holding a hit."""
    arrays, cam = grid
    o, d, t_max = _rays("camera", arrays, cam)
    tables = cl.pad_cluster_tables(arrays)
    cmask, gmask = cl.cull_masks_torch(tables, o, d)
    new = cl.sweep_closest_torch(tables, cmask, gmask, o, d, T_MIN)
    occ = cl.sweep_any_torch(tables, cmask, gmask, o, d, t_max, T_MIN)
    own = cl.ray_votes(tables.cbox, o, d)
    miss = torch.nonzero(~torch.isfinite(new[0]))[0, 0]
    far = torch.nonzero(torch.isfinite(new[0]) & (new[0] > 1.0))[0, 0]
    ref = [x.clone() for x in new]
    occ_ref = occ.clone()
    # a hit in a box the ray misses (a graze), one in a box it enters
    for i, c in ((miss, int(torch.nonzero(~own[miss])[0, 0])),
                 (far, int(torch.nonzero(own[far])[0, 0]))):
        ref[0][i], ref[3][i], ref[4][i] = 0.5, tables.ctab[c * 16, 9], \
            tables.ctab[c * 16, 10]
    # occlusions with no hit anywhere in range: never explained
    free = torch.nonzero(~occ)[:, 0]
    occ_ref[free[:2]] = True
    rep = cab.graze_diffs(tables, cmask, o, d, new, ref, occ, occ_ref,
                          t_max, T_MIN, False)
    assert (rep["hit_diff"], rep["hit_diff_unexplained"]) == (2, 1)
    assert [x["explained"] for x in rep["hit_diff_rays"]] == [
        bool(miss < far), bool(far < miss)]
    assert rep["occ_diff"] == rep["occ_diff_unexplained"] == 2
    assert not cab.graze_ok(rep)
    assert cab.graze_ok(cab.graze_diffs(tables, cmask, o, d, new, new, occ,
                                        occ, t_max, T_MIN, False))


def test_nonfinite_and_parked_rays_vote_by_rule(grid):
    """NaN and +-inf components vote for nothing; parked lanes (2e9 along
    +x) and zero direction components (1e30 reciprocals) vote by their
    slab test; a warp of non-finite rays admits nothing and misses."""
    arrays, cam = grid
    tables = cl.pad_cluster_tables(arrays)
    o, d = _camera_rays(cam, 64)
    o, d = o.clone(), d.clone()
    bad = [(0, "o", 0, float("nan")), (1, "d", 2, float("nan")),
           (2, "o", 1, float("inf")), (3, "d", 0, -float("inf")),
           (4, "d", 1, float("inf"))]
    for i, which, ax, v in bad:
        (o if which == "o" else d)[i, ax] = v
    o[5:8], d[5:8] = torch.tensor([2e9, 0.0, 0.0]), torch.tensor([1.0, 0.0,
                                                                  0.0])
    d[8, 0], d[9] = 0.0, torch.tensor([0.0, -0.0, 0.0])
    o[10], d[10] = torch.tensor([0.0, 0.5, 0.0]), torch.tensor([0.0, 0.0,
                                                               1.0])
    o[32:], d[32:] = float("nan"), 1.0          # a warp of non-finite rays
    votes = cl.ray_votes(tables.cbox, o, d)
    np.testing.assert_array_equal(votes.numpy(),
                                  _np_votes(tables.cbox, o, d))
    assert not votes[:5].any() and not votes[32:].any()
    assert votes[10].any() and votes[:32].any()
    cmask, gmask = cl.cull_masks_torch(tables, o, d)
    cmask[:] = 1
    gmask[:] = 1
    adm = cl.admission_torch(tables, cmask, o, d)
    assert adm[:32].any(1).all() and not adm[32:].any()
    t = cl.sweep_closest_torch(tables, cmask, gmask, o, d, T_MIN)[0]
    assert torch.isinf(t[32:]).all() and torch.isfinite(t[:32]).any()


@pytest.mark.parametrize("name,n", [("camera", SHORT), ("random", N_RAYS)])
def test_census_matches_brute_count(grid, name, n):
    """`admission_census` (the warp walks' votes, admitted clusters and
    the any-hit lower bound) against a count by a loop over warps and
    groups, and `cast_bounds` from it."""
    arrays, cam = grid
    o, d, t_max = _rays(name, arrays, cam, n)
    tables = cl.pad_cluster_tables(arrays)
    cmask, gmask = cl.cull_masks_torch(tables, o, d)
    occ = cl.sweep_any_torch(tables, cmask, gmask, o, d, t_max, T_MIN)
    c = cab.admission_census(tables, cmask, gmask, o, d, occ)
    gv = _np_votes(tables.gbox, o.numpy(), d.numpy())
    cv = _np_votes(tables.cbox, o.numpy(), d.numpy())
    cm, gm, free = cmask.numpy().astype(bool), gmask.numpy(), ~occ.numpy()
    want = dict.fromkeys(("group_votes", "cluster_votes", "admitted",
                          "any_group_votes", "any_cluster_votes",
                          "any_admitted", "warp_groups"), 0)
    for w in range(0, n, 32):
        lanes = min(32, n - w)
        walks = free[w:w + lanes].any()
        b = w // cl.RAY_BLOCK
        for g in np.nonzero(gm[b])[0]:
            sl = slice(g * 16, g * 16 + 16)
            want["group_votes"] += lanes
            want["any_group_votes"] += lanes * walks
            if not gv[w:w + lanes, g].any():
                continue
            want["warp_groups"] += 1
            want["cluster_votes"] += lanes * cm[b, sl].sum()
            want["any_cluster_votes"] += lanes * walks * cm[b, sl].sum()
            adm = (cm[b, sl] & cv[w:w + lanes, sl].any(0)).sum()
            want["admitted"] += lanes * adm
            want["any_admitted"] += free[w:w + lanes].sum() * adm
    assert {k: c[k] for k in want} == want
    assert c["group_misses"] == 0 and c["admitted"] > 0
    bnd = cab.cast_bounds(tables, cmask, gmask, o, d, occ, c)
    ops = cab.FLOPS_VOTE * (want["group_votes"] + want["cluster_votes"]) \
        + 16 * 45 * want["admitted"]
    assert bnd["closest"][0] >= 1e3 * ops / 67e12
    assert bnd["closest"][0] < bnd["closest_block_walk"][0]


@pytest.mark.parametrize("name", SETS)
def test_cull_bound_counts_the_kernels_work(grid, name):
    """`cull_bound`: the kernel's work by a plain count over ray blocks
    (3 for enter and 10 per axis whose reaching rays' directions do not
    span zero, per cluster; nothing for a block with no reaching ray) and
    the reference's count (87 per block and cluster), each against the
    bytes of every ray, box and mask byte once."""
    from directcomputeraytracing_tpu_torch.tools import common

    arrays, cam = grid
    n = 3 * cl.RAY_BLOCK + 17
    o, d, _ = _rays(name, arrays, cam, n)
    o[cl.RAY_BLOCK:2 * cl.RAY_BLOCK] = 1e9     # a block that reaches nothing
    d[cl.RAY_BLOCK:2 * cl.RAY_BLOCK] = torch.tensor([1.0, 0.0, 0.0])
    tables = cl.pad_cluster_tables(arrays)
    cmask, gmask = cl.cull_masks_torch(tables, o, d)
    reach, dn = cl.reach_mask(tables, o, d).numpy(), d.numpy()
    per_cluster = 0
    for b in range(0, n, cl.RAY_BLOCK):
        dr = dn[b:b + cl.RAY_BLOCK][reach[b:b + cl.RAY_BLOCK]]
        if dr.shape[0]:
            per_cluster += 3 + 10 * int(
                ((dr.min(0) > 0) | (dr.max(0) < 0)).sum())
    nb, cg = cmask.shape
    nbytes = 24 * n + 32 * cg + nb * (cg + gmask.shape[1])
    kernel, reference = cab.cull_bound(tables, cmask, gmask, o, d)
    assert kernel == common.bound(per_cluster * cg, nbytes)
    assert reference == common.bound(87 * nb * cg, nbytes)
    assert 0 < per_cluster <= 33 * (nb - 1) and not cmask[1].any()


# ---------------------------------------------------------------------------
# the card: kernels against twins, bit for bit
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _cuda_case(shape, name, n):
    dev = _cuda()
    arrays, cam = _grid(shape, dev)
    cpu_arrays, _ = _grid(shape)
    o, d, t_max = (x.to(dev) for x in _rays(name, cpu_arrays, cam, n))
    return cl.pad_cluster_tables(arrays), o, d, t_max


def _nan_rays(o, d):
    """Every fifth ray with a NaN or +-inf component, a zero direction
    component in others."""
    o, d = o.clone(), d.clone()
    o[0::5, 0] = float("nan")
    d[1::10, 2] = float("inf")
    o[2::10, 1] = -float("inf")
    d[3::10, 1] = 0.0
    return o.contiguous(), d.contiguous()


def _bit_equal(tables, o, d, t_max, watertight):
    cmask, gmask = cl.cull_masks(tables, o, d)
    got = cl.sweep_closest(tables, cmask, gmask, o, d, T_MIN, watertight)
    want = cl.sweep_closest_torch(tables, cmask, gmask, o, d, T_MIN,
                                  watertight)
    assert not any(closest_diffs(got, want).values())
    occ = cl.sweep_any(tables, cmask, gmask, o, d, t_max, T_MIN, watertight)
    assert torch.equal(occ, cl.sweep_any_torch(tables, cmask, gmask, o, d,
                                               t_max, T_MIN, watertight))
    return got, occ


@pytest.mark.cuda
@TESTS
@pytest.mark.parametrize("case", ["incoherent", "short_warps", "nan",
                                  "padded"])
def test_cuda_sweeps_match_twins_bitwise(case, watertight):
    """Kernels against twins in every bit: an incoherent set (random rays
    over the whole grid), casts ending in short warps (1, 31, 33 and
    3 * 1024 + 17 rays), rays with NaN and inf components, and a grid with
    padding clusters."""
    if case == "incoherent":
        tables, o, d, t_max = _cuda_case((3, 3), "random", 1 << 16)
        _bit_equal(tables, o, d, t_max, watertight)
    elif case == "short_warps":
        tables, o, d, t_max = _cuda_case((3, 3), "parked", 3 * 1024 + 17)
        for n in (1, 31, 33, 3 * 1024 + 17):
            _bit_equal(tables, o[:n].contiguous(), d[:n].contiguous(),
                       t_max[:n].contiguous(), watertight)
    elif case == "nan":
        tables, o, d, t_max = _cuda_case((3, 3), "camera", 1 << 14)
        got, _ = _bit_equal(tables, *_nan_rays(o, d), t_max, watertight)
        assert torch.isfinite(got[0]).any()
    else:
        tables, o, d, t_max = _cuda_case((2, 3), "random", 1 << 14)
        _bit_equal(tables, o, d, t_max, watertight)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 3), (2, 3)],
                         ids=["16_groups", "13_groups"])
def test_cuda_cull_matches_twin_on_ray_counts(shape):
    """The cull kernel's masks equal `cull_masks_torch`'s byte for byte on
    casts of 1, 1023, 1025, 7 * 1024 + 5 and 2^20 + 3 rays (clusters of 8
    ray blocks cut short), on a grid of 16 groups and one of 13 (the
    kernel's 8 slices of whole groups uneven, one empty), with NaN and
    +-inf rays and a block whose rays all leave the scene (no reaching
    ray: its rows are zero)."""
    n_max = (1 << 20) + 3
    tables, o, d, _ = _cuda_case(shape, "random", n_max)
    o, d = _nan_rays(o, d)
    o[2 * 1024:3 * 1024] = 1e9
    d[2 * 1024:3 * 1024] = torch.tensor([1.0, 0.0, 0.0], device=o.device)
    for n in (1, 1023, 1025, 7 * 1024 + 5, n_max):
        cl.reset_counters()
        got = cl.cull_masks(tables, o[:n].contiguous(), d[:n].contiguous())
        torch.cuda.synchronize()
        assert cl.counters()["cluster_cull"] == 1
        want = cl.cull_masks_torch(tables, o[:n], d[:n])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert want[0].any() or n == 1   # ray 0 is NaN: no ray reaches
        if n > 3 * 1024:
            assert not want[0][2].any() and not want[1][2].any()


@pytest.mark.cuda
def test_cuda_sweeps_write_only_their_rays():
    """Each output lies between two guard runs of a pattern that must
    keep its bits, and equals the twin's bits."""
    tables, o, d, t_max = _cuda_case((3, 3), "parked", 2 * 1024 + 45)
    lib, guard, n = cl.kernels().lib, 4096, o.shape[0]
    cmask, gmask = cl.cull_masks(tables, o, d)

    def guarded(elem, dtype):
        buf = torch.full((n * elem + 2 * guard,), 0x7F, dtype=torch.uint8,
                         device=o.device)
        return buf, buf[guard:guard + n * elem].view(dtype)

    for wt in (False, True):
        bufs = [guarded(4, torch.float32) for _ in range(3)] + [
            guarded(4, torch.int32) for _ in range(2)] + [
            guarded(1, torch.bool)]
        cl._raise_on(lib.dcrt_cluster_closest(
            tables.ctab.data_ptr(), cl.prepared_rows(tables, wt).data_ptr(),
            tables.cbox.data_ptr(), tables.gbox.data_ptr(), cmask.data_ptr(),
            gmask.data_ptr(), tables.cbox.shape[0], o.data_ptr(),
            d.data_ptr(), n, T_MIN, int(wt),
            *(out.data_ptr() for _, out in bufs), cl._stream(o)), "closest")
        occ = guarded(1, torch.bool)
        cl._raise_on(lib.dcrt_cluster_any(
            cl.prepared_rows(tables, wt).data_ptr(), tables.cbox.data_ptr(),
            tables.gbox.data_ptr(), cmask.data_ptr(), gmask.data_ptr(),
            tables.cbox.shape[0], o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), n, T_MIN, int(wt), occ[1].data_ptr(),
            cl._stream(o)), "any")
        torch.cuda.synchronize()
        for buf, _ in bufs + [occ]:
            assert (buf[:guard] == 0x7F).all()
            assert (buf[-guard:] == 0x7F).all()
        want = cl.sweep_closest_torch(tables, cmask, gmask, o, d, T_MIN, wt)
        assert not any(closest_diffs([x for _, x in bufs], want).values())
        assert torch.equal(occ[1], cl.sweep_any_torch(
            tables, cmask, gmask, o, d, t_max, T_MIN, wt))


@pytest.mark.cuda
def test_cuda_launch_errors_raise():
    """A cluster count the sweeps cannot take (not a positive multiple of
    16) is refused with a CUDA error, and the wrapper's check raises."""
    tables, o, d, t_max = _cuda_case((3, 3), "camera", 64)
    cmask, gmask = cl.cull_masks(tables, o, d)
    lib, stream = cl.kernels().lib, cl._stream(o)
    out = [torch.empty(64, dtype=dt, device=o.device) for dt in (
        torch.float32, torch.float32, torch.float32, torch.int32,
        torch.int32, torch.bool)]
    rows = cl.prepared_rows(tables, False)
    for bad in (15, 0, -16):
        err = lib.dcrt_cluster_closest(
            tables.ctab.data_ptr(), rows.data_ptr(), tables.cbox.data_ptr(),
            tables.gbox.data_ptr(), cmask.data_ptr(), gmask.data_ptr(), bad,
            o.data_ptr(), d.data_ptr(), 64, T_MIN, 0,
            *(x.data_ptr() for x in out), stream)
        assert err != 0
        with pytest.raises(RuntimeError):
            cl._raise_on(err, "sweep_closest")
        assert lib.dcrt_cluster_any(
            rows.data_ptr(), tables.cbox.data_ptr(), tables.gbox.data_ptr(),
            cmask.data_ptr(), gmask.data_ptr(), bad, o.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), 64, T_MIN, 0,
            out[5].data_ptr(), stream) != 0
