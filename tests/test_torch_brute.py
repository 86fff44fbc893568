"""The dense sweep's redesign: the kernels' sieves, mirrored in PyTorch
(`moeller_sieve_torch`, `watertight_sieve_torch`), against the twins'
tests on adversarial and random pairs; the per-scene table cache; and, on
a card, the kernels against their twins bit for bit (every field, the
zeros' signs included) at ragged sizes, on the resident and the streamed
path, with the outputs' edges guarded.

A sieve may pass pairs that miss, but must never reject a pair that the
whole test accepts: the kernels run the whole test's own float operations
on the pairs it passes, so that is what keeps their results equal to the
twins'. On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_brute.py`.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import brute
from directcomputeraytracing_tpu_torch.accel.traverse import (
    ray_triangle_moeller,
    ray_triangle_watertight,
)
from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
from directcomputeraytracing_tpu_torch.tools import brute_ab, common

T_MIN = brute_ab.T_MIN
TESTS = {False: (ray_triangle_moeller, brute.moeller_sieve_torch),
         True: (ray_triangle_watertight, brute.watertight_sieve_torch)}
WT_IDS = ["moeller", "watertight"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(tab, o, d, t_max, watertight):
    """(twin hit, twin t, u, v, sieve pass) over every (triangle, ray)
    pair: tab (T, 12), o and d (T, N, 3) or (N, 3), t_max (N,)."""
    test, sieve = TESTS[watertight]
    tab, o, d, t_max = (torch.as_tensor(x) for x in (tab, o, d, t_max))
    if o.dim() == 2:
        o, d = o[None], d[None]
    v0, v1, v2 = (tab[:, None, 3 * i:3 * i + 3] for i in range(3))
    t, u, v, _, hit = test(o, d, T_MIN, t_max[None], v0, v1, v2)
    return hit, t, u, v, sieve(o, d, v0, v1, v2)


@pytest.mark.parametrize("watertight", [False, True], ids=WT_IDS)
def test_sieve_never_rejects_an_adversarial_hit(watertight):
    """Every pair of the adversarial set that the twin's test accepts
    passes the sieve; the set reaches the edges it is built for."""
    tab, o, d, t_max = brute_ab.adversarial_set()
    hit, t, u, v, ok = _pairs(tab, o, d, t_max, watertight)
    assert not (hit & ~ok).any()
    assert hit.any() and not ok.all()
    if watertight:
        return
    per_tri = hit.sum(1)
    assert (u[hit] == 0).any() and (u[hit] == 1).any()
    assert (v[hit] == 1).any() and (u[hit] + v[hit] == 1).any()
    assert (torch.signbit(u[hit]) & (u[hit] == 0)).any()   # underflow, -0
    assert (t[hit] == T_MIN).any()
    # the legs whose det straddles 1e-10: some decide det_ok each way
    straddle = per_tri[22:36]
    assert (straddle == 0).any() and (straddle > 0).any()
    # hits exactly at t_max are excluded, one float above included
    _, _, _, _, all_hits = TESTS[False][0](
        *(torch.as_tensor(x) for x in (o, d)), T_MIN, 3e38,
        *(torch.as_tensor(tab)[:, None, 3 * i:3 * i + 3] for i in range(3)))
    assert (all_hits & ~hit).any()


@pytest.mark.parametrize("watertight", [False, True], ids=WT_IDS)
def test_sieve_never_rejects_a_random_hit(watertight):
    """Random rays against a random soup and the Cornell box: the sieve
    passes every hit and rejects most pairs (the soup's small triangles
    far more than the box's large ones)."""
    rs = np.random.default_rng(7)
    soup = common.random_soup(rs, 300)
    arrays, _ = flatten_scene(cornell_box("area", "glossy")[0], "cpu")
    cornell = brute.build_table(arrays).numpy()
    for tab, lo, hi, most in ((soup, -1.5, 1.5, 0.1),
                              (cornell, -0.95, 0.95, 0.3)):
        o, d = (x.astype(np.float32) for x in common.rays_inside(
            rs, 1024, lo, hi))
        t_max = rs.uniform(0.05, 3.0, 1024).astype(np.float32)
        hit, _, _, _, ok = _pairs(tab, o, d, t_max, watertight)
        assert hit.any()
        assert not (hit & ~ok).any()
        assert ok.float().mean() < most


def _soup_scene(tab):
    return brute_ab.Soup(torch.from_numpy(tab))


def test_table_cached_per_scene():
    """The second cast reuses the first's table; it equals `build_table`;
    another scene gets its own; the prepared rows are kept per test."""
    rs = np.random.default_rng(3)
    a, b = _soup_scene(common.random_soup(rs, 40)), \
        _soup_scene(common.random_soup(rs, 40))
    o, d = (torch.from_numpy(x.astype(np.float32))
            for x in common.rays_inside(rs, 64, -1.5, 1.5))
    tab = brute.table(a)
    assert brute.table(a) is tab
    assert torch.equal(tab, brute.build_table(a))
    brute.brute_closest(a, o, d, T_MIN)
    brute.brute_any(a, o, d, 1.0, T_MIN)
    assert brute.table(a) is tab
    tab_b = brute.table(b)
    assert tab_b is not tab and torch.equal(tab_b, brute.build_table(b))
    for wt in (False, True):
        rows = brute.prepared_rows(a, wt)
        assert brute.prepared_rows(a, wt) is rows
    assert brute.prepared_rows(a, True) is not brute.prepared_rows(a, False)
    # a scene whose meta is another tensor gets a new table
    c = brute_ab.Soup(torch.cat([a.world_tris, a.world_tri_meta + 1], 1))
    c.world_tris = a.world_tris
    assert not torch.equal(brute.table(c), tab)


def test_prepared_rows_keep_the_twins_bits():
    """Moeller rows hold v0 and the edges v1 - v0, v2 - v0 as the twin
    computes them; watertight rows v0, v1, v2 and the twin's degenerate
    flag (the adversarial set's degenerate triangles among them)."""
    tab = torch.from_numpy(brute_ab.adversarial_set()[0])
    v0, v1, v2 = tab[:, 0:3], tab[:, 3:6], tab[:, 6:9]
    rows = brute.prepare_rows(tab, False)
    assert rows.shape == (tab.shape[0], 12) and rows.is_contiguous()
    for got, want in ((rows[:, 0:3], v0), (rows[:, 4:7], v1 - v0),
                      (rows[:, 8:11], v2 - v0)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not rows[:, 3::4].any()
    rows = brute.prepare_rows(tab, True)
    for got, want in ((rows[:, 0:3], v0), (rows[:, 4:7], v1),
                      (rows[:, 8:11], v2)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the twin rejects a degenerate triangle for every ray: straight down
    # through its first vertex
    o = v0 + torch.tensor([0.0, 0.0, 1.0])
    d = torch.tensor([0.0, 0.0, -1.0]).expand_as(o)
    hit = ray_triangle_watertight(o, d, T_MIN, 3e38, v0, v1, v2)[4]
    flag = rows[:, 3] == 1
    # the three degenerate ones, and the legs of 2^-64 and 2^-40, whose
    # squared cross products underflow to 0
    assert flag[36:39].all() and flag[0:4].all() and flag.sum() == 7
    assert not (hit & flag).any()
    assert not rows[:, 7::4].any()


def test_ptxas_report_names_the_kernels():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114"
        "closest_kernelINS_12MoellerSieveEEEvNS_4ArgsENS_10ClosestOutE' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110"
        "any_kernelINS_15WatertightSieveEEEvNS_4ArgsEPh' for 'sm_90a'",
        "ptxas info    : Used 80 registers, used 1 barriers"])
    rep = brute_ab.ptxas_report(log)
    assert rep == {"closest_moeller": dict(stack=8, spill_stores=4,
                                           spill_loads=4, registers=96),
                   "any_watertight": dict(registers=80)}
    assert set(rep) <= set(brute.KERNELS)
    assert brute.KERNELS[0] == "closest_moeller"


def test_dense_bound_counts():
    ms, by = common.dense_bound("closest", 1 << 20, 32)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 45 * (1 << 20) * 32 / common.PEAK_FLOPS)
    assert common.dense_bound("any", 1, 1)[0] == pytest.approx(
        1e3 * (29 + 48) / common.PEAK_BYTES)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

# (rays, table rows): ragged ray counts against tables around the tiles
# of the first port (128) and the resident limit (2048: 2049 streams)
_CUDA_CASES = [(1, 2048), (255, 127), (257, 128), (257, 129), (1000, 1),
               ((1 << 20) + 3, 2048), (4097, 2049), (300, 5000)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _cuda_set(dev, n_rays, n_tris, seed):
    rs = np.random.default_rng(seed)
    tab = common.random_soup(rs, n_tris)
    if n_tris == 1:     # one large triangle, so that some rays hit it
        tab[0, :9] = [-1.5, -1.5, 0.0, 1.5, -1.5, 0.0, 0.0, 1.5, 0.0]
    tab = torch.from_numpy(tab).to(dev)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(dev)
            for x in common.rays_inside(rs, n_rays, -1.5, 1.5))
    t_max = torch.from_numpy(
        rs.uniform(0.05, 3.0, n_rays).astype(np.float32)).to(dev)
    return tab, o, d, t_max


@pytest.mark.cuda
@pytest.mark.parametrize("watertight", [False, True], ids=WT_IDS)
@pytest.mark.parametrize("n_rays,n_tris", _CUDA_CASES,
                         ids=[f"r{r}-t{t}" for r, t in _CUDA_CASES])
def test_cuda_kernels_match_twins_bitwise(n_rays, n_tris, watertight):
    """Every field of every ray bit-equal to the twins; the wrappers
    launch once a cast and count it."""
    dev = _cuda()
    tab, o, d, t_max = _cuda_set(dev, n_rays, n_tris, n_rays + n_tris)
    scene = brute_ab.Soup(tab)
    want = brute.brute_closest_torch(tab, o, d, T_MIN, watertight)
    want_occ = brute.brute_any_torch(tab, o, d, t_max, T_MIN, watertight)
    lib, rows = brute.kernels().lib, brute.prepared_rows(scene, watertight)
    err, got = brute.launch_closest(lib.dcrt_brute_closest, tab, rows, o, d,
                                    T_MIN, watertight)
    brute._raise_on(err, "closest")
    err, occ = brute.launch_any(lib.dcrt_brute_any, rows, o, d, t_max, T_MIN,
                                watertight)
    brute._raise_on(err, "any")
    torch.cuda.synchronize()
    assert brute_ab.closest_diffs(got, want) == dict.fromkeys(
        brute_ab.FIELDS, 0)
    assert torch.equal(occ, want_occ)
    n_closest, n_any = brute.brute_closest.launches, brute.brute_any.launches
    got = brute.brute_closest(scene, o, d, T_MIN, watertight)
    occ = brute.brute_any(scene, o, d, t_max, T_MIN, watertight)
    torch.cuda.synchronize()
    assert brute.brute_closest.launches == n_closest + 1
    assert brute.brute_any.launches == n_any + 1
    assert not any(brute_ab.closest_diffs(got, want).values())
    assert torch.equal(occ, want_occ)
    assert torch.isfinite(want[0]).any() and want_occ.any()


@pytest.mark.cuda
@pytest.mark.parametrize("watertight", [False, True], ids=WT_IDS)
def test_cuda_adversarial_matches_twins(watertight):
    """The adversarial set, each triangle alone, bit-equal to the
    twins."""
    dev = _cuda()
    diffs = brute_ab.adversarial_diffs(dev, watertight)
    assert not any(diffs[f] for f in brute_ab.FIELDS + ("occ",)), diffs
    assert diffs["hits"] and diffs["occluded"]


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,n_tris", [(257, 2048), (4097, 2049)],
                         ids=["resident", "streamed"])
def test_cuda_kernels_write_only_their_rows(n_rays, n_tris):
    """Each output lies between two guard runs of a NaN pattern that must
    keep its bits, and equals the twin's bits."""
    dev = _cuda()
    tab, o, d, t_max = _cuda_set(dev, n_rays, n_tris, 91)
    lib, guard, stream = brute.kernels().lib, 4096, brute._stream()

    def guarded(elem, dtype):
        buf = torch.full((n_rays * elem + 2 * guard,), 0x7F, dtype=torch.uint8,
                         device=dev)
        return buf, buf[guard:guard + n_rays * elem].view(dtype)

    for wt in (False, True):
        rows = brute.prepare_rows(tab, wt)
        bufs = [guarded(4, torch.float32) for _ in range(3)] + [
            guarded(4, torch.int32) for _ in range(2)] + [
            guarded(1, torch.bool)]
        brute._raise_on(lib.dcrt_brute_closest(
            tab.data_ptr(), rows.data_ptr(), n_tris, o.data_ptr(),
            d.data_ptr(), n_rays, T_MIN, int(wt),
            *(out.data_ptr() for _, out in bufs), stream), "closest")
        occ = guarded(1, torch.bool)
        brute._raise_on(lib.dcrt_brute_any(
            rows.data_ptr(), n_tris, o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), n_rays, T_MIN, int(wt), occ[1].data_ptr(),
            stream), "any")
        torch.cuda.synchronize()
        for buf, _ in bufs + [occ]:
            assert (buf[:guard] == 0x7F).all()
            assert (buf[-guard:] == 0x7F).all()
        want = brute.brute_closest_torch(tab, o, d, T_MIN, wt)
        assert not any(brute_ab.closest_diffs(
            [out for _, out in bufs], want).values())
        assert torch.equal(occ[1], brute.brute_any_torch(
            tab, o, d, t_max, T_MIN, wt))


@pytest.mark.cuda
def test_cuda_launch_errors_raise():
    """A count the kernels cannot take (a negative row count) is
    refused with a CUDA error, and the wrapper's check raises on it."""
    dev = _cuda()
    tab, o, d, t_max = _cuda_set(dev, 64, 16, 5)
    rows = brute.prepare_rows(tab, False)
    lib, stream = brute.kernels().lib, brute._stream()
    out = [torch.empty(64, dtype=dt, device=dev) for dt in (
        torch.float32, torch.float32, torch.float32, torch.int32,
        torch.int32, torch.bool)]
    err = lib.dcrt_brute_closest(
        tab.data_ptr(), rows.data_ptr(), -1, o.data_ptr(), d.data_ptr(), 64,
        T_MIN, 0, *(x.data_ptr() for x in out), stream)
    assert err != 0
    with pytest.raises(RuntimeError):
        brute._raise_on(err, "brute_closest")
    assert lib.dcrt_brute_any(rows.data_ptr(), -1, o.data_ptr(),
                              d.data_ptr(), t_max.data_ptr(), 64, T_MIN, 0,
                              out[5].data_ptr(), stream) != 0
