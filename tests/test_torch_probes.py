"""The two probe kernels (rows 18 and 19): the port's twins against the
reference's probes in interpret mode on the CPU, and the CUDA kernels
against the twins on a card.

Row 18, the item-list probe: the reference's `kernel`, loaded from
`experiments/probe_worklist.py` (its `main` only runs as a script),
through a `PrefetchScalarGridSpec` `pallas_call` built as its `run`
builds it, in interpret mode, on 4 ray blocks, 8 slabs and 3 items a
block, some invalid, one block restarting its running min mid-segment;
inputs from a numpy seed. Every block holds a valid first-flagged item,
so every output block is written (the reference leaves one without any
unset; the port writes 3e38 there, checked on the twin alone). Row 19,
the layout probe: the reference's (R, 16) table and its transpose.

Tolerances. Row 18 against the reference: the twin sums in the kernel's
order (c = 0 a product, then adds in column order), but XLA's CPU
backend contracts and reorders the interpret-mode kernel's multiply-adds
(a third of the lanes differ, by 1-2 ulps; an FMA replay matches 96 %
of them), so the twin is held within 12 ulps of the largest sum of
|terms|, a bound for any order of the 12-term sum; the min and the
running min are order-free. Row 19: none, a transpose moves bits. The
kernels, built without FMA contraction, must equal the twins bit for
bit: `python -m pytest --noconftest -m cuda tests/test_torch_probes.py`.

The min's edges: on `probe_worklist.crafted_inputs` (lanes at +-0, NaN,
+-inf; a NaN slab entry; -0 and +0 sums meeting in one block) the twin
equals the reference's kernel exactly in NaN positions, infinities and
the sign of every zero, and within the 12 ulps above elsewhere; the
kernel equals the twin bit for bit there too (a NaN equal to any NaN),
and on ragged item lists of 1 to 200 ray blocks.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.tools import prof_prep
from directcomputeraytracing_tpu_torch.tools import probe_worklist as pw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS, N_SLABS, PER = 4, 8, 3


def _ref_probe():
    spec = importlib.util.spec_from_file_location(
        "ref_probe_worklist",
        os.path.join(REPO, "experiments", "probe_worklist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _items():
    """PER items a block over scattered slabs; item 1 of block 2 invalid,
    item 2 of block 1 restarts the running min (first bit set)."""
    items = pw.make_items(N_BLOCKS * PER, N_BLOCKS, N_SLABS)
    slabs = (np.arange(items.size) * 3 + 1) % N_SLABS
    items = (items & ~(0xFFFF << 2)) | (slabs << 2).astype(np.int32)
    items[2 * PER + 1] &= ~1
    items[PER + 2] |= 2
    return items


def test_item_list_twin_matches_reference_kernel():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    ref = _ref_probe()
    tab, o = pw.make_inputs(3, N_BLOCKS, N_SLABS)
    items = _items()
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(items.size,),
        in_specs=[pl.BlockSpec((ref.CS, 12),
                               lambda i, it: ((it[i] >> 2) & 0xFFFF, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, ref.RB), lambda i, it: (0, it[i] >> 18),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, ref.RB), lambda i, it: (0, it[i] >> 18),
                               memory_space=pltpu.VMEM))
    want = pl.pallas_call(
        ref.kernel, grid_spec=grid_spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct((1, N_BLOCKS * ref.RB), jnp.float32),
    )(jnp.asarray(items), jnp.asarray(tab), jnp.asarray(o))
    got = pw.item_list(torch.from_numpy(items), torch.from_numpy(tab),
                       torch.from_numpy(o))
    assert got.shape == (1, N_BLOCKS * pw.RB)
    terms = np.abs(tab).reshape(-1, pw.CS, pw.COLS).sum(2).max() \
        * np.abs(o[0]).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=12 * 2.0 ** -24 * terms)
    assert (got < pw.INIT).all()


def _reference(items, tab, o):
    """The reference's `kernel` over `items` in interpret mode, as its
    `run` launches it."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    ref = _ref_probe()
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(items.size,),
        in_specs=[pl.BlockSpec((ref.CS, 12),
                               lambda i, it: ((it[i] >> 2) & 0xFFFF, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, ref.RB), lambda i, it: (0, it[i] >> 18),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, ref.RB), lambda i, it: (0, it[i] >> 18),
                               memory_space=pltpu.VMEM))
    return np.asarray(pl.pallas_call(
        ref.kernel, grid_spec=grid_spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct((1, o.shape[1]), jnp.float32),
    )(jnp.asarray(items), jnp.asarray(tab), jnp.asarray(o)))


def test_item_list_twin_matches_reference_on_crafted_set():
    """NaN positions, infinities and zero signs exactly; finite non-zero
    lanes within 12 ulps of the largest sum of |terms|."""
    items, tab, o = pw.crafted_inputs()
    want = _reference(items, tab, o)
    got = pw.item_list(torch.from_numpy(items), torch.from_numpy(tab),
                       torch.from_numpy(o)).numpy()
    assert got.shape == want.shape == (1, 4 * pw.RB)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    # the set reaches every edge it was made for
    blocks = want.reshape(4, pw.RB)
    zeros = blocks[:2, 1::16]
    x = o[0].reshape(4, pw.RB)
    assert np.isnan(blocks[3]).all()
    assert not np.isnan(blocks[2][np.isfinite(x[2])]).any()
    assert (zeros == 0).all() and np.signbit(zeros).all()
    assert (blocks[:2, 0::16] == 0).all() and np.signbit(
        blocks[:2, 0::16]).all()
    edge = ~nan & (~np.isfinite(want) | (want == 0))
    assert edge.sum() > 0
    np.testing.assert_array_equal(got[edge].view(np.int32),
                                  want[edge].view(np.int32))
    fin = np.isfinite(o[0])
    terms = np.abs(tab[np.isfinite(tab).all(1)]).sum(1).max() \
        * np.abs(o[0, fin]).max()
    rest = ~nan & ~edge
    np.testing.assert_allclose(got[rest], want[rest], rtol=0,
                               atol=12 * 2.0 ** -24 * terms)


EDGES = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 3e38],
                 np.float32)


def _pair_inputs(within):
    """Every ordered pair (u, v) of EDGES, pair i in ray block i, x = 1:
    as rows 0 and 1 of one slab, the other rows 3e38 (within), or as two
    items whose slabs hold u and v in every row. A row's sum is its first
    entry: the other 11 columns are -0, which add nothing."""
    u, v = (e.ravel() for e in np.meshgrid(EDGES, EDGES, indexing="ij"))
    n = u.size
    o = np.ones((3, n * pw.RB), np.float32)
    if within:
        tab = np.full((n, pw.CS, pw.COLS), -0.0, np.float32)
        tab[:, :, 0] = np.float32(pw.INIT)
        tab[:, 0, 0], tab[:, 1, 0] = u, v
        items = (np.arange(n) << 18) | (np.arange(n) << 2) | 3
    else:
        tab = np.full((2 * n, pw.CS, pw.COLS), -0.0, np.float32)
        tab[0::2, :, 0], tab[1::2, :, 0] = u[:, None], v[:, None]
        k = np.arange(2 * n)
        items = ((k // 2) << 18) | (k << 2) | ((k % 2 == 0) << 1) | 1
    return items.astype(np.int32), tab.reshape(-1, pw.COLS), o


def test_item_list_twin_min_is_the_references():
    """The twin's min, on every ordered pair of edge values, in a slab's
    rows and across items, equals jnp.minimum's bits (NaN as NaN)."""
    import jax.numpy as jnp

    u, v = (e.ravel() for e in np.meshgrid(EDGES, EDGES, indexing="ij"))
    want = np.asarray(jnp.minimum(jnp.asarray(u), jnp.asarray(v)))
    want = np.where(np.isnan(want), want,
                    np.minimum(np.float32(pw.INIT), want))
    for within in (False, True):
        items, tab, o = _pair_inputs(within)
        got = pw.item_list_torch(*(torch.from_numpy(x)
                                   for x in (items, tab, o)))
        got = got.view(u.size, pw.RB)[:, 0]
        assert pw.diff(got, torch.from_numpy(want)) == 0, (
            within, u, v, got.numpy(), want)


def test_item_list_twin_restart_and_empty_block():
    """The running min restarts at a first-flagged valid item; a block
    without a valid item reads 3e38."""
    tab, o = pw.make_inputs(4, N_BLOCKS, N_SLABS)
    items = _items()
    items[3 * PER:] &= ~1                     # block 3: no valid item
    got = pw.item_list_torch(torch.from_numpy(items), torch.from_numpy(tab),
                             torch.from_numpy(o)).view(N_BLOCKS, pw.RB)
    assert (got[3] == np.float32(pw.INIT)).all()
    rows = tab.reshape(-1, pw.CS, pw.COLS)

    def red(item):
        x = o[0, (item >> 18) * pw.RB:((item >> 18) + 1) * pw.RB]
        s = rows[(item >> 2) & 0xFFFF]
        acc = s[:, 0:1] * x
        for c in range(1, pw.COLS):
            acc = acc + s[:, c:c + 1] * x
        return acc.min(0)

    np.testing.assert_array_equal(got[1].numpy(), red(items[PER + 2]))
    np.testing.assert_array_equal(
        got[0].numpy(), np.minimum.reduce([red(i) for i in items[:PER]]))


def _ref_table(o, d):
    """The reference probe's (R, 16) table and its transpose, as
    `experiments/prof_prep.py` builds them (`make_base`, `pallas_t`): that
    file times 1M-ray strategies when it is imported, so it cannot be
    loaded here."""
    import jax.numpy as jnp

    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
    return jnp.concatenate([o, d, inv, jnp.zeros((o.shape[0], 7),
                                                 jnp.float32)], axis=1)


def _ref_transpose(base, rb):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def tr_kernel(in_ref, out_ref):              # prof_prep._tr_kernel
        out_ref[:, :] = in_ref[:, :].T

    r = base.shape[0]
    return pl.pallas_call(
        tr_kernel, grid=(r // rb,), interpret=True,
        in_specs=[pl.BlockSpec((rb, 16), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((16, rb), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((16, r), jnp.float32))(base)


def test_transpose_twin_matches_reference():
    import jax.numpy as jnp

    o, d = prof_prep.make_rays(3 * 1024, seed=2)
    d[5] = (1e-31, -1e-31, -0.0)
    base_r = _ref_table(jnp.asarray(o), jnp.asarray(d))
    base = prof_prep.build_table(torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(np.asarray(base_r), base.numpy())
    want = np.asarray(_ref_transpose(base_r, 1024))
    got = prof_prep.transpose16(base)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want[:9], prof_prep.layout_rows(
        torch.from_numpy(o), torch.from_numpy(d)).numpy())


def test_cpu_wrappers_run_the_twins():
    tab, o = (torch.from_numpy(x) for x in pw.make_inputs(1, 2, 4))
    items = torch.from_numpy(pw.make_items(8, 2, 4))
    x = torch.randn(100, 16)
    before = pw.item_list.launches, prof_prep.transpose16.launches
    assert torch.equal(pw.item_list(items, tab, o),
                       pw.item_list_torch(items, tab, o))
    assert torch.equal(prof_prep.transpose16(x), x.T)
    assert (pw.item_list.launches, prof_prep.transpose16.launches) == before
    with pytest.raises(ValueError):
        prof_prep.transpose16(x[:, :9])


@pytest.mark.cuda
def test_cuda_kernels_match_twins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    tab, o = (torch.from_numpy(x).to(dev) for x in pw.make_inputs(5))
    items = torch.from_numpy(pw.make_items(16384)).to(dev)
    got = pw.item_list(items, tab, o)
    x = torch.randn(100_003, 16, device=dev)
    t = prof_prep.transpose16(x)
    torch.cuda.synchronize()
    assert torch.equal(got, pw.item_list_torch(items, tab, o))
    assert torch.equal(t, x.T.contiguous())


def _ragged_items(rng, counts, n_slabs):
    """Items of len(counts) ray blocks, counts[b] in block b: random
    slabs, a tenth invalid, each block's first item first-flagged, a
    restart in the middle of every block of 8 items or more, and a first
    bit on an invalid item (no restart) in every block of 4 or more."""
    out = []
    for b, n in enumerate(counts):
        slab = rng.integers(0, n_slabs, n)
        valid = rng.random(n) > 0.1
        first = np.zeros(n, bool)
        first[:1] = True
        if n >= 8:
            first[n // 2] = valid[n // 2] = True
        if n >= 4:
            first[n // 4 + 1], valid[n // 4 + 1] = True, False
        out.append((b << 18) | (slab << 2) | (first << 1) | valid)
    return np.concatenate(out).astype(np.int32) if out else np.zeros(
        0, np.int32)


def _cuda_case(case):
    """(items, tab, o) of a `cuda` test case."""
    if case == "crafted":
        return pw.crafted_inputs()
    if case.startswith("pairs"):
        return _pair_inputs(case == "pairs_within")
    if case.startswith("capacity"):
        return (pw.make_items(int(case[8:])), *pw.make_inputs(5))
    rng = np.random.default_rng(int(case[6:]))
    n_blocks = int(case[6:])
    counts = rng.integers(0, 24, n_blocks)
    # blocks of 0, 1 and 4096 items where there is room for them
    for b, n in ((0, 1), (1, 0), (2, 4096), (n_blocks - 1, 4096)):
        if b < n_blocks:
            counts[b] = n
    tab, o = pw.make_inputs(n_blocks, n_blocks, 300)
    return _ragged_items(rng, counts, 300), tab, o


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*(f"capacity{c}" for c in pw.CAPACITIES),
                                  "crafted", "pairs_across", "pairs_within",
                                  "blocks1", "blocks3", "blocks64",
                                  "blocks200"])
def test_cuda_item_list_matches_twin_bitwise(case):
    """The redesigned kernel against the twin, bit for bit (a NaN equal
    to any NaN): the reference's four capacities, the crafted set, every
    ordered pair of edge values within a slab and across items, and
    ragged lists of 1, 3, 64 and 200 ray blocks (not multiples of the
    split or of the SMs) with blocks of 0, 1 and 4096 items, invalid
    items and mid-segment restarts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    items, tab, o = (torch.from_numpy(x).to(dev) for x in _cuda_case(case))
    before = pw.item_list.launches
    got = pw.item_list(items, tab, o)
    torch.cuda.synchronize()
    assert pw.item_list.launches == before + 1
    want = pw.item_list_torch(items, tab, o)
    assert got.shape == want.shape
    assert pw.diff(got, want) == 0
