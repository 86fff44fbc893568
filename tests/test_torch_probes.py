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
