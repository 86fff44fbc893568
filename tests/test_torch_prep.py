"""Ray prep (kernel row 6): the port's twin `prep_rays_torch` against the
reference's `_prep_rays_wl` and against its Pallas kernel `_prep_od_kernel`
run in interpret mode, and the CUDA kernel `prep_kernel` against the twin
on a card.

Inputs from a numpy seed, R not a multiple of the 1024-ray block, with
NaN and inf origins and directions, zero directions, components of
+-1e-31 (their reciprocals take +-1e-30), -0.0 components (+1e-30: the
sign comes from d >= 0) and tiny directions whose squared length
underflows to 0 or to a denormal (parked: the reference flushes
denormals to zero, and the port counts them as zero), a negative denormal
component (+1e-30, as flushed to -0.0); t_max None, a scalar and per
ray.

Tolerance: none. The twin runs the reference's float32 operations in its
order, so od and tm must be bit-equal to the reference's up to its larger
padding (a multiple of 8 blocks); the kernel, built without FMA
contraction and with IEEE division, must be bit-equal to the twin. The
reference is imported inside the tests that use it, so the `cuda` test
runs on a card's machine, which has no jax: `python -m pytest
--noconftest -m cuda tests/test_torch_prep.py`.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import worklist as wl

R = 2 * 1024 + 37


def _rays(n=R, seed=5):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[3, 0], o[4, 1], o[5, 2] = np.nan, np.inf, -np.inf
    d[6], d[7, 2], d[8, 1] = 0.0, np.nan, np.inf
    d[9] = (1e-31, -1e-31, 0.5)
    d[10] = (-0.0, 0.3, -0.0)
    d[11] = (1e-31, 0.0, -0.0)            # squared length underflows: parked
    d[12] = (-1e-31, 1e-20, 0.0)          # squares denormal: parked
    d[13] = (-1e-40, 0.5, 2e-19)          # a negative denormal: +1e30
    d[14] = (2e-19, 0.0, 0.0)             # square 4e-38, normal: kept
    t_max = rs.uniform(0.1, 3.0, n).astype(np.float32)
    return o, d, t_max


T_MAX_CASES = {"none": lambda t: None, "scalar": lambda t: 2.5,
               "per_ray": lambda t: t}


@pytest.mark.parametrize("case", list(T_MAX_CASES))
def test_twin_matches_reference_prep(case):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, t_max = _rays()
    t_max = T_MAX_CASES[case](t_max)
    od_r, tm_r, r_r = rwl._prep_rays_wl(
        jnp.asarray(o), jnp.asarray(d),
        None if t_max is None else jnp.asarray(t_max))
    od, tm, r = wl.prep_rays_torch(
        torch.from_numpy(o), torch.from_numpy(d),
        t_max if not isinstance(t_max, np.ndarray)
        else torch.from_numpy(t_max))
    rp = od.shape[1]
    assert r == r_r == R and rp % wl.RB == 0 and rp >= R > rp - wl.RB
    od_r, tm_r = np.asarray(od_r), np.asarray(tm_r)[0]
    np.testing.assert_array_equal(od_r[:, :rp], od.numpy())
    np.testing.assert_array_equal(tm_r[:rp], tm.numpy())
    # the reference's extra padding is the same far ray
    np.testing.assert_array_equal(od_r[:, rp:], od_r[:, -1:].repeat(
        od_r.shape[1] - rp, 1))
    parked = od.numpy()[:, [3, 4, 5, 6, 7, 8, 11, 12]]
    assert (parked[0] == np.float32(wl._FAR)).all()
    assert (parked[3] == 1.0).all() and (parked[4:6] == 0.0).all()
    assert od[6, 9] == np.float32(1e30) and od[7, 9] == np.float32(-1e30)
    assert od[6, 10] == od[8, 10] == np.float32(1e30)
    assert od[6, 13] == np.float32(1e30) and od[3, 14] == np.float32(2e-19)


def test_twin_matches_reference_pallas_kernel():
    """The reference's `_prep_od_kernel` through `pl.pallas_call` in
    interpret mode, with `_prep_od_pallas`'s grid and block specs, on the
    twin's sanitised, padded rays: the same (9, Rp) rows."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from directcomputeraytracing_tpu.accel import worklist as rwl

    o, d, _ = _rays(seed=6)
    od, _, _ = wl.prep_rays_torch(torch.from_numpy(o), torch.from_numpy(d))
    rp = od.shape[1]
    spec = pl.BlockSpec((rwl.RB, 3), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        rwl._prep_od_kernel, grid=(rp // rwl.RB,), in_specs=[spec, spec],
        out_specs=pl.BlockSpec((9, rwl.RB), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((9, rp), jnp.float32),
        interpret=True)(jnp.asarray(od[0:3].T.numpy()),
                        jnp.asarray(od[3:6].T.numpy()))
    np.testing.assert_array_equal(np.asarray(want), od.numpy())


def test_cpu_wrapper_runs_the_twin():
    o, d, t_max = (torch.from_numpy(x) for x in _rays(300))
    before = wl.prep_rays.launches
    for tm_in in (None, 1.5, t_max):
        got, want = wl.prep_rays(o, d, tm_in), wl.prep_rays_torch(o, d, tm_in)
        assert got[2] == want[2]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert wl.prep_rays.launches == before
    with pytest.raises(ValueError):
        wl.prep_rays(o.double(), d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(T_MAX_CASES) + ["tensor_scalar"])
def test_cuda_kernel_matches_twin(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    o, d, t_max = (torch.from_numpy(x).to(dev) for x in _rays(100_003, 7))
    t_in = (torch.tensor(2.5, device=dev) if case == "tensor_scalar"
            else T_MAX_CASES[case](t_max))
    before = wl.prep_rays.launches
    od, tm, r = wl.prep_rays(o, d, t_in)
    od_w, tm_w, r_w = wl.prep_rays_torch(o, d, t_in)
    torch.cuda.synchronize()
    assert wl.prep_rays.launches == before + 1 and r == r_w
    assert torch.equal(od, od_w) and torch.equal(tm, tm_w)
