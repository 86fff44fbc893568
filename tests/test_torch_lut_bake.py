"""The LUT bake: the port's estimator, averages and bake against the
reference on the CPU.

- The estimator, exactly: each bake body's per-chunk terms and mean
  (`brdf_terms`, `dielectric_terms`) on the same numpy
  uniforms against the same composition of the reference's public
  `bsdf` functions: every sample's term within 1e-5 (1 + |term|) but
  for at most 1 in 10^4 (texel, sample) pairs, which the test counts
  (XLA rounds the BSDF chain differently, so a sample whose selection
  draw or total-internal-reflection test lies an ulp from its threshold
  may take the other branch; the eta axis [1, 3] also differs from the
  reference's in a few points by an ulp, see `bake._axis`), and every
  texel's mean within 1e-5 where none of its terms flipped.
- `_average` against the reference's on the committed tables, 1e-6.
- The noise gate: the port draws its samples from `torch.Generator`s,
  not from `jax.random`'s bits, so its bake equals the reference's only
  up to Monte-Carlo noise. The port's `bake_luts(seed=1, quality=0.25)`
  against the reference's: the mean and the max absolute difference of
  each table within twice the reference's own spread between two seeds
  at that quality. The spread was measured once, over the ten pairs of
  seeds 1-5 (`SPREAD`: per table the largest mean and the largest max
  over the pairs). All texels of a table share each chunk's samples, so
  a table's error is nearly one draw for all its texels and one pair's
  spread varies several-fold: the BRDF's mean spread is 0.00273 between
  seeds 1 and 2 and 0.00942 between 1 and 4.
- `tests/test_lut.py`'s white-furnace cases on the port's bake.
- `bake_luts_cached` with a `tmp_path` cache, and with its defaults,
  which load the committed bake.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.lut import bake
from directcomputeraytracing_tpu_torch.lut.textures import (
    BxDFLuts,
    committed_lut_path,
    load_luts,
    save_luts,
)

CPU = torch.device("cpu")
EST_TOL = 1e-5
N_EST = 64                  # samples of the estimator's chunk
# the reference's own spread at quality 0.25 over the pairs of seeds 1-5:
# table -> (largest mean, largest max absolute difference of a pair)
SPREAD = {"brdf": (0.00942, 0.01591), "brdf_avg": (0.00937, 0.01483),
          "brdf_dielectric": (0.00235, 0.02126),
          "brdf_dielectric_avg": (0.00206, 0.01078),
          "bsdf": (0.00163, 0.01003), "bsdf_avg": (0.00155, 0.00450)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniforms(seed=0):
    rs = np.random.default_rng(seed)
    return rs.random((N_EST, 2), dtype=np.float32), \
        rs.random(N_EST, dtype=np.float32)


FLIP_SHARE = 1e-4


def _ref_terms(val, wi, pdf):
    import jax.numpy as jnp

    return np.asarray(jnp.where(pdf > 0.0, val * jnp.abs(wi[..., 2])
                                / jnp.maximum(pdf, 1e-20), 0.0))


def _assert_estimates_match(got_terms, want_terms):
    """The estimator gate of the module docstring."""
    close = np.abs(got_terms - want_terms) <= EST_TOL * (
        1 + np.abs(want_terms))
    assert (~close).mean() <= FLIP_SHARE, np.argwhere(~close)[:8]
    clean = close.all(-1)
    assert clean.mean() > 0.99
    np.testing.assert_allclose(got_terms.mean(-1)[clean],
                               want_terms.mean(-1)[clean], rtol=0,
                               atol=EST_TOL)


def test_brdf_estimator_matches_the_reference():
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.bsdf.ggx import (
        eval_ct_brdf,
        pdf_ct_brdf,
        sample_ggx_m,
    )
    from directcomputeraytracing_tpu.lut import bake as rb

    u2, _ = _uniforms()
    cos_o = jnp.maximum(rb._axis(rb.BRDF_COS), 1e-4)
    a = rb._axis(rb.BRDF_ALPHA)[:, None, None]
    wo = rb._wo_from_cos(cos_o)[None, :, None, :]
    m = sample_ggx_m(wo, jnp.asarray(u2)[None, None], a, use_vndf=True)
    wi = 2.0 * jnp.sum(wo * m, -1, keepdims=True) * m - wo
    wdm = jnp.sum(wo * m, -1)
    want = _ref_terms(eval_ct_brdf(wi, wo, a, m, wdm), wi,
                      pdf_ct_brdf(wi, wo, a, m, wdm, use_vndf=True))
    got = bake.brdf_terms(torch.from_numpy(u2)).numpy()
    assert got.shape == (32, 32, N_EST)
    _assert_estimates_match(got, want)


@pytest.mark.parametrize("is_bsdf", [False, True], ids=["brdf", "bsdf"])
def test_dielectric_estimator_matches_the_reference(is_bsdf):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.bsdf.fresnel import fresnel_dielectric
    from directcomputeraytracing_tpu.bsdf.ggx import (
        eval_ct_brdf,
        eval_ct_bsdf,
        pdf_ct_brdf,
        pdf_ct_bsdf,
        sample_ct_bsdf,
        sample_ggx_m,
    )
    from directcomputeraytracing_tpu.lut import bake as rb

    u2, u_sel = _uniforms(1)
    cos_o = jnp.maximum(rb._axis(rb.DIEL_COS), 1e-4)
    alpha = rb._axis(rb.DIEL_ALPHA)
    eta = rb._axis(rb.DIEL_ETA, rb.ETA_START, rb.ETA_END)
    side = jnp.asarray([0.0, 1.0], jnp.float32)[:, None, None, None, None]
    et = eta[None, :, None, None, None]
    eta_o = jnp.where(side == 1.0, et, 1.0)[..., 0][..., None]
    eta_i = jnp.where(side == 1.0, 1.0, et)[..., 0][..., None]
    a = alpha[None, None, :, None, None]
    wo = rb._wo_from_cos(cos_o)[None, None, None, :, None, :]
    u = jnp.asarray(u2)[None, None, None, None]
    if is_bsdf:
        us = jnp.asarray(u_sel)[None, None, None, None]
        wi, m, wdm = sample_ct_bsdf(wo, us, u, a, eta_o, eta_i,
                                    use_vndf=True)
        val = eval_ct_bsdf(wi, wo, a, eta_o, eta_i, scale_factor=False)
        pdf = pdf_ct_bsdf(wi, wo, a, eta_o, eta_i, use_vndf=True)
    else:
        m = sample_ggx_m(wo, u, a, use_vndf=True)
        wi = 2.0 * jnp.sum(wo * m, -1, keepdims=True) * m - wo
        wdm = jnp.sum(wo * m, -1)
        val = eval_ct_brdf(wi, wo, a, m, wdm) * fresnel_dielectric(
            wdm, eta_o, eta_i)
        pdf = pdf_ct_brdf(wi, wo, a, m, wdm, use_vndf=True)
    want = _ref_terms(val, wi, pdf)
    got = bake.dielectric_terms(torch.from_numpy(u2),
                                torch.from_numpy(u_sel), is_bsdf)
    assert got.shape == (2, 16, 16, 32, N_EST)
    _assert_estimates_match(got.numpy(), want)
    # the sliced integration of a bake body gives the same terms
    part = bake.dielectric_terms(torch.from_numpy(u2),
                                 torch.from_numpy(u_sel), is_bsdf,
                                 slice(4, 6))
    np.testing.assert_array_equal(part.numpy(), got[:, 4:6].numpy())


def test_axes_match_the_reference():
    import jax.numpy as jnp

    for n in (32, 16):
        np.testing.assert_array_equal(
            bake._axis(n).numpy(), np.asarray(jnp.linspace(0, 1, n,
                                                           dtype=jnp.float32)))
    np.testing.assert_allclose(bake._axis(16, 1.0, 3.0).numpy(),
                               np.linspace(1, 3, 16), rtol=0, atol=1e-6)


def test_average_matches_the_reference():
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.lut import bake as rb

    with np.load(committed_lut_path()) as data:
        for k in ("brdf", "brdf_dielectric", "bsdf"):
            got = bake._average(torch.from_numpy(data[k])).numpy()
            want = np.asarray(rb._average(jnp.asarray(data[k])))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            np.testing.assert_allclose(np.clip(got, 0, 1), data[k + "_avg"],
                                       rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def luts():
    return bake.bake_luts(seed=1, quality=0.25, device=CPU)


def test_bake_within_the_reference_noise(luts):
    from directcomputeraytracing_tpu.lut.bake import bake_luts as ref_bake

    ref = ref_bake(seed=1, quality=0.25)
    for k, (mean_s, max_s) in SPREAD.items():
        got, want = getattr(luts, k).numpy(), np.asarray(getattr(ref, k))
        assert got.shape == want.shape and got.dtype == np.float32, k
        diff = np.abs(got - want)
        assert diff.mean() <= 2 * mean_s, (k, diff.mean())
        assert diff.max() <= 2 * max_s, (k, diff.max())


# --- tests/test_lut.py's white-furnace cases on the port's bake ---------

def test_brdf_smooth_row_is_one(luts):
    np.testing.assert_allclose(luts.brdf.numpy()[0], 1.0, atol=1e-6)


def test_brdf_energy_below_one_and_decreasing(luts):
    e = luts.brdf.numpy()
    assert e.max() <= 1.0 + 1e-3
    assert e[-1, 3] < e[4, 3]
    assert e[-1, -1] < 0.95


def test_bsdf_energy_near_one(luts):
    e = luts.bsdf.numpy()
    assert e.max() <= 1.0 + 1e-3
    np.testing.assert_allclose(e[:, :, 0, :], 1.0, atol=1e-6)


def test_dielectric_brdf_smooth_is_fresnel(luts):
    from directcomputeraytracing_tpu_torch.bsdf.fresnel import (
        fresnel_dielectric,
    )

    e = luts.brdf_dielectric.numpy()
    cos = np.maximum(np.linspace(0, 1, 32, dtype=np.float32), 1e-4)
    eta = np.linspace(1, 3, 16, dtype=np.float32)
    for side in (0, 1):
        for ei in (3, 9):
            eta_o = eta[ei] if side == 1 else 1.0
            eta_i = 1.0 if side == 1 else eta[ei]
            f = fresnel_dielectric(torch.from_numpy(cos),
                                   torch.tensor(eta_o), torch.tensor(eta_i))
            np.testing.assert_allclose(e[side, ei, 0], f.numpy(), atol=2e-3)


def test_average_matches_independent_trapezoid(luts):
    e = luts.brdf.numpy()
    n = e.shape[1] - 1
    cos = np.linspace(0, 1, e.shape[1])
    f = np.clip(e, 0, 1) * cos
    expected = (f[:, 1:-1].sum(1) + 0.5 * (e[:, 0] * 1e-4 + e[:, -1])) \
        * 2.0 / n
    np.testing.assert_allclose(luts.brdf_avg.numpy(), np.clip(expected, 0, 1),
                               atol=1e-5)


def test_monte_carlo_consistency():
    e1 = bake._bake_brdf(torch.Generator().manual_seed(0), 2, 2048)
    e2 = bake._bake_brdf(torch.Generator().manual_seed(9), 2, 2048)
    assert (e1 - e2).abs().mean() < 0.01


# --- the cache ---------------------------------------------------------

def test_cached_bake_writes_and_reloads(tmp_path, monkeypatch):
    path = tmp_path / "luts.npz"
    calls = []

    def counted(**kw):
        """A stand-in bake (the committed tables, halved): the cache is
        under test here, the bake above."""
        calls.append(kw)
        return BxDFLuts(*(x * 0.5 for x in load_luts(kw["device"])))

    monkeypatch.setattr(bake, "bake_luts", counted)
    first = bake.bake_luts_cached(seed=3, quality=0.5, cache_path=str(path),
                                  device=CPU)
    assert path.exists() and len(calls) == 1
    again = bake.bake_luts_cached(seed=3, quality=0.5, cache_path=str(path),
                                  device=CPU)
    assert len(calls) == 1
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert isinstance(again, BxDFLuts)
    assert calls == [dict(seed=3, quality=0.5, device=CPU)]
    assert torch.equal(again.brdf, load_luts(CPU).brdf * 0.5)


def test_cached_bake_defaults_load_the_committed_file(monkeypatch):
    def refuse(**kw):
        raise AssertionError("the defaults must not bake")

    monkeypatch.setattr(bake, "bake_luts", refuse)
    got = bake.bake_luts_cached(device=CPU)
    want = load_luts(CPU)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    import directcomputeraytracing_tpu_torch as port_pkg

    assert port_pkg.bake_luts_cached is bake.bake_luts_cached


def test_save_and_load_luts_round_trip(tmp_path):
    luts = load_luts(CPU)
    save_luts(tmp_path / "x.npz", luts)
    for a, b in zip(load_luts(CPU, tmp_path / "x.npz"), luts):
        assert torch.equal(a, b)
    # the reference reads the port's file
    from directcomputeraytracing_tpu.lut.textures import load_luts as ref_load

    ref = ref_load(str(tmp_path / "x.npz"))
    np.testing.assert_array_equal(np.asarray(ref.bsdf), luts.bsdf.numpy())


@pytest.mark.cuda
def test_cuda_bake_within_the_noise():
    """The card's bake (quality 0.25, seed 1) against the committed bake:
    the noise gate's bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = bake.bake_luts(seed=1, quality=0.25, device="cuda")
    want = load_luts("cuda")
    for k, (mean_s, max_s) in SPREAD.items():
        diff = (getattr(got, k) - getattr(want, k)).abs()
        assert float(diff.mean()) <= 2 * mean_s, k
        assert float(diff.max()) <= 2 * max_s, k


def measure_spread(seeds=range(1, 6), quality=0.25):
    """Print the reference bake's spread between each pair of `seeds` at
    `quality` (the figures `SPREAD` keeps: per table the largest mean and
    max over the pairs) and the port's seed-1 bake against the
    reference's. Run from the repository root:
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_lut_bake.py
    """
    import itertools

    from directcomputeraytracing_tpu.lut.bake import bake_luts as ref_bake

    ref = {s: ref_bake(seed=s, quality=quality) for s in seeds}
    port = bake.bake_luts(seed=1, quality=quality, device=CPU)
    for k in BxDFLuts._fields:
        pairs = {(a, b): np.abs(np.asarray(getattr(ref[a], k))
                                - np.asarray(getattr(ref[b], k)))
                 for a, b in itertools.combinations(seeds, 2)}
        own = np.abs(getattr(port, k).numpy() - np.asarray(getattr(ref[1],
                                                                   k)))
        print(k, "pairs (mean, max):",
              {f"{a}-{b}": (round(float(d.mean()), 5), round(float(d.max()),
                                                           5))
               for (a, b), d in pairs.items()},
              "largest:", (round(max(float(d.mean()) for d in pairs.values()),
                                 5),
                           round(max(float(d.max()) for d in pairs.values()),
                                 5)),
              "port seed 1:", (round(float(own.mean()), 5),
                               round(float(own.max()), 5)))


if __name__ == "__main__":
    measure_spread()
