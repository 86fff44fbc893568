"""The port's reconstruction filters against the reference's, on the CPU.

`filter_weight` on every kind over a grid of offsets and
`convolve_sample_pass` on an odd-sized frame (23 x 37) at radii 0.5 to 3,
with jitter and values from a numpy seed. Tolerance: rtol 1e-5, atol
1e-6. The two evaluate the same float32 expressions (exp, sin and the
polynomials round within an ulp or two between XLA's and PyTorch's CPU
kernels), and the convolution sums the footprint's terms in the same
order, so the sums differ by a few ulps at most. The reference's own
filter tests (constant input, box identity, the Mitchell and Gaussian
formulas) run on the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu.film import filters as ref
from directcomputeraytracing_tpu_torch.film import filters as port

KINDS = ["box", "triangle", "gaussian", "mitchell", "lanczos"]
RADII = [0.5, 1.0, 1.5, 2.0, 3.0]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(kind, radius):
    return (ref.FilterParams(kind=kind, radius=radius),
            port.FilterParams(kind=kind, radius=radius))


def test_filter_params_defaults_equal_the_reference():
    assert port.FilterParams._fields == ref.FilterParams._fields
    assert tuple(port.FilterParams()) == tuple(ref.FilterParams())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius", [0.5, 2.0])
def test_filter_weight_matches_reference(kind, radius):
    d = np.linspace(-3.5, 3.5, 57, dtype=np.float32)
    dx, dy = (a.ravel() for a in np.meshgrid(d, d[::-1]))
    rp, pp = _params(kind, radius)
    want = np.asarray(ref.filter_weight(rp, jnp.asarray(dx),
                                        jnp.asarray(dy)))
    got = port.filter_weight(pp, torch.from_numpy(dx), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius", RADII)
def test_convolve_matches_reference(kind, radius):
    rng = np.random.default_rng(10 * KINDS.index(kind)
                                + RADII.index(radius))
    h, w = 23, 37
    pos = rng.random((h, w, 2), dtype=np.float32)
    val = (rng.random((h, w, 3), dtype=np.float32) * 4.0).astype(np.float32)
    rp, pp = _params(kind, radius)
    wv, ww = ref.convolve_sample_pass(jnp.asarray(pos), jnp.asarray(val),
                                      rp)
    gv, gw = port.convolve_sample_pass(torch.from_numpy(pos),
                                       torch.from_numpy(val), pp)
    assert gv.shape == (h, w, 3) and gw.shape == (h, w)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind,radius", [
    ("box", 0.5), ("box", 1.0), ("triangle", 2.0), ("gaussian", 2.0),
    ("mitchell", 2.0), ("lanczos", 4.0),
])
def test_constant_input_reconstructs_constant(kind, radius):
    """The reference's case on the port: a normalised filter gives back a
    constant image after the weighted resolve."""
    pos = torch.full((16, 16, 2), 0.5)
    val = torch.tensor([1.0, 2.0, 3.0]).expand(16, 16, 3).contiguous()
    vsum, wsum = port.convolve_sample_pass(
        pos, val, port.FilterParams(kind=kind, radius=radius))
    out = vsum[6:10, 6:10] / wsum[6:10, 6:10, None]
    np.testing.assert_allclose(out.numpy(), val[6:10, 6:10].numpy(),
                               rtol=1e-5)


def test_box_half_radius_is_identity():
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.random((8, 8, 2), np.float32))
    val = torch.from_numpy(rng.random((8, 8, 3), np.float32))
    vsum, wsum = port.convolve_sample_pass(
        pos, val, port.FilterParams(kind="box", radius=0.5))
    np.testing.assert_allclose(wsum.numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(vsum.numpy(), val.numpy(), rtol=1e-6)


def test_filter_weights_match_reference_formulas():
    zero, two = torch.tensor(0.0), torch.tensor(2.0)
    w0 = float(port.filter_weight(
        port.FilterParams(kind="mitchell", radius=2.0), zero, zero))
    np.testing.assert_allclose(w0, (16.0 / 18.0) ** 2, rtol=1e-5)
    w = float(port.filter_weight(
        port.FilterParams(kind="gaussian", radius=2.0, gaussian_alpha=1.5),
        two, zero))
    np.testing.assert_allclose(w, 0.0, atol=1e-7)


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        port.filter_weight(port.FilterParams(kind="sinc"), torch.zeros(1),
                           torch.zeros(1))
