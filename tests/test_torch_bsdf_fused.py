"""The BSDF kernels (`bsdf/fused.py`, `csrc/bsdf.cu`) against their twin,
`bsdf/dispatch.py`.

Inputs are numpy-seeded lanes that reach every branch: all five material
types, alpha on both sides of ALPHA_THRESHOLD (and 0), wo below the
shading normal on one- and two-sided materials, multiscattering on and
off, the three internal-scattering modes, ior in [1, 3] and outside it
(the LUTs' clamp) and 1 (matched media), grazing wo, wi = -wo (a zero
half vector) and wi . n = 0, the disk centre of the cosine sample; `ior`
is a strided view of material rows, as `shade_hit` gives it. Both the
committed LUT bake and `placeholder_luts`.

On CPU tensors the wrappers are the twin itself. The `cuda` cases hold
the kernels to the twin on the card: value and pdf within 1e-5 relative
plus 1e-7 absolute, wi within 2e-6 a component, is_delta exact. The
kernels round every product and sum as the twin's ops do (-fmad=false),
and on the card both take CUDA's sqrtf, sinf, cosf and atanf. A sample
whose u_sel lies within 1e-5 of a lobe-selection threshold (shifting
u_sel by 1e-5 changes the twin's direction) may pick another lobe after
an ulp elsewhere: those lanes are left out of the sample comparison and
counted, at most 1e-4 of the lanes.

The kernels' lane code also builds as C++ for the host (g++), which holds
its logic to the twin's on the CPU. There sin, cos and atan are glibc's
against PyTorch's CPU kernels, and PyTorch's CPU sqrt is not always
correctly rounded (an ulp off on 0.7 % of random inputs), so a lane may
differ by ulps, and an ulp of a sampled direction is amplified near the
disk's rim (sqrt(1 - p1^2 - p2^2)) and in refraction near grazing. So the
host case is held within 1e-3 relative (values, pdfs) and 1e-4 (wi), far
below what a wrong branch or formula gives, and draws its rough lobes from
alpha >= 1/16, below which the GGX peak turns an ulp of direction into a
large relative change of the value.

On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_bsdf_fused.py`.
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.bsdf import dispatch, fused
from directcomputeraytracing_tpu_torch.core import constants as C
from directcomputeraytracing_tpu_torch.core.types import Intersection
from directcomputeraytracing_tpu_torch.lut.textures import (
    load_luts,
    placeholder_luts,
)

RTOL, ATOL, WI_TOL = 1e-5, 1e-7, 2e-6
U_SHIFT = 1e-5                 # the lobe-threshold window of u_sel
THRESHOLD_SHARE = 1e-4         # at most this share of lanes in it
N_CUDA = 1 << 16
N_HOST = 1 << 14
LUTS = ("committed", "placeholder")
# the host build (see the module doc): over five seeds its evaluations
# came within 5.1e-6 relative of the twin's, its samples' values and pdfs
# within 1.02e-4, their wi within 1.91e-5
HOST_RTOL, HOST_WI_TOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are small, and with several
    threads the twin's first call in a process read other values in some
    runs (PyTorch 2.13's CPU kernels), which one thread never did."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_batch(n, seed, device, min_rough_alpha=0.0):
    """(wo, wi, u2, u_sel, itx) of n seeded lanes (see the module doc);
    min_rough_alpha: the least alpha of a rough lane (others are 0 or
    below ALPHA_THRESHOLD)."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    normal = _unit(rs.normal(size=(n, 3)))
    tangent = rs.normal(size=(n, 3))
    tangent = _unit(tangent - (tangent * normal).sum(1, keepdims=True)
                    * normal)
    # a tenth of the lanes in the axis frame, where a direction in the
    # tangent plane has a z of exactly 0
    axis = rs.random(n) < 0.1
    normal[axis] = (0.0, 0.0, 1.0)
    tangent[axis] = (1.0, 0.0, 0.0)
    bitangent = np.cross(normal, tangent)

    def plane(k):
        phi = rs.uniform(0.0, 2 * np.pi, (k, 1))
        return np.cos(phi), np.sin(phi)

    wo = _unit(rs.normal(size=(n, 3)))
    graze = rs.random(n) < 0.05            # grazing wo, in the plane
    c, s = plane(graze.sum())
    wo[graze] = c * tangent[graze] + s * bitangent[graze]
    near = (rs.random(n) < 0.05) & ~graze   # just off the plane
    c, s = plane(near.sum())
    wo[near] = _unit(c * tangent[near] + s * bitangent[near]
                     + rs.choice([-1e-3, 1e-3], (near.sum(), 1))
                     * normal[near])
    wi = _unit(rs.normal(size=(n, 3)))
    opposite = rs.random(n) < 0.05          # wi = -wo: zero half vector
    wi[opposite] = -wo[opposite]
    flat = (rs.random(n) < 0.05) & ~opposite   # wi . n = 0
    c, s = plane(flat.sum())
    wi[flat] = c * tangent[flat] + s * bitangent[flat]

    mtype = rs.integers(0, 5, n)
    roughness = rs.uniform(np.sqrt(min_rough_alpha), 1.0, n)
    alpha = roughness * roughness
    pick = rs.random(n)
    below = [0.0, 1e-6, 1e-4, 5.2e-4]       # below ALPHA_THRESHOLD
    above = [5.3e-4, 1e-3, 1e-2]
    alpha[pick < 0.1] = rs.choice(below, (pick < 0.1).sum())
    if not min_rough_alpha:
        few = (pick >= 0.1) & (pick < 0.2)
        alpha[few] = rs.choice(above, few.sum())
    albedo = rs.uniform(0.0, 1.0, (n, 3))
    cond = mtype == C.MATERIAL_TYPE_CONDUCTOR
    albedo[cond] = rs.uniform(0.0, 5.0, (cond.sum(), 3))   # absorption k
    ior = rs.uniform(0.5, 3.5, (n, 3))      # [1, 3] and the LUT clamp
    ior[rs.random(n) < 0.03] = 1.0          # matched media
    u2 = rs.random((n, 2))
    u2[rs.random(n) < 0.01] = 0.5           # the disk's centre

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(device)

    # ior as a strided view of material rows, as shade_hit gives it
    mrow = torch.zeros((n, 12), dtype=torch.float32, device=device)
    mrow[:, 3:6] = t(ior)
    itx = Intersection(
        albedo=t(albedo), alpha=t(alpha),
        position=torch.zeros((n, 3), device=device), normal=t(normal),
        tangent=t(tangent), geometry_normal=t(normal), ior=mrow[:, 3:6],
        is_two_sided=t(rs.random(n) < 0.5, torch.bool),
        backface=torch.zeros(n, dtype=torch.bool, device=device),
        multiscattering=t(rs.random(n) < 0.5, torch.bool),
        internal_mode=t(rs.integers(0, 3, n), torch.int64),
        material_type=t(mtype, torch.int64),
        light_index=torch.zeros(n, dtype=torch.int64, device=device),
        triangle_index=torch.zeros(n, dtype=torch.int32, device=device))
    return t(wo), t(wi), t(u2), t(rs.random(n)), itx


def _luts(kind, device):
    return load_luts(device) if kind == "committed" \
        else placeholder_luts(device)


def _far(got, want, rtol, atol):
    """Lanes (leading axis) where got and want differ beyond atol + rtol
    |want| in any component; equal non-finite values (NaN with NaN)
    agree."""
    got, want = got.double(), want.double()
    both_nan = torch.isnan(got) & torch.isnan(want)
    ok = (got == want) | both_nan | (
        (got - want).abs() <= atol + rtol * want.abs())
    return ~(ok.reshape(ok.shape[0], -1).all(1))


def _same(got, want):
    """Lanes whose values are all equal (NaN with NaN)."""
    eq = (got == want) | (torch.isnan(got) & torch.isnan(want)) \
        if got.is_floating_point() else got == want
    return eq.reshape(eq.shape[0], -1).all(1)


def _max_rel(got, want, lanes=None):
    """The largest |got - want| / (|want| + ATOL / RTOL) over the finite
    values of want (of the lanes given)."""
    rel = ((got.double() - want.double()).abs()
           / (want.double().abs() + ATOL / RTOL))
    ok = torch.isfinite(want)
    if lanes is not None:
        ok &= lanes.reshape(-1, *[1] * (want.dim() - 1))
    return float(rel[ok].max()) if ok.any() else 0.0


def threshold_lanes(luts, wo, u2, u_sel, itx, use_vndf):
    """Lanes whose twin direction or delta flag changes when u_sel moves
    by U_SHIFT either way: those within U_SHIFT of a lobe threshold."""
    wi0, _, _, d0 = dispatch.sample_bsdf(luts, wo, u2, u_sel, itx, use_vndf)
    out = torch.zeros_like(d0)
    for shift in (-U_SHIFT, U_SHIFT):
        wi1, _, _, d1 = dispatch.sample_bsdf(luts, wo, u2, u_sel + shift, itx,
                                             use_vndf)
        out |= ~_same(wi1, wi0) | (d1 != d0)
    return out


def compare(got_eval, got_sample, luts, batch, use_vndf, rtol=RTOL,
            wi_tol=WI_TOL):
    """The kernels' outputs against the twin's on one batch: a report of
    the lanes far from it (values and pdfs beyond rtol, wi beyond wi_tol,
    is_delta), the lanes left out at a lobe threshold,
    the bit-equal share and the largest relative differences."""
    wo, wi, u2, u_sel, itx = batch
    want_f = dispatch.evaluate_bsdf(luts, wi, wo, itx, use_vndf)
    want_p = dispatch.evaluate_bsdf_pdf(luts, wi, wo, itx, use_vndf)
    want_s = dispatch.sample_bsdf(luts, wo, u2, u_sel, itx, use_vndf)
    skip = threshold_lanes(luts, wo, u2, u_sel, itx, use_vndf)
    keep = ~skip
    rep = dict(
        lanes=wo.shape[0], threshold=int(skip.sum()),
        eval_far=int((_far(got_eval[0], want_f, rtol, ATOL)
                      | _far(got_eval[1], want_p, rtol, ATOL)).sum()),
        wi_far=int((_far(got_sample[0], want_s[0], 0.0, wi_tol)
                    & keep).sum()),
        sample_far=int(((_far(got_sample[1], want_s[1], rtol, ATOL)
                         | _far(got_sample[2], want_s[2], rtol, ATOL))
                        & keep).sum()),
        delta_diff=int(((got_sample[3] != want_s[3]) & keep).sum()))
    equal = _same(got_eval[0], want_f) & _same(got_eval[1], want_p)
    for g, w in zip(got_sample, want_s):
        equal &= _same(g, w)
    rep["bit_equal_share"] = float(equal.double().mean())
    for name, pairs, lanes in (
            ("eval", ((got_eval[0], want_f), (got_eval[1], want_p)), None),
            ("sample", zip(got_sample[:3], want_s[:3]), keep)):
        rep[f"max_rel_{name}"] = max(_max_rel(g, w, lanes) for g, w in pairs)
    return rep


def _assert_close(rep):
    print("bsdf kernels vs twin:", rep)
    assert rep["threshold"] <= THRESHOLD_SHARE * rep["lanes"], rep
    assert rep["eval_far"] == rep["wi_far"] == rep["sample_far"] \
        == rep["delta_diff"] == 0, rep


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", LUTS)
def test_cpu_wrappers_are_the_twin(kind, monkeypatch):
    """On CPU tensors both wrappers return the dispatch's outputs bit for
    bit, and neither builds nor launches a kernel."""
    monkeypatch.setattr(fused, "kernels", lambda: pytest.fail("built"))
    luts = _luts(kind, "cpu")
    wo, wi, u2, u_sel, itx = make_batch(4096, 7, "cpu")
    launches = (fused.evaluate_bsdf_value_pdf.launches,
                fused.sample_bsdf.launches)
    f, p = fused.evaluate_bsdf_value_pdf(luts, wi, wo, itx)
    assert torch.equal(f, dispatch.evaluate_bsdf(luts, wi, wo, itx))
    assert torch.equal(p, dispatch.evaluate_bsdf_pdf(luts, wi, wo, itx))
    got = fused.sample_bsdf(luts, wo, u2, u_sel, itx, False)
    want = dispatch.sample_bsdf(luts, wo, u2, u_sel, itx, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launches == (fused.evaluate_bsdf_value_pdf.launches,
                        fused.sample_bsdf.launches)


@pytest.fixture(scope="module")
def host_lib():
    """csrc/bsdf.cu's lane code built as host C++ (the entries loop over
    the lanes)."""
    from directcomputeraytracing_tpu_torch.ops import native
    from directcomputeraytracing_tpu_torch.utils.cuda_build import (
        load_library,
    )

    built = load_library("bsdf.cu", compiler=native.find_gxx,
                         flags=native.GXX_FLAGS + ("-x", "c++"),
                         name="bsdf_host")
    fused.bind(built.lib)
    return built.lib


@pytest.mark.parametrize("use_vndf", [True, False], ids=["vndf", "ndf"])
@pytest.mark.parametrize("kind", LUTS)
def test_host_build_matches_twin(kind, use_vndf, host_lib):
    """The kernels' lane code, run on the host, against the twin."""
    luts = _luts(kind, "cpu")
    batch = make_batch(N_HOST, 11 + use_vndf, "cpu", min_rough_alpha=1 / 16)
    wo, wi, u2, u_sel, itx = batch
    err, got_eval = fused.launch_eval(host_lib, luts, wi, wo, itx, use_vndf)
    assert err == 0
    err, got_sample = fused.launch_sample(host_lib, luts, wo, u2, u_sel, itx,
                                          use_vndf)
    assert err == 0
    _assert_close(compare(got_eval, got_sample, luts, batch, use_vndf,
                          HOST_RTOL, HOST_WI_TOL))


def test_host_build_reads_strided_and_converted_fields(host_lib):
    """Fields of other dtypes and layouts (int32 types, a transposed wo,
    expanded rows) give the outputs of contiguous ones."""
    luts = _luts("committed", "cpu")
    wo, wi, u2, u_sel, itx = make_batch(512, 3, "cpu")
    want = fused.launch_eval(host_lib, luts, wi, wo, itx, True)[1]
    itx2 = itx._replace(
        material_type=itx.material_type.to(torch.int32),
        internal_mode=itx.internal_mode.to(torch.int32),
        albedo=itx.albedo[:1].expand(512, 3))
    want2 = fused.launch_eval(host_lib, luts, wi, wo, itx._replace(
        albedo=itx.albedo[:1].repeat(512, 1)), True)[1]
    got = fused.launch_eval(host_lib, luts, wi, wo.T.contiguous().T, itx,
                            True)[1]
    got2 = fused.launch_eval(host_lib, luts, wi, wo, itx2, True)[1]
    for g, w in zip(got + got2, want + want2):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        fused.launch_eval(host_lib, luts, wi[:-1], wo, itx, True)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_vndf", [True, False], ids=["vndf", "ndf"])
@pytest.mark.parametrize("kind", LUTS)
def test_cuda_kernels_match_twin(kind, use_vndf):
    """Both kernels against the twin on the card, 2^16 lanes; the
    wrappers launch once a call and count it."""
    dev = _cuda()
    luts = _luts(kind, dev)
    batch = make_batch(N_CUDA, 20261018 + use_vndf, dev)
    wo, wi, u2, u_sel, itx = batch
    launches = (fused.evaluate_bsdf_value_pdf.launches,
                fused.sample_bsdf.launches)
    got_eval = fused.evaluate_bsdf_value_pdf(luts, wi, wo, itx, use_vndf)
    got_sample = fused.sample_bsdf(luts, wo, u2, u_sel, itx, use_vndf)
    torch.cuda.synchronize()
    assert (fused.evaluate_bsdf_value_pdf.launches,
            fused.sample_bsdf.launches) == (launches[0] + 1, launches[1] + 1)
    _assert_close(compare(got_eval, got_sample, luts, batch, use_vndf))


@pytest.mark.cuda
def test_cuda_cornell_image_matches_twin(monkeypatch):
    """Cornell glossy at 256^2, 1 spp, through the kernels and through the
    twin on the card: the benchmark's check reads a median pixel gap of
    at most 1e-6 and at most 1e-3 of the pixels diverged."""
    from benchmark.check import numbers
    from directcomputeraytracing_tpu_torch import Renderer, cornell_box
    from directcomputeraytracing_tpu_torch.integrator import megakernel

    dev = _cuda()

    def render(graphed):
        r = Renderer(*cornell_box("area", "glossy"), 256, 256, max_bounce=4,
                     device=dev)
        if not graphed:
            r._graphs = None
        return r.render(spp=1)

    launches = fused.sample_bsdf.launches
    fast = render(True)
    assert fused.sample_bsdf.launches == launches + 5
    monkeypatch.setattr(
        megakernel, "evaluate_bsdf_value_pdf",
        lambda luts, wi, wo, itx, v: (
            dispatch.evaluate_bsdf(luts, wi, wo, itx, v),
            dispatch.evaluate_bsdf_pdf(luts, wi, wo, itx, v)))
    monkeypatch.setattr(megakernel, "sample_bsdf", dispatch.sample_bsdf)
    # the twin's host-built constants keep it out of CUDA graphs
    twin = render(False)
    got = numbers([fast], [twin])
    print("cornell 256^2 kernels vs twin:", got)
    assert got["pixel_gap_median"] <= 1e-6, got
    assert got["diverged_share"] <= 1e-3, got
