"""Kulla-Conty energy LUTs baked by Monte-Carlo integration.

Counterpart of `directcomputeraytracing_tpu.lut.bake` (the reference's
startup GPU bake, INTEGRATE_COOKTORRANCE_BXDF / INTEGRATE_AVERAGE): for
every LUT texel (cosThetaO, alpha[, eta, side]) the directional albedo
E = (1/N) sum f(wi, wo) |wi.z| / pdf is estimated with VNDF importance
sampling (the BSDF without the refraction scale factor), and
Eavg = 2 * trapezoid(E(c) * c) over the cos axis. All texels of a LUT
share each chunk's samples; the chunk means (float32) are averaged at the
end. The axes, chunk sizes, sample counts per quality, smooth-row paths
and clipping are the reference's.

The samples come from one `torch.Generator` per table on the bake's
device, seeded from `seed`, not from `jax.random`'s bits, so the port's
bake equals the reference's only up to Monte-Carlo noise (the tests hold
the estimator exactly on shared samples, and the bake to a noise gate).
A chunk's texels are integrated in slices of the leading axes (the mean
runs over samples only), which bounds the memory of a chunk.
"""

import os

import torch

from ..bsdf.fresnel import fresnel_dielectric
from ..bsdf.ggx import (
    eval_ct_brdf,
    eval_ct_bsdf,
    pdf_ct_brdf,
    pdf_ct_bsdf,
    sample_ct_bsdf,
    sample_ggx_m,
)
from ..core.constants import ALPHA_THRESHOLD
from ..sampling.montecarlo import dot
from .textures import (
    BxDFLuts,
    committed_lut_path,
    load_luts,
    save_luts,
)

# LUT dimensions (the reference's BxDFTextureDef)
BRDF_COS = 32
BRDF_ALPHA = 32
DIEL_COS = 32
DIEL_ALPHA = 16
DIEL_ETA = 16
ETA_START = 1.0
ETA_END = 3.0
BRDF_CHUNK = 4096
DIEL_CHUNK = 1024


def _axis(n, lo=0.0, hi=1.0, device="cpu"):
    """n float32 points from lo to hi: lo * (1 - s) + hi * s with s = i
    times the float32 reciprocal of n - 1, the last point hi. On [0, 1]
    these are the reference's points bit for bit; the eta axis [1, 3]
    differs from them in a few points by an ulp or two."""
    s = torch.arange(n, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=torch.float32, device=device)
    out = lo * (1.0 - s) + hi * s
    out[-1] = hi
    return out


def _wo_from_cos(cos_o):
    sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
    return torch.stack([sin_o, torch.zeros_like(cos_o), cos_o], dim=-1)


def _average(e):
    """Eavg = 2 * trapezoid(E(c) * c) dc over the last (cos) axis, in the
    reference's composition: interior texels saturated and weighted by
    their cos, endpoint cos values 0.0001 and 1."""
    n = e.shape[-1] - 1
    cos = _axis(e.shape[-1], device=e.device)
    f = torch.clamp(e, 0.0, 1.0) * cos
    fa = e[..., 0] * 1e-4
    fb = e[..., -1]
    s = f[..., 1:-1].sum(-1)
    return (s + 0.5 * (fa + fb)) * (2.0 / n)


def _terms(val, wi, pdf):
    """Each sample's term f |wi.z| / pdf of the estimate (0 where the pdf
    is 0)."""
    return torch.where(pdf > 0.0, val * torch.abs(wi[..., 2])
                       / torch.clamp(pdf, min=1e-20), 0.0)


def brdf_terms(u2, alpha=None):
    """A chunk's terms of the Cook-Torrance BRDF's E over the (alpha,
    cos) texels: u2 (B, 2) uniforms -> (len(alpha), BRDF_COS, B); their
    mean over B is the chunk's estimate."""
    dev = u2.device
    cos_o = torch.clamp(_axis(BRDF_COS, device=dev), min=1e-4)
    alpha = _axis(BRDF_ALPHA, device=dev) if alpha is None else alpha
    wo = _wo_from_cos(cos_o)[None, :, None, :]    # (1, C, 1, 3)
    a = alpha[:, None, None].expand(-1, BRDF_COS, 1)   # (A, C, 1)
    u2 = u2[None, None]                           # (1, 1, B, 2)
    m = sample_ggx_m(wo, u2, a, use_vndf=True)
    wo_dot_m = dot(wo, m)
    wi = 2.0 * wo_dot_m[..., None] * m - wo
    val = eval_ct_brdf(wi, wo, a, m, wo_dot_m)
    pdf = pdf_ct_brdf(wi, wo, a, m, wo_dot_m, use_vndf=True)
    return _terms(val, wi, pdf)


def _diel_axes(dev):
    cos_o = torch.clamp(_axis(DIEL_COS, device=dev), min=1e-4)
    alpha = _axis(DIEL_ALPHA, device=dev)
    eta = _axis(DIEL_ETA, ETA_START, ETA_END, device=dev)
    side = torch.tensor([0.0, 1.0], device=dev)[:, None, None, None]
    et = eta[None, :, None, None]
    eta_o = torch.where(side == 1.0, et, 1.0)        # (2, E, 1, 1)
    eta_i = torch.where(side == 1.0, 1.0, et)
    return cos_o, alpha, eta_o, eta_i


def dielectric_terms(u2, u_sel, is_bsdf, eta_slice=slice(None)):
    """A chunk's terms of the dielectric-Fresnel-weighted BRDF's
    (is_bsdf False) or the BSDF's (True) E over the (side, eta, alpha,
    cos) texels, side 1 = entering (wo inside the denser medium: eta_o =
    eta, eta_i = 1): u2 (B, 2), u_sel (B,) uniforms (the BRDF ignores
    u_sel) -> (2, len(eta[eta_slice]), DIEL_ALPHA, DIEL_COS, B)."""
    dev = u2.device
    cos_o, alpha, eta_o, eta_i = _diel_axes(dev)
    eta_o = eta_o[:, eta_slice, ..., None]          # (2, E, 1, 1, 1)
    eta_i = eta_i[:, eta_slice, ..., None]
    a = alpha[None, None, :, None, None].expand(
        1, 1, -1, DIEL_COS, 1)                       # (1, 1, A, C, 1)
    wo = _wo_from_cos(cos_o)[None, None, None, :, None, :]
    u2 = u2[None, None, None, None]                  # (1, 1, 1, 1, B, 2)
    if is_bsdf:
        wi, m, wo_dot_m = sample_ct_bsdf(wo, u_sel[None, None, None, None],
                                         u2, a, eta_o, eta_i, use_vndf=True)
        val = eval_ct_bsdf(wi, wo, a, eta_o, eta_i, scale_factor=False)
        pdf = pdf_ct_bsdf(wi, wo, a, eta_o, eta_i, use_vndf=True)
    else:
        m = sample_ggx_m(wo, u2, a, use_vndf=True)
        wo_dot_m = dot(wo, m)
        wi = 2.0 * wo_dot_m[..., None] * m - wo
        val = eval_ct_brdf(wi, wo, a, m, wo_dot_m) * fresnel_dielectric(
            wo_dot_m, eta_o, eta_i)
        pdf = pdf_ct_brdf(wi, wo, a, m, wo_dot_m, use_vndf=True)
    return _terms(val, wi, pdf)


def _bake_brdf(gen, n_chunks, chunk):
    """E(cosTheta, alpha) of the Cook-Torrance BRDF -> (ALPHA, COS)."""
    dev = gen.device
    alpha = _axis(BRDF_ALPHA, device=dev)
    acc = torch.zeros((BRDF_ALPHA, BRDF_COS), device=dev)
    for _ in range(n_chunks):
        u2 = torch.rand((chunk, 2), generator=gen, device=dev)
        acc = acc + torch.cat([brdf_terms(u2, alpha[i:i + 8]).mean(-1)
                               for i in range(0, BRDF_ALPHA, 8)])
    e = acc / n_chunks
    return torch.where((alpha < ALPHA_THRESHOLD)[:, None], 1.0, e)


def _bake_dielectric(gen, n_chunks, chunk, is_bsdf):
    """E of the Fresnel-weighted BRDF (is_bsdf False) or the BSDF (True)
    -> (2, ETA, ALPHA, COS), leaving slices first."""
    dev = gen.device
    acc = torch.zeros((2, DIEL_ETA, DIEL_ALPHA, DIEL_COS), device=dev)
    for _ in range(n_chunks):
        u2 = torch.rand((chunk, 2), generator=gen, device=dev)
        u_sel = torch.rand((chunk,), generator=gen, device=dev)
        acc = acc + torch.cat([
            dielectric_terms(u2, u_sel, is_bsdf, slice(i, i + 2)).mean(-1)
            for i in range(0, DIEL_ETA, 2)], dim=1)
    e = acc / n_chunks
    cos_o, alpha, eta_o, eta_i = _diel_axes(dev)
    # perfectly smooth rows: the delta lobes' exact energy
    if is_bsdf:
        e_smooth = torch.ones_like(e)
    else:
        e_smooth = torch.broadcast_to(
            fresnel_dielectric(cos_o[None, None, None, :], eta_o, eta_i),
            e.shape)
    smooth = (alpha < ALPHA_THRESHOLD)[None, None, :, None]
    return torch.where(smooth, e_smooth, e)


def bake_luts(seed=0, quality=1.0, device="cuda"):
    """Bake all six LUTs on device. quality scales the sample counts (1.0
    = the reference's 5 x 4096 BRDF samples, 20 x 1024 and 96 x 1024 for
    the two dielectric tables)."""
    dev = torch.device(device)
    gens = [torch.Generator(device=dev).manual_seed(3 * int(seed) + j)
            for j in range(3)]
    n1 = max(1, round(5 * quality))
    n2 = max(1, round(20 * quality))
    n3 = max(1, round(96 * quality))
    brdf = _bake_brdf(gens[0], n1, BRDF_CHUNK)
    diel = _bake_dielectric(gens[1], n2, DIEL_CHUNK, is_bsdf=False)
    bsdf = _bake_dielectric(gens[2], n3, DIEL_CHUNK, is_bsdf=True)
    return BxDFLuts(
        brdf=torch.clamp(brdf, 0.0, 1.0),
        brdf_avg=torch.clamp(_average(brdf), 0.0, 1.0),
        brdf_dielectric=torch.clamp(diel, 0.0, 1.0),
        brdf_dielectric_avg=torch.clamp(_average(diel), 0.0, 1.0),
        bsdf=torch.clamp(bsdf, 0.0, 1.0),
        bsdf_avg=torch.clamp(_average(bsdf), 0.0, 1.0),
    )


def bake_luts_cached(seed=0, quality=1.0, cache_path=None, device="cuda"):
    """bake_luts with a disk cache: `_bxdf_luts_s{seed}_q{quality:g}.npz`
    beside this module unless cache_path is given. The defaults' file is
    the committed bake, which is loaded, not baked."""
    if cache_path is None:
        cache_path = os.path.join(os.path.dirname(committed_lut_path()),
                                  f"_bxdf_luts_s{seed}_q{quality:g}.npz")
    if os.path.exists(cache_path):
        try:
            return load_luts(device, cache_path)
        except (OSError, ValueError, KeyError):
            pass
    luts = bake_luts(seed=seed, quality=quality, device=device)
    try:
        save_luts(cache_path, luts)
    except OSError:
        pass
    return luts
