"""GGX microfacet distribution and Cook-Torrance BRDF/BSDF (tangent space).

Counterpart of `directcomputeraytracing_tpu.bsdf.ggx`: Smith
height-uncorrelated shadowing, classic-NDF and visible-NDF sampling
(`use_vndf`), the reflection BRDF and the refractive dielectric BSDF.
Fresnel is applied by the dispatcher for the BRDF; the dielectric BSDF
applies exact dielectric Fresnel itself.
"""

import torch

from ..sampling.montecarlo import PI, cross, dot, norm
from .fresnel import fresnel_dielectric


def _unit(v):
    return v / torch.clamp(norm(v), min=1e-20)[..., None]


def _g1(alpha2, m, w):
    consistent = dot(w, m) * w[..., 2] > 0.0
    ndw = torch.abs(w[..., 2])
    denom = torch.sqrt(alpha2 + (1.0 - alpha2) * ndw * ndw) + ndw
    return torch.where(consistent, 2.0 * ndw / torch.clamp(denom, min=1e-20),
                       0.0)


def ggx_shadowing(wi, wo, m, alpha):
    a2 = alpha * alpha
    return _g1(a2, m, wi) * _g1(a2, m, wo)


def ggx_d(m, alpha):
    a2 = alpha * alpha
    ndm = m[..., 2]
    f = ndm * ndm * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(f * f * PI, min=1e-20)


def sample_ggx_ndf(u2, alpha):
    theta = torch.atan(alpha * torch.sqrt(
        u2[..., 0] / torch.clamp(1.0 - u2[..., 0], min=1e-20)))
    phi = (2.0 * PI) * u2[..., 1]
    s = torch.sin(theta)
    return torch.stack([torch.cos(phi) * s, torch.sin(phi) * s,
                        torch.cos(theta)], dim=-1)


def sample_ggx_vndf(wo, u2, alpha):
    """Heitz 2018 visible-normal sampling."""
    vh = _unit(torch.stack([alpha * wo[..., 0], alpha * wo[..., 1],
                            torch.broadcast_to(wo[..., 2], alpha.shape)],
                           dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device)
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                     torch.zeros_like(inv_len)], dim=-1),
        x_axis)
    t2 = cross(vh, t1)
    r = torch.sqrt(u2[..., 0])
    phi = (2.0 * PI) * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None]
          * vh)
    return _unit(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                              torch.clamp(nh[..., 2], min=0.0)], dim=-1))


def ggx_pdf_m(wo, m, alpha, use_vndf):
    """pdf of sampling the microfacet normal m."""
    if use_vndf:
        return (ggx_d(m, alpha) * _g1(alpha * alpha, m, wo)
                * torch.clamp(dot(wo, m), min=0.0)
                / torch.clamp(wo[..., 2], min=1e-20))
    return ggx_d(m, alpha) * torch.abs(m[..., 2])


def sample_ggx_m(wo, u2, alpha, use_vndf):
    return sample_ggx_vndf(wo, u2, alpha) if use_vndf \
        else sample_ggx_ndf(u2, alpha)


# -- Cook-Torrance BRDF (reflection only; Fresnel applied by the caller) -----

def eval_ct_brdf(wi, wo, alpha, m, wo_dot_m):
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (wo_dot_m > 0.0) \
        & (torch.abs(m).sum(-1) > 0.0)
    v = ggx_d(m, alpha) * ggx_shadowing(wi, wo, m, alpha) / torch.clamp(
        4.0 * wi[..., 2] * wo[..., 2], min=1e-20)
    return torch.where(valid, v, 0.0)


def pdf_ct_brdf(wi, wo, alpha, m, wo_dot_m, use_vndf):
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (wo_dot_m > 0.0)
    pdf = ggx_pdf_m(wo, m, alpha, use_vndf) / torch.clamp(
        4.0 * wo_dot_m, min=1e-20)
    return torch.where(valid, pdf, 0.0)


def sample_ct_brdf(wo, u2, alpha, use_vndf):
    """Returns (wi, m) with wi = wo reflected about m."""
    m = sample_ggx_m(wo, u2, alpha, use_vndf)
    wi = 2.0 * dot(wo, m)[..., None] * m - wo
    return wi, m


# -- Cook-Torrance BSDF (reflection + refraction, dielectric) ----------------

def _half_vector(wi, wo, eta_o, eta_i):
    reflect = (wi[..., 2] * wo[..., 2]) > 0.0
    scale_o = torch.where(reflect, 1.0, eta_o)
    scale_i = torch.where(reflect, 1.0, eta_i)
    m = _unit(wo * scale_o[..., None] + wi * scale_i[..., None])
    m = torch.where((m[..., 2] < 0.0)[..., None], -m, m)
    return m, reflect


def eval_ct_bsdf(wi, wo, alpha, eta_o, eta_i, scale_factor=True):
    """scale_factor=False drops the (eta_o / eta_i)^2 radiance compression
    of refraction (the reference's REFRACTION_NO_SCALE_FACTOR, set only
    for the energy-LUT bake)."""
    active = (wo[..., 2] != 0.0) & (wi[..., 2] != 0.0)
    m, reflect = _half_vector(wi, wo, eta_o, eta_i)
    wi_dot_m = dot(wi, m)
    wo_dot_m = dot(wo, m)
    d = ggx_d(m, alpha)
    f = fresnel_dielectric(wo_dot_m, eta_o, eta_i)
    g = ggx_shadowing(wi, wo, m, alpha)
    refl_v = f * d * g / torch.clamp(
        4.0 * torch.abs(wi[..., 2]) * torch.abs(wo[..., 2]), min=1e-20)
    sqrt_denom = eta_o * wo_dot_m + eta_i * wi_dot_m
    refr_v = (1.0 - f) * torch.abs(
        d * g * torch.abs(wi_dot_m) * torch.abs(wo_dot_m)
        * (eta_o * eta_o if scale_factor else eta_i * eta_i)
        / torch.clamp(torch.abs(wi[..., 2] * wo[..., 2] * sqrt_denom
                                * sqrt_denom), min=1e-20))
    v = torch.where(reflect, refl_v, refr_v)
    return torch.where(active, v, 0.0)


def pdf_ct_bsdf(wi, wo, alpha, eta_o, eta_i, use_vndf):
    active = (wo[..., 2] != 0.0) & (wi[..., 2] != 0.0)
    m, reflect = _half_vector(wi, wo, eta_o, eta_i)
    wi_dot_m = dot(wi, m)
    wo_dot_m = dot(wo, m)
    active = active & (wi_dot_m * wi[..., 2] > 0.0) \
        & (wo_dot_m * wo[..., 2] > 0.0)
    sqrt_denom = eta_o * wo_dot_m + eta_i * wi_dot_m
    dwh_dwi = torch.where(
        reflect,
        1.0 / torch.clamp(4.0 * torch.abs(wi_dot_m), min=1e-20),
        torch.abs(eta_i * eta_i * wi_dot_m)
        / torch.clamp(sqrt_denom * sqrt_denom, min=1e-20))
    pdf = ggx_pdf_m(wo, m, alpha, use_vndf)
    f = fresnel_dielectric(wo_dot_m, eta_o, eta_i)
    pdf = pdf * torch.where(reflect, f, 1.0 - f) * dwh_dwi
    return torch.where(active, pdf, 0.0)


def _refract(w, m, eta_rel):
    """Refract -w about m with relative IOR eta_rel = eta_o / eta_i (HLSL
    refract semantics)."""
    i = -w
    cos_i = -dot(i, m)
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    t = eta_rel[..., None] * i + (eta_rel * cos_i - cos_t)[..., None] * m
    return torch.where(tir[..., None], 0.0, t)


def sample_ct_bsdf(wo, u_sel, u2, alpha, eta_o, eta_i, use_vndf):
    """Returns (wi, m, wo_dot_m); the selection sample picks reflection or
    refraction by exact Fresnel."""
    m = sample_ggx_m(wo, u2, alpha, use_vndf)
    wo_dot_m = dot(wo, m)
    f = fresnel_dielectric(wo_dot_m, eta_o, eta_i)
    reflect = u_sel < f
    wi_refl = 2.0 * wo_dot_m[..., None] * m - wo
    wi_refr = _refract(wo, m, eta_o / eta_i)
    wi = torch.where(reflect[..., None], wi_refl, wi_refr)
    bad = (wo[..., 2] == 0.0) | (wo_dot_m <= 0.0)
    wi = torch.where(bad[..., None], 0.0, wi)
    matched = eta_o == eta_i
    wi = torch.where(matched[..., None], -wo, wi)
    return wi, m, wo_dot_m
