"""Kulla-Conty multiple-scattering energy compensation lobes.

Counterpart of `directcomputeraytracing_tpu.bsdf.kullaconty`: average
Fresnel fits, the multiscatter Fresnel, the (1-Ei)(1-Eo)/(pi(1-Eavg))
compensation lobe, its reflection-only BRDF and its reciprocity-corrected
BSDF. Energies come from the LUTs (`lut.textures`).
"""

import torch

from ..lut.textures import sample_brdf_energy, sample_bsdf_energy
from ..sampling.montecarlo import PI, cosine_sample_hemisphere

INV_PI = 1.0 / PI


def favg_dielectric(eta):
    eta2 = eta * eta
    return torch.where(
        eta >= 1.0,
        (eta - 1.0) / (4.08567 + 1.00071 * eta),
        0.997118 + 0.1014 * eta - 0.965241 * eta2 - 0.130607 * eta2 * eta)


def favg_conductor(eta, k):
    """(..., 3) RGB fit."""
    num = (eta * (133.736 - 98.9833 * eta)
           + k * (eta * (59.5617 - 3.98288 * eta) - 182.37)
           + ((0.30818 * eta - 13.1093) * eta - 62.5919) * k * k
           - 8.21474)
    den = (k * (eta * (94.6517 - 15.8558 * eta) - 187.166)
           + (-78.476 * eta - 395.268) * eta
           + (eta * (eta - 15.4387) - 62.0752) * k * k)
    return torch.clamp(num / torch.where(torch.abs(den) < 1e-20, 1e-20, den),
                       0.0, 1.0)


def multiscatter_fresnel(e_avg, f_avg):
    """F_ms = Favg^2 Eavg / (1 - Favg (1 - Eavg)); broadcasts RGB f_avg."""
    if f_avg.dim() > e_avg.dim():
        e_avg = e_avg[..., None]
    return f_avg * f_avg * e_avg / torch.clamp(
        1.0 - f_avg * (1.0 - e_avg), min=1e-20)


def multiscatter_bxdf(e_i, e_o, e_avg):
    return torch.where(
        e_avg < 1.0,
        (1.0 - e_i) * (1.0 - e_o) / torch.clamp(PI * (1.0 - e_avg),
                                                min=1e-20),
        0.0)


def reciprocal_factor(f_avg_leave, f_avg_enter, e_avg_leave, e_avg_enter,
                      eta):
    inv_eta = 1.0 / eta
    factor = (1.0 - f_avg_leave) * (1.0 - e_avg_leave)
    factor1 = (1.0 - f_avg_enter) * (1.0 - e_avg_enter) * inv_eta * inv_eta
    return factor1 / torch.clamp(factor + factor1, min=1e-5)


# -- reflection-only multiscatter BRDF (plastic / conductor) -----------------

def eval_ms_brdf(luts, wi, wo, alpha, e_o, e_avg, factor):
    """factor is F_ms (scalar per ray or RGB). Returns (..., 3) for RGB."""
    valid = (wo[..., 2] > 0.0) & (wi[..., 2] > 0.0)
    e_i = sample_brdf_energy(luts, wi[..., 2], alpha)
    v = multiscatter_bxdf(e_i, e_o, e_avg)
    if factor.dim() > v.dim():
        v = v[..., None]
        valid = valid[..., None]
    return torch.where(valid, v * factor, 0.0)


def pdf_ms_brdf(wi, wo):
    valid = (wo[..., 2] > 0.0) & (wi[..., 2] > 0.0)
    return torch.where(valid, wi[..., 2] * INV_PI, 0.0)


def sample_ms_brdf(wo, u2):
    return cosine_sample_hemisphere(u2)


# -- transmission-aware multiscatter BSDF (dielectric) -----------------------

def eval_ms_bsdf(luts, wi, alpha, ratio, eta, e_o, e_avg, e_avg_inv,
                 is_entering):
    cos_i = torch.abs(wi[..., 2])
    eval_reflection = wi[..., 2] > 0.0
    e_i = sample_bsdf_energy(
        luts, cos_i, alpha, eta,
        torch.where(eval_reflection, is_entering, ~is_entering))
    factor = torch.where(eval_reflection, 1.0 - ratio, ratio)
    v = multiscatter_bxdf(
        e_i, e_o, torch.where(eval_reflection, e_avg, e_avg_inv)) * factor
    return torch.where(cos_i > 0.0, v, 0.0)


def pdf_ms_bsdf(wi, ratio):
    cos_i = torch.abs(wi[..., 2])
    refl = wi[..., 2] > 0.0
    pdf = cos_i * INV_PI * torch.where(refl, 1.0 - ratio, ratio)
    return torch.where(cos_i > 0.0, pdf, 0.0)


def sample_ms_bsdf(wo, u_sel, u2, ratio):
    """Cosine hemisphere, flipped below the surface with probability
    `ratio` (the transmission share)."""
    wi = cosine_sample_hemisphere(u2)
    transmit = u_sel < ratio
    z = torch.where(transmit, -wi[..., 2], wi[..., 2])
    return torch.cat([wi[..., :2], z[..., None]], dim=-1)
