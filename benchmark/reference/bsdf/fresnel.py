"""Fresnel terms (exact dielectric, exact conductor, Schlick).

PyTorch counterpart of `directcomputeraytracing_tpu.bsdf.fresnel`;
elementwise, `fresnel_conductor` over a trailing RGB axis.
"""

import torch

from ..sampling.montecarlo import safe_sqrt


def fresnel_dielectric(cos_theta_i, eta_o, eta_i):
    """Unpolarized dielectric reflectance. A negative cosine means the ray
    is on the eta_i side (the media are swapped)."""
    eta_o = torch.as_tensor(eta_o, dtype=cos_theta_i.dtype,
                            device=cos_theta_i.device)
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    swap = cos_i < 0.0
    e_o = torch.where(swap, eta_i, eta_o)
    e_i = torch.where(swap, eta_o, eta_i)
    cos_i = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = e_o / e_i * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (e_i * cos_i - e_o * cos_t) / torch.clamp(
        e_i * cos_i + e_o * cos_t, min=1e-20)
    r_perp = (e_o * cos_i - e_i * cos_t) / torch.clamp(
        e_o * cos_i + e_i * cos_t, min=1e-20)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def fresnel_conductor(cos_theta_i, eta_o, eta_i, k):
    """Exact conductor Fresnel; eta_i and k are (..., 3) RGB."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)[..., None]
    eta = eta_i / eta_o
    etak = k / eta_o
    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - sin2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * etak2)
    t1 = a2b2 + cos2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * cos_i * a
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_theta_i, f0):
    """Schlick's approximation; an f0 with more dimensions than the cosine
    (an RGB f0) takes the cosine's term over its trailing axis."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    a = 1.0 - cos_i
    a5 = (a * a) * (a * a) * a
    if f0.ndim > cos_i.ndim:
        a5 = a5[..., None]
    return f0 + (1.0 - f0) * a5
