"""Perfect-specular delta lobes (mirror BRDF, smooth dielectric BSDF).

Counterpart of `directcomputeraytracing_tpu.bsdf.specular`. Delta lobes
have zero eval and pdf for arbitrary directions; sampling returns (wi,
value, pdf) with the 1/|cos| delta normalisation inside `value`.
"""

import torch

from .fresnel import fresnel_dielectric


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def sample_specular_brdf(wo):
    """Mirror reflection about +z. Returns (wi, value, pdf)."""
    wi = _mirror(wo)
    ok = wo[..., 2] > 0.0
    value = torch.where(ok, 1.0 / torch.clamp(wi[..., 2], min=1e-20), 0.0)
    pdf = torch.where(ok, 1.0, 0.0).to(wo.dtype)
    return wi, value, pdf


def sample_specular_bsdf(wo, u_sel, eta_o, eta_i, is_thin):
    """Smooth dielectric: Fresnel-weighted reflect/refract delta lobes;
    `is_thin` adds the thin-slab inter-reflection term and pass-through
    transmission. Returns (wi, value, pdf)."""
    f = fresnel_dielectric(wo[..., 2], eta_o, eta_i)
    t = 1.0 - f
    thin_f = torch.where(
        f < 1.0, f + t * t * f / torch.clamp(1.0 - f * f, min=1e-20), f)
    f = torch.where(is_thin, thin_f, f)
    t = 1.0 - f

    reflect = u_sel < f
    wi_refl = _mirror(wo)
    eta_rel = eta_o / eta_i
    cos_i = wo[..., 2]
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi_refr_solid = torch.stack(
        [-eta_rel * wo[..., 0], -eta_rel * wo[..., 1], -cos_t], dim=-1)
    wi_refr = torch.where(is_thin[..., None], -wo, wi_refr_solid)
    wi = torch.where(reflect[..., None], wi_refl, wi_refr)

    # radiance compression on refraction (the reference's default path)
    scale = torch.where(is_thin, 1.0, (eta_o * eta_o) / (eta_i * eta_i))
    val_refl = f / torch.clamp(wi_refl[..., 2], min=1e-20)
    val_refr = t * scale / torch.clamp(-wi_refr[..., 2], min=1e-20)
    value = torch.where(reflect, val_refl, val_refr)
    pdf = torch.where(reflect, f, t)

    bad = (wo[..., 2] <= 0.0) | (~reflect & (wi[..., 2] == 0.0))
    matched = eta_o == eta_i
    value = torch.where(matched, 1.0 / torch.clamp(wo[..., 2], min=1e-20),
                        torch.where(bad, 0.0, value))
    pdf = torch.where(matched, 1.0, torch.where(bad, 0.0, pdf))
    wi = torch.where(matched[..., None], -wo,
                     torch.where(bad[..., None], 0.0, wi))
    return wi, value, pdf
