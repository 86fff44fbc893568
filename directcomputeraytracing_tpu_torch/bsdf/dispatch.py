"""Material dispatch: evaluate / pdf / sample over a mixed ray batch.

Counterpart of `directcomputeraytracing_tpu.bsdf.dispatch`: every lobe is
evaluated for the whole batch and blended with masks, per material type:
  Diffuse         Lambert
  Plastic         Lambert + CT-GGX with dielectric Fresnel (+ KC
                  multiscatter), specular weight from the dielectric
                  energy LUT, internal-scattering factor on the substrate
  Conductor       CT-GGX with conductor Fresnel (+ KC multiscatter,
                  0.5/0.5 lobe selection)
  Dielectric      CT-GGX refractive BSDF (+ KC reciprocal multiscatter);
                  a perfectly smooth alpha falls back to the delta BSDF
  ThinDielectric  delta reflect / pass-through with thin-slab Fresnel
Directions are world-space at the interface; the tangent frame and the
hemisphere flip (wo below the shading normal) are handled here.
"""

import torch

from ..core.constants import (
    ALPHA_THRESHOLD,
    INTERNAL_SCATTERING_MODE_IGNORE,
    INTERNAL_SCATTERING_MODE_MULTIPLE,
    MATERIAL_TYPE_CONDUCTOR,
    MATERIAL_TYPE_DIELECTRIC,
    MATERIAL_TYPE_DIFFUSE,
    MATERIAL_TYPE_PLASTIC,
    MATERIAL_TYPE_THIN_DIELECTRIC,
)
from ..lut.textures import (
    sample_brdf_dielectric_energy,
    sample_brdf_dielectric_energy_avg,
    sample_brdf_energy,
    sample_brdf_energy_avg,
    sample_bsdf_energy,
    sample_bsdf_energy_avg,
)
from ..sampling.montecarlo import cross, dot, normalize
from . import ggx, kullaconty as kc, lambert, specular
from .fresnel import fresnel_conductor, fresnel_dielectric


def _to_tbn(v, t, b, n):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def _from_tbn(v, t, b, n):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def _frame(itx):
    return itx.tangent, cross(itx.normal, itx.tangent), itx.normal


def _flip_z(v, flip):
    return torch.cat([v[..., :2], (v[..., 2] * flip)[..., None]], dim=-1)


def _local(wo_w, wi_w, itx):
    """Frame, tangent-space wo (and wi), the inverted mask and the z flip
    that puts wo in the upper hemisphere."""
    t, b, n = _frame(itx)
    wo = _to_tbn(wo_w, t, b, n)
    inverted = wo[..., 2] < 0.0
    flip = torch.where(inverted, -1.0, 1.0).to(wo.dtype)
    wi = None if wi_w is None else _flip_z(_to_tbn(wi_w, t, b, n), flip)
    return (t, b, n), _flip_z(wo, flip), wi, inverted, flip


def _half(wo, wi):
    h = wo + wi
    zero = torch.abs(h).sum(-1) == 0.0
    return torch.where(zero[..., None], 0.0, normalize(h))


def _internal_scattering_factor(luts, alpha, albedo, ior, mode):
    avg_r = sample_brdf_dielectric_energy_avg(luts, alpha, ior, True)
    factor = (1.0 - avg_r)[..., None] / torch.where(
        (mode == INTERNAL_SCATTERING_MODE_MULTIPLE)[..., None],
        torch.clamp(1.0 - albedo * avg_r[..., None], min=1e-20), 1.0)
    return torch.where((mode == INTERNAL_SCATTERING_MODE_IGNORE)[..., None],
                       1.0, factor)


def _category_a_lobes(luts, itx, wo, inverted, smooth):
    """Lobe masks and weights shared by the non-dielectric types."""
    mt = itx.material_type
    is_diffuse = mt == MATERIAL_TYPE_DIFFUSE
    is_plastic = mt == MATERIAL_TYPE_PLASTIC
    is_conductor = mt == MATERIAL_TYPE_CONDUCTOR
    has_any = ~inverted | itx.is_two_sided
    cos_o = wo[..., 2]

    e = sample_brdf_energy(luts, cos_o, itx.alpha)
    e_avg = sample_brdf_energy_avg(luts, itx.alpha)
    ms_plastic = itx.multiscattering & is_plastic & has_any & ~smooth
    ms_conductor = itx.multiscattering & is_conductor & has_any & ~smooth

    f_ms_plastic = kc.multiscatter_fresnel(
        e_avg, kc.favg_dielectric(itx.ior[..., 0]))
    f_ms_conductor = kc.multiscatter_fresnel(
        e_avg, kc.favg_conductor(itx.ior, itx.albedo))
    f_ms = torch.where(is_plastic[..., None], f_ms_plastic[..., None],
                       f_ms_conductor)

    # plastic CT-lobe selection weight
    w_ct_plastic = sample_brdf_dielectric_energy(
        luts, cos_o, itx.alpha, itx.ior[..., 0], False)
    w_ms_plastic = torch.where(ms_plastic, f_ms_plastic * (1.0 - e), 0.0)
    w_l_plastic = torch.clamp(1.0 - w_ct_plastic - w_ms_plastic, min=0.0)

    w_ct = torch.where(is_plastic, w_ct_plastic,
                       torch.where(is_conductor,
                                   torch.where(ms_conductor, 0.5, 1.0), 0.0))
    w_ms = torch.where(is_plastic, w_ms_plastic,
                       torch.where(ms_conductor, 0.5, 0.0))
    w_l = torch.where(is_diffuse, 1.0,
                      torch.where(is_plastic, w_l_plastic, 0.0))
    return dict(is_diffuse=is_diffuse, is_plastic=is_plastic,
                is_conductor=is_conductor, has_any=has_any, e=e, e_avg=e_avg,
                f_ms=f_ms, w_l=w_l, w_ct=w_ct, w_ms=w_ms,
                ms_plastic=ms_plastic, ms_conductor=ms_conductor)


def _dielectric_ms_terms(luts, itx, cos_o, inverted):
    """Kulla-Conty terms of the rough dielectric BSDF."""
    ior = itx.ior[..., 0]
    e_avg_enter = sample_bsdf_energy_avg(luts, itx.alpha, ior, True)
    f_avg_enter = kc.favg_dielectric(1.0 / ior)
    e_avg_leave = sample_bsdf_energy_avg(luts, itx.alpha, ior, False)
    f_avg_leave = kc.favg_dielectric(ior)
    recip = kc.reciprocal_factor(f_avg_leave, f_avg_enter, e_avg_leave,
                                 e_avg_enter, ior)
    e = sample_bsdf_energy(luts, cos_o, itx.alpha, ior, inverted)
    f_avg = torch.where(inverted, f_avg_enter, f_avg_leave)
    e_avg = torch.where(inverted, e_avg_enter, e_avg_leave)
    e_inv_avg = torch.where(inverted, e_avg_leave, e_avg_enter)
    ratio = torch.where(inverted, 1.0 - recip, recip) * (1.0 - f_avg)
    return e, e_avg, e_inv_avg, ratio


def _ct_fresnel(itx, wo_dot_h, dielectric_mask):
    f_d = fresnel_dielectric(wo_dot_h, 1.0, itx.ior[..., 0])[..., None]
    f_c = fresnel_conductor(wo_dot_h, 1.0, itx.ior, itx.albedo)
    return torch.where(dielectric_mask[..., None], f_d, f_c)


def _lobe_sum(terms):
    """Sum of the (mask, value) lobes that are on."""
    out = 0.0
    for mask, value in terms:
        if value.dim() > mask.dim():
            mask = mask[..., None]
        out = out + torch.where(mask, value, 0.0)
    return out


def _categories(itx):
    smooth = itx.alpha < ALPHA_THRESHOLD
    is_dielectric = itx.material_type == MATERIAL_TYPE_DIELECTRIC
    is_thin = itx.material_type == MATERIAL_TYPE_THIN_DIELECTRIC
    return smooth, is_dielectric, is_thin, ~is_dielectric & ~is_thin


def _rough_dielectric_etas(itx, inverted):
    ior = itx.ior[..., 0]
    return (ior, torch.where(inverted, ior, 1.0),
            torch.where(inverted, 1.0, ior))


def evaluate_bsdf(luts, wi_w, wo_w, itx, use_vndf=True):
    """f(wi, wo): (R, 3). Delta lobes contribute zero."""
    _, wo, wi, inverted, _ = _local(wo_w, wi_w, itx)
    cos_o = wo[..., 2]
    smooth, is_dielectric, _, cat_a = _categories(itx)

    lob = _category_a_lobes(luts, itx, wo, inverted, smooth)
    h = _half(wo, wi)
    wo_dot_h = dot(h, wo)
    ratio_l = torch.where(lob["is_diffuse"], 1.0, lob["w_l"])
    internal = _internal_scattering_factor(
        luts, itx.alpha, itx.albedo, itx.ior[..., 0], itx.internal_mode)
    v_lambert = (lambert.eval_lambert(wi, wo) * ratio_l)[..., None] \
        * itx.albedo * torch.where(lob["is_plastic"][..., None], internal,
                                   1.0)
    v_ct = ggx.eval_ct_brdf(wi, wo, itx.alpha, h, wo_dot_h)[..., None] \
        * _ct_fresnel(itx, wo_dot_h, lob["is_plastic"])
    v_ms = kc.eval_ms_brdf(luts, wi, wo, itx.alpha, lob["e"], lob["e_avg"],
                           lob["f_ms"])
    value_a = _lobe_sum([
        ((lob["is_diffuse"] | lob["is_plastic"]) & lob["has_any"], v_lambert),
        ((lob["is_plastic"] | lob["is_conductor"]) & lob["has_any"]
         & ~smooth, v_ct),
        (lob["ms_plastic"] | lob["ms_conductor"], v_ms)])

    ior, eta_o, eta_i = _rough_dielectric_etas(itx, inverted)
    v_b = ggx.eval_ct_bsdf(wi, wo, itx.alpha, eta_o, eta_i)
    e_d, e_avg_d, e_inv_avg_d, ratio_d = _dielectric_ms_terms(
        luts, itx, cos_o, inverted)
    v_b_ms = kc.eval_ms_bsdf(luts, wi, itx.alpha, ratio_d, ior, e_d,
                             e_avg_d, e_inv_avg_d, inverted)
    v_b = v_b + torch.where(itx.multiscattering, v_b_ms, 0.0)
    value_b = torch.where((is_dielectric & ~smooth)[..., None],
                          v_b[..., None], 0.0)
    return torch.where(cat_a[..., None], value_a, value_b)


def evaluate_bsdf_pdf(luts, wi_w, wo_w, itx, use_vndf=True):
    """Sampling pdf of wi given wo: (R,)."""
    _, wo, wi, inverted, _ = _local(wo_w, wi_w, itx)
    cos_o = wo[..., 2]
    smooth, is_dielectric, _, cat_a = _categories(itx)

    lob = _category_a_lobes(luts, itx, wo, inverted, smooth)
    h = _half(wo, wi)
    wo_dot_h = dot(h, wo)
    pdf_a = _lobe_sum([
        ((lob["is_diffuse"] | lob["is_plastic"]) & lob["has_any"],
         lambert.pdf_lambert(wi, wo) * lob["w_l"]),
        ((lob["is_plastic"] | lob["is_conductor"]) & lob["has_any"]
         & ~smooth,
         ggx.pdf_ct_brdf(wi, wo, itx.alpha, h, wo_dot_h, use_vndf)
         * lob["w_ct"]),
        (lob["ms_plastic"] | lob["ms_conductor"],
         kc.pdf_ms_brdf(wi, wo) * lob["w_ms"])])

    _, eta_o, eta_i = _rough_dielectric_etas(itx, inverted)
    e_d, _, _, ratio_d = _dielectric_ms_terms(luts, itx, cos_o, inverted)
    w_bsdf = torch.where(itx.multiscattering, e_d, 1.0)
    w_ms = torch.where(itx.multiscattering, 1.0 - e_d, 0.0)
    pdf_b = ggx.pdf_ct_bsdf(wi, wo, itx.alpha, eta_o, eta_i, use_vndf) \
        * w_bsdf + kc.pdf_ms_bsdf(wi, ratio_d) * w_ms
    pdf_b = torch.where(is_dielectric & ~smooth, pdf_b, 0.0)
    return torch.where(cat_a, pdf_a, pdf_b)


def sample_bsdf(luts, wo_w, u2, u_sel, itx, use_vndf=True):
    """Sample wi given wo. Returns (wi_w (R, 3), value (R, 3), pdf (R,),
    is_delta (R,) bool); consumes exactly (u_sel, u2), the selection
    sample reused for the Fresnel choice inside the rough dielectric."""
    (t, b, n), wo, _, inverted, flip = _local(wo_w, None, itx)
    cos_o = wo[..., 2]
    smooth, is_dielectric, is_thin, cat_a = _categories(itx)
    cat_c = is_thin | (is_dielectric & smooth)   # delta BSDF

    # ---- category A
    lob = _category_a_lobes(luts, itx, wo, inverted, smooth)
    w_l, w_ct, w_ms = lob["w_l"], lob["w_ct"], lob["w_ms"]
    pick_l = u_sel < w_l
    pick_ct = ~pick_l & (u_sel < w_l + w_ct)

    wi_l = lambert.sample_lambert(wo, u2)
    wi_ct, m_ct = ggx.sample_ct_brdf(wo, u2, itx.alpha, use_vndf)
    wi_spec, v_spec, p_spec = specular.sample_specular_brdf(wo)
    wi_ms = kc.sample_ms_brdf(wo, u2)

    delta_a = pick_ct & smooth
    wi_a = torch.where(pick_l[..., None], wi_l,
                       torch.where(pick_ct[..., None],
                                   torch.where(smooth[..., None], wi_spec,
                                               wi_ct),
                                   wi_ms))
    h = torch.where((pick_ct & ~smooth)[..., None], m_ct, _half(wo, wi_a))
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=h.dtype, device=h.device)
    h = torch.where(delta_a[..., None], z_axis, h)
    wo_dot_h = torch.where(delta_a, cos_o, dot(h, wo))

    has_lambert = (lob["is_diffuse"] | lob["is_plastic"]) & lob["has_any"] \
        & ~delta_a
    has_ct = ((lob["is_plastic"] | lob["is_conductor"]) & lob["has_any"]
              & ~smooth & ~delta_a)
    has_ms = (lob["ms_plastic"] | lob["ms_conductor"]) & ~delta_a

    internal = _internal_scattering_factor(
        luts, itx.alpha, itx.albedo, itx.ior[..., 0], itx.internal_mode)
    v_lambert = (lambert.eval_lambert(wi_a, wo) * w_l)[..., None] \
        * itx.albedo * torch.where(lob["is_plastic"][..., None], internal,
                                   1.0)
    fres = _ct_fresnel(itx, wo_dot_h, lob["is_plastic"])
    v_ct = ggx.eval_ct_brdf(wi_a, wo, itx.alpha, h, wo_dot_h)[..., None] \
        * fres
    v_ms = kc.eval_ms_brdf(luts, wi_a, wo, itx.alpha, lob["e"],
                           lob["e_avg"], lob["f_ms"])
    value_a = _lobe_sum([(has_lambert, v_lambert), (has_ct, v_ct),
                         (has_ms, v_ms)])
    pdf_a = _lobe_sum([
        (has_lambert, lambert.pdf_lambert(wi_a, wo) * w_l),
        (has_ct, ggx.pdf_ct_brdf(wi_a, wo, itx.alpha, h, wo_dot_h, use_vndf)
         * w_ct),
        (has_ms, kc.pdf_ms_brdf(wi_a, wo) * w_ms)])
    # delta reflection (smooth CT pick)
    value_a = torch.where(delta_a[..., None], v_spec[..., None] * fres,
                          value_a)
    pdf_a = torch.where(delta_a, p_spec * w_ct, pdf_a)

    # ---- category C: delta dielectric
    ior = itx.ior[..., 0]
    entering_c = inverted & ~is_thin
    wi_c, v_c, p_c = specular.sample_specular_bsdf(
        wo, u_sel, torch.where(entering_c, ior, 1.0),
        torch.where(entering_c, 1.0, ior), is_thin)

    # ---- category B: rough dielectric
    _, eta_o, eta_i = _rough_dielectric_etas(itx, inverted)
    e_d, e_avg_d, e_inv_avg_d, ratio_d = _dielectric_ms_terms(
        luts, itx, cos_o, inverted)
    w_bsdf = torch.where(itx.multiscattering, e_d, 1.0)
    w_msb = torch.where(itx.multiscattering, 1.0 - e_d, 0.0)
    wi_bs, _, _ = ggx.sample_ct_bsdf(wo, u_sel, u2, itx.alpha, eta_o, eta_i,
                                     use_vndf)
    wi_msb = kc.sample_ms_bsdf(wo, u_sel, u2, ratio_d)
    wi_b = torch.where((u_sel < w_bsdf)[..., None], wi_bs, wi_msb)
    v_b = ggx.eval_ct_bsdf(wi_b, wo, itx.alpha, eta_o, eta_i) \
        + torch.where(itx.multiscattering,
                      kc.eval_ms_bsdf(luts, wi_b, itx.alpha, ratio_d, ior,
                                      e_d, e_avg_d, e_inv_avg_d, inverted),
                      0.0)
    p_b = ggx.pdf_ct_bsdf(wi_b, wo, itx.alpha, eta_o, eta_i, use_vndf) \
        * w_bsdf + torch.where(itx.multiscattering,
                               kc.pdf_ms_bsdf(wi_b, ratio_d) * w_msb, 0.0)

    # ---- combine
    wi = torch.where(cat_a[..., None], wi_a,
                     torch.where(cat_c[..., None], wi_c, wi_b))
    value = torch.where(cat_a[..., None], value_a,
                        torch.where(cat_c[..., None], v_c[..., None],
                                    v_b[..., None]))
    pdf = torch.where(cat_a, pdf_a, torch.where(cat_c, p_c, p_b))
    is_delta = torch.where(cat_a, delta_a, cat_c)
    return _from_tbn(_flip_z(wi, flip), t, b, n), value, pdf, is_delta
