"""Lambert BRDF in tangent space (+z = shading normal); albedo is applied
by the dispatcher. Counterpart of `directcomputeraytracing_tpu.bsdf.
lambert`."""

import torch

from ..sampling.montecarlo import PI, cosine_sample_hemisphere

INV_PI = 1.0 / PI


def _upper(wi, wo):
    return (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)


def eval_lambert(wi, wo):
    """(R,) reflectance without albedo."""
    return torch.where(_upper(wi, wo), INV_PI, 0.0).to(wi.dtype)


def pdf_lambert(wi, wo):
    return torch.where(_upper(wi, wo), wi[..., 2] * INV_PI, 0.0)


def sample_lambert(wo, u2):
    """Cosine-hemisphere wi (R, 3)."""
    return cosine_sample_hemisphere(u2)
