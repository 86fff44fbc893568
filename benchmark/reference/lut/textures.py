"""Kulla-Conty energy LUTs: container, loader and clamped lerp lookups.

PyTorch counterpart of `directcomputeraytracing_tpu.lut.textures`. The
reference contracts one-hot weight matrices with the tables because a
gather is slow on the TPU; here each lookup gathers the two neighbours
per axis and blends them in the reference's order (z, then y, then x).
Texel centres sit at u * (dim - 1), clamped to [0, 1].

Layouts (entering = from outside into the denser medium):
  brdf:                (A=32, C=32)           E(cosTheta, alpha)
  brdf_avg:            (A=32,)                Eavg(alpha)
  brdf_dielectric:     (2, E=16, A=16, C=32)  [leave/enter, eta, alpha, cos]
  brdf_dielectric_avg: (2, E=16, A=16)
  bsdf:                (2, E=16, A=16, C=32)
  bsdf_avg:            (2, E=16, A=16)
The eta axis spans [1, 3] via w = (eta - 1) / 2.
"""

import os
from typing import NamedTuple

import numpy as np
import torch


class BxDFLuts(NamedTuple):
    brdf: torch.Tensor
    brdf_avg: torch.Tensor
    brdf_dielectric: torch.Tensor
    brdf_dielectric_avg: torch.Tensor
    bsdf: torch.Tensor
    bsdf_avg: torch.Tensor


_SHAPES = {"brdf": (32, 32), "brdf_avg": (32,),
           "brdf_dielectric": (2, 16, 16, 32), "brdf_dielectric_avg": (2, 16, 16),
           "bsdf": (2, 16, 16, 32), "bsdf_avg": (2, 16, 16)}


def committed_lut_path():
    """The port's copy of the reference's committed bake (seed 0, quality
    1), which `lut.bake.bake_luts_cached()` loads by default."""
    return os.path.join(os.path.dirname(__file__), "_bxdf_luts_s0_q1.npz")


def load_luts(device, path=None) -> BxDFLuts:
    """Read a bake (an npz of the six tables) with
    numpy onto device; path None reads the committed bake."""
    with np.load(committed_lut_path() if path is None else path) as data:
        return BxDFLuts(**{k: torch.from_numpy(np.asarray(data[k], np.float32))
                           .to(device) for k in BxDFLuts._fields})


def placeholder_luts(device) -> BxDFLuts:
    """Unit-energy LUTs (E = 1 everywhere): the multiscatter lobes vanish."""
    return BxDFLuts(**{k: torch.ones(s, dtype=torch.float32, device=device)
                       for k, s in _SHAPES.items()})


def _axis(u, dim):
    """Neighbour indices (i0, i1) and blend weight f for coordinate u."""
    pos = torch.nan_to_num(torch.clamp(u, 0.0, 1.0)) * (dim - 1)
    i0f = torch.floor(pos)
    f = pos - i0f
    i0 = i0f.long()
    return i0, torch.clamp(i0 + 1, max=dim - 1), f


def _lerp(a, b, f):
    return a * (1.0 - f) + b * f


def _sample_1d(tex, u):
    i0, i1, f = _axis(u, tex.shape[0])
    return _lerp(tex[i0], tex[i1], f)


def _sample_2d(tex, uy, ux, lead=()):
    """tex (..., Y, X); uy indexes Y, ux indexes X; `lead` holds index
    tensors for the leading axes."""
    y0, y1, fy = _axis(uy, tex.shape[-2])
    x0, x1, fx = _axis(ux, tex.shape[-1])
    r0 = _lerp(tex[(*lead, y0, x0)], tex[(*lead, y1, x0)], fy)
    r1 = _lerp(tex[(*lead, y0, x1)], tex[(*lead, y1, x1)], fy)
    return _lerp(r0, r1, fx)


def _sample_3d(tex, uz, uy, ux, side):
    """tex (2, Z, Y, X) with a per-element side select."""
    z0, z1, fz = _axis(uz, tex.shape[1])
    y0, y1, fy = _axis(uy, tex.shape[2])
    x0, x1, fx = _axis(ux, tex.shape[3])

    def zlerp(y, x):
        return _lerp(tex[side, z0, y, x], tex[side, z1, y, x], fz)

    r0 = _lerp(zlerp(y0, x0), zlerp(y1, x0), fy)
    r1 = _lerp(zlerp(y0, x1), zlerp(y1, x1), fy)
    return _lerp(r0, r1, fx)


def _side(entering, like):
    return torch.as_tensor(entering, device=like.device).long() \
        .expand(like.shape)


def _eta_coord(eta):
    return (eta - 1.0) * 0.5


def sample_brdf_energy(luts: BxDFLuts, cos_theta, alpha):
    """E(cosTheta, alpha) for the Cook-Torrance BRDF."""
    return _sample_2d(luts.brdf, alpha, cos_theta)


def sample_brdf_energy_avg(luts: BxDFLuts, alpha):
    return _sample_1d(luts.brdf_avg, alpha)


def sample_brdf_dielectric_energy(luts, cos_theta, alpha, eta, entering):
    return _sample_3d(luts.brdf_dielectric, _eta_coord(eta), alpha,
                      cos_theta, _side(entering, cos_theta))


def sample_brdf_dielectric_energy_avg(luts, alpha, eta, entering):
    return _sample_2d(luts.brdf_dielectric_avg, _eta_coord(eta), alpha,
                      lead=(_side(entering, alpha),))


def sample_bsdf_energy(luts, cos_theta, alpha, eta, entering):
    return _sample_3d(luts.bsdf, _eta_coord(eta), alpha, cos_theta,
                      _side(entering, cos_theta))


def sample_bsdf_energy_avg(luts, alpha, eta, entering):
    return _sample_2d(luts.bsdf_avg, _eta_coord(eta), alpha,
                      lead=(_side(entering, alpha),))
