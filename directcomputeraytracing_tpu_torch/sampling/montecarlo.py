"""Monte-Carlo sampling primitives on tensors.

PyTorch counterpart of `directcomputeraytracing_tpu.sampling.montecarlo`:
branch-free selects over the batch, samples in the last dimension.
"""

import math

import torch

PI = math.pi


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def dot(a, b):
    """Per-row dot product of (..., 3) vectors, summed in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(v):
    return torch.sqrt(dot(v, v))


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def normalize(v):
    """v / max(|v|, 1e-20)."""
    return v / torch.clamp(norm(v), min=1e-20)[..., None]


def concentric_sample_disk(u):
    """[0,1)^2 -> unit disk, the reference's 8-sector formulation.
    u: (..., 2) -> (..., 2)."""
    s = 2.0 * u - 1.0
    sx = s[..., 0]
    sy = s[..., 1]
    c_right = sx >= -sy
    c_rt = sx > sy
    c_lb = sx <= sy
    r = torch.where(c_right, torch.where(c_rt, sx, sy),
                    torch.where(c_lb, -sx, -sy))
    r_safe = torch.where(r == 0.0, torch.ones_like(r), r)
    theta = torch.where(
        c_right,
        torch.where(c_rt,
                    torch.where(sy > 0.0, sy / r_safe, 8.0 + sy / r_safe),
                    2.0 - sx / r_safe),
        torch.where(c_lb, 4.0 - sy / r_safe, 6.0 + sx / r_safe))
    theta = theta * (PI / 4.0)
    out = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                     dim=-1)
    zero = (sx == 0.0) & (sy == 0.0)
    return torch.where(zero[..., None], 0.0, out)


def cosine_sample_hemisphere(u):
    """[0,1)^2 -> cosine-weighted direction about +z."""
    d = concentric_sample_disk(u)
    z = safe_sqrt(1.0 - (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]))
    return torch.cat([d, z[..., None]], dim=-1)


def sample_triangle(u):
    """[0,1)^2 -> uniform barycentric (u, v) (sqrt warp)."""
    s = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - s, u[..., 1] * s], dim=-1)


def sample_sphere(u):
    """[0,1)^2 -> uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = (2.0 * PI) * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


UNIFORM_SPHERE_PDF = 1.0 / (4.0 * PI)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (beta = 2)."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0, f * f / denom, 0.0)
