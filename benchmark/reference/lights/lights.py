"""Light sampling and evaluation (point / directional / mesh / environment).

Counterpart of `directcomputeraytracing_tpu.lights.lights`, with the
reference's deliberate choices kept: triangle lights sample with pdf
1/area, lat-long or D3D-order cubemap environments are sampled uniformly
over the sphere, and every light sample consumes the same four numbers
whatever the light's type. Every index into a light or triangle table is
clamped, so miss lanes (tri 0, light index 0xFFFFFFFF) gather in range.
"""

from typing import NamedTuple

import torch

from ..core.constants import (
    LIGHT_FLAGS_DIRECTIONAL,
    LIGHT_FLAGS_ENVIRONMENT,
    LIGHT_FLAGS_MESH,
    LIGHT_FLAGS_POINT,
    LIGHT_INDEX_INVALID,
    SHADOW_EPSILON,
)
from ..core.types import transform_point
from ..sampling.montecarlo import (
    PI,
    UNIFORM_SPHERE_PDF,
    cross,
    dot,
    norm,
    sample_sphere,
    sample_triangle,
)


class LightSample(NamedTuple):
    radiance: torch.Tensor   # (R, 3)
    wi: torch.Tensor         # (R, 3)
    pdf: torch.Tensor        # (R,)
    distance: torch.Tensor   # (R,)
    is_delta: torch.Tensor   # (R,) bool


def _normalize_len(v):
    n = norm(v)
    return v / torch.clamp(n, min=1e-20)[..., None], n


def _cubemap_face_uv(wi):
    """D3D cubemap addressing: direction -> (face, u, v), faces ordered
    +X -X +Y -Y +Z -Z, u and v in [0, 1]."""
    x, y, z = wi[..., 0], wi[..., 1], wi[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                     min=1e-20)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    return face, sc / ma * 0.5 + 0.5, tc / ma * 0.5 + 0.5


def _sample_cubemap(faces_tex, wi):
    """Bilinear lookup on (6, S, S, 3) faces, texels clamped to the face."""
    s = faces_tex.shape[1]
    face, u, v = _cubemap_face_uv(wi)
    fx = u * s - 0.5
    fy = v * s - 0.5
    x0 = torch.clamp(torch.floor(fx).long(), 0, s - 1)
    y0 = torch.clamp(torch.floor(fy).long(), 0, s - 1)
    x1 = torch.clamp(x0 + 1, max=s - 1)
    y1 = torch.clamp(y0 + 1, max=s - 1)
    tx = torch.clamp(fx - x0.to(fx.dtype), 0.0, 1.0)[..., None]
    ty = torch.clamp(fy - y0.to(fy.dtype), 0.0, 1.0)[..., None]
    v00 = faces_tex[face, y0, x0]
    v01 = faces_tex[face, y0, x1]
    v10 = faces_tex[face, y1, x0]
    v11 = faces_tex[face, y1, x1]
    return (v00 * (1 - tx) + v01 * tx) * (1 - ty) \
        + (v10 * (1 - tx) + v11 * tx) * ty


def sample_env_radiance(env_texture, wi, has_env_texture):
    """Environment radiance: unit without a texture, a D3D cubemap for
    (6, S, S, 3), a bilinear lat-long panorama for (H, W, 3)."""
    if not has_env_texture:
        return torch.ones(wi.shape[:-1] + (3,), dtype=wi.dtype,
                          device=wi.device)
    if env_texture.dim() == 4:
        return _sample_cubemap(env_texture, wi)
    h, w = env_texture.shape[0], env_texture.shape[1]
    u = torch.atan2(wi[..., 2], wi[..., 0]) * (0.5 / PI) + 0.5
    v = torch.acos(torch.clamp(wi[..., 1], -1.0, 1.0)) * (1.0 / PI)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    v00 = env_texture[y0c, x0w]
    v01 = env_texture[y0c, x1w]
    v10 = env_texture[y1c, x0w]
    v11 = env_texture[y1c, x1w]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) \
        + (v10 * (1 - fx) + v11 * fx) * fy


def _world_triangle(scene, tri_idx, inst):
    tri = scene.triangles[torch.clamp(tri_idx, 0,
                                      scene.triangles.shape[0] - 1)]
    m = scene.instance_transforms[inst]
    return tuple(transform_point(scene.vtx_position[tri[..., k]], m)
                 for k in range(3))


def _mesh_light_triangle(scene, light_idx, u_tri):
    """A uniform triangle of the light's range: world vertices, count."""
    offset = scene.light_tri_offset[light_idx]
    count = scene.light_tri_count[light_idx]
    pick = torch.minimum((u_tri * count.to(u_tri.dtype)).long(), count - 1)
    v0, v1, v2 = _world_triangle(scene, offset + pick,
                                 scene.light_instance[light_idx])
    return v0, v1, v2, count


def sample_light_direct(scene, light_count, has_env_texture, p,
                        u_sel, u_tri, u2):
    """NEE light sample at shading points p (R, 3); light_count static."""
    idx = torch.clamp((u_sel * light_count).long(), max=light_count - 1)
    flags = scene.light_flags[idx]
    radiance0 = scene.light_radiance[idx]
    lpos = scene.light_position[idx]
    is_point = (flags & LIGHT_FLAGS_POINT) != 0
    is_dir = (flags & LIGHT_FLAGS_DIRECTIONAL) != 0
    is_mesh = (flags & LIGHT_FLAGS_MESH) != 0

    # point light
    to_l = lpos - p
    dist_p = norm(to_l)
    wi_p = to_l / torch.clamp(dist_p, min=1e-20)[..., None]
    rad_p = radiance0 / torch.clamp(dist_p * dist_p, min=1e-20)[..., None]
    # directional: position holds the direction the light travels
    wi_d = -lpos
    # mesh light
    v0, v1, v2, tri_count = _mesh_light_triangle(scene, idx, u_tri)
    area = 0.5 * norm(cross(v2 - v0, v1 - v0))
    bary = sample_triangle(u2)
    spos = v0 + (v1 - v0) * bary[..., 0:1] + (v2 - v0) * bary[..., 1:2]
    nrm, _ = _normalize_len(cross(v2 - v0, v1 - v0))
    wi_m, dist_m = _normalize_len(spos - p)
    wi_dot_n = -dot(wi_m, nrm)
    pdf_area = torch.where(area >= 5e-7, 1.0 / torch.clamp(area, min=5e-7),
                           0.0)
    pdf_m = pdf_area * dist_m * dist_m / torch.clamp(wi_dot_n, min=1e-20)
    pdf_m = torch.where(wi_dot_n > 0.0, pdf_m, 0.0) \
        / tri_count.to(pdf_m.dtype)
    rad_m = torch.where((wi_dot_n > 0.0)[..., None], radiance0, 0.0)
    # environment: uniform sphere
    wi_e = sample_sphere(u2)
    rad_e = radiance0 * sample_env_radiance(scene.env_texture, wi_e,
                                            has_env_texture)

    def by_type(point, directional, mesh, env):
        c = (lambda m: m[..., None]) if point.dim() > is_point.dim() \
            else (lambda m: m)
        return torch.where(c(is_point), point,
                           torch.where(c(is_dir), directional,
                                       torch.where(c(is_mesh), mesh, env)))

    wi = by_type(wi_p, wi_d, wi_m, wi_e)
    radiance = by_type(rad_p, radiance0, rad_m, rad_e)
    pdf = torch.where(is_point | is_dir, 1.0,
                      torch.where(is_mesh, pdf_m, UNIFORM_SPHERE_PDF))
    distance = torch.where(is_point, dist_p,
                           torch.where(is_mesh, dist_m, float("inf")))
    pdf = pdf / light_count
    distance = torch.where(torch.isfinite(distance),
                           distance * (1.0 - SHADOW_EPSILON), distance)
    return LightSample(radiance=radiance, wi=wi, pdf=pdf, distance=distance,
                       is_delta=is_point | is_dir)


def evaluate_light_direct(scene, light_count, has_env_texture, light_idx,
                          triangle_idx, normal, wi, distance):
    """Radiance and pdf of reaching light `light_idx` along wi at `distance`
    (surface normal `normal` for mesh lights), for the MIS implicit-hit
    term. An invalid index gives pdf 0."""
    valid = light_idx != LIGHT_INDEX_INVALID
    idx = torch.clamp(torch.where(valid, light_idx, 0), 0,
                      scene.light_flags.shape[0] - 1)
    flags = scene.light_flags[idx]
    radiance0 = scene.light_radiance[idx]
    is_mesh = (flags & LIGHT_FLAGS_MESH) != 0
    is_env = (flags & LIGHT_FLAGS_ENVIRONMENT) != 0

    # mesh light solid-angle pdf from the triangle actually hit
    v0, v1, v2 = _world_triangle(scene, triangle_idx.long(),
                                 scene.light_instance[idx])
    area2 = norm(cross(v2 - v0, v1 - v0))   # 2 * area
    pdf_area = torch.where(area2 >= 1e-6,
                           1.0 / torch.clamp(0.5 * area2, min=1e-20), 0.0)
    wi_dot_n = -dot(wi, normal)
    pdf_m = pdf_area * torch.where(
        wi_dot_n > 0.0,
        distance * distance / torch.clamp(wi_dot_n, min=1e-20), 0.0)
    pdf_m = pdf_m / scene.light_tri_count[idx].to(pdf_m.dtype)
    rad_m = torch.where((wi_dot_n > 0.0)[..., None], radiance0, 0.0)
    rad_e = radiance0 * sample_env_radiance(scene.env_texture, wi,
                                            has_env_texture)
    radiance = torch.where(is_mesh[..., None], rad_m,
                           torch.where(is_env[..., None], rad_e, 0.0))
    pdf = torch.where(is_mesh, pdf_m,
                      torch.where(is_env, UNIFORM_SPHERE_PDF, 0.0))
    pdf = pdf / light_count
    radiance = torch.where(valid[..., None], radiance, 0.0)
    pdf = torch.where(valid, pdf, 0.0)
    return radiance, pdf


def evaluate_env(scene, wi, env_light_index, has_env_texture):
    """Environment radiance seen directly by camera rays that miss."""
    return scene.light_radiance[env_light_index] * sample_env_radiance(
        scene.env_texture, wi, has_env_texture)
