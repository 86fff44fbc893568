"""The reference's shading pieces: its render settings, the ray-origin
offset and hit shading.

A frozen copy of the port's `integrator/common.py` (`offset_ray_origin`,
`sample_texture_atlas`, `shade_hit` and their helpers) at the commit
that defined the benchmark, with the settings the path loop reads; no
traversal settings, sort keys or slab depths: the reference casts every
ray against the whole soup (`reference.intersect`).
"""

from dataclasses import dataclass

import torch

from ..core.constants import (
    INSTANCE_MATERIAL_OVERRIDE_NONE,
    MATERIAL_FLAG_INTERNAL_SCATTERING_MASK,
    MATERIAL_FLAG_INTERNAL_SCATTERING_SHIFT,
    MATERIAL_FLAG_IS_TWOSIDED,
    MATERIAL_FLAG_MULTISCATTERING,
    MATERIAL_FLAG_ROUGHNESS_TEXTURE,
    MATERIAL_FLAG_TYPE_MASK,
)
from ..core.types import Intersection, transform_point, transform_vector
from ..sampling.montecarlo import cross, dot, norm, normalize


@dataclass(frozen=True)
class RenderConfig:
    """The path loop's static settings (the port's `RenderConfig` fields
    that shading and sampling read)."""

    width: int
    height: int
    max_bounce: int = 4
    light_count: int = 0
    env_light_index: int = -1           # -1 = none
    has_env_texture: bool = False
    light_visible: bool = True
    use_vndf: bool = True
    any_hit: bool = False               # alpha-tested transparency
    any_hit_texture: bool = False       # ... with opacity textures

    @property
    def has_env_light(self):
        return self.env_light_index >= 0


def offset_ray_origin(p, n, d):
    """Integer-ulp offset of p along the geometric normal, sign-matched to
    the outgoing direction d (Waechter & Binder)."""
    n = n * torch.sign(dot(n, d))[..., None]
    of_i = torch.trunc(256.0 * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32) + torch.where(p < 0.0, -of_i,
                                                            of_i)
    return torch.where(torch.abs(p) < (1.0 / 32.0), p + n * (1.0 / 65536.0),
                       p_bits.view(torch.float32))


def _bary3(p0, p1, p2, u, v):
    return p0 + (p1 - p0) * u[..., None] + (p2 - p0) * v[..., None]


def sample_texture_atlas(textures, texture_sizes, tex_idx, uv):
    """Bilinear wrap sample of atlas layer tex_idx at uv; tex_idx (R,)
    (callers mask out -1), uv (R, 2)."""
    k = torch.clamp(tex_idx, 0, textures.shape[0] - 1)
    hw = texture_sizes[k]
    h, w = hw[..., 0], hw[..., 1]
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w.to(u.dtype) - 0.5
    y = v * h.to(v.dtype) - 0.5
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0m, x1m = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    y0m, y1m = torch.remainder(y0, h), torch.remainder(y0 + 1, h)
    v00 = textures[k, y0m, x0m]
    v01 = textures[k, y0m, x1m]
    v10 = textures[k, y1m, x0m]
    v11 = textures[k, y1m, x1m]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) \
        + (v10 * (1 - fx) + v11 * fx) * fy


def _checkerboard(uv):
    cell = (uv[..., 0] * 2).to(torch.int32) + (uv[..., 1] * 2).to(torch.int32)
    return torch.where(torch.remainder(cell, 2) != 0, 1.0, 0.0).to(uv.dtype)


def _tangent(t0, t1, t2, u, v, normal):
    """Interpolated tangent with the reference's two-stage fallback for
    degenerate tangents."""
    eps = 1e-6
    tangent = _bary3(t0, t1, t2, u, v)
    tlen = norm(tangent)
    ortho = tangent - dot(tangent, normal)[..., None] * normal
    tangent = torch.where((tlen >= eps)[..., None], ortho, tangent)
    tlen = norm(tangent)
    fallback = cross(normal, torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype,
                                          device=normal.device)
                     .expand(normal.shape))
    flen = norm(fallback)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=normal.dtype,
                          device=normal.device)
    fallback = torch.where((flen >= eps)[..., None], fallback, x_axis)
    return normalize(torch.where((tlen < eps)[..., None], fallback, tangent))


def shade_hit(scene, origin, direction, hit):
    """HitInfo batch -> world-space Intersection batch. Miss lanes (tri 0)
    shade triangle 0 and are masked by the caller."""
    tri_id = torch.clamp(hit.triangle.long(), 0, scene.triangles.shape[0] - 1)
    tri = scene.triangles[tri_id]
    c0 = scene.vtx_table[tri[..., 0]]
    c1 = scene.vtx_table[tri[..., 1]]
    c2 = scene.vtx_table[tri[..., 2]]
    p0, n0, t0, uv0 = c0[:, 0:3], c0[:, 3:6], c0[:, 6:9], c0[:, 9:11]
    p1, n1, t1, uv1 = c1[:, 0:3], c1[:, 3:6], c1[:, 6:9], c1[:, 9:11]
    p2, n2, t2, uv2 = c2[:, 0:3], c2[:, 3:6], c2[:, 6:9], c2[:, 9:11]

    u, v = hit.u, hit.v
    position = _bary3(p0, p1, p2, u, v)
    normal = normalize(_bary3(n0, n1, n2, u, v))
    tangent = _tangent(t0, t1, t2, u, v, normal)
    geometry_normal = normalize(cross(p2 - p0, p1 - p0))

    # material: the instance override wins; one packed-row gather
    inst = hit.instance.long()
    override = scene.instance_material_overrides[inst]
    mat_id = torch.where(override != INSTANCE_MATERIAL_OVERRIDE_NONE,
                         override, scene.material_ids[tri_id])
    mrow = scene.mat_table[torch.clamp(mat_id, 0, scene.mat_table.shape[0] - 1)]
    flags = mrow[:, 10].long()
    tex_idx = mrow[:, 11].long()

    uv = (uv0 + (uv1 - uv0) * u[..., None] + (uv2 - uv0) * v[..., None]) \
        * mrow[:, 7:9]
    tex_rgb = sample_texture_atlas(scene.textures, scene.texture_sizes,
                                   tex_idx, uv)[..., :3]
    albedo = torch.where((tex_idx >= 0)[..., None], mrow[:, 0:3] * tex_rgb,
                         mrow[:, 0:3])
    roughness = mrow[:, 6] * torch.where(
        (flags & MATERIAL_FLAG_ROUGHNESS_TEXTURE) != 0, _checkerboard(uv),
        1.0)

    # local -> world (uniform-scale assumption, like the reference)
    m = scene.instance_transforms[inst]
    return Intersection(
        albedo=albedo,
        alpha=roughness * roughness,
        position=transform_point(position, m),
        normal=normalize(transform_vector(normal, m)),
        tangent=normalize(transform_vector(tangent, m)),
        geometry_normal=normalize(transform_vector(geometry_normal, m)),
        ior=mrow[:, 3:6],
        is_two_sided=(flags & MATERIAL_FLAG_IS_TWOSIDED) != 0,
        backface=hit.backface,
        multiscattering=(flags & MATERIAL_FLAG_MULTISCATTERING) != 0,
        internal_mode=(flags & MATERIAL_FLAG_INTERNAL_SCATTERING_MASK)
        >> MATERIAL_FLAG_INTERNAL_SCATTERING_SHIFT,
        material_type=flags & MATERIAL_FLAG_TYPE_MASK,
        light_index=scene.instance_light_indices[inst],
        triangle_index=hit.triangle,
    )
