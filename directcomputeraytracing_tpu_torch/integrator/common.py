"""Shared integrator pieces: render config, ray-origin offset, hit shading,
the bounce-ray sort key and order, parked rays, small device constants.

Counterpart of `directcomputeraytracing_tpu.integrator.common`, with the
casts' slab and backend settings: `marches_slabs`, `pool_cast_backend`,
`pool_slab_march`, `pool_slab_phases`, `megakernel_slab_depth` and
`slab_depth`. "Auto" is `None` for `RenderConfig.slab_march` and
`pool_slab_march` (a negative `pool_slab_march`, the reference's -1,
too) and "" for `pool_backend`. `slab_march=None` means the integrator's
default: no slabs in the megakernel, POOL_SLAB_DEFAULT for the
wavefront's pool casts; an explicit value, 0.0 included, reaches the
pool casts unless `pool_slab_march` is set (the reference's
`pool_slab_cfg` inherits only a positive `slab_march` and takes its
default for 0.0).
"""

from dataclasses import dataclass
from typing import Optional

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
    """Static integrator settings (the reference's per-scene shader
    defines)."""

    width: int
    height: int
    max_bounce: int = 4
    light_count: int = 0
    env_light_index: int = -1           # -1 = none
    has_env_texture: bool = False
    light_visible: bool = True          # env/mesh lights seen by camera
    use_vndf: bool = True
    traversal_backend: str = "auto"     # dense sweep or work list, by
                                        # size; "brute" (or "pallas"),
                                        # "pallas_wl", "pallas_wlg",
                                        # "pallas_pair", "pallas_cluster"
                                        # force a kernel
    filter_type: str = "box"            # film reconstruction filter
    filter_radius: float = 0.5
    any_hit: bool = False               # alpha-tested transparency
    any_hit_texture: bool = False       # ... with opacity textures
    watertight: bool = False            # PBRT watertight triangle test
    slab_march: Optional[float] = None  # distance-slab casting: phase 1
                                        # capped at this fraction of the
                                        # scene diagonal; 0 = off, None =
                                        # the integrator's default (off in
                                        # the megakernel, POOL_SLAB_DEFAULT
                                        # for the wavefront's pool casts)
    slab_phases: int = 2                # slab phases of a marched cast
                                        # (windows SLAB_GROW-x wider each,
                                        # the last unbounded)
    pool_slab_march: Optional[float] = None  # the wavefront pool casts'
                                        # own slab_march: None (or < 0) =
                                        # auto, slab_march with
                                        # slab_phases where slab_march is
                                        # set, else POOL_SLAB_DEFAULT with
                                        # pool_slab_phases; 0 = off
    pool_slab_phases: int = 2           # slab phases of the pool casts'
                                        # own setting (and of the default)
    pool_backend: str = ""              # the wavefront's pool casts'
                                        # backend, "" = pool_cast_backend's
                                        # choice; "pallas_pair" sweeps the
                                        # incoherent pool by (ray, super)
                                        # pairs

    @property
    def has_env_light(self):
        return self.env_light_index >= 0


_CONSTANTS = {}


def constant(values, dtype, device):
    """A small constant tensor, built once per (values, dtype, device) and
    shared: callers only read it. A `torch.tensor(..., device=...)` on a
    CUDA device copies from pageable host memory, which a CUDA graph
    capture forbids, so the shading a capture records takes its constants
    from here (built by an eager pass before the capture)."""
    key = (values, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def has_worklist_tables(scene):
    """True when the scene casts through the work list: it has world-soup
    cluster tables or instanced tables. Such scenes trace in 32x32 tiles
    and sort their bounce rays and pool lanes."""
    return scene.cluster_bbox.shape[0] > 1 or scene.isup_inst.shape[0] > 1


def pool_cast_backend(cfg, scene):
    """The wavefront pool casts' backend: cfg.pool_backend when set; else,
    for "auto" on scenes with world-soup cluster tables, the grouped
    work-list sweep ("pallas_wlg"), as the reference resolves it on its
    accelerator, else cfg.traversal_backend ("auto": the dense sweep, or
    on instanced scenes the per-ray instanced sweep, which the reference's
    "pallas_wlg" downgrades to as well). The grouped kernels' warps walk
    their block's items on their own and skip the items none of their
    rays can enter, with the same hits as the per-ray sweeps, which walk
    by warps too. On an NVIDIA H100 80GB HBM3 at 700 W, on a sorted
    2^18-ray pool (Baldwin-Weber), the per-ray sweeps take 0.333 ms
    (any-hit) and 0.853 (closest) against the grouped ones' 0.404 and
    1.000 (`chip_smoke.py` phase 2c, one run; the grouped closest sweep
    led on the unsorted 1M sets, 2.18 against 2.54 ms on random rays,
    `tools/worklist_ab.py`; PERF.md). The three pool backends'
    ("pallas_wlg", "pallas_wl", "pallas_pair") 1080p pool passes trade
    the lead between runs (PERF.md)."""
    if cfg.pool_backend:
        return cfg.pool_backend
    if cfg.traversal_backend == "auto" and scene.cluster_bbox.shape[0] > 1:
        return "pallas_wlg"
    return cfg.traversal_backend


# The reference's default phase-1 window of the pool casts, a fraction of
# the scene diagonal (its integrator/common.py). The reference chose it on
# its accelerator, where it kept mid-drain pool casts inside the grouped
# sweep's fixed item capacity; the port's item lists have no capacity,
# and whether slabs pay here is measured on the card (PERF.md).
POOL_SLAB_DEFAULT = 0.03


def marches_slabs(scene, backend):
    """True where slab marching runs, as the reference's `slab_enabled`
    has it: on the work list and the pair sweep, whose casts take t_cap.
    The dense and clustered sweeps ignore t_cap, so a second phase would
    repeat the cast. (The pair sweep carries no best across supers; the
    slab window stands in for it.)"""
    from ..accel.traverse import _resolve_backend

    return _resolve_backend(scene, backend) in ("wl", "wlg", "pair")


def _pool_slab(cfg):
    """(march, phases) of the pool casts: cfg.pool_slab_march when it is
    set (>= 0) with pool_slab_phases; else cfg.slab_march with
    slab_phases where slab_march is set; else POOL_SLAB_DEFAULT with
    pool_slab_phases. The reference's `pool_slab_cfg` resolves them the
    same way, but for a slab_march set to 0.0 or less, which turns the
    pool slabs off here and gives POOL_SLAB_DEFAULT there."""
    if cfg.pool_slab_march is not None and cfg.pool_slab_march >= 0.0:
        return cfg.pool_slab_march, cfg.pool_slab_phases
    if cfg.slab_march is not None:
        return cfg.slab_march, cfg.slab_phases
    return POOL_SLAB_DEFAULT, cfg.pool_slab_phases


def pool_slab_march(scene, cfg, backend):
    """The pool casts' phase-1 window as a fraction of the scene diagonal,
    0.0 for no slabs: `_pool_slab`'s, where `marches_slabs`."""
    march = _pool_slab(cfg)[0]
    if march <= 0.0 or not marches_slabs(scene, backend):
        return 0.0
    return float(march)


def pool_slab_phases(cfg):
    """The slab phases of the pool casts' closest casts (`_pool_slab`)."""
    return int(_pool_slab(cfg)[1])


def megakernel_slab_depth(scene, cfg):
    """The megakernel's phase-1 cap, or None: it marches its camera and
    sorted bounce casts only for cfg.slab_march > 0 where
    `marches_slabs` (None, the default, is off); elsewhere the field is
    ignored, as in the reference."""
    march = cfg.slab_march or 0.0
    if march <= 0.0 or not marches_slabs(scene, cfg.traversal_backend):
        return None
    return slab_depth(scene, march)


def slab_depth(scene, march):
    """Phase-1 cap: march of the scene diagonal, as a float (one host
    read). The scene box is the work list's table bounds."""
    from ..accel.worklist import scene_tables

    lo, hi = scene_tables(scene).bounds
    return march * float(torch.linalg.vector_norm(hi - lo))


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
    fallback = cross(normal, constant((0.0, 1.0, 0.0), normal.dtype,
                                      normal.device).expand(normal.shape))
    flen = norm(fallback)
    x_axis = constant((1.0, 0.0, 0.0), normal.dtype, normal.device)
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


def ray_sort_key(origin, direction, scene_lo, scene_inv_extent):
    """Coherence sort key for bounce rays (the reference's `oct_morton12`
    scheme): 3 direction-octant bits above a 12-bit Morton code of the
    origin's cell in a 16^3 grid over the scene box. (R,) int64."""
    oct_ = ((direction[:, 0] >= 0).long()
            | ((direction[:, 1] >= 0).long() << 1)
            | ((direction[:, 2] >= 0).long() << 2))
    q = torch.clamp((origin - scene_lo) * scene_inv_extent, 0.0, 0.999)
    cell = (q * 16).long()
    m = torch.zeros_like(oct_)
    for b in range(4):
        for ax in range(3):
            m = m | (((cell[:, ax] >> b) & 1) << (3 * b + ax))
    return (oct_ << 12) | m


def sort_order(scene, origin, direction, alive):
    """Lane order of the rays' `ray_sort_key`, dead lanes last (stable).
    The key's grid spans the work-list tables' scene box (the reference
    uses its TLAS root box, the same box up to rounding)."""
    from ..accel.worklist import scene_tables

    lo, hi = scene_tables(scene).bounds
    key = ray_sort_key(origin, direction, lo,
                       1.0 / torch.clamp_min(hi - lo, 1e-6))
    return torch.argsort(torch.where(alive, key, 0xFFFFFFFF), stable=True)


def park_rays(mask, origin, direction):
    """Lanes outside mask cast a far ray along +x that enters nothing
    (stale rays would widen their blocks' work-list items)."""
    x_axis = constant((1.0, 0.0, 0.0), direction.dtype, direction.device)
    return (torch.where(mask[:, None], origin, 2e9),
            torch.where(mask[:, None], direction, x_axis))
