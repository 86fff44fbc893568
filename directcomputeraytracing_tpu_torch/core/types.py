"""Tensor records that cross the port's function boundaries.

PyTorch counterparts of `directcomputeraytracing_tpu.core.types`, with the
reference's field names. `SceneTensors` holds only the scene fields the
integrators read, over the dense sweep or the work-list traversal of the
world soup or of the instanced tables, and the alpha test's: opacities,
instance flags and the opaque/masked cluster split. The stack walker's
node tables are kept beside a scene (`accel.traverse.node_tables`), built
on first use. Integer fields are
int64:
the reference's uint32 fields use bit 31 (`LIGHT_INDEX_INVALID`,
`INSTANCE_MATERIAL_OVERRIDE_NONE`), which int32 cannot hold. Float
fields are float32 throughout.

Transforms are (4, 3) row-vector matrices, world = [p, 1] @ M.
"""

from typing import NamedTuple

import numpy as np
import torch


class SceneTensors(NamedTuple):
    vtx_position: torch.Tensor      # (V, 3) f32
    triangles: torch.Tensor         # (T, 3) i64 vertex indices, leaf order
    world_tris: torch.Tensor        # (B, 9) f32 world-space v0|v1|v2
    world_tri_meta: torch.Tensor    # (B, 3) f32 [tri id, inst id, flip]
    cluster_tris: torch.Tensor      # (C*16, 13) f32 v0|v1|v2|tri|inst|
                                    #   flip|soup row, per 16-tri cluster
    cluster_bw: torch.Tensor        # (C*16, 16) f32 Baldwin-Weber rows
    cluster_bbox: torch.Tensor      # (C, 8) f32; C > 1 = clustered scene
    icl_slab: torch.Tensor          # (CL*16, 13) f32 mesh-local v0|v1|v2|
                                    #   tri|0|0|row, per 16-tri cluster
    icl_bw: torch.Tensor            # (CL*16, 16) f32 Baldwin-Weber rows
    isup_cbox: torch.Tensor         # (NS, 32, 8) f32 world cluster boxes
    isup_sbox: torch.Tensor         # (NS, 8) f32 world super boxes
    isup_local: torch.Tensor        # (NS,) i64 local super of each
    isup_inst: torch.Tensor         # (NS,) i64; NS > 1 = instanced tables
    inst_rows: torch.Tensor         # (I, 16) f32 world->local 3x3 | t |
                                    #   det < 0 | 0 0 0
    vtx_table: torch.Tensor         # (V, 12) f32 pos|nrm|tan|uv|pad
    mat_table: torch.Tensor         # (M, 16) f32 albedo|ior|rough|tiling|
                                    #   opacity|flags|albedo_tex|opacity_tex
    material_ids: torch.Tensor      # (T,) i64
    tri_opacity: torch.Tensor       # (T,) f32 base-material opacity
    world_tri_opacity: torch.Tensor  # (B,) f32 override-aware, 1 on
                                     #   opaque instances
    instance_transforms: torch.Tensor          # (I, 4, 3) f32
    instance_flags: torch.Tensor               # (I,) i64 INSTANCE_FLAG_*
    instance_material_overrides: torch.Tensor  # (I,) i64
    instance_light_indices: torch.Tensor       # (I,) i64
    light_radiance: torch.Tensor    # (L, 3) f32
    light_position: torch.Tensor    # (L, 3) f32 (directional: direction)
    light_tri_offset: torch.Tensor  # (L,) i64
    light_tri_count: torch.Tensor   # (L,) i64
    light_instance: torch.Tensor    # (L,) i64
    light_flags: torch.Tensor       # (L,) i64
    textures: torch.Tensor          # (K, TH, TW, 4) f32
    texture_sizes: torch.Tensor     # (K, 2) i64 (h, w)
    env_texture: torch.Tensor       # (EH, EW, 3) or (6, S, S, 3) f32
    # the opaque/masked split of the world-soup clusters (alpha-tested
    # scenes with cluster tables; (16, 13) / (16, 16) / (1, 8)
    # placeholders otherwise): cluster tables of the triangles that never
    # alpha-test (o) and of those that may (m)
    oclu_tris: torch.Tensor         # (CO*16, 13) f32
    oclu_bw: torch.Tensor           # (CO*16, 16) f32
    oclu_bbox: torch.Tensor         # (CO, 8) f32
    mclu_tris: torch.Tensor         # (CM*16, 13) f32
    mclu_bw: torch.Tensor           # (CM*16, 16) f32
    mclu_bbox: torch.Tensor         # (CM, 8) f32


class Intersection(NamedTuple):
    """Batched surface interaction record; all fields (R, ...)."""

    albedo: torch.Tensor          # (R, 3) (conductor: absorption k)
    alpha: torch.Tensor           # (R,) GGX alpha = roughness^2
    position: torch.Tensor        # (R, 3) world
    normal: torch.Tensor          # (R, 3) shading normal, world
    tangent: torch.Tensor         # (R, 3) world
    geometry_normal: torch.Tensor  # (R, 3) world
    ior: torch.Tensor             # (R, 3)
    is_two_sided: torch.Tensor    # (R,) bool
    backface: torch.Tensor        # (R,) bool
    multiscattering: torch.Tensor  # (R,) bool
    internal_mode: torch.Tensor   # (R,) i64
    material_type: torch.Tensor   # (R,) i64
    light_index: torch.Tensor     # (R,) i64
    triangle_index: torch.Tensor  # (R,) i32


class CameraParams(NamedTuple):
    """Thin-lens / pinhole camera constants (0-d or small tensors)."""

    transform: torch.Tensor        # (4, 4) f32 row-vector camera->world
    film_size: torch.Tensor        # (2,) f32 meters
    aperture_radius: torch.Tensor  # () f32, 0 = pinhole
    focal_distance: torch.Tensor   # () f32
    film_distance: torch.Tensor    # () f32
    blade_count: torch.Tensor      # () i64, <= 2 = circular
    blade_vertex_pos: torch.Tensor  # (2,) f32 unit-polygon vertex
    aperture_base_angle: torch.Tensor  # () f32 radians

    @staticmethod
    def create(transform=None, film_size=(0.05333, 0.03), aperture_radius=0.0,
               focal_distance=2.0, film_distance=None, focal_length=0.05,
               fov_x=None, blade_count=0, aperture_rotation=0.0):
        """Host-side camera description (CPU tensors; `to_device` moves
        it), with the reference's defaults and the same float64 host
        arithmetic before the float32 cast."""
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        if film_distance is None:
            if fov_x is not None:
                film_distance = 0.5 * film_size[0] / max(
                    np.tan(0.5 * fov_x), 1e-4)
            else:
                film_distance = (focal_length * focal_distance) / (
                    focal_length + focal_distance)
        blade_angle = np.pi / max(int(blade_count), 1)
        blade_vertex = (np.cos(blade_angle), np.sin(blade_angle))

        def f32(x):
            return torch.from_numpy(np.array(x, np.float32))

        return CameraParams(
            transform=f32(transform),
            film_size=f32(film_size),
            aperture_radius=f32(aperture_radius),
            focal_distance=f32(focal_distance),
            film_distance=f32(film_distance),
            blade_count=torch.tensor(int(blade_count), dtype=torch.int64),
            blade_vertex_pos=f32(blade_vertex),
            aperture_base_angle=f32(aperture_rotation),
        )


def to_device(record, device):
    """The same NamedTuple of tensors, placed on `device`."""
    return type(record)(*(x.to(device) for x in record))


def transform_point(p, m):
    """[p, 1] @ m for (..., 3) points and (..., 4, 3) matrices."""
    return (p[..., 0:1] * m[..., 0, :] + p[..., 1:2] * m[..., 1, :]
            + p[..., 2:3] * m[..., 2, :] + m[..., 3, :])


def transform_vector(v, m):
    return (v[..., 0:1] * m[..., 0, :] + v[..., 1:2] * m[..., 1, :]
            + v[..., 2:3] * m[..., 2, :])


def invert_rigid_affine43(m):
    """Inverse of a (4, 3) row-vector affine transform, in float64 on the
    host, returned as float32."""
    m = np.asarray(m, np.float64)
    inv_a = np.linalg.inv(m[:3, :])
    out = np.zeros((4, 3), np.float32)
    out[:3, :] = inv_a.astype(np.float32)
    out[3, :] = (-m[3, :] @ inv_a).astype(np.float32)
    return out


def transform_point44(p, m):
    """Row-vector transform of (..., 3) points by a (4, 4) matrix."""
    return transform_point(p, m[:, :3])


def transform_vector44(v, m):
    return transform_vector(v, m[:, :3])


def _tensor(x, device):
    a = np.asarray(x)
    if a.dtype.kind in "ui":
        a = a.astype(np.int64)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def from_reference(scene_arrays, luts, camera, device):
    """The reference's `SceneArrays`, `BxDFLuts` and `CameraParams` as the
    port's (SceneTensors, BxDFLuts, CameraParams) on `device`, with the
    reference's node table and leaf-ordered triangles kept as the scene's
    walker tables (the stack bound read back from the table). Fields are
    read as numpy arrays, so any array type with `__array__` works."""
    from ..accel.build import stack_bound
    from ..accel.traverse import NodeTables, register_node_tables
    from ..lut.textures import BxDFLuts

    scene = SceneTensors(*(_tensor(getattr(scene_arrays, f), device)
                           for f in SceneTensors._fields))
    nodes = np.asarray(scene_arrays.node_table)
    register_node_tables(scene, NodeTables(
        _tensor(nodes, device), _tensor(scene_arrays.tri_verts, device),
        stack_bound(nodes)))
    luts = BxDFLuts(*(_tensor(getattr(luts, f), device)
                      for f in BxDFLuts._fields))
    camera = CameraParams(*(_tensor(getattr(camera, f), device)
                            for f in CameraParams._fields))
    return scene, luts, camera
