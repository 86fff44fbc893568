"""The reference's scene model and its plain flattening.

A frozen copy of the port's host-side scene records (`Mesh`, `Material`,
`Instance`, `PunctualLight`, `Scene`) and of the table packing of its
`flatten_scene` (lights, materials, texture atlas, alpha flags), without
any traversal structure: triangles stay in mesh order, and the world-space
soup that `reference.intersect` sweeps is built here.
"""

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.constants import (
    INSTANCE_FLAG_OPAQUE,
    INSTANCE_MATERIAL_OVERRIDE_NONE,
    INTERNAL_SCATTERING_MODE_IGNORE,
    LIGHT_FLAGS_DIRECTIONAL,
    LIGHT_FLAGS_ENVIRONMENT,
    LIGHT_FLAGS_MESH,
    LIGHT_FLAGS_POINT,
    LIGHT_INDEX_INVALID,
    MATERIAL_FLAG_ALBEDO_TEXTURE,
    MATERIAL_FLAG_INTERNAL_SCATTERING_SHIFT,
    MATERIAL_FLAG_IS_TWOSIDED,
    MATERIAL_FLAG_MULTISCATTERING,
    MATERIAL_FLAG_ROUGHNESS_TEXTURE,
    MATERIAL_TYPE_DIFFUSE,
)


@dataclass
class Mesh:
    positions: np.ndarray             # (V, 3) f32
    indices: np.ndarray               # (T, 3) int
    normals: Optional[np.ndarray] = None     # (V, 3)
    tangents: Optional[np.ndarray] = None    # (V, 3)
    texcoords: Optional[np.ndarray] = None   # (V, 2)
    material_ids: Optional[np.ndarray] = None  # (T,) int
    name: str = ""

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32)
        self.indices = np.asarray(self.indices, np.int64).reshape(-1, 3)
        v = self.positions.shape[0]
        t = self.indices.shape[0]
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions,
                                                  self.indices)
        if self.tangents is None:
            self.tangents = np.zeros((v, 3), np.float32)
        if self.texcoords is None:
            self.texcoords = np.zeros((v, 2), np.float32)
        if self.material_ids is None:
            self.material_ids = np.zeros(t, np.int64)
        self.normals = np.asarray(self.normals, np.float32)
        self.tangents = np.asarray(self.tangents, np.float32)
        self.texcoords = np.asarray(self.texcoords, np.float32)
        self.material_ids = np.asarray(self.material_ids, np.int64)


@dataclass
class Material:
    albedo: tuple = (0.8, 0.8, 0.8)
    mtype: int = MATERIAL_TYPE_DIFFUSE
    ior: tuple = (1.5, 1.5, 1.5)      # conductor: eta; k goes in `k`
    k: Optional[tuple] = None          # conductor absorption (kept in albedo)
    roughness: float = 1.0
    tiling: tuple = (1.0, 1.0)
    opacity: float = 1.0
    two_sided: bool = False
    multiscattering: bool = False
    internal_scattering: int = INTERNAL_SCATTERING_MODE_IGNORE
    albedo_texture: int = -1
    opacity_texture: int = -1
    roughness_texture: bool = False
    name: str = ""

    def flags(self) -> int:
        f = int(self.mtype) & 0xF
        if self.albedo_texture >= 0:
            f |= MATERIAL_FLAG_ALBEDO_TEXTURE
        if self.roughness_texture:
            f |= MATERIAL_FLAG_ROUGHNESS_TEXTURE
        if self.two_sided:
            f |= MATERIAL_FLAG_IS_TWOSIDED
        if self.multiscattering:
            f |= MATERIAL_FLAG_MULTISCATTERING
        f |= (int(self.internal_scattering) & 0x3) << \
            MATERIAL_FLAG_INTERNAL_SCATTERING_SHIFT
        return f

    @property
    def non_opaque(self):
        return self.opacity < 1.0 or self.opacity_texture >= 0


@dataclass
class Instance:
    mesh: int
    transform: np.ndarray = None       # (4, 3) row-vector local->world
    material_override: int = -1
    is_emitter: bool = False
    radiance: tuple = (0.0, 0.0, 0.0)  # if emitter (area light)
    name: str = ""

    def __post_init__(self):
        if self.transform is None:
            self.transform = np.concatenate(
                [np.eye(3, dtype=np.float32), np.zeros((1, 3), np.float32)])
        self.transform = np.asarray(self.transform, np.float32).reshape(4, 3)


@dataclass
class PunctualLight:
    """Point, directional or constant/textured environment light."""
    kind: str                          # 'point' | 'directional' | 'env'
    radiance: tuple = (1.0, 1.0, 1.0)
    position: tuple = (0.0, 0.0, 0.0)  # point: position; directional: dir


@dataclass
class Scene:
    meshes: List[Mesh] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    lights: List[PunctualLight] = field(default_factory=list)
    # (H, W, 3) lat-long or (6, S, S, 3) D3D-order cubemap radiance
    env_texture: Optional[np.ndarray] = None
    textures: List[np.ndarray] = field(default_factory=list)  # (h, w, 4)


class SceneMeta(NamedTuple):
    """Static scene facts that specialise the integrator."""
    light_count: int
    env_light_index: int   # LIGHT_INDEX_INVALID if none
    has_env_texture: bool
    any_non_opaque: bool
    any_opacity_texture: bool


def compute_vertex_normals(positions, indices):
    """Area-weighted vertex normals; front faces are clockwise (geometry
    normal = cross(v0v2, v0v1))."""
    normals = np.zeros_like(positions)
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    fn = np.cross(v2 - v0, v1 - v0)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(lens, 1e-20)).astype(np.float32)


def _lights(scene, mesh_tri_offsets):
    """Punctual lights first, then one mesh light per emissive instance
    (the reference's order). Returns the light table columns, the
    per-instance light index and the env light index."""
    rows = []
    inst_light = np.full(len(scene.instances), LIGHT_INDEX_INVALID,
                         np.int64)
    env_light_index = LIGHT_INDEX_INVALID
    kinds = {"point": LIGHT_FLAGS_POINT,
             "directional": LIGHT_FLAGS_DIRECTIONAL,
             "env": LIGHT_FLAGS_ENVIRONMENT}
    for light in scene.lights:
        if light.kind not in kinds:
            raise ValueError(light.kind)
        if light.kind == "env":
            env_light_index = len(rows)
        rows.append((light.radiance, light.position, 0, 0, 0,
                     kinds[light.kind]))
    for i, inst in enumerate(scene.instances):
        if inst.is_emitter:
            inst_light[i] = len(rows)
            rows.append((inst.radiance, (0.0, 0.0, 0.0),
                         int(mesh_tri_offsets[inst.mesh]),
                         scene.meshes[inst.mesh].indices.shape[0], i,
                         LIGHT_FLAGS_MESH))
    n = max(len(rows), 1)
    radiance = np.zeros((n, 3), np.float32)
    position = np.zeros((n, 3), np.float32)
    offset = np.zeros(n, np.int64)
    count = np.ones(n, np.int64)
    instance = np.zeros(n, np.int64)
    flags = np.zeros(n, np.int64)
    for j, (rad, pos, off, cnt, ins, flg) in enumerate(rows):
        radiance[j] = rad
        position[j] = pos
        offset[j] = off
        count[j] = max(cnt, 1)
        instance[j] = ins
        flags[j] = flg
    return ((radiance, position, offset, count, instance, flags),
            inst_light, env_light_index, len(rows))


def _materials(materials):
    """(M, 16) packed material table, as the reference packs it."""
    table = np.zeros((len(materials), 16), np.float32)
    for j, mat in enumerate(materials):
        table[j, 0:3] = mat.k if mat.k is not None else mat.albedo
        table[j, 3:6] = mat.ior
        table[j, 6] = mat.roughness
        table[j, 7:9] = mat.tiling
        table[j, 9] = mat.opacity
        table[j, 10] = mat.flags()
        table[j, 11] = mat.albedo_texture
        table[j, 12] = mat.opacity_texture
    return table


def _texture_atlas(textures):
    if not textures:
        return np.zeros((1, 1, 1, 4), np.float32), np.ones((1, 2), np.int64)
    th = max(t.shape[0] for t in textures)
    tw = max(t.shape[1] for t in textures)
    atlas = np.zeros((len(textures), th, tw, 4), np.float32)
    sizes = np.zeros((len(textures), 2), np.int64)
    for k, t in enumerate(textures):
        atlas[k, : t.shape[0], : t.shape[1]] = t
        sizes[k] = (t.shape[0], t.shape[1])
    return atlas, sizes


def _instance_flags(scene, material_ids, mesh_tri_offsets):
    """(I,) INSTANCE_FLAG_OPAQUE, or 0 where the instance's override (or,
    without one, a material of its mesh) may be transparent."""
    n_mat = len(scene.materials)
    flags = np.full(len(scene.instances), INSTANCE_FLAG_OPAQUE, np.int64)
    for i, inst in enumerate(scene.instances):
        if 0 <= inst.material_override < n_mat:
            mats = [inst.material_override]
        else:
            lo = mesh_tri_offsets[inst.mesh]
            mats = np.unique(material_ids[
                lo:lo + scene.meshes[inst.mesh].indices.shape[0]])
        if any(scene.materials[int(m)].non_opaque for m in mats):
            flags[i] = 0
    return flags


def _world_opacity(scene, inst_flags, mat_table, tri_opacity,
                   mesh_tri_offsets):
    """(B,) opacity per world-soup triangle: 1 on opaque instances, the
    override's opacity where an instance has one, else the triangle's."""
    n_mat = mat_table.shape[0]
    out = []
    for i, inst in enumerate(scene.instances):
        lo = int(mesh_tri_offsets[inst.mesh])
        n = scene.meshes[inst.mesh].indices.shape[0]
        if inst_flags[i] & INSTANCE_FLAG_OPAQUE:
            out.append(np.ones(n, np.float32))
        elif 0 <= inst.material_override < n_mat:
            out.append(np.full(n, mat_table[inst.material_override, 9],
                               np.float32))
        else:
            out.append(tri_opacity[lo:lo + n])
    return np.concatenate(out)


class RefScene(NamedTuple):
    """What the reference's path loop reads, on one device. Triangle ids
    index `triangles` (mesh order); the world soup row w is triangle
    `world_tri[w]` of instance `world_inst[w]`."""
    vtx_position: torch.Tensor
    triangles: torch.Tensor
    vtx_table: torch.Tensor
    mat_table: torch.Tensor
    material_ids: torch.Tensor
    tri_opacity: torch.Tensor
    instance_transforms: torch.Tensor
    instance_flags: torch.Tensor
    instance_material_overrides: torch.Tensor
    instance_light_indices: torch.Tensor
    light_radiance: torch.Tensor
    light_position: torch.Tensor
    light_tri_offset: torch.Tensor
    light_tri_count: torch.Tensor
    light_instance: torch.Tensor
    light_flags: torch.Tensor
    textures: torch.Tensor
    texture_sizes: torch.Tensor
    env_texture: torch.Tensor
    world_v0: torch.Tensor          # (B, 3) world-space corners
    world_v1: torch.Tensor
    world_v2: torch.Tensor
    world_tri: torch.Tensor         # (B,) triangle id
    world_inst: torch.Tensor        # (B,) instance id
    world_masked: torch.Tensor      # (B,) bool: may alpha-test


def flatten(scene: Scene, device, dtype=torch.float32):
    """(RefScene, SceneMeta): the scene's tables in mesh order and its
    world-space soup, floats in dtype."""
    if not scene.materials:
        scene.materials = [Material()]
    offsets = np.zeros(len(scene.meshes), np.int64)
    vtx_off, tri_off, tris, mids = 0, 0, [], []
    for m, mesh in enumerate(scene.meshes):
        offsets[m] = tri_off
        tris.append(mesh.indices + vtx_off)
        mids.append(mesh.material_ids)
        vtx_off += mesh.positions.shape[0]
        tri_off += mesh.indices.shape[0]
    triangles = np.concatenate(tris).astype(np.int64)
    material_ids = np.concatenate(mids).astype(np.int64)
    all_pos = np.concatenate([m.positions for m in scene.meshes])
    light_cols, inst_light, env_light_index, n_lights = _lights(scene,
                                                                offsets)
    mat_table = _materials(scene.materials)
    n_mat = mat_table.shape[0]
    inst_flags = _instance_flags(scene, material_ids, offsets)
    tri_opacity = mat_table[material_ids, 9]
    world_opacity = _world_opacity(scene, inst_flags, mat_table,
                                   tri_opacity, offsets)

    wv, wtri, winst = [], [], []
    for ii, inst in enumerate(scene.instances):
        lo = int(offsets[inst.mesh])
        n = scene.meshes[inst.mesh].indices.shape[0]
        v = all_pos[triangles[lo:lo + n]]                 # (n, 3, 3)
        wv.append((v @ inst.transform[:3] + inst.transform[3])
                  .astype(np.float32))
        wtri.append(np.arange(lo, lo + n))
        winst.append(np.full(n, ii))
    wv = np.concatenate(wv)
    wtri, winst = np.concatenate(wtri), np.concatenate(winst)
    ov = np.asarray([i.material_override for i in scene.instances],
                    np.int64)[winst]
    eff = np.where((ov >= 0) & (ov < n_mat), ov, material_ids[wtri])
    opaque = (inst_flags[winst] & INSTANCE_FLAG_OPAQUE) != 0
    masked = ~opaque & ((world_opacity < 1.0) | (mat_table[eff, 12] >= 0))

    atlas, sizes = _texture_atlas(scene.textures)
    env = (scene.env_texture if scene.env_texture is not None
           else np.ones((1, 1, 3), np.float32))
    vtx_table = np.concatenate(
        [all_pos, np.concatenate([m.normals for m in scene.meshes]),
         np.concatenate([m.tangents for m in scene.meshes]),
         np.concatenate([m.texcoords for m in scene.meshes])], axis=1)
    overrides = np.asarray(
        [i.material_override if 0 <= i.material_override
         else INSTANCE_MATERIAL_OVERRIDE_NONE for i in scene.instances],
        np.int64)
    inst_tf = np.stack([i.transform for i in scene.instances])

    def t(a, kind=None):
        a = np.ascontiguousarray(a)
        x = torch.from_numpy(a).to(device)
        if kind == "f":
            return x.to(dtype)
        return x.long() if a.dtype.kind in "iu" else x

    arrays = RefScene(
        vtx_position=t(all_pos, "f"), triangles=t(triangles),
        vtx_table=t(vtx_table, "f"), mat_table=t(mat_table, "f"),
        material_ids=t(material_ids), tri_opacity=t(tri_opacity, "f"),
        instance_transforms=t(inst_tf, "f"),
        instance_flags=t(inst_flags),
        instance_material_overrides=t(overrides),
        instance_light_indices=t(inst_light),
        light_radiance=t(light_cols[0], "f"),
        light_position=t(light_cols[1], "f"),
        light_tri_offset=t(light_cols[2]), light_tri_count=t(light_cols[3]),
        light_instance=t(light_cols[4]), light_flags=t(light_cols[5]),
        textures=t(atlas, "f"), texture_sizes=t(sizes),
        env_texture=t(np.asarray(env, np.float32), "f"),
        world_v0=t(wv[:, 0], "f"), world_v1=t(wv[:, 1], "f"),
        world_v2=t(wv[:, 2], "f"), world_tri=t(wtri), world_inst=t(winst),
        world_masked=torch.from_numpy(masked).to(device))
    meta = SceneMeta(
        light_count=n_lights, env_light_index=int(env_light_index),
        has_env_texture=scene.env_texture is not None,
        any_non_opaque=any(m.non_opaque for m in scene.materials),
        any_opacity_texture=any(m.opacity_texture >= 0
                                for m in scene.materials))
    return arrays, meta
