"""Host-side scene model and its flattening to device tensors.

Numpy counterpart of `directcomputeraytracing_tpu.scene.scene`: one SAH
BLAS per mesh orders each mesh's triangles into leaf order (the
reference's numpy SAH build, `directcomputeraytracing_tpu.accel.build`),
and materials, lights and textures pack into the tables `SceneTensors`
names. Scenes of at most `SOUP_MAX_TRIS` world triangles expand their
instances into a world-space triangle soup, clustered above
`DENSE_MAX_TRIS` for the work-list traversal (`accel.cluster`). Larger
scenes keep their triangles mesh-local and get the instanced work-list
tables instead (the reference's BLAS sharing; a test forces them on a
small scene by lowering `SOUP_MAX_TRIS`). The port has no stack
traversal, so no TLAS is built: a larger scene of at most 64 local
triangles, which the reference sends to its stack walker, raises.

Alpha-tested scenes (a material with opacity < 1 or an opacity texture)
get the reference's alpha tables: per-triangle and per-world-triangle
opacity, per-instance OPAQUE flags (an instance is opaque unless its
override, or one of its mesh's materials, may be transparent), and on
world-soup cluster tables the opaque/masked split: the clusters of the
triangles that never alpha-test and of those that may, when both exist.
Instanced tables get no split (the reference's needs the soup), so their
alpha casts re-cast through the whole scene.
"""

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..accel.build import build_bvh
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

from ..accel.cluster import (
    CLUSTER_SIZE,
    SUPER_SIZE,
    baldwin_table,
    build_clusters,
    build_instanced_supers,
    build_local_clusters,
)
from ..core.types import SceneTensors, invert_rigid_affine43

# Largest world-triangle soup the dense sweep takes; the reference builds
# cluster tables above this (scene/scene.py:398).
DENSE_MAX_TRIS = 2048
# Largest soup the reference expands; above it, it builds the instanced
# work-list tables instead (scene/scene.py:338, :451).
SOUP_MAX_TRIS = 1 << 20
# Local triangles (all meshes) up to which a scene above SOUP_MAX_TRIS gets
# no instanced tables: the reference casts it with its stack walker (:453).
INSTANCED_MIN_LOCAL_TRIS = 64


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


def _world_soup(scene, tri_verts, mesh_tri_offsets):
    """Each instance's leaf-ordered triangles in world space: (B, 9)
    v0|v1|v2 and (B, 3) meta [tri id, instance, flip]."""
    world_tris, world_meta = [], []
    for ii, inst in enumerate(scene.instances):
        lo = int(mesh_tri_offsets[inst.mesh])
        hi = lo + scene.meshes[inst.mesh].indices.shape[0]
        a = inst.transform[:3]
        world_tris.append((tri_verts[lo:hi].reshape(-1, 3, 3) @ a
                           + inst.transform[3]).reshape(-1, 9)
                          .astype(np.float32))
        meta = np.empty((hi - lo, 3), np.float32)
        meta[:, 0] = np.arange(lo, hi, dtype=np.float32)
        meta[:, 1] = ii
        meta[:, 2] = 1.0 if np.linalg.det(a.astype(np.float64)) < 0 else 0.0
        world_meta.append(meta)
    return np.concatenate(world_tris), np.concatenate(world_meta)


_SPLIT_FIELDS = ("oclu_tris", "oclu_bw", "oclu_bbox", "mclu_tris", "mclu_bw",
                 "mclu_bbox")


def _no_clusters():
    """Placeholder cluster tables (tris, Baldwin-Weber rows, boxes)."""
    return (np.zeros((CLUSTER_SIZE, 13), np.float32),
            np.zeros((CLUSTER_SIZE, 16), np.float32),
            np.zeros((1, 8), np.float32))


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


def _alpha_split(scene, world_tris, world_meta, world_opacity, inst_flags,
                 material_ids, mat_table):
    """The opaque/masked split of the world soup's clusters: (oclu_tris,
    oclu_bw, oclu_bbox, mclu_tris, mclu_bw, mclu_bbox), or None unless
    both sides have triangles. A triangle is maybe-transparent on a
    non-opaque instance where its opacity is below 1 or its effective
    material (the override, else its own) has an opacity texture."""
    n_mat = mat_table.shape[0]
    prim = world_meta[:, 0].astype(np.int64)
    iid = world_meta[:, 1].astype(np.int64)
    ov = np.asarray([inst.material_override for inst in scene.instances],
                    np.int64)[iid]
    eff = np.where((ov >= 0) & (ov < n_mat), ov, material_ids[prim])
    opaque = (inst_flags[iid] & INSTANCE_FLAG_OPAQUE) != 0
    maybe = ~opaque & ((world_opacity < 1.0) | (mat_table[eff, 12] >= 0))
    if not (maybe.any() and (~maybe).any()):
        return None
    out = ()
    for part in (~maybe, maybe):
        tris, bbox = build_clusters(world_tris[part], world_meta[part])
        out += (tris, baldwin_table(tris), bbox)
    return out


def flatten_scene(scene: Scene, device):
    """Compile the host scene into (SceneTensors on `device`, SceneMeta)."""
    if not (scene.meshes and scene.instances):
        raise ValueError("scene needs geometry")
    if not scene.materials:
        scene.materials = [Material()]
    total_world_tris = sum(scene.meshes[i.mesh].indices.shape[0]
                           for i in scene.instances)
    instanced = total_world_tris > SOUP_MAX_TRIS
    local_tris = sum(m.indices.shape[0] for m in scene.meshes)
    if instanced and local_tris <= INSTANCED_MIN_LOCAL_TRIS:
        raise NotImplementedError(
            f"{total_world_tris} world triangles from {local_tris} local "
            "ones: the reference casts such scenes with its stack walker "
            "(ROADMAP queue 1, item 8)")
    any_non_opaque = any(m.non_opaque for m in scene.materials)

    # per-mesh BLAS leaf order; triangle ids are global, mesh by mesh
    mesh_tris, mesh_matids = [], []
    mesh_tri_offsets = np.zeros(len(scene.meshes), np.int64)
    vtx_offset = tri_cursor = 0
    for m, mesh in enumerate(scene.meshes):
        v = mesh.positions[mesh.indices]
        order = build_bvh(v.min(axis=1), v.max(axis=1),
                          max_prims_in_node=2).prim_order
        mesh_tris.append(mesh.indices[order] + vtx_offset)
        mesh_matids.append(mesh.material_ids[order])
        mesh_tri_offsets[m] = tri_cursor
        tri_cursor += mesh.indices.shape[0]
        vtx_offset += mesh.positions.shape[0]
    triangles = np.concatenate(mesh_tris).astype(np.int64)
    material_ids = np.concatenate(mesh_matids).astype(np.int64)
    all_pos = np.concatenate([m.positions for m in scene.meshes])

    light_cols, inst_light, env_light_index, n_lights = _lights(
        scene, mesh_tri_offsets)
    mat_table = _materials(scene.materials)
    n_mat = len(scene.materials)

    tri_verts = all_pos[triangles].reshape(-1, 9)
    if instanced:
        world_tris = np.zeros((1, 9), np.float32)
        world_meta = np.zeros((1, 3), np.float32)
    else:
        world_tris, world_meta = _world_soup(scene, tri_verts,
                                             mesh_tri_offsets)
    if world_tris.shape[0] > DENSE_MAX_TRIS:
        cluster_tris, cluster_bbox = build_clusters(world_tris, world_meta)
        cluster_bw = baldwin_table(cluster_tris)
    else:
        cluster_tris, cluster_bw, cluster_bbox = _no_clusters()

    inst_flags = _instance_flags(scene, material_ids, mesh_tri_offsets)
    tri_opacity = mat_table[material_ids, 9]
    world_opacity = (_world_opacity(scene, inst_flags, mat_table,
                                    tri_opacity, mesh_tri_offsets)
                     if world_tris.shape[0] > 1
                     else np.ones(1, np.float32))
    split = _no_clusters() * 2
    if any_non_opaque and cluster_bbox.shape[0] > 1:
        split = _alpha_split(scene, world_tris, world_meta, world_opacity,
                             inst_flags, material_ids, mat_table) or split

    inst_tf = np.stack([i.transform for i in scene.instances])
    inst_inv = np.stack([invert_rigid_affine43(t) for t in inst_tf])
    inst_det = np.asarray([np.linalg.det(t[:3].astype(np.float64))
                           for t in inst_tf])
    inst_rows = np.concatenate(
        [inst_inv[:, :3].reshape(-1, 9), inst_inv[:, 3],
         (inst_det < 0).astype(np.float32)[:, None],
         np.zeros((len(scene.instances), 3), np.float32)],
        axis=1).astype(np.float32)
    if instanced:
        icl_slab, lbox, mso, msc = build_local_clusters(
            tri_verts, mesh_tri_offsets,
            [m.indices.shape[0] for m in scene.meshes])
        icl_bw = baldwin_table(icl_slab)
        isup_cbox, isup_sbox, isup_local, isup_inst = build_instanced_supers(
            lbox, mso, msc, [i.mesh for i in scene.instances], inst_tf)
    else:
        icl_slab = np.zeros((CLUSTER_SIZE, 13), np.float32)
        icl_bw = np.zeros((CLUSTER_SIZE, 16), np.float32)
        isup_cbox = np.zeros((1, SUPER_SIZE, 8), np.float32)
        isup_sbox = np.zeros((1, 8), np.float32)
        isup_local = isup_inst = np.zeros(1, np.int64)

    atlas, sizes = _texture_atlas(scene.textures)
    env = (scene.env_texture if scene.env_texture is not None
           else np.ones((1, 1, 3), np.float32))
    vtx_table = np.concatenate(
        [all_pos, np.concatenate([m.normals for m in scene.meshes]),
         np.concatenate([m.tangents for m in scene.meshes]),
         np.concatenate([m.texcoords for m in scene.meshes]),
         np.zeros((all_pos.shape[0], 1), np.float32)], axis=1)
    overrides = np.asarray(
        [i.material_override if 0 <= i.material_override
         else INSTANCE_MATERIAL_OVERRIDE_NONE for i in scene.instances],
        np.int64)

    def t(a, dtype=None):
        a = np.ascontiguousarray(a, dtype)
        return torch.from_numpy(a).to(device)

    arrays = SceneTensors(
        vtx_position=t(all_pos, np.float32),
        triangles=t(triangles),
        world_tris=t(world_tris),
        world_tri_meta=t(world_meta),
        cluster_tris=t(cluster_tris),
        cluster_bw=t(cluster_bw),
        cluster_bbox=t(cluster_bbox),
        icl_slab=t(icl_slab),
        icl_bw=t(icl_bw),
        isup_cbox=t(isup_cbox),
        isup_sbox=t(isup_sbox),
        isup_local=t(isup_local, np.int64),
        isup_inst=t(isup_inst, np.int64),
        inst_rows=t(inst_rows),
        vtx_table=t(vtx_table, np.float32),
        mat_table=t(mat_table),
        material_ids=t(material_ids),
        tri_opacity=t(tri_opacity, np.float32),
        world_tri_opacity=t(world_opacity, np.float32),
        instance_transforms=t(inst_tf),
        instance_flags=t(inst_flags, np.int64),
        instance_material_overrides=t(overrides),
        instance_light_indices=t(inst_light),
        light_radiance=t(light_cols[0]),
        light_position=t(light_cols[1]),
        light_tri_offset=t(light_cols[2]),
        light_tri_count=t(light_cols[3]),
        light_instance=t(light_cols[4]),
        light_flags=t(light_cols[5]),
        textures=t(atlas),
        texture_sizes=t(sizes),
        env_texture=t(env, np.float32),
        **{f: t(a) for f, a in zip(_SPLIT_FIELDS, split)},
    )
    meta = SceneMeta(
        light_count=n_lights,
        env_light_index=int(env_light_index),
        has_env_texture=scene.env_texture is not None,
        any_non_opaque=any_non_opaque,
        any_opacity_texture=any(m.opacity_texture >= 0
                                for m in scene.materials),
    )
    return arrays, meta
