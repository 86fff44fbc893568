"""Headless scene edits: cheap per-field `SceneTensors` updates.

Counterpart of `directcomputeraytracing_tpu.scene.edit` (the reference
renderer's per-frame editor writes, Source/Scene.cpp:672-807: a
material, light or instance-flag edit rewrites one buffer region and
never rebuilds the BVH). Every function here is a plain tensor update on
the flattened scene that returns a new `SceneTensors` through
`_replace`, on the scene's device, with no re-flatten. Geometry and
transform edits are out of scope by the same rule: they go through
`flatten_scene`.

The port keeps its materials in `mat_table` alone, so every material
edit writes its columns (`_COL`; the flag word in column 10, the opacity
texture in column 12). Its unsigned fields are int64, with
`INSTANCE_MATERIAL_OVERRIDE_NONE` and `LIGHT_INDEX_INVALID` as the
values `flatten_scene` writes.

Opacity and override edits re-derive the alpha tables the way
`flatten_scene` builds them (`_recompute_opacity_tables`). They need the
world soup's triangle-to-instance table (`world_tri_meta`), which scenes
on the instanced tables or the node table alone do not carry: there they
raise `ValueError`, and the edited scene is flattened again. Where the
scene has the opaque/masked cluster split, such an edit drops it (the
placeholders `flatten_scene` writes without one), since triangles may
move across it; casts then take the full recast path over the cluster
tables. The split is not rebuilt here.

Caveat: `RenderConfig.any_hit` is fixed when a `Renderer` is made, from
the scene's materials at flatten time. An opacity edit on a scene that
was flattened with no non-opaque material changes the tables but not the
image.

No edit replaces a geometry tensor (`world_tris`, `cluster_bbox`,
`isup_sbox`, `inst_rows`, ...): the traversal tables kept beside a scene
are keyed on them (`accel.worklist.scene_tables`, `accel.clustered`,
`accel.brute`, `accel.traverse.node_tables`), so an edited scene casts
through the tables already built.
"""

import numpy as np
import torch

from ..core.constants import (
    INSTANCE_FLAG_OPAQUE,
    INSTANCE_MATERIAL_OVERRIDE_NONE,
    LIGHT_INDEX_INVALID,
)
from .scene import _SPLIT_FIELDS, _no_clusters

# mat_table column layout (scene.py `_materials`):
# [albedo 0:3 | ior 3:6 | rough 6 | tiling 7:9 | opacity 9 | flags 10 |
#  albedo_tex 11 | opacity_tex 12 | pad 13:16]
_COL = {"albedo": 0, "ior": 3, "roughness": 6, "tiling": 7,
        "opacity": 9}
_FLAGS_COL = 10
_OPACITY_TEX_COL = 12


def _f32(value, like):
    """value as a flat float32 tensor on like's device."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=like.device).reshape(-1)


def _recompute_opacity_tables(arrays):
    """Re-derive the per-triangle and per-world-triangle opacities and the
    per-instance OPAQUE flags from the (edited) material table and
    overrides, by `flatten_scene`'s rules: an instance is OPAQUE iff the
    effective material (its override, else the triangle's own) of each of
    its triangles is fully opaque and untextured. Drops the opaque/masked
    split where the scene has one."""
    if arrays.world_tris.shape[0] <= 1:
        raise ValueError("opacity and override edits need the world soup "
                         "(world_tri_meta); this scene has none: flatten "
                         "the edited scene instead")
    mat = arrays.mat_table
    opacity = mat[:, _COL["opacity"]]
    clear = ~((opacity < 1.0) | (mat[:, _OPACITY_TEX_COL] >= 0))
    tri_id = arrays.world_tri_meta[:, 0].long()
    inst_id = arrays.world_tri_meta[:, 1].long()
    ov = arrays.instance_material_overrides[inst_id]
    eff = torch.where(ov < mat.shape[0], ov, arrays.material_ids[tri_id])
    flags = arrays.instance_flags
    inst_opaque = torch.ones(flags.shape[0], dtype=torch.float32,
                             device=flags.device).scatter_reduce(
        0, inst_id, clear[eff].float(), "amin", include_self=True) > 0.5
    arrays = arrays._replace(
        tri_opacity=opacity[arrays.material_ids],
        world_tri_opacity=torch.where(inst_opaque[inst_id], 1.0,
                                      opacity[eff]),
        instance_flags=torch.where(inst_opaque, flags | INSTANCE_FLAG_OPAQUE,
                                   flags & ~INSTANCE_FLAG_OPAQUE))
    if arrays.mclu_bbox.shape[0] > 1:
        arrays = arrays._replace(**{
            f: torch.from_numpy(a).to(mat.device)
            for f, a in zip(_SPLIT_FIELDS, _no_clusters() * 2)})
    return arrays


def update_material(arrays, index, albedo=None, ior=None, roughness=None,
                    tiling=None, opacity=None):
    """Edit one material's scalar and vector fields (no re-flatten). An
    opacity edit also re-derives the alpha tables and per-instance OPAQUE
    flags. Returns new SceneTensors."""
    given = {"albedo": albedo, "ior": ior, "roughness": roughness,
             "tiling": tiling, "opacity": opacity}
    tab = arrays.mat_table.clone()
    for name, value in given.items():
        if value is not None:
            v = _f32(value, tab)
            c = _COL[name]
            tab[index, c:c + v.shape[0]] = v
    arrays = arrays._replace(mat_table=tab)
    if opacity is not None:
        arrays = _recompute_opacity_tables(arrays)
    return arrays


def update_material_flags(arrays, index, flags):
    """Replace one material's packed flag word (type bits, two-sided,
    multiscattering, internal-scattering mode: core.constants)."""
    tab = arrays.mat_table.clone()
    tab[index, _FLAGS_COL] = float(np.float32(int(flags)))
    return arrays._replace(mat_table=tab)


def update_light(arrays, index, radiance=None, position=None):
    """Edit a punctual or mesh light's radiance, or its position (a
    directional light's direction)."""
    lr, lp = arrays.light_radiance, arrays.light_position
    if radiance is not None:
        lr = lr.clone()
        lr[index] = _f32(radiance, lr)
    if position is not None:
        lp = lp.clone()
        lp[index] = _f32(position, lp)
    return arrays._replace(light_radiance=lr, light_position=lp)


def update_instance_override(arrays, index, material_override):
    """Set, or clear with a negative value, an instance's material
    override; re-derives the alpha tables as flatten_scene does."""
    mo = int(material_override)
    if mo >= arrays.mat_table.shape[0]:
        raise IndexError(f"material override {mo}: the scene has "
                         f"{arrays.mat_table.shape[0]} materials")
    overrides = arrays.instance_material_overrides.clone()
    overrides[index] = INSTANCE_MATERIAL_OVERRIDE_NONE if mo < 0 else mo
    return _recompute_opacity_tables(
        arrays._replace(instance_material_overrides=overrides))


def update_emitter_radiance(arrays, instance_index, radiance):
    """Edit an emissive instance's radiance (its mesh light row). On an
    instance that is not an emitter no row matches, so nothing changes."""
    lr = arrays.light_radiance
    li = arrays.instance_light_indices[instance_index]
    row = torch.arange(lr.shape[0], device=lr.device) == li
    return arrays._replace(
        light_radiance=torch.where(row[:, None], _f32(radiance, lr), lr))


def light_index_of(arrays, instance_index):
    """The light row of an emissive instance, or None (a host read)."""
    li = int(arrays.instance_light_indices[instance_index])
    return None if li == LIGHT_INDEX_INVALID else li
