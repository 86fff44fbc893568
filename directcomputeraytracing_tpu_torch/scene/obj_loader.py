"""Wavefront OBJ + MTL scene ingestion.

The port's copy of `directcomputeraytracing_tpu.scene.obj_loader` (the
same numpy code; it builds the port's `scene.Scene`, held to the
reference's field for field by `tests/test_torch_loaders.py`).

Behavioral port of the reference's OBJ pipeline
(reference: Source/WavefrontOBJLoading.cpp — tinyobjloader parse,
MikkTSpace tangent generation :88-153, vertex dedup keyed on
(pos/normal/texcoord index, tangent) :155-263, RHS->LHS handedness flip
(x = -x) + winding-order flip + texcoord V flip :431-437, MTL->material
translation defaulting to Plastic :305-372, one mesh + identity instance
per OBJ shape :439-456) — re-implemented in vectorized NumPy (ingestion
is host-side/offline; the C++ path is only warranted if profiling says
so, SURVEY.md §2).

Tangents come from a vectorized UV-gradient accumulation (the standard
Lengyel method, orthonormalized per vertex) rather than a line-for-line
MikkTSpace port; both produce normal-consistent tangent frames for the
anisotropy-free BSDFs this renderer ships.
"""

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.constants import MATERIAL_TYPE_PLASTIC
from .scene import Instance, Material, Mesh, Scene


@dataclass
class MtlMaterial:
    name: str = ""
    diffuse: tuple = (0.8, 0.8, 0.8)
    ior: float = 1.5
    roughness: float = 1.0
    opacity: float = 1.0
    map_kd: Optional[str] = None


def parse_mtl(path) -> Dict[str, MtlMaterial]:
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            k = tok[0]
            if k == "newmtl":
                cur = MtlMaterial(name=tok[1] if len(tok) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif k == "Kd":
                cur.diffuse = tuple(float(x) for x in tok[1:4])
            elif k == "Ni":
                cur.ior = float(tok[1])
            elif k == "Ns":
                # Blinn-Phong exponent -> GGX roughness (PBR-ish remap)
                ns = max(float(tok[1]), 1.0)
                cur.roughness = float(np.clip(np.sqrt(2.0 / (ns + 2.0)),
                                              0.0, 1.0))
            elif k == "d":
                cur.opacity = float(tok[1])
            elif k == "Tr":
                cur.opacity = 1.0 - float(tok[1])
            elif k == "map_Kd":
                cur.map_kd = tok[-1]
    return mats


def _parse_index(s, n_v, n_vt, n_vn):
    """OBJ face corner 'v/vt/vn' with negative-index support."""
    parts = s.split("/")

    def fix(tok, n):
        if not tok:
            return -1
        i = int(tok)
        return i - 1 if i > 0 else n + i

    vi = fix(parts[0], n_v)
    ti = fix(parts[1], n_vt) if len(parts) > 1 else -1
    ni = fix(parts[2], n_vn) if len(parts) > 2 else -1
    return vi, ti, ni


def compute_tangents(positions, normals, texcoords, indices):
    """Per-vertex tangents the MikkTSpace way, vectorized
    (reference: MikkTSpace/mikktspace.c via WavefrontOBJLoading.cpp:
    88-153): per-face UV-gradient tangents are accumulated per corner
    weighted by the CORNER ANGLE (not area — MikkTSpace's defining
    property, so long thin triangles don't dominate a vertex), split
    by texture-space handedness (corners whose faces disagree in UV
    winding average separately, mirrored-UV seams keep a consistent
    frame), then Gram-Schmidt orthonormalized against the vertex
    normal.

    Remaining delta vs mikktspace.c: no neighborhood subgroup split
    within a handedness class (affects only meshes that weld faces of
    disagreeing smoothing groups onto one vertex)."""
    t_acc = np.zeros_like(positions)
    t_acc_f = np.zeros_like(positions)   # flipped-handedness class
    w_pos = np.zeros(len(positions))
    w_neg = np.zeros(len(positions))
    p = [positions[indices[:, k]] for k in range(3)]
    uv = [texcoords[indices[:, k]] for k in range(3)]
    e1 = p[1] - p[0]
    e2 = p[2] - p[0]
    d1 = uv[1] - uv[0]
    d2 = uv[2] - uv[0]
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    degen = np.abs(det) < 1e-12
    r = np.where(degen, 0.0, 1.0 / np.where(degen, 1.0, det))
    tan = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    tlen = np.linalg.norm(tan, axis=1, keepdims=True)
    tan = np.where(tlen > 1e-12, tan / np.maximum(tlen, 1e-20), 0.0)
    flipped = det < 0.0
    for k in range(3):
        a = p[(k + 1) % 3] - p[k]
        b = p[(k + 2) % 3] - p[k]
        an = np.linalg.norm(a, axis=1)
        bn = np.linalg.norm(b, axis=1)
        cosang = np.sum(a * b, axis=1) / np.maximum(an * bn, 1e-20)
        angle = np.arccos(np.clip(cosang, -1.0, 1.0))
        wt = np.where(degen, 0.0, angle)
        idx = indices[:, k]
        np.add.at(t_acc, idx, tan * np.where(flipped, 0.0, wt)[:, None])
        np.add.at(t_acc_f, idx, tan * np.where(flipped, wt, 0.0)[:, None])
        np.add.at(w_pos, idx, np.where(flipped, 0.0, wt))
        np.add.at(w_neg, idx, np.where(flipped, wt, 0.0))
    # the dominant handedness class wins the vertex (a welded vertex on
    # a mirrored-UV seam keeps the majority frame instead of a
    # cancelled average)
    use_flip = (w_neg > w_pos)[:, None]
    t_acc = np.where(use_flip, t_acc_f, t_acc)
    # Gram-Schmidt against the normal
    t_acc -= normals * np.sum(t_acc * normals, axis=1, keepdims=True)
    lens = np.linalg.norm(t_acc, axis=1, keepdims=True)
    return np.where(lens > 1e-8, t_acc / np.maximum(lens, 1e-20),
                    0.0).astype(np.float32)


def load_obj(path, default_material=None):
    """Load an OBJ (+MTL) file into a Scene: one mesh + identity instance
    per shape, materials translated to Plastic (reference default)."""
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    texcoords: List[List[float]] = []
    mtl: Dict[str, MtlMaterial] = {}
    mat_order: List[str] = []

    # faces grouped into shapes on o/g statements
    shapes = []           # list of (name, faces); face = (corners, mat_id)
    cur_faces: List = []
    cur_name = ""
    cur_mat = -1

    def flush():
        nonlocal cur_faces
        if cur_faces:
            shapes.append((cur_name, cur_faces))
            cur_faces = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            k = tok[0]
            if k == "v":
                positions.append([float(x) for x in tok[1:4]])
            elif k == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif k == "vt":
                texcoords.append([float(x) for x in tok[1:3]])
            elif k == "mtllib":
                mtl.update(parse_mtl(os.path.join(os.path.dirname(path),
                                                  " ".join(tok[1:]))))
            elif k == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name not in mat_order:
                    mat_order.append(name)
                cur_mat = mat_order.index(name)
            elif k in ("o", "g"):
                flush()
                cur_name = " ".join(tok[1:])
            elif k == "f":
                corners = [_parse_index(s, len(positions), len(texcoords),
                                        len(normals)) for s in tok[1:]]
                for i in range(1, len(corners) - 1):  # fan triangulation
                    cur_faces.append(((corners[0], corners[i],
                                       corners[i + 1]), cur_mat))
    flush()

    pos_np = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm_np = (np.asarray(normals, np.float32).reshape(-1, 3)
              if normals else np.zeros((0, 3), np.float32))
    uv_np = (np.asarray(texcoords, np.float32).reshape(-1, 2)
             if texcoords else np.zeros((0, 2), np.float32))
    # RHS -> LHS (reference: WavefrontOBJLoading.cpp:431-437)
    pos_np[:, 0] = -pos_np[:, 0]
    if len(nrm_np):
        nrm_np[:, 0] = -nrm_np[:, 0]
    if len(uv_np):
        uv_np[:, 1] = 1.0 - uv_np[:, 1]

    # materials: translate MTL -> Plastic (reference default :317);
    # map_Kd images decode sRGB->linear into the texture atlas (the
    # reference's WIC R8G8B8A8_sRGB load, Source/Texture.cpp:87-162) and
    # multiply the Kd albedo at shading time (HitShader.inc.hlsl:62-68)
    materials = []
    textures = []
    tex_cache: Dict[str, int] = {}

    def load_texture(fname):
        if fname in tex_cache:
            return tex_cache[fname]
        fpath = os.path.join(os.path.dirname(path), fname)
        try:
            from ..utils.image import load_texture_rgba

            rgba = load_texture_rgba(fpath)
        except Exception:
            tex_cache[fname] = -1
            return -1
        textures.append(rgba)
        tex_cache[fname] = len(textures) - 1
        return tex_cache[fname]

    if mat_order:
        for name in mat_order:
            m = mtl.get(name, MtlMaterial(name=name))
            tex = load_texture(m.map_kd) if m.map_kd else -1
            materials.append(Material(
                albedo=m.diffuse, mtype=MATERIAL_TYPE_PLASTIC,
                ior=(m.ior,) * 3, roughness=m.roughness,
                opacity=m.opacity, albedo_texture=tex, name=name))
    else:
        materials.append(default_material or Material(name="default"))

    meshes, instances = [], []
    for name, faces in shapes:
        # exact MikkTSpace per-corner tangents, computed the way the
        # reference does (WavefrontOBJLoading.cpp:147-152 + 215-218):
        # original RHS coordinates and ORIGINAL winding in, V already
        # flipped; the RHS->LHS transform then negates tangent.x like
        # any other normal-transformed vector (:297-309), and the
        # vertex dedup keys on the tangent so corners with different
        # spaces split the vertex
        have_normals = all(c[2] >= 0 for corners, _ in faces
                           for c in corners)
        corner_tan = None
        if have_normals and os.environ.get("DCRT_FAST_TANGENTS") != "1":
            from .mikktspace import generate_tangents

            ctup = np.asarray([[c for c in corners]
                               for corners, _ in faces], np.int64)
            flip = np.asarray([-1.0, 1.0, 1.0], np.float32)
            cpos = pos_np[ctup[..., 0]] * flip   # undo the RHS->LHS
            cnrm = nrm_np[ctup[..., 2]] * flip
            cuv = np.where((ctup[..., 1:2] >= 0),
                           uv_np[np.maximum(ctup[..., 1], 0)], 0.0
                           ).astype(np.float32)
            corner_tan, _ = generate_tangents(cpos, cnrm, cuv)
            corner_tan = corner_tan * flip       # transform to LHS

        key_to_idx: Dict = {}
        vpos, vnrm, vuv, vtan = [], [], [], []
        tris = []
        matids = []
        for fidx, (corners, mat_id) in enumerate(faces):
            # winding flip: reverse corner order (reference :433)
            tri = []
            for j, c in enumerate(reversed(corners)):
                if corner_tan is not None:
                    tan = corner_tan[fidx, 2 - j]
                    key = (c, tan.tobytes())
                else:
                    tan, key = None, c
                if key not in key_to_idx:
                    key_to_idx[key] = len(vpos)
                    vi, ti, ni = c
                    vpos.append(pos_np[vi])
                    vnrm.append(nrm_np[ni] if ni >= 0 else None)
                    vuv.append(uv_np[ti] if ti >= 0
                               else np.zeros(2, np.float32))
                    vtan.append(tan)
                tri.append(key_to_idx[key])
            tris.append(tri)
            matids.append(max(mat_id, 0))
        vpos = np.asarray(vpos, np.float32)
        vuv = np.asarray(vuv, np.float32)
        idx = np.asarray(tris, np.int64)
        if any(n is None for n in vnrm):
            vnrm = None
        else:
            vnrm = np.asarray(vnrm, np.float32)
        mesh = Mesh(positions=vpos, indices=idx, normals=vnrm,
                    texcoords=vuv,
                    material_ids=np.asarray(matids, np.int64),
                    name=name or os.path.basename(path))
        if corner_tan is not None:
            mesh.tangents = np.asarray(vtan, np.float32)
        else:
            mesh.tangents = compute_tangents(
                mesh.positions, mesh.normals, mesh.texcoords,
                mesh.indices)
        meshes.append(mesh)
        instances.append(Instance(mesh=len(meshes) - 1, name=mesh.name))

    return Scene(meshes=meshes, instances=instances, materials=materials,
                 textures=textures)
