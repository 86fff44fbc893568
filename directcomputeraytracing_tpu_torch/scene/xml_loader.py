"""Partial Mitsuba 3.0 XML scene ingestion.

The port's copy of `directcomputeraytracing_tpu.scene.xml_loader` (the
same numpy code; its camera is the port's `core.types.CameraParams` on
the CPU, which `Renderer` moves to its device; held to the reference by
`tests/test_torch_loaders.py`).

Behavioral port of the reference's XML pipeline (reference:
Source/SceneXMLLoading.cpp:1045-1512): `integrator path` max_depth
:1095-1106; `sensor perspective/thinlens` with film size, rfilter
(box/tent/gaussian/mitchell/lanczos), fov/fov_axis/focal_length/
aperture_radius/focus_distance :1107-1246; bsdf types diffuse /
roughdiffuse / dielectric / thindielectric / roughdielectric / conductor
/ roughconductor / plastic / roughplastic / twosided / mask :719-1004
(alpha -> roughness = sqrt(alpha) :887-889, int_ior/ext_ior defaults
1.49/1.000277 :894-896, conductor eta/k RGB); `texture type="bitmap"`
for reflectance/diffuse_reflectance/opacity, inline or by <ref>, with
the reference's white-albedo bypass :989 and opacity bypass :766
(GetOrAddTexture :670-716); shapes `obj` (deduped by
filename -> instancing) and `rectangle` (shared [-1,1]^2 z=0 mesh,
Mesh.cpp:7-57) :1302-1385; per-shape `to_world` (Mitsuba column-vector
row-major -> row-vector transpose, then RHS->LHS first-column negation
:416-428); `area` emitters -> mesh lights :1416-1439; `constant` env and
`directional` emitters :1443-1500; `$name` default-parameter
substitution :53-97.

Returns (Scene, XmlRenderSettings) — the settings carry the camera,
film, filter and integrator parameters the XML specifies.
"""

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core.constants import (
    MATERIAL_TYPE_CONDUCTOR,
    MATERIAL_TYPE_DIELECTRIC,
    MATERIAL_TYPE_DIFFUSE,
    MATERIAL_TYPE_PLASTIC,
    MATERIAL_TYPE_THIN_DIELECTRIC,
)
from ..core.types import CameraParams
from ..utils.log import logger
from .obj_loader import load_obj
from .scene import Instance, Material, Mesh, PunctualLight, Scene

DEFAULT_INT_IOR = 1.49        # reference: SceneXMLLoading.cpp:896
DEFAULT_EXT_IOR = 1.000277
FILTER_MAP = {"box": "box", "tent": "triangle", "gaussian": "gaussian",
              "mitchell": "mitchell", "lanczos": "lanczos"}


@dataclass
class XmlRenderSettings:
    width: int = 768
    height: int = 576
    max_depth: int = 4
    filter_type: str = "box"
    camera: Optional[CameraParams] = None
    fov: float = np.deg2rad(45.0)
    fov_axis: str = "x"
    aperture_radius: float = 0.0
    focus_distance: float = 2.0
    focal_length: float = 0.05
    to_world: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))


def _subst(value: str, defaults: Dict[str, str]) -> str:
    if value.startswith("$"):
        return defaults.get(value[1:], value)
    return value


class _TextureCtx:
    """Dedup-and-load context for <texture type="bitmap"> elements
    (reference: SMaterialGatheringContext::GetOrAddTexture,
    SceneXMLLoading.cpp:670-716 — dedup by element, unsupported types
    log and return no-texture)."""

    def __init__(self, base_dir):
        self.base_dir = base_dir
        self.textures = []            # (H, W, 4) linear float32 each
        self._cache = {}              # id(element) | abspath -> index
        self.named = {}               # id attribute -> element

    def get_or_add(self, el):
        if el.get("type") != "bitmap":
            return -1
        key = id(el)
        if key in self._cache:
            return self._cache[key]
        fname = None
        for c in el.findall("string"):
            if c.get("name") == "filename":
                fname = c.get("value")
        idx = -1
        if fname:
            fpath = os.path.normpath(os.path.join(self.base_dir, fname))
            if fpath in self._cache:
                idx = self._cache[fpath]
            else:
                try:
                    from ..utils.image import load_texture_rgba

                    self.textures.append(load_texture_rgba(fpath))
                    idx = len(self.textures) - 1
                except Exception:
                    idx = -1
                self._cache[fpath] = idx
        self._cache[key] = idx
        return idx


def _is_tex(v):
    return isinstance(v, tuple) and len(v) == 2 and v[0] == "__tex__"


def _props(node, defaults, ctx=None):
    """Collect child <integer|float|string|boolean|rgb|point|vector>
    properties into a dict. With a _TextureCtx, inline <texture>
    children and named <ref> children resolve to ("__tex__", element)
    markers the BSDF translator turns into texture indices."""
    out = {}
    for c in node:
        name = c.get("name")
        if name is None:
            continue
        val = _subst(c.get("value", ""), defaults)
        if ctx is not None and c.tag == "texture":
            out[name] = ("__tex__", c)
        elif ctx is not None and c.tag == "ref":
            tgt = ctx.named.get(c.get("id"))
            if tgt is not None:
                out[name] = ("__tex__", tgt)
        elif c.tag == "integer":
            out[name] = int(float(val))
        elif c.tag == "float":
            out[name] = float(val)
        elif c.tag in ("string", "boolean"):
            out[name] = val
        elif c.tag == "rgb":
            out[name] = np.asarray(
                [float(x) for x in val.replace(",", " ").split()],
                np.float32)
            if out[name].size == 1:
                out[name] = np.repeat(out[name], 3)
        elif c.tag in ("point", "vector"):
            if c.get("value") is not None:
                out[name] = np.asarray(
                    [float(x) for x in val.replace(",", " ").split()],
                    np.float32)
            else:
                out[name] = np.asarray(
                    [float(_subst(c.get(a, "0"), defaults))
                     for a in "xyz"], np.float32)
    return out


def _parse_transform(node, defaults):
    """<transform> -> reference-convention (4, 4) row-vector matrix with
    the RHS->LHS conversion applied (SceneXMLLoading.cpp:416-428)."""
    m = np.eye(4, dtype=np.float64)   # row-major, column-vector (Mitsuba)
    for c in node:
        if c.tag == "matrix":
            vals = [float(x) for x in
                    _subst(c.get("value", ""), defaults).split()]
            step = np.asarray(vals, np.float64).reshape(4, 4)
        elif c.tag == "translate":
            step = np.eye(4)
            step[:3, 3] = [float(_subst(c.get(a, "0"), defaults))
                           for a in "xyz"]
        elif c.tag == "scale":
            step = np.eye(4)
            if c.get("value") is not None:
                v = [float(x) for x in
                     _subst(c.get("value"), defaults).split()]
                if len(v) == 1:
                    v = v * 3
            else:
                v = [float(_subst(c.get(a, "1"), defaults)) for a in "xyz"]
            step[0, 0], step[1, 1], step[2, 2] = v
        elif c.tag == "rotate":
            ax = np.asarray([float(_subst(c.get(a, "0"), defaults))
                             for a in "xyz"], np.float64)
            ax /= max(np.linalg.norm(ax), 1e-12)
            th = np.deg2rad(float(_subst(c.get("angle", "0"), defaults)))
            x, y, z = ax
            cth, sth = np.cos(th), np.sin(th)
            o = 1 - cth
            step = np.eye(4)
            step[:3, :3] = [
                [cth + x * x * o, x * y * o - z * sth, x * z * o + y * sth],
                [y * x * o + z * sth, cth + y * y * o, y * z * o - x * sth],
                [z * x * o - y * sth, z * y * o + x * sth, cth + z * z * o],
            ]
        elif c.tag == "lookat":
            origin = np.asarray([float(x) for x in _subst(
                c.get("origin", "0,0,0"), defaults).replace(",", " ")
                .split()], np.float64)
            target = np.asarray([float(x) for x in _subst(
                c.get("target", "0,0,1"), defaults).replace(",", " ")
                .split()], np.float64)
            up = np.asarray([float(x) for x in _subst(
                c.get("up", "0,1,0"), defaults).replace(",", " ")
                .split()], np.float64)
            fwd = target - origin
            fwd /= max(np.linalg.norm(fwd), 1e-12)
            left = np.cross(up / max(np.linalg.norm(up), 1e-12), fwd)
            left /= max(np.linalg.norm(left), 1e-12)
            new_up = np.cross(fwd, left)
            step = np.eye(4)
            step[:3, 0] = left
            step[:3, 1] = new_up
            step[:3, 2] = fwd
            step[:3, 3] = origin
        else:
            continue
        m = step @ m
    # column-vector row-major -> row-vector (transpose), then negate the
    # first column (RHS -> LHS x flip)
    out = m.T.astype(np.float32)
    out[:, 0] = -out[:, 0]
    return out


def _translate_bsdf(node, defaults, ctx=None, two_sided=False,
                    opacity=1.0, opacity_texture=-1, name=None):
    """BSDF element -> Material (reference: TranslateMaterialFromBSDF,
    SceneXMLLoading.cpp:719-1004; bitmap textures :672-716 with the
    opacity bypass :766 and albedo bypass :989)."""
    btype = node.get("type")
    name = name or node.get("id")
    if btype == "twosided":
        inner = node.find("bsdf")
        return _translate_bsdf(inner, defaults, ctx, two_sided=True,
                               opacity=opacity,
                               opacity_texture=opacity_texture, name=name)
    if btype == "mask":
        p = _props(node, defaults, ctx)
        op = p.get("opacity")
        op_tex = -1
        if _is_tex(op) and ctx is not None:
            op_tex = ctx.get_or_add(op[1])
            # bypass the scalar when a texture drives opacity
            # (reference: SceneXMLLoading.cpp:766); a texture that
            # failed to load degrades to fully opaque, loudly
            if op_tex < 0:
                logger.warning(
                    "mask bsdf %s: opacity bitmap failed to load, "
                    "falling back to opaque", name or "<anon>")
            op = 1.0
        elif isinstance(op, np.ndarray):
            op = float(op.mean())
        else:
            op = 1.0 if op is None else float(op)
        inner = node.find("bsdf")
        return _translate_bsdf(inner, defaults, ctx, two_sided=two_sided,
                               opacity=op, opacity_texture=op_tex,
                               name=name)

    p = _props(node, defaults, ctx)
    rough = btype.startswith("rough")
    alpha = float(p.get("alpha", 0.1))
    roughness = float(np.sqrt(alpha)) if rough else 0.0

    int_ior = float(p.get("int_ior", DEFAULT_INT_IOR))
    ext_ior = float(p.get("ext_ior", DEFAULT_EXT_IOR))

    def albedo_of(key, default):
        """RGB value or bitmap texture with white-albedo bypass
        (reference: SceneXMLLoading.cpp:989)."""
        v = p.get(key, default)
        if _is_tex(v) and ctx is not None:
            tex = ctx.get_or_add(v[1])
            if tex >= 0:
                return (1.0, 1.0, 1.0), tex
            return tuple(np.atleast_1d(default)[:3]), -1
        return tuple(np.atleast_1d(v)[:3]), -1

    base = btype[5:] if rough else btype
    if base == "diffuse":
        alb, atex = albedo_of("reflectance",
                              np.asarray([0.5, 0.5, 0.5], np.float32))
        return Material(albedo=alb, albedo_texture=atex,
                        mtype=MATERIAL_TYPE_DIFFUSE,
                        roughness=1.0, two_sided=two_sided, opacity=opacity,
                        opacity_texture=opacity_texture,
                        name=name or btype)
    if base == "dielectric":
        return Material(albedo=(1.0, 1.0, 1.0),
                        mtype=MATERIAL_TYPE_DIELECTRIC,
                        ior=(int_ior / ext_ior,) * 3, roughness=roughness,
                        two_sided=two_sided, opacity=opacity,
                        opacity_texture=opacity_texture,
                        name=name or btype)
    if base == "thindielectric":
        return Material(albedo=(1.0, 1.0, 1.0),
                        mtype=MATERIAL_TYPE_THIN_DIELECTRIC,
                        ior=(int_ior / ext_ior,) * 3, roughness=roughness,
                        two_sided=two_sided, opacity=opacity,
                        opacity_texture=opacity_texture,
                        name=name or btype)
    if base == "conductor":
        eta = np.atleast_1d(p.get("eta", np.asarray([0.2, 0.92, 1.1],
                                                    np.float32)))
        k = np.atleast_1d(p.get("k", np.asarray([3.9, 2.45, 2.14],
                                                np.float32)))
        ext_eta = float(p.get("ext_eta", 1.000277))
        return Material(albedo=tuple(k[:3]), k=tuple(k[:3]),
                        mtype=MATERIAL_TYPE_CONDUCTOR,
                        ior=tuple((eta / ext_eta)[:3]), roughness=roughness,
                        two_sided=two_sided, opacity=opacity,
                        opacity_texture=opacity_texture,
                        name=name or btype)
    if base == "plastic":
        alb, atex = albedo_of("diffuse_reflectance",
                              np.asarray([0.5, 0.5, 0.5], np.float32))
        return Material(albedo=alb, albedo_texture=atex,
                        mtype=MATERIAL_TYPE_PLASTIC,
                        ior=(int_ior / ext_ior,) * 3, roughness=roughness,
                        two_sided=two_sided, opacity=opacity,
                        opacity_texture=opacity_texture,
                        name=name or btype)
    # unsupported -> black diffuse (reference :856-860 default branch)
    return Material(albedo=(0.0, 0.0, 0.0), mtype=MATERIAL_TYPE_DIFFUSE,
                    two_sided=two_sided, opacity=opacity,
                    opacity_texture=opacity_texture,
                    name=name or btype or "unknown")


def _rectangle_mesh():
    """Shared [-1,1]^2 z=0 rectangle (reference: Mesh::GenerateRectangle,
    Mesh.cpp:7-57 — normals +z, CCW front winding)."""
    pos = np.asarray([[1, 1, 0], [1, -1, 0], [-1, -1, 0], [-1, 1, 0]],
                     np.float32)
    nrm = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    tan = np.tile(np.asarray([[1, 0, 0]], np.float32), (4, 1))
    uv = np.asarray([[1, 1], [1, 0], [0, 0], [0, 1]], np.float32)
    idx = np.asarray([[0, 1, 3], [1, 2, 3]], np.int64)
    return Mesh(positions=pos, indices=idx, normals=nrm, tangents=tan,
                texcoords=uv, name="rectangle")


def load_mitsuba_xml(path):
    """Parse a Mitsuba 3.0 scene XML -> (Scene, XmlRenderSettings)."""
    tree = ET.parse(path)
    root = tree.getroot()
    base_dir = os.path.dirname(os.path.abspath(path))

    defaults = {}
    for d in root.findall("default"):
        defaults[d.get("name")] = d.get("value")

    settings = XmlRenderSettings()
    scene = Scene()
    named_materials: Dict[str, int] = {}
    obj_mesh_cache: Dict[str, int] = {}
    rect_mesh_index = -1

    integrator = root.find("integrator")
    if integrator is not None:
        p = _props(integrator, defaults)
        settings.max_depth = int(p.get("max_depth", 4))

    sensor = root.find("sensor")
    if sensor is not None:
        p = _props(sensor, defaults)
        settings.fov_axis = p.get("fov_axis", "x")
        if "fov" in p:
            settings.fov = np.deg2rad(float(p["fov"]))
        if "focal_length" in p:
            settings.focal_length = float(str(p["focal_length"])
                                          .replace("mm", "")) / 1000.0
        settings.focus_distance = float(p.get("focus_distance", 2.0))
        if sensor.get("type") == "thinlens":
            settings.aperture_radius = float(p.get("aperture_radius", 0.0))
        tf = sensor.find("transform")
        if tf is not None:
            settings.to_world = _parse_transform(tf, defaults)
        film = sensor.find("film")
        if film is not None:
            fp = _props(film, defaults)
            settings.width = int(fp.get("width", settings.width))
            settings.height = int(fp.get("height", settings.height))
            rf = film.find("rfilter")
            if rf is not None:
                settings.filter_type = FILTER_MAP.get(rf.get("type"), "box")

    # film size from fov: reference computes film distance from fov over
    # the fov axis with a fixed 35mm-ish film back (Scene.cpp:837-842)
    film_w, film_h = 0.036, 0.024
    aspect = settings.width / max(settings.height, 1)
    film_h = film_w / aspect
    fd_axis = film_w if settings.fov_axis == "x" else film_h
    film_distance = 0.5 * fd_axis / max(np.tan(0.5 * settings.fov), 1e-6)
    settings.camera = CameraParams.create(
        transform=settings.to_world, film_size=(film_w, film_h),
        aperture_radius=settings.aperture_radius,
        focal_distance=settings.focus_distance,
        film_distance=film_distance)

    def add_material(mat: Material) -> int:
        scene.materials.append(mat)
        return len(scene.materials) - 1

    tex_ctx = _TextureCtx(base_dir)
    for t in root.findall("texture"):
        if t.get("id"):
            tex_ctx.named[t.get("id")] = t

    for b in root.findall("bsdf"):
        mid = add_material(_translate_bsdf(b, defaults, tex_ctx))
        if b.get("id"):
            named_materials[b.get("id")] = mid

    for shape in root.findall("shape"):
        stype = shape.get("type")
        tf = shape.find("transform")
        to_world = (_parse_transform(tf, defaults) if tf is not None
                    else None)
        if to_world is None and stype == "obj":
            # OBJ vertices already get the RHS->LHS flip inside load_obj;
            # identity instance then matches the reference's
            # ApplyTransform=false + transform-on-instance path
            inst_tf = np.concatenate([np.diag([-1.0, 1.0, 1.0]),
                                      np.zeros((1, 3))]).astype(np.float32)
        elif to_world is None:
            inst_tf = np.concatenate(
                [np.eye(3), np.zeros((1, 3))]).astype(np.float32)
        else:
            inst_tf = to_world[:, :3].astype(np.float32)

        # material: ref or inline
        mat_id = -1
        ref = shape.find("ref")
        if ref is not None and ref.get("id") in named_materials:
            mat_id = named_materials[ref.get("id")]
        else:
            b = shape.find("bsdf")
            if b is not None:
                mat_id = add_material(_translate_bsdf(b, defaults,
                                                      tex_ctx))

        # emitter?
        radiance = None
        em = shape.find("emitter")
        if em is not None and em.get("type") == "area":
            ep = _props(em, defaults)
            radiance = tuple(np.atleast_1d(
                ep.get("radiance", np.ones(3, np.float32)))[:3])

        if stype == "obj":
            fname = None
            for c in shape.findall("string"):
                if c.get("name") == "filename":
                    fname = _subst(c.get("value"), defaults)
            if fname is None:
                continue
            fpath = os.path.normpath(os.path.join(base_dir, fname))
            if fpath in obj_mesh_cache:
                mesh_idx = obj_mesh_cache[fpath]
            else:
                sub = load_obj(fpath)
                if not sub.meshes:
                    continue
                # merge the obj's shapes into one mesh entry each; undo the
                # loader's own x-flip since the instance transform (which
                # already folds the handedness conversion) applies it
                for m in sub.meshes:
                    m.positions[:, 0] = -m.positions[:, 0]
                    m.normals[:, 0] = -m.normals[:, 0]
                    # tangents were derived from the flipped positions;
                    # keep the frame consistent under the un-flip
                    m.tangents[:, 0] = -m.tangents[:, 0]
                mesh_idx = len(scene.meshes)
                merged = _merge_meshes(sub.meshes)
                scene.meshes.append(merged)
                obj_mesh_cache[fpath] = mesh_idx
            scene.instances.append(Instance(
                mesh=mesh_idx, transform=inst_tf,
                material_override=mat_id if mat_id >= 0 else -1,
                is_emitter=radiance is not None,
                radiance=radiance or (0.0, 0.0, 0.0),
                name=os.path.basename(fname)))
        elif stype == "rectangle":
            if rect_mesh_index < 0:
                rect_mesh_index = len(scene.meshes)
                scene.meshes.append(_rectangle_mesh())
            scene.instances.append(Instance(
                mesh=rect_mesh_index, transform=inst_tf,
                material_override=mat_id if mat_id >= 0 else -1,
                is_emitter=radiance is not None,
                radiance=radiance or (0.0, 0.0, 0.0),
                name="rectangle"))
        # other shape types: unsupported (reference supports the same two)

    for em in root.findall("emitter"):
        etype = em.get("type")
        p = _props(em, defaults)
        if etype == "constant":
            rad = tuple(np.atleast_1d(
                p.get("radiance", np.ones(3, np.float32)))[:3])
            scene.lights.append(PunctualLight(kind="env", radiance=rad))
        elif etype == "directional":
            irr = tuple(np.atleast_1d(
                p.get("irradiance", np.ones(3, np.float32)))[:3])
            d = p.get("direction", np.asarray([0, -1, 0], np.float32))
            d = np.asarray(d, np.float32)
            d[0] = -d[0]          # RHS -> LHS
            d /= max(np.linalg.norm(d), 1e-12)
            scene.lights.append(PunctualLight(kind="directional",
                                              radiance=irr,
                                              position=tuple(d)))

    if not scene.materials:
        scene.materials.append(Material(name="default"))
    scene.textures = tex_ctx.textures
    return scene, settings


def _merge_meshes(meshes):
    """Concatenate a list of Mesh into one (obj shapes -> one mesh,
    matching the reference's one-Mesh-per-obj-file policy in the XML
    path, SceneXMLLoading.cpp:1302-1330)."""
    if len(meshes) == 1:
        return meshes[0]
    pos = np.concatenate([m.positions for m in meshes])
    nrm = np.concatenate([m.normals for m in meshes])
    tan = np.concatenate([m.tangents for m in meshes])
    uv = np.concatenate([m.texcoords for m in meshes])
    idx, mid = [], []
    off = 0
    for m in meshes:
        idx.append(m.indices + off)
        mid.append(m.material_ids)
        off += m.positions.shape[0]
    return Mesh(positions=pos, indices=np.concatenate(idx), normals=nrm,
                tangents=tan, texcoords=uv,
                material_ids=np.concatenate(mid), name=meshes[0].name)
