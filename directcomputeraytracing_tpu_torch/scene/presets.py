"""Procedural scenes: the Cornell box, the sphere grid and their
alpha-tested variants.

Counterparts of `cornell_box`, `uv_sphere` and `sphere_grid` in
`directcomputeraytracing_tpu.scene.presets`, with the same geometry,
materials, lights and camera: LHS coordinates, front faces wound
clockwise (geometry normal = cross(v0v2, v0v1)), camera looking along +z.

Alpha-tested scenes: `alpha_sphere_grid` is the reference's split scene
(its tests' `split_scene`: the spheres of material override 1 see-through
at opacity 0.4), or with textured=True opaque but for the holes of an
opacity mask (`dot_mask`, the reference stand-in's dot grid, made here
with numpy); `alpha_panel` is the reference tests' panel over a floor.
"""

import numpy as np

from ..camera.camera import look_at_transform
from ..core.constants import (
    MATERIAL_TYPE_CONDUCTOR,
    MATERIAL_TYPE_DIELECTRIC,
    MATERIAL_TYPE_PLASTIC,
)
from ..core.types import CameraParams
from .scene import Instance, Material, Mesh, PunctualLight, Scene


def _quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (corners in order)."""
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return pos, idx


def _merge(parts):
    pos, idx, mat = [], [], []
    off = 0
    for p, i, m in parts:
        pos.append(p)
        idx.append(np.asarray(i) + off)
        mat.append(np.full(len(i), m, np.int64))
        off += len(p)
    return np.concatenate(pos), np.concatenate(idx), np.concatenate(mat)


def _box(cx, cz, w, d, hgt, mat, angle=0.0):
    """Top and four sides of a box rotated by `angle` about +y."""
    c, sn = np.cos(angle), np.sin(angle)

    def rot(x, z):
        return (cx + x * c - z * sn, cz + x * sn + z * c)

    corners = [rot(-w, -d), rot(w, -d), rot(w, d), rot(-w, d)]
    p, i = _quad(*[[x, hgt, z] for x, z in corners])
    faces = [(p, i, mat)]
    for (ax, az), (bx, bz) in zip(corners, corners[1:] + corners[:1]):
        p, i = _quad([ax, 0, az], [bx, 0, bz], [bx, hgt, bz], [ax, hgt, az])
        faces.append((p, i, mat))
    return faces


def cornell_box(light="area", material_set="diffuse"):
    """Cornell box, side 2 centred at the origin (y in [0, 2]), camera on -z.

    light: 'area' (ceiling quad mesh light) or 'point'.
    material_set: 'diffuse' | 'glossy' (rough conductor tall block +
    plastic short block) | 'dielectric' (glass tall block).
    Returns (Scene, CameraParams on the CPU).
    """
    mats = [Material(albedo=(0.73, 0.73, 0.73), name="white"),
            Material(albedo=(0.63, 0.065, 0.05), name="red"),
            Material(albedo=(0.14, 0.45, 0.091), name="green")]
    s, h = 1.0, 2.0   # half-width, height
    parts = [
        (*_quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]), 0),  # floor
        (*_quad([-s, h, -s], [-s, h, s], [s, h, s], [s, h, -s]), 0),  # ceiling
        (*_quad([-s, 0, s], [s, 0, s], [s, h, s], [-s, h, s]), 0),    # back
        (*_quad([-s, 0, -s], [-s, 0, s], [-s, h, s], [-s, h, -s]), 1),  # left
        (*_quad([s, 0, -s], [s, h, -s], [s, h, s], [s, 0, s]), 2),    # right
    ]
    if material_set == "diffuse":
        tall_mat = short_mat = 0
    elif material_set == "glossy":
        mats.append(Material(albedo=(3.9, 2.45, 2.14),
                             ior=(0.143, 0.375, 1.44),
                             mtype=MATERIAL_TYPE_CONDUCTOR,
                             k=(3.983, 2.386, 1.603),
                             roughness=0.25, multiscattering=True,
                             name="metal"))
        mats.append(Material(albedo=(0.2, 0.3, 0.7), ior=(1.5, 1.5, 1.5),
                             mtype=MATERIAL_TYPE_PLASTIC, roughness=0.15,
                             multiscattering=True, name="plastic"))
        tall_mat, short_mat = 3, 4
    elif material_set == "dielectric":
        mats.append(Material(albedo=(1.0, 1.0, 1.0), ior=(1.5, 1.5, 1.5),
                             mtype=MATERIAL_TYPE_DIELECTRIC, roughness=0.1,
                             multiscattering=True, name="glass"))
        tall_mat, short_mat = 3, 0
    else:
        raise ValueError(material_set)
    parts += _box(-0.35, 0.3, 0.26, 0.26, 1.2, tall_mat, angle=0.3)
    parts += _box(0.4, -0.25, 0.26, 0.26, 0.6, short_mat, angle=-0.25)

    pos, idx, mat = _merge(parts)
    meshes = [Mesh(positions=pos, indices=idx, material_ids=mat,
                   name="room")]
    instances = [Instance(mesh=0, name="room")]
    lights = []
    if light == "area":
        lp, li = _quad([-0.3, h - 1e-3, -0.25], [-0.3, h - 1e-3, 0.25],
                       [0.3, h - 1e-3, 0.25], [0.3, h - 1e-3, -0.25])
        meshes.append(Mesh(positions=lp, indices=li,
                           material_ids=np.zeros(len(li), np.int64),
                           name="lamp"))
        instances.append(Instance(mesh=1, is_emitter=True,
                                  radiance=(17.0, 12.0, 4.0), name="lamp"))
    else:
        lights.append(PunctualLight(kind="point", radiance=(6.0, 6.0, 6.0),
                                    position=(0.0, 1.6, -0.3)))

    scene = Scene(meshes=meshes, instances=instances, materials=mats,
                  lights=lights)
    cam = CameraParams.create(
        transform=look_at_transform((0.0, 1.0, -3.6), (0.0, 1.0, 0.0)),
        fov_x=np.deg2rad(38.0), aperture_radius=0.0, focal_distance=3.6)
    return scene, cam


def uv_sphere(stacks=16, slices=24):
    """Lat-long unit sphere; front faces outward under the LHS
    cross(v0v2, v0v1) convention. Returns (positions, indices)."""
    verts = []
    for i in range(stacks + 1):
        th = np.pi * i / stacks
        for j in range(slices + 1):
            ph = 2.0 * np.pi * j / slices
            verts.append((np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)))
    verts = np.asarray(verts, np.float32)
    idx = []
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            if i > 0:
                idx.append([a, b, a + 1])
            if i < stacks - 1:
                idx.append([a + 1, b, b + 1])
    return verts, np.asarray(idx, np.int64)


def sphere_grid(nx=5, nz=5, stacks=24, slices=32, light="area"):
    """nx * nz instanced spheres (seeded radii, grey and rough-metal
    alternating) on a ground quad under a quad lamp. sphere_grid(12, 12)
    has 211,972 world triangles: the work-list traversal's scene.
    Returns (Scene, CameraParams on the CPU)."""
    sv, si = uv_sphere(stacks, slices)
    sphere = Mesh(positions=sv, indices=si,
                  material_ids=np.zeros(len(si), np.int64), name="sphere")

    ext = max(nx, nz) * 1.5
    gp, gi = _quad([-ext, 0, -ext], [ext, 0, -ext], [ext, 0, ext],
                   [-ext, 0, ext])
    ground = Mesh(positions=gp, indices=gi,
                  material_ids=np.zeros(len(gi), np.int64), name="ground")

    mats = [Material(albedo=(0.6, 0.6, 0.6), name="grey"),
            Material(albedo=(3.9, 2.45, 2.14), ior=(0.143, 0.375, 1.44),
                     mtype=MATERIAL_TYPE_CONDUCTOR, k=(3.983, 2.386, 1.603),
                     roughness=0.3, name="metal")]
    meshes = [sphere, ground]
    instances = [Instance(mesh=1, name="ground")]
    rng = np.random.default_rng(11)
    for ix in range(nx):
        for iz in range(nz):
            r = 0.35 + 0.2 * rng.random()
            t = np.zeros((4, 3), np.float32)
            t[0, 0] = t[1, 1] = t[2, 2] = r
            t[3] = ((ix - (nx - 1) / 2) * 1.5, r,
                    (iz - (nz - 1) / 2) * 1.5)
            instances.append(Instance(
                mesh=0, transform=t,
                material_override=1 if (ix + iz) % 2 else 0,
                name=f"sphere_{ix}_{iz}"))

    lp, li = _quad([-2.0, 7.0, -2.0], [-2.0, 7.0, 2.0], [2.0, 7.0, 2.0],
                   [2.0, 7.0, -2.0])
    lamp = Mesh(positions=lp, indices=li,
                material_ids=np.zeros(len(li), np.int64), name="lamp")
    meshes.append(lamp)
    instances.append(Instance(mesh=2, is_emitter=True,
                              radiance=(20.0, 18.0, 15.0), name="lamp"))

    scene = Scene(meshes=meshes, instances=instances, materials=mats)
    cam = CameraParams.create(
        transform=look_at_transform((0.0, 4.5, -1.9 * max(nx, nz)),
                                    (0.0, 0.5, 0.0)),
        fov_x=np.deg2rad(50.0), focal_distance=10.0)
    return scene, cam


def dot_mask(size=64, cell=16, r2_min=18):
    """(size, size, 4) f32 RGBA opacity mask: R (the opacity) 0 in round
    holes on a grid of cell-pixel cells, 1 elsewhere (the reference
    stand-in's mask, `scene/standin.py` `_write_textures`)."""
    yy, xx = np.mgrid[0:size, 0:size]
    tex = np.ones((size, size, 4), np.float32)
    tex[..., 0] = ((xx % cell - cell // 2) ** 2
                   + (yy % cell - cell // 2) ** 2 > r2_min)
    return tex


def sphere_uvs(stacks, slices):
    """Lat-long texture coordinates of `uv_sphere(stacks, slices)`'s
    vertices."""
    i, j = np.divmod(np.arange((stacks + 1) * (slices + 1)), slices + 1)
    return np.stack([j / slices, i / stacks], 1).astype(np.float32)


def set_alpha_material(scene, material_cls, textured, stacks, slices):
    """Make material 1 (the spheres of `sphere_grid`'s override 1)
    alpha-tested in place: opacity 0.4, or with textured opacity 1 and
    `dot_mask` as texture 0 over the sphere's lat-long UVs. material_cls
    is the Material of the scene's own module."""
    scene.materials[1] = material_cls(
        albedo=(0.8, 0.3, 0.3), opacity=1.0 if textured else 0.4,
        opacity_texture=0 if textured else -1, name="seethrough")
    if textured:
        scene.textures = [dot_mask()]
        scene.meshes[0].texcoords = sphere_uvs(stacks, slices)


def alpha_sphere_grid(nx=5, nz=5, stacks=24, slices=32, textured=False):
    """`sphere_grid` with half its spheres alpha-tested
    (`set_alpha_material`); flattened with cluster tables it gets the
    opaque/masked split. Returns (Scene, CameraParams on the CPU)."""
    scene, cam = sphere_grid(nx, nz, stacks, slices)
    set_alpha_material(scene, Material, textured, stacks, slices)
    return scene, cam


def alpha_panel(opacity=0.5, textured=False):
    """A floor and a panel above it under a point light (the reference
    alpha tests' `_panel_scene`): the panel has `opacity`, or with
    textured opacity 1 and `dot_mask` over its UVs. 4 triangles: the
    dense sweep. Returns (Scene, CameraParams on the CPU)."""
    fp, fi = _quad([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2])
    floor = Mesh(positions=fp, indices=fi,
                 material_ids=np.zeros(len(fi), np.int64), name="floor")
    pp, pi = _quad([-1, 1, -1], [-1, 1, 1], [1, 1, 1], [1, 1, -1])
    panel = Mesh(positions=pp, indices=pi,
                 material_ids=np.ones(len(pi), np.int64),
                 texcoords=np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]],
                                      np.float32), name="panel")
    mats = [Material(albedo=(0.8, 0.8, 0.8), name="floor"),
            Material(albedo=(0.8, 0.8, 0.8),
                     opacity=1.0 if textured else opacity,
                     opacity_texture=0 if textured else -1, name="panel")]
    scene = Scene(meshes=[floor, panel],
                  instances=[Instance(mesh=0), Instance(mesh=1)],
                  materials=mats, textures=[dot_mask()] if textured else [],
                  lights=[PunctualLight(kind="point", radiance=(20, 20, 20),
                                        position=(0.0, 3.0, 0.0))])
    cam = CameraParams.create(
        transform=look_at_transform((0, 2.5, -4.0), (0, 0, 0)),
        fov_x=np.deg2rad(45.0))
    return scene, cam
