"""Procedural Cornell box scenes.

Counterpart of `cornell_box` in `directcomputeraytracing_tpu.scene.presets`,
with the same geometry, materials, lights and camera: LHS coordinates,
front faces wound clockwise (geometry normal = cross(v0v2, v0v1)), camera
looking along +z.
"""

import numpy as np

from directcomputeraytracing_tpu.core.constants import (
    MATERIAL_TYPE_CONDUCTOR,
    MATERIAL_TYPE_DIELECTRIC,
    MATERIAL_TYPE_PLASTIC,
)

from ..camera.camera import look_at_transform
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
