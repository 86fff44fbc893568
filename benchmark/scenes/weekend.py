"""Scene kind `weekend`: the final scene of Ray Tracing in One Weekend,
built from the layout frozen in the configuration.

The configuration's `scene` holds the book's spheres (`spheres`: centre,
radius and material of each, in the book's right-handed frame and call
order), the tessellation of the one sphere mesh they instance, the
ground plane, the sky texture's shape and the camera. `inputs`
makes the sphere mesh and the sky texture with the frozen generator
(`reference/scene/weekend.py`) once, and both sides take the same
arrays; `program` builds the port's Scene and camera and `reference` the
reference's, from the same numbers by the same rules:

- the port's frame is left-handed, so every z of a centre is negated,
  which keeps the book's image rather than its mirror (`camera` holds
  the book's camera, `book_camera`, in the port's frame already);
- a sphere is an instance of the mesh scaled by its radius and moved to
  its centre, with its own material by override; the ground is a
  two-triangle plane at y = 0;
- a Lambertian is a diffuse material; glass a smooth dielectric; a metal
  a conductor of eta 1 whose absorption k = 2 sqrt(A / (1 - A)) makes its
  normal-incidence reflectance the book's albedo A, roughness the fuzz;
- the sky is an environment light of the configured radiance over the
  lat-long texture;
- the camera is `CameraParams.create` of the `camera` arguments, as in
  the `description` kind.
"""

import math

import numpy as np

MATERIAL_TYPE_CONDUCTOR = 2
MATERIAL_TYPE_DIELECTRIC = 3


def inputs(config, workdir):
    from ..reference.scene.weekend import book_sky, uv_sphere

    s = config["scene"]
    return {"sphere": uv_sphere(int(s["sphere_mesh"]["stacks"]),
                                int(s["sphere_mesh"]["slices"])),
            "sky": book_sky(int(s["sky"]["height"]), int(s["sky"]["width"]))}


def metal_k(albedo):
    """Per channel, the k of an eta-1 conductor whose reflectance at
    normal incidence, k^2 / (4 + k^2), is the albedo."""
    return tuple(2.0 * math.sqrt(a / (1.0 - a)) for a in albedo)


def _material(mat, material_cls):
    if mat["kind"] == "lambertian":
        return material_cls(albedo=tuple(mat["albedo"]), name="lambertian")
    if mat["kind"] == "dielectric":
        return material_cls(albedo=(1.0, 1.0, 1.0), ior=(mat["ior"],) * 3,
                            mtype=MATERIAL_TYPE_DIELECTRIC, roughness=0.0,
                            name="glass")
    if mat["kind"] == "metal":
        return material_cls(albedo=tuple(mat["albedo"]),
                            ior=(1.0, 1.0, 1.0), k=metal_k(mat["albedo"]),
                            mtype=MATERIAL_TYPE_CONDUCTOR,
                            roughness=mat["fuzz"], name="metal")
    raise ValueError(f"material kind {mat['kind']!r}")


def _build(config, inp, mesh_cls, material_cls, instance_cls, light_cls,
           scene_cls, camera_cls):
    s = config["scene"]
    sv, si = inp["sphere"]
    sphere = mesh_cls(positions=sv, indices=si,
                      material_ids=np.zeros(len(si), np.int64),
                      name="sphere")
    h = float(s["ground"]["half_width"])
    ground = mesh_cls(
        positions=np.asarray([[-h, 0, -h], [h, 0, -h], [h, 0, h],
                              [-h, 0, h]], np.float32),
        indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int64),
        material_ids=np.zeros(2, np.int64), name="ground")
    mats = [material_cls(albedo=tuple(s["ground"]["albedo"]), name="ground")]
    instances = [instance_cls(mesh=1, name="ground")]
    for k, sp in enumerate(s["spheres"]):
        t = np.zeros((4, 3), np.float32)
        t[0, 0] = t[1, 1] = t[2, 2] = sp["radius"]
        x, y, z = sp["centre"]
        t[3] = (x, y, -z)
        mats.append(_material(sp["material"], material_cls))
        instances.append(instance_cls(mesh=0, transform=t,
                                      material_override=len(mats) - 1,
                                      name=f"sphere_{k}"))
    scene = scene_cls(
        meshes=[sphere, ground], instances=instances, materials=mats,
        lights=[light_cls(kind="env", radiance=tuple(s["sky"]["radiance"]))],
        env_texture=inp["sky"])
    cam = dict(s["camera"])
    cam["transform"] = np.asarray(cam["transform"], np.float32)
    return scene, camera_cls.create(**cam)


def program(config, inp):
    """(the port's Scene, its CameraParams)."""
    from directcomputeraytracing_tpu_torch.core.types import CameraParams
    from directcomputeraytracing_tpu_torch.scene.scene import (
        Instance, Material, Mesh, PunctualLight, Scene)

    return _build(config, inp, Mesh, Material, Instance, PunctualLight,
                  Scene, CameraParams)


def reference(config, inp):
    """(the reference's Scene, its CameraParams)."""
    from ..reference.core.types import CameraParams
    from ..reference.scene.scene import (
        Instance, Material, Mesh, PunctualLight, Scene)

    return _build(config, inp, Mesh, Material, Instance, PunctualLight,
                  Scene, CameraParams)
