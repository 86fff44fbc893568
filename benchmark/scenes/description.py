"""Scene kind `description`: the scene written out in the configuration.

The configuration's `scene.description` holds meshes (positions, indices,
material ids), instances, materials, punctual lights and the camera's
arguments as numbers; `program` builds the port's `Scene` and camera from
them and `reference` the reference's, so both sides start from the same
numbers.
"""

import numpy as np


def inputs(config, workdir):
    return config["scene"]["description"]


def _build(desc, mesh_cls, material_cls, instance_cls, light_cls, scene_cls,
           camera_cls):
    meshes = [mesh_cls(positions=np.asarray(m["positions"], np.float32),
                       indices=np.asarray(m["indices"], np.int64),
                       material_ids=np.asarray(m["material_ids"], np.int64),
                       name=m["name"]) for m in desc["meshes"]]
    materials = [material_cls(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in m.items()})
                 for m in desc["materials"]]
    instances = [instance_cls(
        mesh=i["mesh"], transform=np.asarray(i["transform"], np.float32),
        material_override=i["material_override"],
        is_emitter=i["is_emitter"], radiance=tuple(i["radiance"]),
        name=i["name"]) for i in desc["instances"]]
    lights = [light_cls(kind=p["kind"], radiance=tuple(p["radiance"]),
                        position=tuple(p["position"]))
              for p in desc["lights"]]
    cam = dict(desc["camera"])
    cam["transform"] = np.asarray(cam["transform"], np.float32)
    return (scene_cls(meshes=meshes, instances=instances, materials=materials,
                      lights=lights), camera_cls.create(**cam))


def program(config, desc):
    """(the port's Scene, its CameraParams)."""
    from directcomputeraytracing_tpu_torch.core.types import CameraParams
    from directcomputeraytracing_tpu_torch.scene.scene import (
        Instance, Material, Mesh, PunctualLight, Scene)

    return _build(desc, Mesh, Material, Instance, PunctualLight, Scene,
                  CameraParams)


def reference(config, desc):
    """(the reference's Scene, its CameraParams)."""
    from ..reference.core.types import CameraParams
    from ..reference.scene.scene import (
        Instance, Material, Mesh, PunctualLight, Scene)

    return _build(desc, Mesh, Material, Instance, PunctualLight, Scene,
                  CameraParams)
