"""PyTorch + CUDA port of the directcomputeraytracing_tpu path tracer.

The JAX package `directcomputeraytracing_tpu` is the reference; this
package mirrors its module layout and is held against it module by
module. It imports torch and numpy, never jax. Its kernels are written by
hand for Hopper (sm_90a) in `csrc/` and built with nvcc on first use;
every kernel has a plain PyTorch twin that runs for CPU tensors.

Quick start::

    import torch
    from directcomputeraytracing_tpu_torch import Renderer, cornell_box
    scene, camera = cornell_box("area", "glossy")
    r = Renderer(scene, camera, 1024, 1024, max_bounce=4,
                 device=torch.device("cuda"))
    image = r.render(spp=16)          # (H, W, 3) linear radiance
    display = r.postprocessed()       # exposure + tonemap + sRGB

A Mitsuba XML scene (or `load_obj` for an OBJ) with a splatting film::

    from directcomputeraytracing_tpu_torch import (FilterParams,
                                                   load_mitsuba_xml)
    scene, settings = load_mitsuba_xml("scene.xml")
    r = Renderer(scene, settings.camera, settings.width, settings.height,
                 integrator="wavefront",
                 filter_params=FilterParams("gaussian", radius=2.0))

Across the ranks of a process group (one process a rank; each builds
the same scene; `image()` is a collective)::

    from directcomputeraytracing_tpu_torch import (DistributedRenderer,
                                                   make_mesh)
    from directcomputeraytracing_tpu_torch.parallel.dist import (
        initialize_distributed)
    initialize_distributed()     # DCRT_COORDINATOR, DCRT_NUM_PROCESSES,
                                 # DCRT_PROCESS_ID
    mesh = make_mesh(spp_parallel=2)
    dr = DistributedRenderer(mesh, r.arrays, r.luts, r.camera, r.cfg)
    dr.render_step(); image = dr.image()

From the shell (`--device cpu` runs the twins)::

    python -m directcomputeraytracing_tpu_torch.cli.render scene.xml \
        --resx 1280 --resy 720 --spp 64 -o out.png
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy exports keep `import directcomputeraytracing_tpu_torch` light
    if name in ("Renderer", "SEED_FIXED", "SEED_SAMPLE_COUNT",
                "SEED_FRAME_INDEX"):
        from .integrator import renderer as _m
        return getattr(_m, name)
    if name == "RenderConfig":
        from .integrator.common import RenderConfig
        return RenderConfig
    if name in ("cornell_box", "sphere_grid"):
        from .scene import presets as _m
        return getattr(_m, name)
    if name in ("Scene", "Mesh", "Material", "Instance", "PunctualLight",
                "flatten_scene"):
        from .scene import scene as _m
        return getattr(_m, name)
    if name == "load_obj":
        from .scene.obj_loader import load_obj
        return load_obj
    if name == "load_mitsuba_xml":
        from .scene.xml_loader import load_mitsuba_xml
        return load_mitsuba_xml
    if name == "CameraParams":
        from .core.types import CameraParams
        return CameraParams
    if name in ("bake_luts", "bake_luts_cached"):
        from .lut import bake as _m
        return getattr(_m, name)
    if name == "FilterParams":
        from .film.filters import FilterParams
        return FilterParams
    if name == "PostParams":
        from .post.pipeline import PostParams
        return PostParams
    if name in ("DistributedRenderer", "make_mesh"):
        from .parallel import dist as _m
        return getattr(_m, name)
    raise AttributeError(name)


__all__ = ["Renderer", "RenderConfig", "SEED_FIXED", "SEED_SAMPLE_COUNT",
           "SEED_FRAME_INDEX", "cornell_box", "sphere_grid", "Scene", "Mesh",
           "Material", "Instance", "PunctualLight", "flatten_scene",
           "load_obj", "load_mitsuba_xml", "CameraParams", "bake_luts",
           "bake_luts_cached", "FilterParams", "PostParams",
           "DistributedRenderer", "make_mesh"]
