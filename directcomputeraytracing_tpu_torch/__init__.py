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
    if name == "CameraParams":
        from .core.types import CameraParams
        return CameraParams
    if name == "PostParams":
        from .post.pipeline import PostParams
        return PostParams
    raise AttributeError(name)


__all__ = ["Renderer", "RenderConfig", "SEED_FIXED", "SEED_SAMPLE_COUNT",
           "SEED_FRAME_INDEX", "cornell_box", "sphere_grid", "Scene", "Mesh",
           "Material", "Instance", "PunctualLight", "flatten_scene",
           "CameraParams", "PostParams"]
