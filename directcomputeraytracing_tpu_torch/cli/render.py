"""Headless render CLI.

The port's copy of `directcomputeraytracing_tpu.cli.render`, with the
reference's flags, defaults and JSON result line, plus `--device`
(default "cuda"; it fails where CUDA is absent and never falls back to
the CPU). Scene specs: `preset:cornell[-glossy|-dielectric|-point]`,
`preset:spheres[-N]`, `preset:weekend` (the final scene of Ray Tracing in
One Weekend, by default at the book's 1200x800 and depth), an .obj (+ .mtl)
framed from -z, or a Mitsuba .xml.

    python -m directcomputeraytracing_tpu_torch.cli.render scene.xml \\
        --resx 1280 --resy 720 --spp 64 -o out.png
"""

import argparse
import json
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="dcrt-render",
        description="Monte-Carlo path tracer (PyTorch + CUDA port of "
                    "the DirectComputeRayTracing capability rebuild)")
    p.add_argument("scene", help=".obj or Mitsuba .xml scene file, or "
                   "preset:cornell[-glossy|-dielectric|-point], "
                   "preset:spheres[-N] or preset:weekend")
    p.add_argument("--resx", type=int, default=None,
                   help="default 1280, unless the scene XML sets a film "
                        "size (reference default, CommandLineArgs.cpp)")
    p.add_argument("--resy", type=int, default=None)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--max-bounce", type=int, default=None,
                   help="override scene/integrator bounce cap")
    p.add_argument("--integrator", choices=["megakernel", "wavefront"],
                   default="megakernel")
    p.add_argument("--filter", dest="filter_type", default=None,
                   choices=["box", "triangle", "gaussian", "mitchell",
                            "lanczos"])
    p.add_argument("--filter-radius", type=float, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="fixed frame seed (deterministic); default: "
                        "per-sample seeds")
    p.add_argument("--seed-mode", default="sample_count",
                   choices=["sample_count", "frame_index", "fixed"],
                   help="progressive seed mode (reference "
                        "EFrameSeedType; frame_index keeps advancing "
                        "across film resets)")
    p.add_argument("--no-post", action="store_true",
                   help="write raw linear radiance instead of the "
                        "exposure/tonemap chain")
    p.add_argument("--manual-ev100", type=float, default=None)
    p.add_argument("--checkpoint", default=None,
                   help=".npz film checkpoint to resume from / save to")
    p.add_argument("--output-bvh", default=None, metavar="XML",
                   help="dump BVH structure to XML (reference -OutputBVH)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--luts", default=None,
                   help="path to baked BxDF LUTs (.npz); bakes fresh "
                        "when omitted and multiscatter materials exist")
    p.add_argument("--env", default=None, metavar="IMAGE",
                   help="attach an IBL environment light from a cubemap or "
                   "lat-long "
                        "radiance map (npy/npz/png/dds)")
    p.add_argument("--env-scale", type=float, default=1.0)
    p.add_argument("--slab-march", type=float, default=None,
                   metavar="F",
                   help="distance-slab cast marching: phase-1 window "
                        "= F * scene diagonal, later phases re-cast "
                        "the compacted remainder (work-list backend)")
    p.add_argument("--slab-phases", type=int, default=None)
    p.add_argument("--aov", default=None,
                   choices=["normal", "tangent", "albedo",
                            "negative_ndotv", "backface",
                            "iteration_count"],
                   help="render a debug AOV instead of the beauty pass")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; the "
                        "CPU runs the kernels' PyTorch twins)")
    return p


def load_scene(spec):
    """Returns (scene, camera, settings-or-None)."""
    from ..scene.presets import cornell_box

    if spec.startswith("preset:"):
        name = spec.split(":", 1)[1]
        if name == "weekend":
            from ..scene import presets
            from ..scene.xml_loader import XmlRenderSettings

            scene, cam = presets.one_weekend_final()
            width, height = presets.WEEKEND_FRAME
            return scene, cam, XmlRenderSettings(
                width=width, height=height,
                max_depth=presets.WEEKEND_MAX_BOUNCE + 1, camera=cam)
        if name.startswith("spheres"):
            from ..scene.presets import sphere_grid

            n = int(name.split("-")[1]) if "-" in name else 5
            scene, cam = sphere_grid(n, n)
            return scene, cam, None
        kind = "area"
        mats = "diffuse"
        if name.endswith("-point"):
            kind = "point"
        if "glossy" in name:
            mats = "glossy"
        elif "dielectric" in name:
            mats = "dielectric"
        scene, cam = cornell_box(light=kind, material_set=mats)
        return scene, cam, None
    if spec.lower().endswith(".xml"):
        from ..scene.xml_loader import load_mitsuba_xml

        scene, settings = load_mitsuba_xml(spec)
        return scene, settings.camera, settings
    if spec.lower().endswith(".obj"):
        import numpy as np

        from ..camera.camera import look_at_transform
        from ..core.types import CameraParams
        from ..scene.obj_loader import load_obj

        scene = load_obj(spec)
        # frame the scene: look at the union AABB from -z
        lo = np.min([m.positions.min(0) for m in scene.meshes], axis=0)
        hi = np.max([m.positions.max(0) for m in scene.meshes], axis=0)
        c = (lo + hi) / 2
        ext = float(np.linalg.norm(hi - lo))
        cam = CameraParams.create(
            transform=look_at_transform(
                (c[0], c[1], c[2] - 1.6 * ext), tuple(c)),
            fov_x=np.deg2rad(45.0), focal_distance=1.6 * ext)
        return scene, cam, None
    raise SystemExit(f"unrecognized scene file: {spec}")


def _device(name):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available here "
                         "(pass --device cpu to render with the twins)")
    return device


def main(argv=None):
    args = build_parser().parse_args(argv)
    t0 = time.time()
    device = _device(args.device)

    scene, cam, settings = load_scene(args.scene)

    width, height = args.resx, args.resy
    max_bounce = args.max_bounce
    filter_type = args.filter_type
    if settings is not None:
        if width is None:
            width = settings.width
        if height is None:
            height = settings.height
        if max_bounce is None:
            max_bounce = max(settings.max_depth - 1, 0)
        if filter_type is None:
            filter_type = settings.filter_type
    if width is None:
        width = 1280
    if height is None:
        height = 720
    if max_bounce is None:
        max_bounce = 4
    if filter_type is None:
        filter_type = "box"

    if args.env:
        from ..scene.scene import PunctualLight
        from ..utils.image import load_env_map

        scene.env_texture = load_env_map(args.env)
        scene.lights.append(PunctualLight(
            kind="env", radiance=(args.env_scale,) * 3))

    from ..core.constants import MATERIAL_TYPE_DIFFUSE
    from ..film.filters import FilterParams
    from ..integrator.renderer import Renderer
    from ..post.pipeline import PostParams
    from ..utils.image import save_image

    luts = None
    if args.luts:
        from ..lut.textures import load_luts

        luts = load_luts(device, args.luts)
    elif any(m.mtype != MATERIAL_TYPE_DIFFUSE for m in scene.materials):
        from ..lut.bake import bake_luts_cached

        print("baking BxDF energy LUTs (cached)...", file=sys.stderr)
        luts = bake_luts_cached(device=device)

    fp = FilterParams(kind=filter_type,
                      radius=args.filter_radius
                      if args.filter_radius is not None
                      else (0.5 if filter_type == "box" else 2.0))
    pp = PostParams(enabled=not args.no_post,
                    auto_exposure=args.manual_ev100 is None,
                    manual_ev100=15.0 if args.manual_ev100 is None
                    else args.manual_ev100)
    cfg_kw = {}
    if args.slab_march is not None:
        cfg_kw["slab_march"] = args.slab_march
    if args.slab_phases is not None:
        cfg_kw["slab_phases"] = args.slab_phases
    r = Renderer(scene, cam, width=width, height=height,
                 max_bounce=max_bounce, luts=luts,
                 integrator=args.integrator, filter_params=fp,
                 post_params=pp, device=device, **cfg_kw)

    if args.output_bvh:
        from ..accel.build import serialize_bvh_to_xml

        with open(args.output_bvh, "w") as f:
            f.write(serialize_bvh_to_xml(scene))
        print(f"BVH dump written to {args.output_bvh}", file=sys.stderr)

    if args.checkpoint and os.path.exists(args.checkpoint):
        r.load_checkpoint(args.checkpoint)
        print(f"resumed at {r.spp} spp", file=sys.stderr)

    if args.aov:
        from ..integrator.aov import render_aov
        from ..integrator.megakernel import full_frame_pixels

        px, py = full_frame_pixels(r.cfg, device)
        v = render_aov(r.arrays, r.camera, r.cfg, px, py, args.seed or 0,
                       kind=args.aov).cpu().numpy()
        img = v.reshape(height, width, 3)
        if args.aov == "iteration_count":
            img = img / max(img.max(), 1.0)
        save_image(args.output, img, srgb=True)
        print(json.dumps({"output": args.output, "aov": args.aov,
                          "resolution": [width, height]}))
        return

    todo = max(args.spp - r.spp, 0)
    for s in range(todo):
        if args.seed is not None or args.seed_mode == "fixed":
            seed = args.seed or 0
        elif args.seed_mode == "frame_index":
            seed = r.frame_index
        else:
            seed = r.spp
        r.render_sample(seed)
        if (s + 1) % 8 == 0 or s + 1 == todo:
            print(f"  {r.spp}/{args.spp} spp "
                  f"({time.time() - t0:.1f}s)", file=sys.stderr)

    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)

    if args.no_post:
        save_image(args.output, r.image(), srgb=True)
    else:
        save_image(args.output, r.postprocessed(), srgb=False)
    dt = time.time() - t0
    print(json.dumps({"output": args.output, "spp": r.spp,
                      "resolution": [width, height],
                      "integrator": args.integrator,
                      "wall_s": round(dt, 2),
                      "spp_per_sec": round(args.spp / max(dt, 1e-9), 3)}))


if __name__ == "__main__":
    main()
