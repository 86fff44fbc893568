"""Headline-config stand-in: a >=200k-triangle Mitsuba XML scene.

The port's copy of `directcomputeraytracing_tpu.scene.standin`: it writes
the same files, byte for byte (`tests/test_torch_loaders.py`).

The reference's marquee demo is the Spaceship scene (README.md:20
screenshots) rendered through the Mitsuba XML loader — the scene assets
are not in the repo, so benchmarks and tests use this programmatic
stand-in with the same ingredients: instanced OBJ geometry through the
full XML path (deduped shapes, per-shape to_world), the whole BSDF mix
(diffuse / roughplastic / roughconductor / roughdielectric / mask with
a bitmap opacity texture + a bitmap albedo), a rectangle area emitter,
a constant env emitter, and a thin-lens-capable perspective sensor.

`write_standin_scene(dir)` emits sphere.obj + textures + standin.xml
and returns the XML path.
"""

import os

import numpy as np

from .presets import uv_sphere


def _write_sphere_obj(path, stacks=24, slices=32):
    """Unit UV sphere with normals + UVs (the loader's RHS->LHS flip
    assumes Mitsuba-style OBJ input, so emit plain right-handed data)."""
    verts, idx = uv_sphere(stacks, slices)
    # uv_sphere returns LHS-ready data; undo the loader's incoming flip
    # (load_obj negates x and rewinds) so round-tripping reproduces it
    v = np.asarray(verts, np.float64).copy()
    v[:, 0] = -v[:, 0]
    tri = np.asarray(idx)[:, ::-1]
    n = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    uu = 0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi)
    vv = 0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi
    with open(path, "w") as f:
        f.write("# stand-in sphere\n")
        for p in v:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for p, q in zip(uu, vv):
            f.write(f"vt {p:.6f} {1.0 - q:.6f}\n")
        for p in n:
            f.write(f"vn {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for a, b, c in tri + 1:
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
    return len(tri)


def _write_textures(dirname):
    """A checkerboard albedo PNG and a dot-grid opacity mask PNG."""
    from PIL import Image

    yy, xx = np.mgrid[0:64, 0:64]
    checker = (((xx // 8) + (yy // 8)) % 2).astype(np.float32)
    alb = np.zeros((64, 64, 3), np.uint8)
    alb[..., 0] = np.where(checker > 0, 230, 40)
    alb[..., 1] = np.where(checker > 0, 120, 160)
    alb[..., 2] = 60
    albedo_path = os.path.join(dirname, "standin_albedo.png")
    Image.fromarray(alb, "RGB").save(albedo_path)

    r2 = (xx % 16 - 8) ** 2 + (yy % 16 - 8) ** 2
    mask = np.where(r2 > 18, 255, 0).astype(np.uint8)
    mask_path = os.path.join(dirname, "standin_mask.png")
    Image.fromarray(mask, "L").save(mask_path)
    return os.path.basename(albedo_path), os.path.basename(mask_path)


_BSDFS = """
  <bsdf type="diffuse" id="mat-diffuse">
    <rgb name="reflectance" value="0.65, 0.35, 0.3"/>
  </bsdf>
  <bsdf type="twosided" id="mat-textured">
    <bsdf type="diffuse">
      <texture type="bitmap" name="reflectance">
        <string name="filename" value="{albedo}"/>
      </texture>
    </bsdf>
  </bsdf>
  <bsdf type="roughplastic" id="mat-plastic">
    <rgb name="diffuse_reflectance" value="0.2, 0.45, 0.75"/>
    <float name="alpha" value="0.09"/>
    <float name="int_ior" value="1.49"/>
  </bsdf>
  <bsdf type="roughconductor" id="mat-metal">
    <rgb name="eta" value="0.2, 0.92, 1.1"/>
    <rgb name="k" value="3.9, 2.45, 2.14"/>
    <float name="alpha" value="0.05"/>
  </bsdf>
  <bsdf type="roughdielectric" id="mat-glass">
    <float name="int_ior" value="1.5"/>
    <float name="alpha" value="0.02"/>
  </bsdf>
  <bsdf type="mask" id="mat-masked">
    <texture type="bitmap" name="opacity">
      <string name="filename" value="{mask}"/>
    </texture>
    <bsdf type="diffuse">
      <rgb name="reflectance" value="0.8, 0.75, 0.3"/>
    </bsdf>
  </bsdf>
"""

_MATS = ["mat-diffuse", "mat-textured", "mat-plastic", "mat-metal",
         "mat-glass", "mat-masked"]


def write_standin_scene(dirname, nx=12, nz=12, stacks=24, slices=32):
    """Emit the stand-in scene files; returns the XML path.

    Default 12x12 spheres x 1472 tris ~= 212k triangles + ground and
    emitter rectangles, matching the reference headline scale."""
    os.makedirs(dirname, exist_ok=True)
    obj_path = os.path.join(dirname, "standin_sphere.obj")
    _write_sphere_obj(obj_path, stacks, slices)
    albedo, mask = _write_textures(dirname)

    shapes = []
    spacing = 2.4
    for iz in range(nz):
        for ix in range(nx):
            x = (ix - (nx - 1) / 2) * spacing
            z = (iz - (nz - 1) / 2) * spacing
            mat = _MATS[(ix + iz * nx) % len(_MATS)]
            shapes.append(f"""
  <shape type="obj">
    <string name="filename" value="standin_sphere.obj"/>
    <transform name="to_world">
      <scale value="0.9"/>
      <translate x="{x:.3f}" y="0.9" z="{z:.3f}"/>
    </transform>
    <ref id="{mat}"/>
  </shape>""")

    span = max(nx, nz) * spacing
    xml = f"""<scene version="3.0.0">
  <integrator type="path">
    <integer name="max_depth" value="8"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <string name="fov_axis" value="x"/>
    <transform name="to_world">
      <lookat origin="0, {span * 0.55:.2f}, {-span * 0.95:.2f}"
              target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="1920"/>
      <integer name="height" value="1080"/>
      <rfilter type="gaussian"/>
    </film>
  </sensor>
{_BSDFS.format(albedo=albedo, mask=mask)}
{"".join(shapes)}
  <shape type="rectangle">
    <transform name="to_world">
      <scale value="{span:.2f}"/>
      <rotate x="1" angle="-90"/>
      <translate y="0"/>
    </transform>
    <bsdf type="diffuse">
      <rgb name="reflectance" value="0.55, 0.55, 0.55"/>
    </bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world">
      <scale value="{span * 0.25:.2f}"/>
      <rotate x="1" angle="90"/>
      <translate y="{span * 0.6:.2f}"/>
    </transform>
    <emitter type="area">
      <rgb name="radiance" value="14, 13, 12"/>
    </emitter>
  </shape>
  <emitter type="constant">
    <rgb name="radiance" value="0.18, 0.2, 0.25"/>
  </emitter>
</scene>
"""
    xml_path = os.path.join(dirname, "standin.xml")
    with open(xml_path, "w") as f:
        f.write(xml)
    return xml_path
