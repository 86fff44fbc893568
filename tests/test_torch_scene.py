"""The port's host side: presets, flatten_scene, from_reference, no jax.

Tolerance: none. The port's numpy `flatten_scene` must give the
reference's values exactly for every field the slice reads, since both
run the same numpy arithmetic on the same float32 inputs.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu.lut.textures import (
    placeholder_luts as ref_placeholder_luts,
)
from directcomputeraytracing_tpu.scene.presets import cornell_box as ref_cornell
from directcomputeraytracing_tpu.scene.scene import flatten_scene as ref_flatten
from directcomputeraytracing_tpu_torch.core.types import (
    CameraParams,
    SceneTensors,
    from_reference,
)
from directcomputeraytracing_tpu_torch.lut.textures import (
    BxDFLuts,
    load_luts,
    placeholder_luts,
)
from directcomputeraytracing_tpu_torch.scene import scene as port_scene_mod
from directcomputeraytracing_tpu_torch.scene.presets import (
    cornell_box,
    sphere_grid,
)
from directcomputeraytracing_tpu_torch.scene.scene import (
    SOUP_MAX_TRIS,
    Material,
    flatten_scene,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("light", ["area", "point"])
@pytest.mark.parametrize("material_set", ["diffuse", "glossy", "dielectric"])
def test_flatten_matches_reference(light, material_set):
    ref_scene, ref_camera = ref_cornell(light, material_set)
    ref_arrays, ref_meta = ref_flatten(ref_scene)
    want, _, want_cam = from_reference(ref_arrays, ref_placeholder_luts(),
                                       ref_camera, "cpu")
    scene, camera = cornell_box(light, material_set)
    got, meta = flatten_scene(scene, "cpu")
    for f in SceneTensors._fields:
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
    for f in CameraParams._fields:
        assert torch.equal(getattr(want_cam, f), getattr(camera, f)), f
    assert meta.light_count == ref_meta.light_count
    assert meta.env_light_index == ref_meta.env_light_index
    assert meta.has_env_texture == ref_meta.has_env_texture
    assert meta.any_non_opaque == ref_meta.any_non_opaque


def test_from_reference_types():
    ref_arrays, _ = ref_flatten(ref_cornell("area", "glossy")[0])
    scene, luts, cam = from_reference(ref_arrays, ref_placeholder_luts(),
                                      ref_cornell("area", "glossy")[1], "cpu")
    for f, x in scene._asdict().items():
        src = np.asarray(getattr(ref_arrays, f))
        # uint32 fields become int64 so that bit 31 survives
        assert x.dtype == (torch.int64 if src.dtype.kind in "ui"
                           else torch.float32), f
        np.testing.assert_array_equal(x.numpy(), src.astype(x.numpy().dtype),
                                      err_msg=f)
    assert int(scene.instance_light_indices.max()) == 0xFFFFFFFF
    assert all(torch.equal(a, b) for a, b in zip(luts, placeholder_luts("cpu")))
    assert cam.blade_count.dtype == torch.int64


def test_committed_luts_load():
    from directcomputeraytracing_tpu.lut.bake import bake_luts_cached

    ref = bake_luts_cached()
    got = load_luts("cpu")
    for f in BxDFLuts._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)


def test_flatten_matches_reference_clustered_and_instanced():
    """A clustered scene (2049 to 2^20 world triangles) flattens exactly as
    the reference does, cluster tables included, and so does a scene above
    2^20 world triangles, instanced tables included and the world soup a
    placeholder; with alpha the clustered scene gets the opaque/masked
    split of its clusters, as the reference's does."""
    from directcomputeraytracing_tpu.scene import scene as ref_scene_mod
    from directcomputeraytracing_tpu.scene.presets import (
        sphere_grid as ref_grid,
    )

    ref_scene, ref_camera = ref_grid(3, 3, stacks=12, slices=16)
    want, _, want_cam = from_reference(ref_flatten(ref_scene)[0],
                                       ref_placeholder_luts(), ref_camera,
                                       "cpu")
    scene, camera = sphere_grid(3, 3, stacks=12, slices=16)
    got, meta = flatten_scene(scene, "cpu")
    assert got.cluster_bbox.shape[0] > 1
    for f in SceneTensors._fields:
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
    for f in CameraParams._fields:
        assert torch.equal(getattr(want_cam, f), getattr(camera, f)), f

    rs = np.random.default_rng(0)
    n = 1024
    pos = rs.random((3 * n, 3), dtype=np.float32)
    idx = np.arange(3 * n).reshape(n, 3)
    copies = SOUP_MAX_TRIS // n + 1

    def many(mod):
        return mod.Scene(meshes=[mod.Mesh(positions=pos, indices=idx)],
                         instances=[mod.Instance(mesh=0)] * copies)

    want = from_reference(ref_flatten(many(ref_scene_mod))[0],
                          ref_placeholder_luts(), ref_camera, "cpu")[0]
    got = flatten_scene(many(port_scene_mod), "cpu")[0]
    assert got.isup_inst.shape[0] > 1 and got.world_tris.shape[0] == 1
    for f in SceneTensors._fields:
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
    scene.materials[1] = Material(opacity=0.4)
    ref_scene.materials[1] = ref_scene_mod.Material(opacity=0.4)
    got, meta = flatten_scene(scene, "cpu")
    want = from_reference(ref_flatten(ref_scene)[0], ref_placeholder_luts(),
                          ref_camera, "cpu")[0]
    assert meta.any_non_opaque and got.mclu_bbox.shape[0] > 1
    for f in ("oclu_bbox", "mclu_bbox", "world_tri_opacity",
              "instance_flags"):
        assert torch.equal(getattr(want, f), getattr(got, f)), f


def test_port_runs_without_jax():
    """Import, build, flatten and render 8x8 at 1 spp with jax blocked."""
    code = textwrap.dedent("""
        import sys
        for k in [k for k in sys.modules if k == "jax" or k.startswith("jax.")]:
            del sys.modules[k]
        sys.modules["jax"] = None          # any `import jax` now fails
        import numpy as np, torch
        from directcomputeraytracing_tpu_torch import Renderer, cornell_box
        from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
        scene, cam = cornell_box("area", "glossy")
        arrays, meta = flatten_scene(scene, torch.device("cpu"))
        img = Renderer(scene, cam, 8, 8, max_bounce=2,
                       device=torch.device("cpu")).render(spp=1)
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
        assert img.mean() > 0
        loaded = [k for k, m in sys.modules.items()
                  if (k == "jax" or k.startswith("jax.")) and m is not None]
        assert not loaded, loaded
        print("ok", arrays.world_tris.shape[0], meta.light_count)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok", "32", "1"]


def test_sphere_grid_renders_without_jax():
    """A clustered scene renders through the work-list twins with jax
    blocked: the port builds its cluster tables itself."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import numpy as np, torch
        from directcomputeraytracing_tpu_torch import Renderer
        from directcomputeraytracing_tpu_torch.scene.presets import (
            sphere_grid)
        r = Renderer(*sphere_grid(3, 3, stacks=12, slices=16), 16, 16,
                     max_bounce=2, device=torch.device("cpu"))
        img = r.render(spp=1)
        assert img.shape == (16, 16, 3) and np.isfinite(img).all()
        assert img.mean() > 0
        assert not [k for k, m in sys.modules.items()
                    if k.startswith("jax") and m is not None]
        print("ok", r.arrays.cluster_bbox.shape[0], r._inv is not None)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok", "256", "True"]
