"""The benchmark's frozen inputs are the port's inputs of today.

The Cornell description in `benchmark/configs/cornell-glossy.json` builds
the scene and camera of the port's `cornell_box("area", "glossy")`, and
the reference's builder reads it into the same numbers. Run on the CPU:

    python -m pytest benchmark/tests -q
"""

import numpy as np
import pytest
import torch

from benchmark.named import load
from benchmark.run import bench_spec, cell_spec, config_of


def _scene_arrays(scene):
    out = {}
    for k, m in enumerate(scene.meshes):
        for f in ("positions", "indices", "normals", "tangents", "texcoords",
                  "material_ids"):
            out[f"mesh{k}.{f}"] = np.asarray(getattr(m, f))
    for k, i in enumerate(scene.instances):
        out[f"inst{k}"] = np.asarray(i.transform)
        out[f"inst{k}.meta"] = np.asarray(
            [i.mesh, i.material_override, i.is_emitter, *i.radiance],
            np.float64)
    for k, m in enumerate(scene.materials):
        out[f"mat{k}"] = np.asarray(
            [*(m.k or m.albedo), *m.ior, m.roughness, *m.tiling, m.opacity,
             m.flags(), m.albedo_texture, m.opacity_texture], np.float64)
    for k, t in enumerate(scene.textures):
        out[f"tex{k}"] = np.asarray(t)
    out["lights"] = np.asarray([[*p.radiance, *p.position]
                                for p in scene.lights], np.float64)
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _camera(cam):
    return {f: np.asarray(v) for f, v in cam._asdict().items()}


def test_cornell_description_is_the_ports():
    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box

    spec = bench_spec()
    cfg = config_of(spec, cell_spec(spec, "cornell-1024-mk"))
    kind = load("scenes", cfg["scene"]["kind"])
    scene, cam = kind.program(cfg, kind.inputs(cfg, None))
    ref_scene, ref_cam = cornell_box("area", "glossy")
    _same(_scene_arrays(scene), _scene_arrays(ref_scene))
    _same(_camera(cam), _camera(ref_cam))
    assert [m.name for m in scene.materials] == \
        [m.name for m in ref_scene.materials]


@pytest.mark.parametrize("workload", ["cornell-1024-mk"])
def test_reference_scene_reads_the_same_numbers(tmp_path, workload):
    """Both sides' description builders give the same meshes, materials,
    lights, textures and camera from the same inputs."""
    spec = bench_spec()
    cfg = config_of(spec, cell_spec(spec, workload))
    kind = load("scenes", cfg["scene"]["kind"])
    inputs = kind.inputs(cfg, str(tmp_path))
    prog, prog_cam = kind.program(cfg, inputs)
    ref, ref_cam = kind.reference(cfg, inputs)
    _same(_scene_arrays(prog), _scene_arrays(ref))
    _same(_camera(prog_cam), _camera(ref_cam))


def test_dense_bound_is_the_tools():
    from directcomputeraytracing_tpu_torch.tools import common

    from benchmark import yardstick

    for kind in ("closest", "any"):
        for rays, tris in ((1 << 20, 34), (4096, 2048), (1, 1)):
            ms, by = common.dense_bound(kind, rays, tris)
            s, by2 = yardstick.dense_bound(kind, rays, tris)
            assert by == by2
            assert s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_busy_union_and_gaps():
    from benchmark.yardstick import busy_union, idle_gaps

    spans = [(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 11)]
    assert busy_union(spans) == 3 + 2 + 1
    assert idle_gaps(spans) == [(3, 5), (7, 10)]


def test_kernel_names_map_to_counters():
    from benchmark.run import _launch_counts
    from benchmark.yardstick import PORT_KERNELS, port_kernel

    counters = _launch_counts()
    for key, (_, counter) in PORT_KERNELS.items():
        assert counter in counters, key
    assert port_kernel("void closest_kernel<MoellerSieve>(float const*)") \
        == "brute_sweep.cu closest_kernel"
    assert port_kernel("void closest_kernel<Moeller>(unsigned char const*, "
                       "int)") == "clustered.cu closest_kernel"
    assert port_kernel("void closest_ray_kernel<BaldwinWeber, false>(int)") \
        == "worklist.cu closest_ray_kernel"
    assert port_kernel("elementwise_kernel") is None


@pytest.mark.cuda
def test_luts_on_the_card_are_the_committed_table():
    """On the card: the reference's frozen LUT table loads to the same
    numbers as the port's committed bake."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from directcomputeraytracing_tpu_torch.lut.textures import load_luts

    from benchmark.reference.lut.textures import load_luts as ref_luts

    for a, b in zip(load_luts("cuda"), ref_luts("cuda")):
        assert torch.equal(a, b)
