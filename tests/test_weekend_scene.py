"""The final scene of Ray Tracing in One Weekend (`presets.one_weekend_final`)
on the CPU: its layout against the book's rules and generator, the
benchmark's frozen configuration against the preset, the port against
the benchmark's plain reference on a cut of the scene, and the wavefront
pool's counts and the instanced casts' item counts in the spans.

The cut: the three spheres of radius 1 and the first 16 small ones, each
a `uv_sphere(6, 12)`, at 24x16 pixels, 2 samples, the full depth
(max_bounce 48), with `SOUP_MAX_TRIS` lowered below its 2,282 world
triangles so that it flattens to the instanced tables, as the full scene
does. The reference casts each ray against the world soup with the
Moeller-Trumbore test; the port's instanced sweeps test in each
instance's space with the Baldwin-Weber test, so t, u and v round
otherwise (~1e-7 relative), and a path that meets a facet edge or a
lobe threshold within that may part ways.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from directcomputeraytracing_tpu_torch.accel import traverse, worklist
from directcomputeraytracing_tpu_torch.accel.traverse import (
    intersect_any,
    intersect_closest,
)
from directcomputeraytracing_tpu_torch.core.types import to_device
from directcomputeraytracing_tpu_torch.integrator import wavefront as wf
from directcomputeraytracing_tpu_torch.integrator.common import RenderConfig
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    full_frame_pixels,
)
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.lut.textures import load_luts
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod
from directcomputeraytracing_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "weekend-final.json")
CPU = torch.device("cpu")
W, H, SPP = 24, 16, 2
# the cut against the reference, per pixel gap as `benchmark/check.py`
# takes it: the median gap moves with the rounding of every path, which
# the two triangle tests leave near 1e-7 relative (measured 0 on this
# cut: most pixels' paths agree bit for bit), so 1e-5 leaves two orders
# of magnitude for rounding carried through 50 bounces; a pixel diverges
# (gap > 1e-3) only where a path parts ways at a near-tie, none on this
# cut (the largest gap 8.7e-4), so at most 1 in 100 pixels
GAP_MEDIAN_TOL = 1e-5
DIVERGED_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread per process keeps parallel
    pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config():
    with open(CONFIG) as f:
        return json.load(f)


def _cut(config):
    """The cut's configuration: 16 small spheres and the 3 large ones,
    uv_sphere(6, 12), 24x16."""
    spheres = config["scene"]["spheres"]
    return dict(config, width=W, height=H,
                scene=dict(config["scene"],
                           sphere_mesh={"stacks": 6, "slices": 12},
                           spheres=spheres[:16] + spheres[-3:]))


@pytest.fixture
def instanced_tables(monkeypatch):
    """Flatten scenes of more than 2048 world triangles to the instanced
    tables."""
    monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", 2048)


def test_generator_is_std_mt19937():
    """numpy's MT19937 under the legacy seeding is std::mt19937: the C++
    standard's check value is its 10,000th output at the default seed
    5489; a double is libstdc++'s generate_canonical of two outputs."""
    rnd = presets.BookRandom()
    raw = rnd._bits.random_raw(10000)
    assert int(raw[0]) == 3499211612 and int(raw[-1]) == 4123659995
    rnd = presets.BookRandom()
    assert rnd() == (3499211612 + 581869302 * 2.0 ** 32) / 2.0 ** 64
    assert rnd(0.5, 1.0) == 0.5 + 0.5 * (3890346734 + 3586334585
                                         * 2.0 ** 32) / 2.0 ** 64


def test_layout_keeps_the_books_rules():
    """Replaying the draws: for a, b in -11..10 one choose_mat and two
    centre draws, a sphere of radius 0.2 at y = 0.2 unless within 0.9 of
    (4, 0.2, 0), its material by choose_mat's thresholds 0.8 and 0.95
    with 6 (Lambertian), 4 (metal) or no further draws; then the three
    spheres of radius 1."""
    layout = presets.one_weekend_layout()
    rnd = presets.BookRandom()
    want, skipped = [], 0
    for a in range(-11, 11):
        for b in range(-11, 11):
            u = rnd()
            x, z = a + 0.9 * rnd(), b + 0.9 * rnd()
            assert a <= x < a + 0.9 and b <= z < b + 0.9
            if math.sqrt((x - 4.0) ** 2 + z ** 2) <= 0.9:
                skipped += 1
                continue
            kind = ("lambertian" if u < 0.8 else "metal" if u < 0.95
                    else "dielectric")
            for _ in range({"lambertian": 6, "metal": 4}.get(kind, 0)):
                rnd()
            want.append(((x, 0.2, z), 0.2, kind))
    assert len(layout) == 22 * 22 - skipped + 3 and skipped > 0
    assert [(c, r, m["kind"]) for c, r, m in layout[:-3]] == want
    assert [(c, r) for c, r, _ in layout[-3:]] == [
        ((0.0, 1.0, 0.0), 1.0), ((-4.0, 1.0, 0.0), 1.0),
        ((4.0, 1.0, 0.0), 1.0)]
    assert [m for _, _, m in layout[-3:]] == [
        {"kind": "dielectric", "ior": 1.5},
        {"kind": "lambertian", "albedo": [0.4, 0.2, 0.1]},
        {"kind": "metal", "albedo": [0.7, 0.6, 0.5], "fuzz": 0.0}]
    for _, _, m in layout:
        if m["kind"] == "metal":
            assert all(0.5 <= a < 1.0 for a in m["albedo"])
            assert 0.0 <= m["fuzz"] < 0.5
        elif m["kind"] == "lambertian":
            assert all(0.0 <= a < 1.0 for a in m["albedo"])


def test_preset_scene():
    """483 instances of one 3,968-triangle sphere and the ground: above
    2^20 world triangles with more than 64 local ones, so the full scene
    flattens to the instanced tables; one material a sphere, metals whose
    Fresnel reflectance at normal incidence is the book's albedo; the
    book's camera."""
    scene, cam = presets.one_weekend_final()
    layout = presets.one_weekend_layout()
    world = sum(scene.meshes[i.mesh].indices.shape[0]
                for i in scene.instances)
    assert scene.meshes[0].indices.shape[0] == 3968
    assert len(scene.instances) == len(layout) + 1 == 484
    assert world == 3968 * 483 + 2 > scene_mod.SOUP_MAX_TRIS
    assert len(scene.materials) == len(scene.instances)
    for inst, (c, r, mat) in zip(scene.instances[1:], layout):
        m = scene.materials[inst.material_override]
        assert np.array_equal(inst.transform[3],
                              np.float32([c[0], c[1], -c[2]]))
        assert inst.transform[0, 0] == np.float32(r)
        if mat["kind"] == "metal":
            k = np.asarray(m.k)
            assert np.allclose(k ** 2 / (4 + k ** 2), mat["albedo"],
                               rtol=1e-12)
            assert m.roughness == mat["fuzz"] and m.ior == (1.0,) * 3
    eye = cam.transform[3, :3].numpy()
    assert np.allclose(eye, [13.0, 2.0, -3.0])
    fwd = cam.transform[2, :3].numpy()
    assert np.allclose(fwd, -eye / np.linalg.norm(eye), atol=1e-6)
    fov_y = 2 * math.atan(0.5 * float(cam.film_size[1])
                          / float(cam.film_distance))
    assert math.degrees(fov_y) == pytest.approx(20.0, rel=1e-6)
    assert float(cam.aperture_radius) == pytest.approx(0.05)
    assert float(cam.focal_distance) == 10.0
    assert scene.env_texture.shape == (256, 512, 3)
    sky = scene.env_texture[[0, 255], 0]
    assert np.allclose(sky[0], [0.5, 0.7, 1.0], atol=1e-4)
    assert np.allclose(sky[1], [1.0, 1.0, 1.0], atol=1e-4)


def test_config_holds_the_presets_numbers(config):
    """`benchmark/configs/weekend-final.json` is the preset frozen: the
    layout number for number, the frame, the depth, the mesh, the sky;
    and its scene kind builds the preset's scene and camera."""
    from benchmark.scenes import weekend

    s = config["scene"]
    layout = presets.one_weekend_layout()
    assert s["seed"] == presets.WEEKEND_SEED
    assert [(tuple(sp["centre"]), sp["radius"], sp["material"])
            for sp in s["spheres"]] == layout
    assert (config["width"], config["height"]) == presets.WEEKEND_FRAME
    assert config["max_bounce"] == presets.WEEKEND_MAX_BOUNCE
    assert (s["sphere_mesh"]["stacks"], s["sphere_mesh"]["slices"]) == \
        presets.WEEKEND_SPHERE_MESH
    assert (s["sky"]["height"], s["sky"]["width"]) == \
        presets.WEEKEND_SKY_SHAPE

    got, got_cam = weekend.program(config, weekend.inputs(config, None))
    want, want_cam = presets.one_weekend_final()
    for a, b in zip(got.meshes, want.meshes):
        for f in ("positions", "indices", "normals", "material_ids"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    assert [(i.mesh, i.material_override) for i in got.instances] == \
        [(i.mesh, i.material_override) for i in want.instances]
    assert all(np.array_equal(a.transform, b.transform)
               for a, b in zip(got.instances, want.instances))
    assert [(m.mtype, m.albedo, m.ior, m.k, m.roughness)
            for m in got.materials] == \
        [(m.mtype, m.albedo, m.ior, m.k, m.roughness)
         for m in want.materials]
    assert [(lt.kind, lt.radiance) for lt in got.lights] == \
        [(lt.kind, lt.radiance) for lt in want.lights]
    assert np.array_equal(got.env_texture, want.env_texture)
    for a, b in zip(got_cam, want_cam):
        assert torch.equal(a, b)


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_port_matches_reference_on_a_cut(config, instanced_tables,
                                         integrator):
    """The port's render of the cut (instanced tables, either integrator)
    against `benchmark.reference.render.render_tiles` over the whole
    frame, by the benchmark's own numbers: median gap at most
    GAP_MEDIAN_TOL, diverged share at most DIVERGED_TOL (see the
    module's constants for why)."""
    from benchmark import check
    from benchmark.reference.render import render_tiles
    from benchmark.scenes import weekend

    cut = _cut(config)
    inp = weekend.inputs(cut, None)
    r = Renderer(*weekend.program(cut, inp), W, H,
                 max_bounce=cut["max_bounce"], integrator=integrator,
                 device=CPU)
    assert worklist.instanced(r.arrays)
    img = r.render(SPP)
    ref = render_tiles(*weekend.reference(cut, inp), W, H,
                       cut["max_bounce"], ("box", 0.5), [(0, 0, W, H)],
                       [list(range(SPP))], CPU)[0].numpy()
    assert np.isfinite(img).all() and img.mean() > 0.1
    got = check.numbers([img], [ref])
    assert got["pixel_gap_median"] <= GAP_MEDIAN_TOL, got
    assert got["diverged_share"] <= DIVERGED_TOL, got


def _cut_tables(config):
    from benchmark.scenes import weekend

    cut = _cut(config)
    arrays, meta = scene_mod.flatten_scene(
        weekend.program(cut, weekend.inputs(cut, None))[0], CPU)
    return cut, arrays, meta


def test_pool_counts_recount(config, instanced_tables, monkeypatch):
    """The wavefront span's and `LAST_STATS`' `busy_lane_iterations` is
    the lanes holding a live path at each pool closest cast, summed, and
    `tail_iterations` the steps that began with the cursor past the last
    item, and the span's `closest_live_rays` the rays of every closest
    cast that are not parked: all recounted by wrapping the loop's
    closest cast and step and the traversal's closest cast, on a 64-lane
    pool (several refills and a tail)."""
    from benchmark.scenes import weekend

    cut, arrays, meta = _cut_tables(config)
    cam = to_device(weekend.program(cut, weekend.inputs(cut, None))[1], CPU)
    cfg = RenderConfig(width=W, height=H, max_bounce=cut["max_bounce"],
                       light_count=meta.light_count,
                       env_light_index=meta.env_light_index,
                       has_env_texture=meta.has_env_texture)
    px, py = full_frame_pixels(cfg, CPU)
    seen = {"busy": 0, "tail": 0, "steps": 0, "live": 0, "held": 0}
    closest, step = wf._pool_closest, wf._step
    cast = traverse.intersect_closest

    def counted_cast(scene, origin, *a, **kw):
        seen["live"] += int((origin[:, 0] < 1e9).sum())   # parked: 2e9
        return cast(scene, origin, *a, **kw)

    def counted_closest(scene, casts, busy, *a):
        seen["busy"] += int(busy.sum())
        seen["held"] += busy.shape[0]
        return closest(scene, casts, busy, *a)

    def counted_step(f, casts, s, cursor, n_busy):
        seen["steps"] += 1
        seen["tail"] += cursor >= f.RT
        return step(f, casts, s, cursor, n_busy)

    monkeypatch.setattr(wf, "_pool_closest", counted_closest)
    monkeypatch.setattr(wf, "_step", counted_step)
    monkeypatch.setattr(wf, "intersect_closest", counted_cast)
    monkeypatch.setattr(traverse, "intersect_closest", counted_cast)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        wf.render_samples_wavefront(arrays, load_luts(CPU), cam, cfg, px,
                                    py, 7, pool_size=64, spp_batch=SPP)
    stats = dict(wf.LAST_STATS)
    (rec,) = [r for r in trace.records()
              if r.name == "dcrt.integrator.wavefront"]
    assert stats["iterations"] == seen["steps"] > W * H * SPP // 64
    assert stats["busy_lane_iterations"] == seen["busy"]
    assert stats["tail_iterations"] == seen["tail"] > 0
    assert seen["busy"] < stats["iterations"] * 64
    assert seen["busy"] <= seen["live"]
    # the drain shed idle lanes: the pool held fewer than 64 at its end
    assert stats["cast_lane_iterations"] == seen["held"]
    assert seen["busy"] < seen["held"] < stats["iterations"] * 64
    assert {k: rec.counts[k] for k in ("iterations", "pool_lanes",
                                       "busy_lane_iterations",
                                       "tail_iterations",
                                       "cast_lane_iterations",
                                       "closest_live_rays")} == {
        "iterations": stats["iterations"], "pool_lanes": 64,
        "busy_lane_iterations": seen["busy"],
        "tail_iterations": seen["tail"], "cast_lane_iterations": seen["held"],
        "closest_live_rays": seen["live"]}


def test_instanced_casts_count_their_items(config, instanced_tables):
    """A cast on instanced tables adds its cull's items to its span, as a
    cast on world-soup clusters does: the item list `worklist.phases`
    builds for the same rays."""
    _, arrays, _ = _cut_tables(config)
    assert worklist.instanced(arrays)
    g = torch.Generator().manual_seed(5)
    o = torch.rand((512, 3), generator=g) * torch.tensor([8.0, 1.0, 8.0]) \
        + torch.tensor([-4.0, 0.5, -4.0])
    d = torch.nn.functional.normalize(torch.randn((512, 3), generator=g),
                                      dim=1)
    tables = worklist.scene_tables(arrays)
    od, tm, _ = worklist.prep_rays(o, d)
    want_closest = worklist.phases(tables, od, tm).sup.numel()
    od, tm, _ = worklist.prep_rays(o, d, torch.full((512,), 2.0))
    want_any = worklist.phases(tables, od, tm).sup.numel()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        hit = intersect_closest(arrays, o, d)
        intersect_any(arrays, o, d, torch.full((512,), 2.0))
    recs = {r.name: r.counts for r in trace.records()}
    assert hit.hit.any()
    assert recs["dcrt.traversal.closest"]["backend"] == "wl"
    assert recs["dcrt.traversal.closest"]["items"] == want_closest > 0
    assert recs["dcrt.traversal.any"]["items"] == want_any > 0
    assert recs["dcrt.traversal.closest"]["rays"] == 512
