"""The readers of the `weekend-1200x800-wf` cell's four per-layer metrics
(`pool_occupancy`, `pool_iterations_per_spp`, `worklist_items_per_ray`,
`inst_sweep_roofline`) on synthetic traces and span records, and the
cell rehearsed on the CPU at a cut size.

Times are µs, as `run.trace` holds them. A reader takes the program's
records of the run's last trace only (a traced run may trace again), and
reads None where the span, its counts, the kernel or the flatten's
fields are absent; the instanced sweeps' share reads 100 % for kernels
timed at their bound.
"""

import sys
import types

import pytest

from benchmark import spans
from benchmark.inst_bound import inst_sweep_bound, scene_bytes
from benchmark.named import load
from benchmark.run import Run

CLOSEST = ("void (anonymous namespace)::closest_ray_kernel<(anonymous "
           "namespace)::BaldwinWeber, true>(int const*)")
ANY = ("void (anonymous namespace)::any_ray_kernel<(anonymous "
       "namespace)::BaldwinWeber, true>(int const*)")
SOUP_CLOSEST = ("void (anonymous namespace)::closest_ray_kernel<(anonymous "
                "namespace)::BaldwinWeber, false>(int const*)")
WAVEFRONT = "dcrt.integrator.wavefront"


def _rec(rid, name, **counts):
    return types.SimpleNamespace(id=rid, name=name, counts=counts)


def _program(monkeypatch, records, setup=()):
    mod = types.ModuleType("fake_program_trace")
    mod.records = lambda: list(records)
    mod.setup_records = lambda: list(setup)
    monkeypatch.setitem(sys.modules, "fake_program_trace", mod)
    monkeypatch.setattr(spans, "PROGRAM_TRACE", "fake_program_trace")


def _run(host_names=(), device=(), launches=None, samples=8):
    host = [(n, float(k), float(k) + 0.5) for k, n in enumerate(host_names)]
    trace = {"host_ops": host, "device_ops": list(device),
             "samples": samples, "launches": launches or {}}
    return Run(spp_per_pass=8, setup_s=1.0, scene_build_s=0.1,
               pass_s=[0.3, 0.3], window_s=0.6, samples=16,
               window_peak_bytes=0, launches={}, alpha_calls=0,
               alpha_passes=0, trace=trace)


def _read(name, run):
    return load("metrics", name).read(run)


def test_pool_readers_take_the_last_trace(monkeypatch):
    # the first record is a trace that was traced again
    _program(monkeypatch, [
        _rec(1, WAVEFRONT, iterations=5, pool_lanes=64,
             busy_lane_iterations=100, tail_iterations=2,
             cast_lane_iterations=320),
        _rec(7, "dcrt.traversal.closest", backend="wl", rays=64, items=3),
        _rec(9, WAVEFRONT, iterations=10, pool_lanes=64,
             busy_lane_iterations=320, tail_iterations=4,
             cast_lane_iterations=640)])
    run = _run([WAVEFRONT, "aten::mul"])
    assert _read("pool_occupancy", run) == pytest.approx(50.0)
    assert _read("pool_iterations_per_spp", run) == pytest.approx(10 / 8)
    # a pool that shed idle lanes in its drain held fewer lanes than
    # iterations x pool_lanes: occupancy is over the lanes it held
    _program(monkeypatch, [
        _rec(9, WAVEFRONT, iterations=10, pool_lanes=64,
             busy_lane_iterations=320, tail_iterations=6,
             cast_lane_iterations=400)])
    assert _read("pool_occupancy", run) == pytest.approx(80.0)


def test_pool_readers_read_none_without_their_counts(monkeypatch):
    run = _run([WAVEFRONT])
    # a program whose span has iterations only (before the pool counts)
    _program(monkeypatch, [_rec(1, WAVEFRONT, iterations=10, pixels=4,
                                spp_batch=8)])
    assert _read("pool_occupancy", run) is None
    assert _read("pool_iterations_per_spp", run) == pytest.approx(10 / 8)
    # a span with the pool's counts but not the lanes it held
    _program(monkeypatch, [_rec(1, WAVEFRONT, iterations=10, pool_lanes=64,
                                busy_lane_iterations=320,
                                tail_iterations=4)])
    assert _read("pool_occupancy", run) is None
    # no span: a megakernel cell
    _program(monkeypatch, [])
    for name in ("pool_occupancy", "pool_iterations_per_spp"):
        assert _read(name, _run(["dcrt.renderer.pass"])) is None
        assert _read(name, run) is None
    # no trace, no program trace module
    untraced = Run(spp_per_pass=8, setup_s=1.0, scene_build_s=0.1,
                   pass_s=[0.3], window_s=0.3, samples=8,
                   window_peak_bytes=0, launches={}, alpha_calls=0,
                   alpha_passes=0, trace=None)
    assert _read("pool_occupancy", untraced) is None
    monkeypatch.setattr(spans, "PROGRAM_TRACE",
                        "directcomputeraytracing_tpu_torch.utils.no_trace")
    assert _read("pool_iterations_per_spp", run) is None


def test_items_per_ray(monkeypatch):
    """Closest work-list casts' items over the pool's live closest rays:
    the casts' `rays` (parked lanes included) do not enter it."""
    _program(monkeypatch, [
        _rec(1, "dcrt.traversal.closest", backend="wl", rays=1000,
             items=999),                                 # an older trace
        _rec(2, WAVEFRONT, iterations=3, pool_lanes=100,
             busy_lane_iterations=150, closest_live_rays=150),
        _rec(3, "dcrt.traversal.slab", backend="wl", rays=100),
        _rec(4, "dcrt.traversal.closest", backend="wl", rays=100, items=30),
        _rec(5, "dcrt.traversal.any", backend="wl", rays=100, items=10),
        _rec(6, "dcrt.traversal.closest", backend="wl", rays=60),  # culled
        _rec(8, "dcrt.traversal.closest", backend="wlg", rays=40,
             items=20)])
    names = [WAVEFRONT, "dcrt.traversal.closest", "dcrt.traversal.slab",
             "dcrt.traversal.any", "dcrt.traversal.closest",
             "dcrt.traversal.closest"]
    assert _read("worklist_items_per_ray", _run(names)) == \
        pytest.approx(50 / 150)
    # a pool that casts fewer parked lanes: the same items, the same rays
    _program(monkeypatch, [
        _rec(2, WAVEFRONT, iterations=3, pool_lanes=100,
             busy_lane_iterations=150, closest_live_rays=150),
        _rec(4, "dcrt.traversal.closest", backend="wl", rays=50, items=30),
        _rec(8, "dcrt.traversal.closest", backend="wlg", rays=50,
             items=20)])
    assert _read("worklist_items_per_ray", _run(
        [WAVEFRONT] + ["dcrt.traversal.closest"] * 2)) == \
        pytest.approx(50 / 150)
    # a pool span without the live count (a program before it)
    _program(monkeypatch, [
        _rec(2, WAVEFRONT, iterations=3, pool_lanes=100,
             busy_lane_iterations=150),
        _rec(4, "dcrt.traversal.closest", backend="wl", rays=100, items=30)])
    assert _read("worklist_items_per_ray", _run(
        [WAVEFRONT, "dcrt.traversal.closest"])) is None
    # dense casts only, or no pool: nothing to read
    _program(monkeypatch, [
        _rec(1, WAVEFRONT, iterations=1, pool_lanes=64,
             busy_lane_iterations=64, closest_live_rays=64),
        _rec(2, "dcrt.traversal.closest", backend="dense", rays=64)])
    assert _read("worklist_items_per_ray", _run(
        [WAVEFRONT, "dcrt.traversal.closest"])) is None
    _program(monkeypatch, [_rec(1, "dcrt.traversal.closest", backend="wl",
                                rays=64, items=5)])
    assert _read("worklist_items_per_ray",
                 _run(["dcrt.traversal.closest"])) is None


FLATTEN = types.SimpleNamespace(name="dcrt.setup.flatten", seconds=1.0,
                                fields={"local_tris": 3970,
                                        "instances": 484})
CASTS = [_rec(2, "dcrt.traversal.closest", backend="wl", rays=1 << 18,
              items=500),
         _rec(3, "dcrt.traversal.any", backend="wl", rays=1 << 18,
              items=300),
         _rec(4, "dcrt.traversal.closest", backend="wl", rays=77, items=9),
         _rec(5, "dcrt.traversal.any", backend="wl", rays=50),   # no items
         _rec(6, "dcrt.traversal.any", backend="wl", rays=12, items=0)]
CAST_NAMES = [r.name for r in CASTS]


def _bound_us(kind, rays):
    return 1e6 * inst_sweep_bound(kind, rays, 3970, 484)[0]


def _timed(scale):
    """Device ops of the three launches, each `scale` times its bound."""
    out, t = [], 0.0
    for name, kind, rays in ((CLOSEST, "closest", 1 << 18),
                             (ANY, "any", 1 << 18),
                             (CLOSEST, "closest", 77)):
        d = scale * _bound_us(kind, rays)
        out.append((name, t, t + d))
        t += d + 10.0
    return out + [("void at::native::elementwise_kernel", t, t + 50.0)]


LAUNCHES = {"sweep_closest_inst": 2, "sweep_any_inst": 1}


def test_inst_roofline_at_its_bound(monkeypatch):
    _program(monkeypatch, CASTS, [FLATTEN])
    run = _run(CAST_NAMES, _timed(1.0), LAUNCHES)
    assert _read("inst_sweep_roofline", run) == pytest.approx(100.0)
    run = _run(CAST_NAMES, _timed(40.0), LAUNCHES)
    assert _read("inst_sweep_roofline", run) == pytest.approx(2.5)
    # the bound: rays in and out, the geometry once a launch
    assert scene_bytes(3970, 484) == 36 * 3970 + 48 * 484
    assert inst_sweep_bound("any", 10, 1, 1)[0] == \
        pytest.approx((29 * 10 + 36 + 48) / 3.35e12)


def test_inst_roofline_reads_none(monkeypatch):
    run = _run(CAST_NAMES, _timed(2.0), LAUNCHES)
    # no flatten fields (a program before them)
    bare = types.SimpleNamespace(name="dcrt.setup.flatten", seconds=1.0,
                                 fields={})
    _program(monkeypatch, CASTS, [bare])
    assert _read("inst_sweep_roofline", run) is None
    _program(monkeypatch, CASTS, [FLATTEN])
    assert _read("inst_sweep_roofline", run) == pytest.approx(50.0)
    # a span the profiler lost
    assert _read("inst_sweep_roofline",
                 _run(CAST_NAMES, _timed(2.0)[1:], LAUNCHES)) is None
    # casts with items that do not match the launches
    assert _read("inst_sweep_roofline", _run(
        CAST_NAMES[:1] + CAST_NAMES[2:], _timed(2.0), LAUNCHES)) is None
    # no instanced kernel: the soup's sweep, or nothing
    assert _read("inst_sweep_roofline", _run(
        CAST_NAMES, [(SOUP_CLOSEST, 0.0, 5.0)],
        {"sweep_closest": 1})) is None
    assert _read("inst_sweep_roofline", _run(CAST_NAMES, [], {})) is None


_REHEARSAL = """
import json
from benchmark import run
from directcomputeraytracing_tpu_torch.scene import scene
scene.SOUP_MAX_TRIS = 2048
with open("benchmark/configs/weekend-final.json") as f:
    sph = json.load(f)["scene"]["spheres"]
cut = {"width": 24, "height": 16, "max_bounce": 6,
       "scene": {"sphere_mesh": {"stacks": 6, "slices": 12},
                 "spheres": sph[:16] + sph[-3:]}}
res, lines = run.execute("weekend-1200x800-wf", 2**31 + 12345, 0.0, 1,
                         "cpu", overrides=cut)
print(json.dumps(res))
"""


def test_the_cell_rehearsed_on_the_cpu():
    """The cell at a cut size (16 small spheres and the 3 large, 24x16,
    max_bounce 6, the twins; `SOUP_MAX_TRIS` lowered so that the cut
    flattens to the instanced tables), traced in a fresh process:
    correct, and the pool and work-list readers read the program's own
    records; the instanced sweeps' share needs the card's kernels."""
    import json
    import os
    import subprocess

    from benchmark.tests.test_import_guard import ROOT

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _REHEARSAL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    m = res["metrics"]
    assert 0.0 < m["pool_occupancy"]["value"] <= 100.0
    assert m["pool_iterations_per_spp"]["value"] > 0.0
    assert m["worklist_items_per_ray"]["value"] > 0.0
    assert "inst_sweep_roofline" not in m
