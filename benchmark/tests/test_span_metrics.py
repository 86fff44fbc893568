"""The span readers (`benchmark/spans.py` and the five metrics that use
it) on synthetic traces and set-up records.

Times are µs, as `run.trace` holds them. A gap between device ops goes to
the innermost `dcrt.<layer>.*` span of the renderer, integrator or
traversal that holds its midpoint, aten ops and unknown names skipped up
the stack, and to no layer outside every such span; the three idle
readers sum to the idle they charged; each reader reads None where there
is nothing to read, the set-up readers too without the program's
`utils/trace.py`.
"""

import random
import sys
import types

import pytest

from benchmark import spans
from benchmark.named import load
from benchmark.run import Run
from benchmark.yardstick import idle_gaps

IDLE = ("idle_ms_per_spp.integrator", "idle_ms_per_spp.traversal",
        "idle_ms_per_spp.renderer")


def _run(trace):
    return Run(spp_per_pass=1, setup_s=1.0, scene_build_s=0.1,
               pass_s=[0.3, 0.3], window_s=0.6, samples=2,
               window_peak_bytes=0, launches={}, alpha_calls=0,
               alpha_passes=0, trace=trace)


def _trace(host, device, samples=2):
    return {"host_ops": host, "device_ops": device, "samples": samples}


def _read(name, run):
    return load("metrics", name).read(run)


HOST = [("dcrt.renderer.render", 0.0, 100.0),
        ("dcrt.integrator.bounce", 10.0, 90.0),
        ("aten::mul", 20.0, 30.0),
        ("dcrt.unknown.x", 40.0, 60.0),
        ("dcrt.traversal.closest", 60.0, 79.0),
        ("cudaLaunchKernel", 61.0, 62.0)]
DEVICE = [("k", 0.0, 10.0), ("k", 30.0, 32.0), ("k", 50.0, 52.0),
          ("k", 70.0, 72.0), ("k", 88.0, 89.0), ("k", 95.0, 100.0),
          ("k", 200.0, 210.0)]


def test_gaps_go_to_the_innermost_known_span():
    by = spans.idle_by_layer(_trace(HOST, DEVICE))
    # (10, 30) mid 20: aten::mul skipped, the bounce; (32, 50) mid 41:
    # the unknown layer skipped, the bounce; (52, 70) mid 61: the cast
    # (its cudaLaunchKernel skipped); (72, 88) mid 80: past the cast, the
    # bounce; (89, 95) mid 92: the render; (100, 200): no span
    assert by == pytest.approx({"integrator": 54e-6, "traversal": 18e-6,
                                "renderer": 6e-6}, abs=1e-12)
    run = _run(_trace(HOST, DEVICE))
    got = [_read(n, run) for n in IDLE]
    assert got == pytest.approx([0.027, 0.009, 0.003], abs=1e-12)


def _nested(rng, t0, t1, depth, out):
    """Random properly nested spans inside (t0, t1)."""
    t = t0
    while depth and t < t1:
        s = t + rng.uniform(0.0, (t1 - t) / 3)
        e = s + rng.uniform(0.0, t1 - s)
        name = rng.choice(["dcrt.renderer.a", "dcrt.integrator.b",
                           "dcrt.traversal.c", "aten::add", "dcrt.setup.d",
                           "dcrt.other.e", "dcrt.integrator"])
        out.append((name, s, e))
        _nested(rng, s, e, depth - 1, out)
        t = e + rng.uniform(0.0, 5.0)


@pytest.mark.parametrize("seed", range(5))
def test_idle_readers_sum_to_the_charged_idle(seed):
    rng = random.Random(seed)
    host = []
    _nested(rng, 0.0, 10_000.0, 4, host)
    starts = sorted(rng.uniform(0.0, 11_000.0) for _ in range(300))
    device = [("k", s, s + rng.uniform(0.0, 30.0)) for s in starts]
    known = [h for h in host if spans.layer_of(h[0])]
    charged = 0.0
    for g0, g1 in idle_gaps([(s, e) for _, s, e in device]):
        mid = 0.5 * (g0 + g1)
        if any(s <= mid <= e for _, s, e in known):
            charged += g1 - g0
    run = _run(_trace(host, device, samples=3))
    total = sum(_read(n, run) for n in IDLE)
    assert total == pytest.approx(charged / 1e3 / 3, rel=1e-9, abs=1e-12)
    by = spans.idle_by_layer(run.trace)
    # the brute force's innermost span of each gap gives the same split
    brute = dict.fromkeys(spans.LAYERS, 0.0)
    for g0, g1 in idle_gaps([(s, e) for _, s, e in device]):
        mid = 0.5 * (g0 + g1)
        holding = [h for h in known if h[1] <= mid <= h[2]]
        if holding:
            inner = max(holding, key=lambda h: (h[1], -h[2]))
            brute[spans.layer_of(inner[0])] += (g1 - g0) / 1e6
    assert by == pytest.approx(brute, abs=1e-12)


def test_layer_of():
    assert spans.layer_of("dcrt.integrator.nee") == "integrator"
    assert spans.layer_of("dcrt.traversal.closest") == "traversal"
    assert spans.layer_of("dcrt.renderer.film") == "renderer"
    for name in ("dcrt.setup.first_pass", "dcrt.integrator", "aten::mul",
                 "integrator.nee", "dcrt.kernels.x"):
        assert spans.layer_of(name) is None


def test_idle_readers_read_none_without_spans():
    host = [("aten::mul", 0.0, 50.0), ("dcrt.setup.first_pass", 0.0, 60.0)]
    for trace in (None, _trace(host, DEVICE), _trace([], DEVICE)):
        run = _run(trace)
        assert [_read(n, run) for n in IDLE] == [None, None, None]
    # spans but no gap under them: 0, not None
    run = _run(_trace([("dcrt.renderer.render", 300.0, 400.0)], DEVICE))
    assert [_read(n, run) for n in IDLE] == [0.0, 0.0, 0.0]


def _program_records(monkeypatch, recs):
    mod = types.ModuleType("fake_program_trace")
    mod.setup_records = lambda: list(recs)
    monkeypatch.setitem(sys.modules, "fake_program_trace", mod)
    monkeypatch.setattr(spans, "PROGRAM_TRACE", "fake_program_trace")


def test_setup_readers(monkeypatch):
    rec = types.SimpleNamespace
    _program_records(monkeypatch, [
        rec(name="dcrt.setup.flatten", seconds=0.4, fields={}),
        rec(name="dcrt.setup.library", seconds=1.5, fields={}),
        rec(name="dcrt.setup.first_pass", seconds=2.0, fields={}),
        rec(name="dcrt.setup.library", seconds=0.25, fields={}),
        rec(name="dcrt.setup.first_pass", seconds=0.1, fields={})])
    run = _run(None)
    assert _read("first_pass_s", run) == 2.0
    assert _read("library_load_s", run) == 1.75
    _program_records(monkeypatch, [])
    assert _read("first_pass_s", run) is None
    assert _read("library_load_s", run) is None


def test_setup_readers_without_the_programs_trace(monkeypatch):
    monkeypatch.setattr(spans, "PROGRAM_TRACE",
                        "directcomputeraytracing_tpu_torch.utils.no_trace")
    run = _run(None)
    assert _read("first_pass_s", run) is None
    assert _read("library_load_s", run) is None
    # a module without the function reads None too
    mod = types.ModuleType("old_program_trace")
    monkeypatch.setitem(sys.modules, "old_program_trace", mod)
    monkeypatch.setattr(spans, "PROGRAM_TRACE", "old_program_trace")
    assert _read("first_pass_s", run) is None


def test_setup_readers_read_the_program():
    """The program's own records reach the readers."""
    from directcomputeraytracing_tpu_torch.utils import trace

    with trace.setup("dcrt.setup.library", library="test_only"):
        pass
    run = _run(None)
    assert _read("library_load_s", run) >= trace.setup_records()[-1].seconds
