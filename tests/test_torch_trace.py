"""The port's spans and set-up records (`utils.trace`), on the CPU.

A 16x16 Cornell box (glossy, area light, max_bounce 4) renders under
`torch.profiler.profile`: one `render(1)` gives one
`dcrt.renderer.render` holding one `pass` holding one `chunk`, and the
chunk holds the camera, max_bounce + 1 bounces, max_bounce + 2 closest
and max_bounce + 1 any-hit casts of the chunk's pixels each, as
`integrator/megakernel.py`'s docstring counts. Every record lies inside
its profiler event (2 µs of slack) and its parent, and carries its
pass's id. With no profiler a render records nothing and opens no
profiler range; images are bit-equal either way.
"""

from collections import deque

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from directcomputeraytracing_tpu_torch.accel.traverse import (
    intersect_closest,
)
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene.presets import (
    cornell_box,
    sphere_grid,
)
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
from directcomputeraytracing_tpu_torch.utils import trace

W = H = 16
MAX_BOUNCE = 4
SLACK_NS = 2000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread per process keeps parallel
    pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _renderer(integrator="megakernel"):
    return Renderer(*cornell_box("area", "glossy"), W, H,
                    max_bounce=MAX_BOUNCE, integrator=integrator,
                    device=torch.device("cpu"))


@pytest.fixture(scope="module")
def warm():
    r = _renderer()
    r.render(1)
    return r


def _profiled(fn, events=False):
    """fn() under the profiler: (its result, the records it left and,
    with events, the profiler's dcrt events as (name, start ns, end ns,
    event), in order; reading them takes seconds on the CPU)."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    if not events:
        return out, trace.records(), None
    base = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e.name, base + e.time_range.start * 1e3,
                     base + e.time_range.end * 1e3, e)
                    for e in prof.events() if e.name.startswith("dcrt."))
    return out, trace.records(), events


def _children(recs, parent, name=None):
    return [r for r in recs if r.parent == parent.id
            and (name is None or r.name == name)]


def _descendants(recs, top):
    ids, out = {top.id}, []
    for r in recs:      # parents come before their children
        if r.parent in ids:
            ids.add(r.id)
            out.append(r)
    return out


def test_gate_flips_inside_the_profiler():
    """The private flag that gates the spans is True exactly inside
    `torch.profiler.profile` (a torch that renames it fails here)."""
    assert autograd_profiler._is_profiler_enabled is False
    assert trace.span("dcrt.renderer.x") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert trace.span("dcrt.renderer.x") is not trace._OFF
    assert autograd_profiler._is_profiler_enabled is False


def test_one_render_tree(warm):
    img, recs, events = _profiled(lambda: warm.render(1), events=True)
    assert img.shape == (H, W, 3)
    assert trace.dropped() == 0
    renders = [r for r in recs if r.name == "dcrt.renderer.render"]
    assert len(renders) == 1
    (top,) = renders
    assert top.parent is None and top.pass_id is None
    assert top.counts == {"spp": 1, "first_sample": warm.spp - 1}
    (pas,) = _children(recs, top, "dcrt.renderer.pass")
    assert pas.pass_id == pas.id and pas.counts == {"samples": 1}
    (chunk,) = _children(recs, pas, "dcrt.integrator.chunk")
    assert chunk.counts == {"chunk": 0, "pixels": W * H}
    assert len(_children(recs, pas, "dcrt.renderer.film")) == 1
    assert len(_children(recs, top, "dcrt.renderer.image")) == 1

    inner = _descendants(recs, chunk)
    names = [r.name for r in inner]
    assert names.count("dcrt.integrator.camera") == 1
    bounces = _children(recs, chunk, "dcrt.integrator.bounce")
    assert [b.counts["bounce"] for b in bounces] == list(
        range(MAX_BOUNCE + 1))
    closest = [r for r in inner if r.name == "dcrt.traversal.closest"]
    anyhit = [r for r in inner if r.name == "dcrt.traversal.any"]
    assert len(closest) == MAX_BOUNCE + 2
    assert len(anyhit) == MAX_BOUNCE + 1
    for cast in closest + anyhit:
        assert cast.counts == {"backend": "dense", "rays": W * H}
    for b in bounces:
        kids = [r.name for r in _children(recs, b)]
        assert kids == ["dcrt.integrator.nee", "dcrt.integrator.bsdf_sample",
                        "dcrt.traversal.closest", "dcrt.integrator.shade",
                        "dcrt.integrator.emission"]
        (nee,) = _children(recs, b, "dcrt.integrator.nee")
        assert [r.name for r in _children(recs, nee)] == [
            "dcrt.traversal.any"]

    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
        if r is not top:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        if r is not top and r.name != "dcrt.renderer.image":
            assert r.pass_id == pas.id, r

    # each record inside its profiler event, on the profiler's clock
    assert sorted({e[0] for e in events}) == sorted({r.name for r in recs})
    for name in {r.name for r in recs}:
        mine = sorted((r.start_ns, r.end_ns) for r in recs
                      if r.name == name)
        theirs = [(s, e) for n, s, e, _ in events if n == name]
        assert len(mine) == len(theirs), name
        for (s, e), (ps, pe) in zip(mine, theirs):
            assert ps - SLACK_NS <= s and e <= pe + SLACK_NS, name
    # the ranges are not user annotations, which come back as device ops
    for *_, ev in events:
        assert not getattr(ev, "is_user_annotation", False)


def test_no_profiler_no_records(warm, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "_RecordFunctionFast", Counting)
    trace.reset()
    n_setup = len(trace.setup_records())
    warm.render(1)
    warm.preview(1, 4)
    assert trace.records() == [] and entered == []
    assert len(trace.setup_records()) == n_setup
    # the same stand-in is entered once the profiler runs
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("dcrt.renderer.x"):
            pass
    assert entered == ["dcrt.renderer.x"]


def test_images_equal_with_and_without_the_profiler():
    plain = _renderer().render(1)
    traced, recs, _ = _profiled(lambda: _renderer().render(1))
    assert recs
    assert np.array_equal(plain, traced)


def test_setup_records_once_per_renderer_and_library():
    from directcomputeraytracing_tpu_torch.ops import native

    before = trace.setup_records()
    r = _renderer()
    made = trace.setup_records()[len(before):]
    names = [s.name for s in made if s.name != "dcrt.setup.library"]
    assert names == ["dcrt.setup.flatten", "dcrt.setup.luts"]
    r.render(1)
    r.render(1)
    made = trace.setup_records()[len(before):]
    first = [s for s in made if s.name == "dcrt.setup.first_pass"]
    assert len(first) == 1 and first[0].fields == {"spp": 1}
    assert all(s.seconds >= 0.0 for s in made)

    def libs():
        return [s for s in trace.setup_records()
                if s.name == "dcrt.setup.library"
                and s.fields["library"].startswith("libbvh_builder-")]

    n0 = len(libs())
    native._load()
    native._load()
    assert len(libs()) == max(n0, 1)
    rec = libs()[-1]
    assert set(rec.fields) == {"library", "build_s", "load_s"}
    assert 0.0 <= rec.fields["load_s"] <= rec.seconds
    assert 0.0 <= rec.fields["build_s"] <= rec.seconds


def test_setup_records_are_logged(caplog):
    import logging

    with caplog.at_level(logging.INFO, logger="dcrt"):
        with trace.setup("dcrt.setup.test_only", n=3):
            pass
    assert any("dcrt.setup.test_only" in m for m in caplog.messages)
    assert trace.setup_records()[-1].fields == {"n": 3}


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_records", deque(maxlen=4))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(7):
            with trace.span("dcrt.renderer.x", i=i):
                pass
    assert [r.counts["i"] for r in trace.records()] == [3, 4, 5, 6]
    assert trace.dropped() == 3
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_worklist_cast_counts_items():
    """A work-list cast's span carries its rays and the cull's items."""
    arrays, _ = flatten_scene(sphere_grid(3, 3, stacks=12, slices=16)[0],
                              torch.device("cpu"))
    g = torch.Generator().manual_seed(3)
    o = torch.rand(64, 3, generator=g) * 0.2 + torch.tensor([0.0, 1.0,
                                                             -3.0])
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, -0.2, 1.0]) + 0.2 * torch.rand(64, 3,
                                                         generator=g), dim=-1)
    _, recs, _ = _profiled(lambda: intersect_closest(arrays, o, d))
    (cast,) = [r for r in recs if r.name == "dcrt.traversal.closest"]
    assert cast.counts["backend"] == "wl" and cast.counts["rays"] == 64
    assert cast.counts["items"] > 0


def test_wavefront_and_preview_spans(warm):
    r = _renderer("wavefront")
    _, recs, _ = _profiled(lambda: r.render(1))
    (wf,) = [x for x in recs if x.name == "dcrt.integrator.wavefront"]
    assert wf.counts["pixels"] == W * H and wf.counts["spp_batch"] == 1
    assert wf.counts["iterations"] >= MAX_BOUNCE + 1
    inner = {x.name for x in _descendants(recs, wf)}
    assert {"dcrt.traversal.closest", "dcrt.traversal.any"} <= inner

    _, recs, _ = _profiled(lambda: warm.preview(1, 4))
    (pv,) = [x for x in recs if x.name == "dcrt.renderer.preview"]
    assert pv.counts == {"spp": 1, "scale": 4}
    (chunk,) = _children(recs, pv, "dcrt.integrator.chunk")
    assert chunk.counts["pixels"] == (W // 4) * (H // 4)


@pytest.mark.cuda
def test_cuda_spans_stay_on_the_host():
    """On the card no device event carries a span's name (a user-scope
    range would come back as a `gpu_user_annotation` device event), and
    the spans are there on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType

    r = Renderer(*cornell_box("area", "glossy"), 64, 64,
                 max_bounce=MAX_BOUNCE, device=torch.device("cuda"))
    r.render(1)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.render(1)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e.name for e in events if e.device_type == DeviceType.CUDA]
    host = [e.name for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("dcrt.")]
    assert device and not [n for n in device if n.startswith("dcrt.")]
    assert len(host) == len(trace.records()) > 0
