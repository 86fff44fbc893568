"""`mk_graph_replay_share` on synthetic span records: the replayed
`dcrt.integrator.segment` spans of the run's last trace over all of them,
nothing to read without them."""

import sys
import types

import pytest

from benchmark import spans
from benchmark.named import load
from benchmark.run import Run

SEGMENT = "dcrt.integrator.segment"


def _rec(rid, name, **counts):
    return types.SimpleNamespace(id=rid, name=name, counts=counts)


def _program(monkeypatch, records):
    mod = types.ModuleType("fake_program_trace")
    mod.records = lambda: list(records)
    monkeypatch.setitem(sys.modules, "fake_program_trace", mod)
    monkeypatch.setattr(spans, "PROGRAM_TRACE", "fake_program_trace")


def _run(host_names):
    host = [(n, float(k), float(k) + 0.5) for k, n in enumerate(host_names)]
    trace = {"host_ops": host, "device_ops": [], "samples": 1}
    return Run(spp_per_pass=1, setup_s=1.0, scene_build_s=0.1,
               pass_s=[0.3], window_s=0.3, samples=1, window_peak_bytes=0,
               launches={}, alpha_calls=0, alpha_passes=0, trace=trace)


def _read(run):
    return load("metrics", "mk_graph_replay_share").read(run)


def test_share_of_the_last_trace(monkeypatch):
    # an eager pass traced first (set-up, or a trace that was traced
    # again), then the last trace: three replayed segments, one eager
    _program(monkeypatch, [
        _rec(1, SEGMENT, segment=0, replayed=0),
        _rec(2, "dcrt.traversal.closest", backend="dense", rays=4),
        _rec(3, SEGMENT, segment=1, replayed=0),
        _rec(4, SEGMENT, segment=0, replayed=1),
        _rec(5, "dcrt.traversal.closest", backend="dense", rays=4),
        _rec(6, SEGMENT, segment=1, replayed=1),
        _rec(7, SEGMENT, segment=0, replayed=0),
        _rec(8, SEGMENT, segment=1, replayed=1)])
    run = _run([SEGMENT, "aten::mul", SEGMENT, SEGMENT, SEGMENT])
    assert _read(run) == pytest.approx(75.0)
    _program(monkeypatch, [_rec(k, SEGMENT, segment=k, replayed=1)
                           for k in range(12)])
    assert _read(_run([SEGMENT] * 12)) == pytest.approx(100.0)


def test_nothing_to_read_without_segments(monkeypatch):
    _program(monkeypatch, [_rec(1, "dcrt.integrator.camera")])
    assert _read(_run(["dcrt.integrator.camera"])) is None
    # fewer records than the trace's ranges: not this trace's records
    _program(monkeypatch, [_rec(1, SEGMENT, segment=0, replayed=1)])
    assert _read(_run([SEGMENT, SEGMENT])) is None
    run = _run([SEGMENT])
    run.trace = None
    assert _read(run) is None
