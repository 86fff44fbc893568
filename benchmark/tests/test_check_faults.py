"""The check fails the faults a cell can have.

Each case drives a tiny CPU rehearsal of a cell through the harness
(`benchmark.run.execute`, which leaves the look for a card to `main`)
with the program's timed path broken underneath, and sees `correct` come
out false against the cell's own limits; the unbroken run comes out true.
The faults: a pass that returns the film unchanged; half of a pass's
pixels left out, each taking its kept neighbour's value (the mean over
the rest); an answer altered where it is produced (a pass's values
handed to the wrong pixels). The exchange between chips has no fault
here: every cell runs on one card.
"""

import pytest
import torch

from benchmark import run
from benchmark.tests.test_import_guard import TINY


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unchanged(monkeypatch):
    from directcomputeraytracing_tpu_torch.integrator import renderer

    monkeypatch.setattr(renderer.Renderer, "render_sample",
                        lambda self, frame_seed: None)


def _patch_samples(monkeypatch, change):
    from directcomputeraytracing_tpu_torch.integrator import renderer

    orig = renderer.render_samples

    def broken(*a, **kw):
        pos, val = orig(*a, **kw)
        return pos, change(val)

    monkeypatch.setattr(renderer, "render_samples", broken)


def _half_left_out(monkeypatch):
    def change(val):
        out = val.clone()
        out[1::2] = val[0::2][:out[1::2].shape[0]]
        return out
    _patch_samples(monkeypatch, change)


def _answer_altered(monkeypatch):
    _patch_samples(monkeypatch, lambda val: torch.roll(val, 1, 0))


FAULTS = {"none": None, "state_unchanged": _unchanged,
          "half_left_out": _half_left_out, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_fault_fails_the_check(monkeypatch, workload, fault):
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch)
    res, lines = run.execute(workload, 2**31 + 11, 0.0, 0, "cpu",
                             overrides=TINY[workload])
    assert res["correct"] == (fault == "none"), lines
    assert list(res)[-1] == "check"
    assert len(lines) == len(res["check"])
