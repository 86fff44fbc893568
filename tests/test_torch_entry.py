"""The port's single-sample entry (`entry.py`) against the reference's
`__graft_entry__.entry` on the CPU: the same scene, configuration and
seed, so the same shapes, and values within `test_torch_render.py`'s
image gate (RMSE <= 1e-3: both trace the same paths, up to the float
rounding of XLA's and PyTorch's CPU kernels)."""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.entry import entry

GATE_RMSE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_the_reference():
    import importlib

    ref_entry = importlib.import_module("__graft_entry__").entry
    ref_fn, ref_args = ref_entry()
    want = [np.asarray(x) for x in ref_fn(*ref_args)]

    fn, args = entry("cpu")
    arrays, luts, cam, px, py, seed = args
    assert px.device.type == "cpu" and arrays.mat_table.device.type == "cpu"
    got = [x.numpy() for x in fn(*args)]
    assert [x.shape for x in got] == [x.shape for x in want] == [
        (64 * 64, 2), (64 * 64, 3)]
    assert all(np.isfinite(x).all() for x in got)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].mean() > 0.0
    assert float(np.sqrt(((got[1] - want[1]) ** 2).mean())) <= GATE_RMSE


def test_entry_defaults_to_the_card():
    import inspect

    assert inspect.signature(entry).parameters["device"].default == "cuda"
