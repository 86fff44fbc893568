"""The control, the plain reference with its path state in bfloat16 in
the program's place, fails the check's limits; and on the card, at the
cell's own frame and scene, too.

CPU: tiny frames. Card (`-m cuda`, skipped without one): one seed of
each cell at its full size, three passes."""

import json

import pytest
import torch

from benchmark import check, control
from benchmark.tests.test_import_guard import TINY


def _fails(workload, readings):
    lim = check.limits(workload)
    for r in readings:
        ok, _ = check.judge(r, lim)
        assert not ok, (workload, r)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails_on_the_cpu(workload):
    torch.set_num_threads(2)
    _fails(workload, control.readings(workload, [3, 2**31 + 5], 1, "cpu",
                                      TINY[workload]))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    readings = control.readings(workload, [2**31 + 9], 3, "cuda")
    print(json.dumps(readings))
    _fails(workload, readings)
