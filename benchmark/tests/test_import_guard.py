"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program.

A tiny CPU rehearsal of each cell runs in a fresh process, which then
lists the top-level names of `sys.modules`; each is compared whole with
jax, jaxlib, flax and directcomputeraytracing_tpu (the program's own name,
directcomputeraytracing_tpu_torch, begins with the JAX package's). The
reference's sources are read for their imports.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY = {"cornell-1024-mk": {"width": 16, "height": 16}}

_PROBE = """
import json, sys
from benchmark import run
res, _ = run.execute({wl!r}, 7, 0.1, 1, "cpu", overrides={ov!r})
print(json.dumps({{"correct": res["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("workload", sorted(TINY))
def test_no_jax_after_a_rehearsal(workload):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(wl=workload,
                                             ov=TINY[workload])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "directcomputeraytracing_tpu_torch" in res["top"]
    assert not set(res["top"]) & set(FORBIDDEN), res["top"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    seen = 0
    for path in _sources(ref):
        for name, level in _imports(path):
            seen += 1
            top = name.split(".")[0]
            if level == 0:
                assert top not in ("directcomputeraytracing_tpu_torch",
                                   "benchmark", *FORBIDDEN), (path, name)
            else:
                # a relative import stays inside benchmark/reference
                depth = os.path.relpath(os.path.dirname(path),
                                        ref).count(os.sep) + 1
                if os.path.dirname(path) == ref:
                    depth = 0
                assert level - 1 <= depth, (path, name, level)
    assert seen > 50


def test_harness_imports_no_jax():
    for path in _sources(BENCH):
        for name, level in _imports(path):
            if level == 0:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
