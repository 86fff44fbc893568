"""A configuration, a cell and a metric are added as new files, and the
harness runs them without an edit to any file it already has.

The test copies `BENCHMARK.json` and `benchmark/` into a temporary
directory, adds a configuration file (a 16x16 Cornell box under a new
name), a traffic file, a metric reader and the cell's limits, registers
them in the copy's `BENCHMARK.json`, and rehearses the new cell on the
CPU in a fresh process from the copy's root."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.test_import_guard import BENCH, ROOT

_METRIC = '''"""passes_run: the window's passes (a throwaway reader)."""


def read(run):
    return float(len(run.pass_s))
'''

_PROBE = """
import json
from benchmark import run
res, _ = run.execute("throwaway-cell", 5, 0.0, 1, "cpu")
print(json.dumps(res))
"""


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_make_a_new_cell(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    before = _digests(copy / "benchmark")

    b = copy / "benchmark"
    cfg = json.loads((b / "configs" / "cornell-glossy.json").read_text())
    cfg.update(width=16, height=16)
    (b / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "workloads" / "progressive-mk.json")
                         .read_text())
    traffic["check"] = {"tiles": 2, "tile": 4}
    (b / "workloads" / "throwaway-traffic.json").write_text(
        json.dumps(traffic))
    (b / "metrics" / "passes_run.py").write_text(_METRIC)
    (b / "limits" / "throwaway-cell.json").write_text(
        (b / "limits" / "cornell-1024-mk.json").read_text())
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "test",
                            "file": "benchmark/configs/throwaway.json",
                            "reduced": ["width", "height"], "why": "test"})
    spec["workloads"].append({"name": "throwaway-cell",
                              "config": "throwaway",
                              "traffic": "throwaway-traffic", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "passes_run", "unit": "passes",
                              "better": "higher", "source": "host_clock",
                              "layer": "renderer", "moves": "ms_per_spp",
                              "workloads": ["throwaway-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["passes_run"]["value"] >= 1
    assert res["metrics"]["passes_run"]["unit"] == "passes"
    after = _digests(copy / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
