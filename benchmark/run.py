"""One run of one benchmark cell.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. The cell
(`workloads` in `BENCHMARK.json`) names a configuration (its file,
`benchmark/configs/<config>.json`: the scene, the frame and the film)
and a traffic mix (`benchmark/workloads/<traffic>.json`: the integrator,
the samples a pass, the passes traced and the tiles checked). The run:

1. builds the scene from the benchmark's own inputs (`benchmark/scenes/
   <kind>.py`, files under the `TMPDIR`), constructs the program's
   `Renderer` on the card and warms it up with one pass of the cell's
   shape (set-up, `setup_s`, counts from the start of this module);
2. sets the film's first sample index from `--seed` and calls
   `Renderer.render(spp_per_pass)` pass after pass until `--seconds`
   have gone by; the pass in flight is counted whole, and the window
   runs to its end. Each call returns the resolved image, as the public
   API does;
3. with `--trace 1`, traces `trace_passes` more passes under
   `torch.profiler` (again, up to `TRACE_TRIES` times, where the profiler
   lost a span of one of the port's kernels);
4. reads the peak memory, frees the program's state, and holds the last
   image's checked tiles against the plain reference (`benchmark/
   check.py`), printing each number compared beside its limit as the last
   lines of standard error and under "check", the last key of the result.

The last line of standard output is the result: the cell's `end_to_end`
metrics with `--trace 0`, its `per_layer` metrics with `--trace 1`, each
read by `benchmark/metrics/<name>.py` (a reader that finds nothing to
read returns None and the metric is left out). No result is printed and
the exit code is not 0 without enough CUDA cards, without the program's
package, or where jax, jaxlib, flax or the JAX package have been loaded
by the time the window closes.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "directcomputeraytracing_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "directcomputeraytracing_tpu")
TRACE_TRIES = 3


class NoResult(Exception):
    """A run that prints no result: the message goes to standard error
    and the exit code is 1."""


def forbidden_modules():
    """Top-level names in sys.modules that the run may not hold, compared
    whole (the program's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(p):
    with open(p) as f:
        return json.load(f)


def bench_spec():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_spec(spec, workload):
    for c in spec["workloads"]:
        if c["name"] == workload:
            return c
    raise NoResult(f"no workload named {workload!r} in BENCHMARK.json")


def config_of(spec, cell):
    for c in spec["configs"]:
        if c["name"] == cell["config"]:
            return load_json(os.path.join(ROOT, c["file"]))
    raise NoResult(f"no config named {cell['config']!r} in BENCHMARK.json")


def traffic_of(cell):
    from .named import path

    return load_json(path("workloads", cell["traffic"], ".json"))


@dataclass
class Cell:
    """A cell resolved from `BENCHMARK.json` and the files it names: what
    a run and the check's control both take from it."""
    name: str
    entry: dict                  # the cell's entry in `workloads`
    config: dict                 # the configuration, overrides applied
    traffic: dict
    kind: object                 # the scene kind's module
    spp: int                     # samples a pass
    filt: tuple                  # (filter kind, radius)
    width: int
    height: int

    def tiles(self, seed):
        """The tiles the check takes for `seed`."""
        from . import check

        chk = self.traffic["check"]
        return check.pick_tiles(seed, self.width, self.height,
                                int(chk["tiles"]), int(chk["tile"]))

    def plan(self, seed, n_passes):
        """The frame seeds of n_passes passes from `seed`, a list a pass."""
        return [[seed + k * self.spp + j for j in range(self.spp)]
                for k in range(n_passes)]


def resolve(workload, overrides=None, spec=None):
    """The Cell named `workload`; `overrides` updates its configuration
    (tests shrink the frame)."""
    from .named import load

    spec = spec or bench_spec()
    entry = cell_spec(spec, workload)
    cfg = config_of(spec, entry)
    for k, v in (overrides or {}).items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    traffic = traffic_of(entry)
    return Cell(name=workload, entry=entry, config=cfg, traffic=traffic,
                kind=load("scenes", cfg["scene"]["kind"]),
                spp=int(traffic["spp_per_pass"]),
                filt=(cfg["filter"]["kind"], float(cfg["filter"]["radius"])),
                width=int(cfg["width"]), height=int(cfg["height"]))


def cell_metrics(spec, workload, trace):
    """[(name, unit)] of the cell's end-to-end metrics (trace 0) or
    per-layer metrics (trace 1)."""
    kind = "per_layer" if trace else "end_to_end"
    return [(m["name"], m["unit"]) for m in spec[kind]
            if workload in m.get("workloads", [workload])]


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    spp_per_pass: int
    setup_s: float
    scene_build_s: float
    pass_s: list                 # host seconds of each window pass
    window_s: float              # window start to the last pass's end
    samples: int                 # samples the window's passes completed
    window_peak_bytes: int       # device memory peak over the window
    launches: dict               # wrapper launch counts over the window
    alpha_calls: int             # recast loops over the window
    alpha_passes: int            # recast passes over the window
    trace: Optional[dict] = None  # see `_traced`


def _launch_counts():
    """The port's wrappers' launch counters, by counter name."""
    from directcomputeraytracing_tpu_torch.accel import (
        brute, clustered, pairsweep, worklist)

    out = {"brute_closest": brute.brute_closest.launches,
           "brute_any": brute.brute_any.launches}
    out.update({k: v for k, v in worklist.counters().items()
                if k not in ("closest_empty", "any_empty", "refine_skipped")})
    out.update(clustered.counters())
    out.update({k: v for k, v in pairsweep.counters().items()
                if k in ("pair_emit", "pair_sweep_closest",
                         "pair_sweep_any")})
    return out


def _delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after}


class _DenseRays:
    """Counts the rays handed to the dense sweep's wrappers while it is
    entered: (kind, rays) per call. The wrappers' own `launches`
    attributes follow onto the stand-ins and back."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from directcomputeraytracing_tpu_torch.accel import brute

        self.saved = {}
        for kind, name in (("closest", "brute_closest"),
                           ("any", "brute_any")):
            orig = getattr(brute, name)

            def counted(scene, origin, *a, _orig=orig, _kind=kind, **kw):
                self.calls.append((_kind, int(origin.shape[0])))
                return _orig(scene, origin, *a, **kw)

            counted.launches = orig.launches
            self.saved[name] = orig
            setattr(brute, name, counted)
        return self

    def __exit__(self, *exc):
        from directcomputeraytracing_tpu_torch.accel import brute

        for name, orig in self.saved.items():
            orig.launches = getattr(brute, name).launches
            setattr(brute, name, orig)


def _traced(r, spp, n_passes, device):
    """n_passes more passes under torch.profiler: device ops, host ops,
    busy and window seconds, launch counts and dense-sweep rays."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from directcomputeraytracing_tpu_torch.accel import traverse

    from .yardstick import busy_union

    before = _launch_counts()
    a_calls, a_passes = traverse.alpha_recast.calls, \
        traverse.alpha_recast.passes
    with _DenseRays() as dense:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_passes):
                img = r.render(spp)
            if device.type == "cuda":
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        (dev if e.device_type == DeviceType.CUDA else host).append(span)
    busy = busy_union([(s, e) for _, s, e in dev]) / 1e6
    return img, dict(
        device_ops=dev, host_ops=host, samples=n_passes * spp,
        window_s=window, busy_s=busy,
        launches=_delta(_launch_counts(), before),
        alpha_calls=traverse.alpha_recast.calls - a_calls,
        alpha_passes=traverse.alpha_recast.passes - a_passes,
        dense_rays=dense.calls, soup_tris=int(r.arrays.world_tris.shape[0]))


def breakdown(trace):
    """The ten device ops with the most time, and the device's idle time
    by what the host was doing: each gap between device ops is charged to
    the innermost host op that spans its middle, and the ten host ops
    with the most idle time under them are listed."""
    from .yardstick import idle_gaps

    by_name = {}
    for name, s, e in trace["device_ops"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = idle_gaps([(s, e) for _, s, e in trace["device_ops"]])
    ops = sorted(trace["host_ops"], key=lambda h: (h[1], -h[2]))
    idle, stack, i = {}, [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while i < len(ops) and ops[i][1] <= mid:
            while stack and stack[-1][2] < ops[i][1]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "host outside any op"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in worst]}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def execute(workload, seed, seconds, trace, device, overrides=None,
            spec=None):
    """Run the cell on `device`; returns (result dict, check lines). The
    CUDA checks are `main`'s: on the CPU this rehearses the run with the
    kernels' twins. `overrides` updates the configuration (`resolve`)."""
    import numpy as np
    import torch

    try:
        from directcomputeraytracing_tpu_torch.film.filters import (
            FilterParams)
        from directcomputeraytracing_tpu_torch.integrator.renderer import (
            Renderer)
    except ImportError as exc:
        raise NoResult(f"the program's package {PROGRAM} is missing: "
                       f"{exc}") from exc
    from directcomputeraytracing_tpu_torch.accel import traverse

    from . import check
    from .named import load

    device = torch.device(device)
    cuda = device.type == "cuda"
    spec = spec or bench_spec()
    c = resolve(workload, overrides, spec)
    cfg, spp, filt = c.config, c.spp, c.filt
    width, height = c.width, c.height

    with tempfile.TemporaryDirectory(prefix="benchmark-") as work:
        t0 = time.perf_counter()
        inputs = c.kind.inputs(cfg, work)
        scene, camera = c.kind.program(cfg, inputs)
        r = Renderer(scene, camera, width, height,
                     max_bounce=int(cfg["max_bounce"]),
                     integrator=c.traffic["integrator"],
                     filter_params=FilterParams(*filt), device=device)
        scene_build_s = time.perf_counter() - t0
        del scene

        # warm-up: one pass of the cell's shape on another stream
        r.spp = seed + (1 << 31)
        r.render(spp)
        r.reset()
        r.spp = seed
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        traverse.reset_counters()
        before = _launch_counts()
        setup_s = time.perf_counter() - _T0

        pass_s = []
        start = time.perf_counter()
        while True:
            ts = time.perf_counter()
            img = r.render(spp)
            te = time.perf_counter()
            pass_s.append(te - ts)
            if te - start >= seconds:
                break
        window_s = te - start
        launches = _delta(_launch_counts(), before)
        alpha = (traverse.alpha_recast.calls, traverse.alpha_recast.passes)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        bad = forbidden_modules()
        if bad:
            raise NoResult(f"modules loaded by the window's close: {bad}")

        traced = None
        n_passes = len(pass_s)
        if trace:
            from .yardstick import PORT_KERNELS, span_shortfall

            # a trace that lost a kernel's span is traced again, so that
            # the kernels' shares read a whole trace (TRACE_TRIES at most)
            for _ in range(TRACE_TRIES):
                img, traced = _traced(r, spp,
                                      int(c.traffic["trace_passes"]), device)
                n_passes += int(c.traffic["trace_passes"])
                if not span_shortfall(traced, PORT_KERNELS, "trace"):
                    break
        memory_peak = max(setup_peak, torch.cuda.max_memory_allocated()) \
            if cuda else 0
        run = Run(spp_per_pass=spp, setup_s=setup_s,
                  scene_build_s=scene_build_s, pass_s=pass_s,
                  window_s=window_s, samples=len(pass_s) * spp,
                  window_peak_bytes=window_peak, launches=launches,
                  alpha_calls=alpha[0], alpha_passes=alpha[1], trace=traced)
        metrics = {}
        for name, unit in cell_metrics(spec, workload, trace):
            value = load("metrics", name).read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}

        # the check: the program's state goes first, then the reference
        tiles = c.tiles(seed)
        prog_tiles = [np.array(img[y:y + th, x:x + tw])
                      for x, y, tw, th in tiles]
        del r, img
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        passes = c.plan(seed, n_passes)
        t_check = time.perf_counter()
        from .reference.render import render_tiles

        ref_scene, ref_camera = c.kind.reference(cfg, inputs)
        ref_tiles = [t.cpu().numpy() for t in render_tiles(
            ref_scene, ref_camera, width, height, int(cfg["max_bounce"]),
            filt, tiles, passes, device)]
    check_s = time.perf_counter() - t_check
    values = check.numbers(prog_tiles, ref_tiles)
    correct, table = check.judge(values, check.limits(workload))

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(c.entry["chips"]),
           "memory_peak_bytes": int(memory_peak)}
    if cuda:
        dev["power_limit"] = _power_limit()
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
    result = {"correct": bool(correct), "attempted": n_passes, "failed": 0,
              "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = breakdown(traced)
    result["pass_ms"] = {
        "min": 1000.0 * min(run.pass_s),
        "quartiles": [1000.0 * x for x in statistics.quantiles(run.pass_s,
                                                                n=4)]
        if len(run.pass_s) > 1 else [],
        "max": 1000.0 * max(run.pass_s)}
    result["check_s"] = check_s
    result["check_tiles"] = check.tile_gaps(tiles, prog_tiles, ref_tiles)
    result["check"] = table
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in table.items()]
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        spec = bench_spec()
        chips = int(cell_spec(spec, args.workload)["chips"])
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device")
        if torch.cuda.device_count() < chips:
            raise NoResult(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell needs {chips}")
        result, lines = execute(args.workload, args.seed, args.seconds,
                                args.trace, "cuda", spec=spec)
        bad = forbidden_modules()
        if bad:
            raise NoResult(f"modules loaded: {bad}")
    except NoResult as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
