"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc
(CUDA_HOME, PATH or /usr/local/cuda). It imports no jax. Phases, in order;
any failure exits non-zero:

1. setup: print the card's name and power limit, build the dense-sweep
   kernels (csrc/brute_sweep.cu) and print the build time and ptxas report;
2. kernels against their PyTorch twins on the card, Moeller and
   watertight, closest and any-hit: (a) the Cornell soup (32 triangles)
   with 1,048,576 camera rays plus 1,048,576 random rays from inside the
   box, (b) a seeded 2048-triangle random soup with 1,048,576 random rays;
   mismatch counts, max errors and kernel/twin times;
3. the main path: Cornell glossy 1024x1024, 16 spp, max_bounce 4 through
   `Renderer.render`, with the kernels' launch counts checked against
   spp * (max_bounce + 2) * chunks (closest) and spp * (max_bounce + 1) *
   chunks (any-hit);
4. the card's render against the port's CPU render (64x64, 4 spp);
5. one JSON line per kernel set, then the contract line, last.

Tolerances (kernel vs twin): the kernels are built without FMA
contraction, so they round like the twins; a hit/miss or occlusion
disagreement is allowed only where the twin's t lies within 1e-5 (1 + t)
of t_min or t_max, a triangle-id disagreement only between hits within
that bound of each other (a near-tie), and t, u, v of same-triangle hits
must agree within 1e-5 (relative to 1 + t for t).
"""

import json
import subprocess
import sys
import time

import numpy as np

TOL = 1e-5
N_RAYS = 1 << 20
RENDER = dict(width=1024, height=1024, spp=16, max_bounce=4)
SMALL = dict(width=64, height=64, spp=4, max_bounce=4)
# CPU vs card render gate. Paths are identical up to float rounding
# (transcendentals differ by an ulp between torch's CPU and CUDA math);
# a rare flipped branch changes one path of one pixel, so the gate allows
# a few diverged pixels but not a systematic difference.
GATE_RMSE = 0.02
GATE_DIVERGED_FRACTION = 0.01


def _timed(fn, reps):
    """Mean ms of fn() over reps launches after one warm-up (CUDA events)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rays_inside(rng, n, lo, hi):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return rng.uniform(lo, hi, (n, 3)), d


def _random_soup(rng, n):
    """n small random triangles in [-1, 1]^3 with random winding flips."""
    v0 = rng.uniform(-1.0, 1.0, (n, 3))
    tab = np.concatenate([v0, v0 + rng.normal(0.0, 0.15, (n, 3)),
                          v0 + rng.normal(0.0, 0.15, (n, 3)),
                          np.arange(n)[:, None], np.zeros((n, 1)),
                          rng.integers(0, 2, (n, 1))], axis=1)
    return tab.astype(np.float32)


def _camera_rays(cam, width, height, device):
    import torch

    from directcomputeraytracing_tpu_torch.camera.camera import generate_ray

    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    film = torch.stack([(xs.reshape(-1) + 0.5) / width,
                        (ys.reshape(-1) + 0.5) / height], dim=-1)
    return generate_ray(cam, film, torch.zeros(film.shape[0], 3,
                                               device=device))


def compare_kernels(tab, o, d, t_max, t_min, watertight):
    """Kernel vs twin on one ray set; returns the mismatch report."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute

    scene = _SoupScene(tab)
    k = brute.brute_closest(scene, o, d, t_min, watertight)
    w = brute.brute_closest_torch(tab, o, d, t_min, watertight)
    occ_k = brute.brute_any(scene, o, d, t_max, t_min, watertight)
    occ_w = brute.brute_any_torch(tab, o, d, t_max, t_min, watertight)
    torch.cuda.synchronize()
    (tk, uk, vk, trik, instk, backk), (tw, uw, vw, triw, instw, backw) = k, w
    hk, hw = torch.isfinite(tk), torch.isfinite(tw)

    def near(t, bound):
        """t finite and within TOL (1 + |t|) of bound."""
        return torch.isfinite(t) & ((t - bound).abs() <= TOL * (1 + t.abs()))

    hit_miss = hk != hw
    hit_miss_bad = hit_miss & ~near(torch.where(hw, tw, tk), t_min)
    both = hk & hw
    tri_diff = both & (trik != triw)
    tri_bad = tri_diff & ~near(tk, tw)
    same = both & (trik == triw)
    dt = torch.where(same, (tk - tw).abs() / (1 + tw.abs()), 0.0)
    du = torch.where(same, (uk - uw).abs(), 0.0)
    dv = torch.where(same, (vk - vw).abs(), 0.0)
    attr_bad = same & ((instk != instw) | (backk != backw))
    occ_diff = occ_k != occ_w
    # an occlusion flip is explained when the nearest hit above t_min sits
    # at t_max (or t_min) within the bound
    tm = torch.as_tensor(t_max, device=o.device).expand(o.shape[:1])
    occ_bad = occ_diff & ~(near(tw, tm) | near(tw, t_min))
    rep = dict(rays=o.shape[0], tris=tab.shape[0],
               watertight=bool(watertight),
               hits=int(hw.sum()), occluded=int(occ_w.sum()),
               hit_miss_diff=int(hit_miss.sum()),
               hit_miss_unexplained=int(hit_miss_bad.sum()),
               tri_diff=int(tri_diff.sum()),
               tri_unexplained=int(tri_bad.sum()),
               inst_or_back_diff=int(attr_bad.sum()),
               max_rel_dt=float(dt.max()), max_du=float(du.max()),
               max_dv=float(dv.max()),
               occ_diff=int(occ_diff.sum()),
               occ_unexplained=int(occ_bad.sum()))
    rep["ok"] = (rep["hit_miss_unexplained"] == 0 and rep["tri_unexplained"]
                 == 0 and rep["inst_or_back_diff"] == 0
                 and rep["occ_unexplained"] == 0
                 and max(rep["max_rel_dt"], rep["max_du"], rep["max_dv"])
                 <= TOL)
    rep["closest_max_abs_err"] = float(max(
        torch.where(same, (tk - tw).abs(), 0.0).max(), du.max(), dv.max()))
    rep["any_max_abs_err"] = float(occ_diff.float().max())
    return rep


class _SoupScene:
    """The two fields the dense sweep reads, from a (B, 12) table."""

    def __init__(self, tab):
        self.world_tris = tab[:, 0:9]
        self.world_tri_meta = tab[:, 9:12]


def phase_kernels(device):
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

    rng = np.random.default_rng(20261016)
    scene, cam = cornell_box("area", "glossy")
    arrays, _ = flatten_scene(scene, device)
    cornell_tab = brute.build_table(arrays)
    o_cam, d_cam = _camera_rays(to_device(cam, device), 1024, 1024, device)
    o_in, d_in = _rays_inside(rng, N_RAYS, [-0.95, 0.05, -0.95],
                              [0.95, 1.95, 0.95])
    o_soup, d_soup = _rays_inside(rng, N_RAYS, -1.5, 1.5)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    cases = {
        "cornell32": (cornell_tab, torch.cat([o_cam, f32(o_in)]),
                      torch.cat([d_cam, f32(d_in)]),
                      f32(rng.uniform(0.05, 4.0, 2 * N_RAYS))),
        "soup2048": (f32(_random_soup(rng, 2048)), f32(o_soup), f32(d_soup),
                     f32(rng.uniform(0.05, 3.0, N_RAYS))),
    }
    reports, times = [], {}
    t_min = 1e-4
    for name, (tab, o_all, d_all, t_max_all) in cases.items():
        scene_like = _SoupScene(tab)
        # timed at the main path's cast size: one ray per pixel of 1024^2
        # (for Cornell, the camera rays)
        o, d, t_max = o_all[:N_RAYS], d_all[:N_RAYS], t_max_all[:N_RAYS]
        for wt in (False, True):
            rep = compare_kernels(tab, o_all, d_all, t_max_all, t_min, wt)
            rep["case"] = name
            reports.append(rep)
            print("kernel-vs-twin", json.dumps(rep))
            tag = f"{name}_{'watertight' if wt else 'moeller'}"
            times[tag] = dict(
                closest_ms=_timed(lambda: brute.brute_closest(
                    scene_like, o, d, t_min, wt), 10),
                closest_twin_ms=_timed(lambda: brute.brute_closest_torch(
                    tab, o, d, t_min, wt), 2),
                any_ms=_timed(lambda: brute.brute_any(
                    scene_like, o, d, t_max, t_min, wt), 10),
                any_twin_ms=_timed(lambda: brute.brute_any_torch(
                    tab, o, d, t_max, t_min, wt), 2))
            print("timing", tag, f"rays={o.shape[0]} tris={tab.shape[0]}",
                  json.dumps(times[tag]))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel/twin mismatch beyond tolerance: {bad}")
    return reports, times


def phase_render(device):
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box

    scene, cam = cornell_box("area", "glossy")
    p = RENDER
    r = Renderer(scene, cam, p["width"], p["height"],
                 max_bounce=p["max_bounce"], device=device)
    # warm-up: the timed call itself, so that the allocator's growth for
    # the fused pass falls outside the timed window
    r.render(spp=p["spp"])
    r.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    brute.brute_closest.launches = 0
    brute.brute_any.launches = 0
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(brute_closest=brute.brute_closest.launches,
                    brute_any=brute.brute_any.launches)
    expect = dict(
        brute_closest=p["spp"] * (p["max_bounce"] + 2) * r.n_chunks,
        brute_any=p["spp"] * (p["max_bounce"] + 1) * r.n_chunks)
    post = r.postprocessed()
    stats = dict(shape=list(img.shape), finite=bool(np.isfinite(img).all()),
                 mean=float(img.mean()), max=float(img.max()),
                 ms_per_spp=1000.0 * seconds / p["spp"],
                 total_s=seconds, chunks=r.n_chunks,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 post_mean=float(post.mean()), post_min=float(post.min()),
                 post_max=float(post.max()),
                 post_finite=bool(np.isfinite(post).all()),
                 launches=launches, expected_launches=expect)
    print("render", json.dumps(stats))
    if not (stats["finite"] and stats["post_finite"] and stats["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit("render output is not a finite, non-black image")
    if launches != expect:
        raise SystemExit(f"launch counts {launches} != expected {expect}")
    return stats


def phase_cpu_vs_card(device):
    import torch

    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box

    p = SMALL
    imgs = {}
    for dev in (torch.device("cpu"), device):
        scene, cam = cornell_box("area", "glossy")
        r = Renderer(scene, cam, p["width"], p["height"],
                     max_bounce=p["max_bounce"], device=dev)
        imgs[dev.type] = r.render(spp=p["spp"])
    a, b = imgs["cpu"], imgs[device.type]
    rmse = float(np.sqrt(((a - b) ** 2).mean()))
    diverged = float((np.abs(a - b).max(-1) > 1e-3 * (1.0 + np.abs(a).max(-1)))
                     .mean())
    rep = dict(rmse=rmse, gate_rmse=GATE_RMSE, diverged_pixels=diverged,
               gate_diverged=GATE_DIVERGED_FRACTION, mean_cpu=float(a.mean()),
               mean_card=float(b.mean()))
    print("cpu-vs-card", json.dumps(rep))
    if rmse > GATE_RMSE or diverged > GATE_DIVERGED_FRACTION:
        raise SystemExit("card render differs from the CPU render")
    return rep


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    device = torch.device("cuda")

    from directcomputeraytracing_tpu_torch.accel import brute

    built = brute.kernels()
    print(f"build: brute_sweep.cu -> {built.path} in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())

    reports, times = phase_kernels(device)
    stats = phase_render(device)
    phase_cpu_vs_card(device)
    if "jax" in sys.modules:
        raise SystemExit("the port imported jax")

    src = "directcomputeraytracing_tpu_torch/csrc/brute_sweep.cu"
    top = times["cornell32_moeller"]   # the main path's scene and test
    print(json.dumps({"kernels": [
        {"name": "brute_closest", "route": "cuda", "source": src,
         "replaces": "directcomputeraytracing_tpu/accel/pallas_brute.py:128",
         "launches": stats["launches"]["brute_closest"],
         "max_abs_err": max(r["closest_max_abs_err"] for r in reports),
         "ms": top["closest_ms"], "plain_ms": top["closest_twin_ms"]},
        {"name": "brute_any", "route": "cuda", "source": src,
         "replaces": "directcomputeraytracing_tpu/accel/pallas_brute.py:179",
         "launches": stats["launches"]["brute_any"],
         "max_abs_err": max(r["any_max_abs_err"] for r in reports),
         "ms": top["any_ms"], "plain_ms": top["any_twin_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
