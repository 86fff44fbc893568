"""What `chip_smoke.py` and the kernel tools share: the seeded ray sets
of the sphere grids, the random soup and row-major camera rays of the
dense sweep, spread ray blocks, CUDA-event timing, bit and sweep-state diffs and
the culls' and the dense sweep's bounds.

`grid_ray_sets` draws every set from one numpy generator in one fixed
order, whichever sets the caller keeps, so two callers with the same
seed and box get the same rays.
"""

import numpy as np
import torch

N_RAYS = 1 << 20
POOL_RAYS = 1 << 18                     # the default pool at 1080p x 8 spp
SET_NAMES = ("camera", "random", "shadow", "random_sorted", "pool_sorted")
SWEEP_FIELDS = ("best", "t", "u", "v", "tri", "inst", "back", "iters")
PEAK_FLOPS = 67e12                      # H100 SXM float32, no tensor cores
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
FLOPS_SLAB = 20                         # one ray-box slab test and its rule
FLOPS_MOELLER = 45                      # one Moeller ray-triangle test


def rays_inside(rng, n, lo, hi):
    """n rays (numpy float64): origins uniform in the box [lo, hi],
    directions uniform on the sphere."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return rng.uniform(lo, hi, (n, 3)), d


def random_soup(rng, n):
    """(n, 12) float32 table of n small random triangles in [-1, 1]^3
    with random winding flips."""
    v0 = rng.uniform(-1.0, 1.0, (n, 3))
    tab = np.concatenate([v0, v0 + rng.normal(0.0, 0.15, (n, 3)),
                          v0 + rng.normal(0.0, 0.15, (n, 3)),
                          np.arange(n)[:, None], np.zeros((n, 1)),
                          rng.integers(0, 2, (n, 1))], axis=1)
    return tab.astype(np.float32)


def camera_rays(cam, width, height, device):
    """Pixel-centre camera rays in row-major order (the order of a dense
    scene's render)."""
    from ..camera.camera import generate_ray

    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    film = torch.stack([(xs.reshape(-1) + 0.5) / width,
                        (ys.reshape(-1) + 0.5) / height], dim=-1)
    return generate_ray(cam, film, torch.zeros(film.shape[0], 3,
                                               device=device))


def tiled_camera_rays(cam, width, height, device):
    """Pixel-centre camera rays in the renderer's 32x32 tile order."""
    from ..camera.camera import generate_ray
    from ..integrator.common import RenderConfig
    from ..integrator.megakernel import tiled_frame_pixels

    px, py, _ = tiled_frame_pixels(RenderConfig(width=width, height=height),
                                   device)
    film = torch.stack([(px + 0.5) / width, (py + 0.5) / height], dim=-1)
    return generate_ray(cam, film.float(),
                        torch.zeros(film.shape[0], 3, device=device))


def sorted_rays(tables, o, d):
    """Rays in `ray_sort_key` order over the work-list tables' bounds, as
    the wavefront sorts its pool."""
    from ..integrator.common import ray_sort_key

    lo, hi = tables.bounds
    key = ray_sort_key(o, d, lo, 1.0 / (hi - lo).clamp_min(1e-6))
    order = torch.argsort(key, stable=True)
    return o[order].contiguous(), d[order].contiguous()


def grid_ray_sets(rng, tables, cam, device, half=18.0, shadow_half=9.0,
                  names=SET_NAMES):
    """The ray sets of a sphere grid, name -> (o, d, t_max) float32 on
    device, for the names kept (all drawn from rng in one order):

    - camera: the 1024^2 pixel-centre rays of cam in tile order;
    - random: N_RAYS rays from inside the scene box [-half, half] x
      [0.01, 6.9] x [-half, half];
    - shadow: N_RAYS rays from [-shadow_half, shadow_half] x [0.01, 1.5]
      x [-shadow_half, shadow_half] towards random points of the lamp
      (y = 7, |x|, |z| <= 2), t_max 0.999 of the distance;
    - random_sorted: the random set in `ray_sort_key` order (tables'
      bounds);
    - pool_sorted: POOL_RAYS more random rays, sorted likewise.

    The other sets' t_max are uniform in [0.5, 30)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = [-half, 0.01, -half], [half, 6.9, half]
    side = int(np.sqrt(N_RAYS))
    o_in, d_in = (f32(x) for x in rays_inside(rng, N_RAYS, lo, hi))
    o_sh = rng.uniform([-shadow_half, 0.01, -shadow_half],
                       [shadow_half, 1.5, shadow_half], (N_RAYS, 3))
    to_lamp = rng.uniform([-2.0, 7.0, -2.0], [2.0, 7.0, 2.0],
                          (N_RAYS, 3)) - o_sh
    dist = np.linalg.norm(to_lamp, axis=1)
    o_pool, d_pool = (f32(x) for x in rays_inside(rng, POOL_RAYS, lo, hi))
    t_max = {name: f32(rng.uniform(0.5, 30.0, n)) for name, n in (
        ("camera", N_RAYS), ("random", N_RAYS), ("random_sorted", N_RAYS),
        ("pool_sorted", POOL_RAYS))}
    sets = {}
    if "camera" in names:
        o_cam, d_cam = tiled_camera_rays(cam, side, side, device)
        sets["camera"] = (o_cam.contiguous(), d_cam.contiguous(),
                          t_max["camera"])
    if "random" in names:
        sets["random"] = (o_in, d_in, t_max["random"])
    if "shadow" in names:
        sets["shadow"] = (f32(o_sh), f32(to_lamp / dist[:, None]),
                          f32(0.999 * dist))
    if "random_sorted" in names:
        sets["random_sorted"] = (*sorted_rays(tables, o_in, d_in),
                                 t_max["random_sorted"])
    if "pool_sorted" in names:
        sets["pool_sorted"] = (*sorted_rays(tables, o_pool, d_pool),
                               t_max["pool_sorted"])
    return sets


def spread_blocks(n_rays, n_blocks, device, rb):
    """Indices of the rays of n_blocks rb-ray blocks (the work list's RB)
    spread evenly over n_rays rays."""
    nb = n_rays // rb
    blocks = torch.arange(0, nb, max(1, nb // n_blocks),
                          device=device)[:n_blocks]
    return (blocks[:, None] * rb
            + torch.arange(rb, device=device)).reshape(-1)


def timed(fn, reps, warm=True):
    """Mean ms of fn() over reps launches, after one warm-up launch unless
    warm is False (CUDA events)."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, entry, tries=3):
    """Mean device ms of one launch of the kernels whose name holds
    `entry`, over reps calls of fn (each launching one of them) after a
    warm-up, by torch.profiler: the kernels' own time, without the host's
    gaps between launches that CUDA events around a run of short launches
    count. The mean is over the launches the profiler caught with a span
    of positive length (it drops a run's events now and then, and within
    one process has also reported an empty span beside each launch); a
    run that reports more such spans than launches is not read. None if
    no run of `tries` gave one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and entry in e.name]
        spans = [t for t in spans if t > 0]
        if 0 < len(spans) <= reps:
            return sum(spans) / 1000.0 / len(spans)
    return None


def bit_diff(a, b):
    """Elements whose bits differ (a float32's zero sign included); -1
    when the shapes differ."""
    if a.shape != b.shape:
        return -1
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def sweep_diffs(a, b, n=len(SWEEP_FIELDS)):
    """Per field of the first n of a sweep state, the count of rays whose
    bits differ."""
    return {SWEEP_FIELDS[i]: int((a[i] != b[i]).sum()) for i in range(n)}


def bound(flops, nbytes):
    """(bound_ms, bound_by) of work of `flops` operations moving `nbytes`
    on an H100 SXM: the larger of the two times at the card's peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def cull_bound(rp, n_boxes, rb):
    """The bound of a cull of rp rays (rb a ray block) against n_boxes
    boxes: FLOPS_SLAB per (ray, box); each ray (28 bytes: o, 1/d, t_max;
    the slab test reads no direction), box (24: lo, hi) and output (4 a
    (block, box)) moved once."""
    return bound(FLOPS_SLAB * rp * n_boxes,
                 28 * rp + 24 * n_boxes + 4 * n_boxes * (rp // rb))


def refine_bound(rp, hsup, n_items, rb):
    """The bound of a refine of n_items (block, hyper) items over rp rays
    against the (nh, hs, 8) member boxes hsup: FLOPS_SLAB per (ray of the
    item's block, member); each ray (28 bytes, as `cull_bound`'s),
    member box (24), item (block and hyper) and output moved once."""
    hs = hsup.shape[1]
    return bound(FLOPS_SLAB * n_items * rb * hs,
                 28 * rp + 24 * hsup.shape[0] * hs + (8 + 4 * hs) * n_items)


def dense_bound(kind, rays, tris):
    """The bound of a dense cast ("closest" or "any") of rays against a
    table of tris rows: FLOPS_MOELLER per pair (the watertight test costs
    more); each ray (24 bytes, and t_max for any-hit), output (21 bytes
    closest, 1 any-hit) and row (48) moved once."""
    per_ray = 45 if kind == "closest" else 29
    return bound(FLOPS_MOELLER * rays * tris, per_ray * rays + 48 * tris)
