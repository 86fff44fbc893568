"""Dense sweep over the world-triangle soup: the CUDA kernels and their twins.

Counterpart of the dense half of `directcomputeraytracing_tpu.accel.
pallas_brute` (`brute_closest_pallas`, `brute_any_pallas`). Each ray is
tested against every triangle of the (B, 12) table [v0 v1 v2 | tri id |
inst id | flip], B <= 2048 on dense scenes (the `"brute"` and `"pallas"`
backends sweep larger soups too).

`brute_closest` and `brute_any` are the wrappers the integrator calls. On
a CUDA tensor they launch the hand-written kernels of `csrc/brute_sweep.cu`
(built with nvcc on first use, loaded with ctypes) and count the launch;
on a CPU tensor they run the plain PyTorch twins `brute_closest_torch` and
`brute_any_torch`, the counterpart of the reference's `traverse._brute`.
Any other device raises. The twins sweep 128-triangle slabs in table
order, keep the first minimum per slab and replace the best hit only when
strictly nearer, so they and the kernels follow the same tie rule.

The table (`table`) and the kernels' prepared rows (`prepared_rows`) are
built once per scene and cached on its `world_tris`. The kernels sieve
every pair without a division and run the whole test only on the pairs
that pass (`moeller_sieve_torch` and `watertight_sieve_torch` mirror the
sieves); a sieve rejects only pairs that the whole test rejects, so the
results keep the twins' bits.
"""

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .traverse import _cross, _xyz, ray_triangle_moeller, \
    ray_triangle_watertight

TRI_SLAB = 128
TWIN_RAY_CHUNK = 1 << 18   # bounds the twin's (rays, slab) temporaries
BIG = 3.0e38
SIEVE_MARGIN = 2.0 ** -20  # the Moeller sieve's slack, a fraction of |det|

# -fmad=false: products and sums round separately, exactly as in the
# twins, so kernel and twin agree bit for bit (a later PR may trade this
# for FMA speed and compare with a tolerance instead)
_NVCC_EXTRA = ("-fmad=false",)
_built = None
_TABLES = WeakIdKeyDictionary()
# the kernels in `dcrt_brute_resources` order
KERNELS = ("closest_moeller", "closest_watertight", "any_moeller",
           "any_watertight")


def build_table(scene):
    """(B, 12) f32 table: world_tris | world_tri_meta."""
    return torch.cat([scene.world_tris, scene.world_tri_meta], dim=1) \
        .contiguous()


def prepare_rows(tab, watertight):
    """The kernels' (B, 12) rows of table tab, 16-byte aligned, in the
    twins' own float arithmetic (`ray_triangle_moeller`,
    `ray_triangle_watertight`): Moeller (v0, 0 | v1 - v0, 0 | v2 - v0, 0);
    watertight (v0, degenerate | v1, 0 | v2, 0), degenerate 1 where the
    squared cross product of the edges is 0. The same rows as
    `Moeller::stage` / `Watertight::stage` of csrc/ray_tri.cuh write for
    the other sweeps: change the two together."""
    v0, v1, v2 = tab[:, 0:3], tab[:, 3:6], tab[:, 6:9]
    zero = torch.zeros_like(tab[:, :1])
    if watertight:
        cx, cy, cz = _cross(*_xyz(v1 - v0), *_xyz(v2 - v0))
        deg = (cx * cx + cy * cy + cz * cz == 0.0).to(tab.dtype)
        parts = (v0, deg[:, None], v1, zero, v2, zero)
    else:
        parts = (v0, zero, v1 - v0, zero, v2 - v0, zero)
    return torch.cat(parts, dim=1).contiguous()


def _entry(scene):
    """The scene's cache entry, kept for as long as its `world_tris`
    lives (rebuilt if its `world_tri_meta` is another tensor)."""
    entry = _TABLES.get(scene.world_tris)
    if entry is None or entry["meta"] is not scene.world_tri_meta:
        entry = dict(meta=scene.world_tri_meta, tab=build_table(scene))
        _TABLES[scene.world_tris] = entry
    return entry


def table(scene):
    """The scene's (B, 12) table (`build_table`), built once per scene."""
    return _entry(scene)["tab"]


def prepared_rows(scene, watertight):
    """The kernels' rows of the scene's table (`prepare_rows`), built once
    per scene and test."""
    entry = _entry(scene)
    key = "watertight" if watertight else "moeller"
    if key not in entry:
        entry[key] = prepare_rows(entry["tab"], watertight)
    return entry[key]


def kernels():
    """The loaded kernel library (built on first call); `.seconds` and
    `.log` describe the build."""
    global _built
    if _built is None:
        from ..utils.cuda_build import load_library

        built = load_library("brute_sweep.cu", _NVCC_EXTRA)
        bind(built.lib)
        _built = built
    return _built


def bind(lib):
    """Set the C interface's argument and result types on a loaded
    library."""
    c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dcrt_brute_closest.argtypes = [c_p, c_p, c_i, c_p, c_p, c_i, c_f,
                                       c_i] + [c_p] * 7
    lib.dcrt_brute_any.argtypes = [c_p, c_i, c_p, c_p, c_p, c_i, c_f, c_i,
                                   c_p, c_p]
    lib.dcrt_brute_resources.argtypes = [c_p]
    for fn in (lib.dcrt_brute_closest, lib.dcrt_brute_any,
               lib.dcrt_brute_resources):
        fn.restype = c_i


def resources():
    """The kernels' resources on the current card, per kernel of KERNELS
    (closest / any, Moeller / watertight):
    resident blocks per SM with a full resident table (2048 rows),
    registers, static shared bytes, local (spill) bytes per thread and
    threads per block."""
    out = (ctypes.c_int * (5 * len(KERNELS)))()
    _raise_on(kernels().lib.dcrt_brute_resources(out), "brute_resources")
    keys = ("blocks_per_sm", "registers", "static_smem", "local_bytes",
            "threads")
    return {name: dict(zip(keys, out[5 * f:5 * f + 5]))
            for f, name in enumerate(KERNELS)}


# ---------------------------------------------------------------------------
# the kernels' sieves, mirrored
# ---------------------------------------------------------------------------

def moeller_sieve_torch(o, d, v0, v1, v2):
    """The Moeller kernels' sieve over broadcastable (..., 3) rays and
    triangles: False where a pair is rejected before the whole test (the
    proof is in csrc/brute_sweep.cu `MoellerSieve`): det_ok fails, or
    with U = un sign(det) and D = |det|, U < -D 2^-20 or
    U > D (1 + 2^-20) (or U is NaN). The arithmetic of `ray_triangle_moeller` up
    to u's numerator un, in its order."""
    ox, oy, oz = _xyz(o)
    dx, dy, dz = _xyz(d)
    v0x, v0y, v0z = _xyz(v0)
    e1x, e1y, e1z = (a - b for a, b in zip(_xyz(v1), (v0x, v0y, v0z)))
    e2x, e2y, e2z = (a - b for a, b in zip(_xyz(v2), (v0x, v0y, v0z)))
    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)
    det = e1x * px + e1y * py + e1z * pz
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    un = tx * px + ty * py + tz * pz
    ad = torch.abs(det)
    us = torch.where(torch.signbit(det), -un, un)   # the kernel's sign flip
    return ((ad >= 1e-10) & (us >= ad * -SIEVE_MARGIN)
            & (us <= ad * (1.0 + SIEVE_MARGIN)))


def watertight_sieve_torch(o, d, v0, v1, v2):
    """The watertight kernels' sieve over broadcastable (..., 3) rays and
    triangles: False where a pair is rejected before the whole test, which
    is where `ray_triangle_watertight`'s own `mixed`, `det_ok` or
    `degenerate` rejects it; its arithmetic, in its order."""
    ox, oy, oz = _xyz(o)
    dx, dy, dz = _xyz(d)
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    kz = torch.where((ax >= ay) & (ax >= az), 0,
                     torch.where(ay >= az, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)

    def pick(x, y, z, k):
        return torch.where(k == 0, x, torch.where(k == 1, y, z))

    d_z = pick(dx, dy, dz, kz)
    inv_z = 1.0 / torch.where(torch.abs(d_z) < 1e-30, 1e-30, d_z)
    sx = -pick(dx, dy, dz, kx) * inv_z
    sy = -pick(dx, dy, dz, ky) * inv_z

    def shear(vtx):
        vx, vy, vz = _xyz(vtx)
        q = (vx - ox, vy - oy, vz - oz)
        pz = pick(*q, kz)
        return pick(*q, kx) + sx * pz, pick(*q, ky) + sy * pz

    (p0x, p0y), (p1x, p1y), (p2x, p2y) = shear(v0), shear(v1), shear(v2)
    e0 = p1x * p2y - p2x * p1y
    e1 = p2x * p0y - p0x * p2y
    e2 = p0x * p1y - p1x * p0y
    mixed = (((e0 < 0.0) | (e1 < 0.0) | (e2 < 0.0))
             & ((e0 > 0.0) | (e1 > 0.0) | (e2 > 0.0)))
    cx, cy, cz = _cross(*(a - b for a, b in zip(_xyz(v1), _xyz(v0))),
                        *(a - b for a, b in zip(_xyz(v2), _xyz(v0))))
    degenerate = cx * cx + cy * cy + cz * cz == 0.0
    return ~mixed & (e0 + e1 + e2 != 0.0) & ~degenerate


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _slab_test(tab, o, d, t_min, t_max, watertight):
    """(R, S) test of rays o, d (R, 3) against table rows tab (S, 12);
    t_max (R, 1) or scalar."""
    test = ray_triangle_watertight if watertight else ray_triangle_moeller
    return test(o[:, None, :], d[:, None, :], t_min, t_max,
                tab[None, :, 0:3], tab[None, :, 3:6], tab[None, :, 6:9])


def _closest_rays(tab, o, d, t_min, watertight):
    r = o.shape[0]
    t_b = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    u_b = torch.zeros_like(t_b)
    v_b = torch.zeros_like(t_b)
    row_b = torch.zeros(r, dtype=torch.int64, device=o.device)
    back_b = torch.zeros(r, dtype=torch.bool, device=o.device)
    for base in range(0, tab.shape[0], TRI_SLAB):
        slab = tab[base:base + TRI_SLAB]
        t, u, v, back, ok = _slab_test(slab, o, d, t_min, t_b[:, None],
                                       watertight)
        tm = torch.where(ok, t, BIG)
        j = torch.argmin(tm, dim=1, keepdim=True)   # first minimum
        slab_min = tm.gather(1, j)[:, 0]
        better = slab_min < t_b
        t_b = torch.where(better, slab_min, t_b)
        u_b = torch.where(better, u.gather(1, j)[:, 0], u_b)
        v_b = torch.where(better, v.gather(1, j)[:, 0], v_b)
        back_b = torch.where(better, back.gather(1, j)[:, 0], back_b)
        row_b = torch.where(better, base + j[:, 0], row_b)
    hit = t_b < BIG
    meta = tab[row_b, 9:12]
    return (torch.where(hit, t_b, float("inf")), u_b, v_b,
            torch.where(hit, meta[:, 0], 0.0).to(torch.int32),
            torch.where(hit, meta[:, 1], 0.0).to(torch.int32),
            hit & (back_b ^ (meta[:, 2] > 0.5)))


def brute_closest_torch(tab, origin, direction, t_min=0.0, watertight=False):
    """Twin of the closest kernel: (t, +inf on miss; u; v; tri i32;
    inst i32; back bool)."""
    parts = [_closest_rays(tab, origin[i:i + TWIN_RAY_CHUNK],
                           direction[i:i + TWIN_RAY_CHUNK], t_min, watertight)
             for i in range(0, origin.shape[0], TWIN_RAY_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*parts))


def brute_any_torch(tab, origin, direction, t_max, t_min=0.0,
                    watertight=False):
    """Twin of the any-hit kernel: (R,) bool, a hit in [t_min, t_max)."""
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    t_max = t_max.expand(origin.shape[:1])
    out = []
    for i in range(0, origin.shape[0], TWIN_RAY_CHUNK):
        o = origin[i:i + TWIN_RAY_CHUNK]
        d = direction[i:i + TWIN_RAY_CHUNK]
        tm = t_max[i:i + TWIN_RAY_CHUNK, None]
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for base in range(0, tab.shape[0], TRI_SLAB):
            ok = _slab_test(tab[base:base + TRI_SLAB], o, d, t_min, tm,
                            watertight)[4]
            occ = occ | ok.any(dim=1)
        out.append(occ)
    return torch.cat(out)


# ---------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, twin on CPU tensors
# ---------------------------------------------------------------------------

def _check(tab, origin, direction):
    for name, x, cols in (("table", tab, 12), ("origin", origin, 3),
                          ("direction", direction, 3)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous (N, {cols}) float32 "
                             f"tensor, got {tuple(x.shape)} {x.dtype}")
        if x.device != origin.device:
            raise ValueError(f"{name} on {x.device}, rays on {origin.device}")
    if direction.shape[0] != origin.shape[0]:
        raise ValueError("origin and direction ray counts differ")


def _device_kind(x):
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no dense sweep for device {x.device}")
    return x.device.type


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def launch_closest(fn, tab, rows, origin, direction, t_min, watertight):
    """Launch a build's closest entry fn (`dcrt_brute_closest`) on CUDA
    tensors: (CUDA error, (t, u, v, tri, inst, back))."""
    r = origin.shape[0]
    f32 = dict(dtype=torch.float32, device=origin.device)
    i32 = dict(dtype=torch.int32, device=origin.device)
    t, u, v = (torch.empty(r, **f32) for _ in range(3))
    tri, inst = torch.empty(r, **i32), torch.empty(r, **i32)
    back = torch.empty(r, dtype=torch.bool, device=origin.device)
    with torch.cuda.device(origin.device):   # the launch targets the
        err = fn(                            # runtime's current device
            tab.data_ptr(), rows.data_ptr(), tab.shape[0], origin.data_ptr(),
            direction.data_ptr(), r, float(t_min), int(watertight),
            *(x.data_ptr() for x in (t, u, v, tri, inst, back)), _stream())
    return err, (t, u, v, tri, inst, back)


def launch_any(fn, rows, origin, direction, t_max, t_min, watertight):
    """Launch a build's any-hit entry fn (`dcrt_brute_any`) on CUDA
    tensors, t_max (R,) contiguous: (CUDA error, occluded (R,) bool)."""
    r = origin.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=origin.device)
    with torch.cuda.device(origin.device):
        err = fn(rows.data_ptr(), rows.shape[0], origin.data_ptr(),
                 direction.data_ptr(), t_max.data_ptr(), r, float(t_min),
                 int(watertight), occ.data_ptr(), _stream())
    return err, occ


def brute_closest(scene, origin, direction, t_min=0.0, watertight=False):
    """Closest hit over the world-triangle soup. Returns (t, u, v, tri,
    inst, back) with t = +inf on a miss."""
    tab = table(scene)
    _check(tab, origin, direction)
    if _device_kind(origin) == "cpu":
        return brute_closest_torch(tab, origin, direction, t_min, watertight)
    err, out = launch_closest(kernels().lib.dcrt_brute_closest, tab,
                              prepared_rows(scene, watertight), origin,
                              direction, t_min, watertight)
    _raise_on(err, "brute_closest")
    brute_closest.launches += 1
    return out


def brute_any(scene, origin, direction, t_max, t_min=0.0, watertight=False):
    """Occlusion over the world-triangle soup: (R,) bool, a hit in
    [t_min, t_max) per ray."""
    tab = table(scene)
    _check(tab, origin, direction)
    if _device_kind(origin) == "cpu":
        return brute_any_torch(tab, origin, direction, t_max, t_min,
                               watertight)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    t_max = t_max.expand(origin.shape[:1]).contiguous()
    err, occ = launch_any(kernels().lib.dcrt_brute_any,
                          prepared_rows(scene, watertight), origin, direction,
                          t_max, t_min, watertight)
    _raise_on(err, "brute_any")
    brute_any.launches += 1
    return occ


brute_closest.launches = 0
brute_any.launches = 0
