"""Dense sweep over the world-triangle soup: the CUDA kernels and their twins.

Counterpart of the dense half of `directcomputeraytracing_tpu.accel.
pallas_brute` (`brute_closest_pallas`, `brute_any_pallas`). Each ray is
tested against every triangle of the (B, 12) table [v0 v1 v2 | tri id |
inst id | flip], B <= 2048.

`brute_closest` and `brute_any` are the wrappers the integrator calls. On
a CUDA tensor they launch the hand-written kernels of `csrc/brute_sweep.cu`
(built with nvcc on first use, loaded with ctypes) and count the launch;
on a CPU tensor they run the plain PyTorch twins `brute_closest_torch` and
`brute_any_torch`, the counterpart of the reference's `traverse._brute`.
Any other device raises. The twins sweep 128-triangle slabs in table
order, keep the first minimum per slab and replace the best hit only when
strictly nearer, so they and the kernels follow the same tie rule.
"""

import ctypes

import torch

from .traverse import ray_triangle_moeller, ray_triangle_watertight

TRI_SLAB = 128
TWIN_RAY_CHUNK = 1 << 18   # bounds the twin's (rays, slab) temporaries
BIG = 3.0e38

# -fmad=false: products and sums round separately, exactly as in the
# twins, so kernel and twin agree bit for bit (a later PR may trade this
# for FMA speed and compare with a tolerance instead)
_NVCC_EXTRA = ("-fmad=false",)
_built = None


def build_table(scene):
    """(B, 12) f32 table: world_tris | world_tri_meta."""
    return torch.cat([scene.world_tris, scene.world_tri_meta], dim=1) \
        .contiguous()


def kernels():
    """The loaded kernel library (built on first call); `.seconds` and
    `.log` describe the build."""
    global _built
    if _built is None:
        from ..utils.cuda_build import load_library

        built = load_library("brute_sweep.cu", _NVCC_EXTRA)
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        built.lib.dcrt_brute_closest.argtypes = [
            c_p, c_i, c_p, c_p, c_i, c_f, c_i, c_p, c_p, c_p, c_p, c_p, c_p,
            c_p]
        built.lib.dcrt_brute_closest.restype = c_i
        built.lib.dcrt_brute_any.argtypes = [
            c_p, c_i, c_p, c_p, c_p, c_i, c_f, c_i, c_p, c_p]
        built.lib.dcrt_brute_any.restype = c_i
        _built = built
    return _built


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


def brute_closest(scene, origin, direction, t_min=0.0, watertight=False):
    """Closest hit over the world-triangle soup. Returns (t, u, v, tri,
    inst, back) with t = +inf on a miss."""
    tab = build_table(scene)
    _check(tab, origin, direction)
    if _device_kind(origin) == "cpu":
        return brute_closest_torch(tab, origin, direction, t_min, watertight)
    r = origin.shape[0]
    f32 = dict(dtype=torch.float32, device=origin.device)
    i32 = dict(dtype=torch.int32, device=origin.device)
    t, u, v = (torch.empty(r, **f32) for _ in range(3))
    tri, inst = torch.empty(r, **i32), torch.empty(r, **i32)
    back = torch.empty(r, dtype=torch.bool, device=origin.device)
    lib = kernels().lib
    with torch.cuda.device(origin.device):   # the launch targets the
        err = lib.dcrt_brute_closest(        # runtime's current device
            tab.data_ptr(), tab.shape[0], origin.data_ptr(),
            direction.data_ptr(), r, float(t_min), int(watertight),
            t.data_ptr(), u.data_ptr(), v.data_ptr(), tri.data_ptr(),
            inst.data_ptr(), back.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "brute_closest")
    brute_closest.launches += 1
    return t, u, v, tri, inst, back


def brute_any(scene, origin, direction, t_max, t_min=0.0, watertight=False):
    """Occlusion over the world-triangle soup: (R,) bool, a hit in
    [t_min, t_max) per ray."""
    tab = build_table(scene)
    _check(tab, origin, direction)
    if _device_kind(origin) == "cpu":
        return brute_any_torch(tab, origin, direction, t_max, t_min,
                               watertight)
    r = origin.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    t_max = t_max.expand(r).contiguous()
    occ = torch.empty(r, dtype=torch.bool, device=origin.device)
    lib = kernels().lib
    with torch.cuda.device(origin.device):
        err = lib.dcrt_brute_any(
            tab.data_ptr(), tab.shape[0], origin.data_ptr(),
            direction.data_ptr(), t_max.data_ptr(), r, float(t_min),
            int(watertight), occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "brute_any")
    brute_any.launches += 1
    return occ


brute_closest.launches = 0
brute_any.launches = 0
