"""BSDF evaluation and sampling: hand-written CUDA kernels on CUDA tensors.

The integrators call these two functions. On CUDA tensors each launches
one kernel of `csrc/bsdf.cu` (built with nvcc on first use, loaded with
ctypes, launched on PyTorch's current stream) and counts the launch (a
call recorded into a CUDA graph under capture launches nothing then and
is not counted; its replays are not counted either):
`evaluate_bsdf_value_pdf` runs `bsdf_eval_kernel`, which returns NEE's
value and pdf together, and `sample_bsdf` runs `bsdf_sample_kernel`. On
any other device they call `dispatch`'s functions unchanged, which are
the CPU path and the kernels' twin: the same formulas in the same order,
so the two agree to the rounding of sin, cos and atan (the kernels are
built with -fmad=false, in float32).

The kernels read the Intersection fields in the dtypes `shade_hit` makes
(float32; bool; internal_mode and material_type int64) through their row
strides, so a strided view such as the material rows' `ior` is read in
place; a field of another dtype, or one whose components are not
adjacent, is converted first (one op). The LUTs must be contiguous
float32 on the lanes' device.
"""

import ctypes

import torch

from . import dispatch

# -fmad=false: products and sums round separately, as the twin's ops do
_NVCC_EXTRA = ("-fmad=false",)
_built = None

# the kernels' per-lane inputs, in the order of `Field` in csrc/bsdf.cu:
# (name, columns, dtype); the Intersection's fields by their own names
FIELDS = (("wo", 3, torch.float32), ("wi", 3, torch.float32),
          ("u2", 2, torch.float32), ("u_sel", 0, torch.float32),
          ("tangent", 3, torch.float32), ("normal", 3, torch.float32),
          ("albedo", 3, torch.float32), ("alpha", 0, torch.float32),
          ("ior", 3, torch.float32), ("is_two_sided", 0, torch.bool),
          ("multiscattering", 0, torch.bool),
          ("internal_mode", 0, torch.int64),
          ("material_type", 0, torch.int64))
_ITX_FIELDS = ("tangent", "normal", "albedo", "alpha", "ior", "is_two_sided",
               "multiscattering", "internal_mode", "material_type")


def kernels():
    """The loaded kernel library (built on first call); `.seconds` and
    `.log` describe the build."""
    global _built
    if _built is None:
        from ..utils.cuda_build import load_library

        built = load_library("bsdf.cu", _NVCC_EXTRA)
        bind(built.lib)
        _built = built
    return _built


def bind(lib):
    """Set the C interface's argument and result types on a loaded
    library (the nvcc build, or the host build of the CPU tests)."""
    c_p, c_i = ctypes.c_void_p, ctypes.c_int
    head = [ctypes.POINTER(c_p), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(c_p), ctypes.POINTER(c_i), c_i, c_i]
    lib.dcrt_bsdf_eval.argtypes = head + [c_p] * 3
    lib.dcrt_bsdf_sample.argtypes = head + [c_p] * 5
    lib.dcrt_bsdf_eval.restype = c_i
    lib.dcrt_bsdf_sample.restype = c_i


def _lane_args(inputs, n):
    """(pointers, row strides) of the per-lane inputs {name: tensor} in
    FIELDS order, a null pointer for a missing one, and the tensors they
    point into, which the caller holds until the launch."""
    ptrs = (ctypes.c_void_p * len(FIELDS))()
    strides = (ctypes.c_longlong * len(FIELDS))()
    keep = []
    for k, (name, cols, dtype) in enumerate(FIELDS):
        x = inputs.get(name)
        if x is None:
            continue
        shape = (n, cols) if cols else (n,)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: need shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtype:
            x = x.to(dtype)
        if cols and x.stride(1) != 1:
            x = x.contiguous()
        keep.append(x)
        ptrs[k] = x.data_ptr()
        strides[k] = x.stride(0)
    return ptrs, strides, keep


def _lut_args(luts, device):
    """(pointers, sizes) of the six tables in BxDFLuts order, as
    csrc/bsdf.cu's `Table` and `kDims` have them."""
    tabs = (ctypes.c_void_p * len(luts))()
    for k, (name, t) in enumerate(zip(luts._fields, luts)):
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"luts.{name}: need a contiguous float32 tensor "
                             f"on {device}")
        tabs[k] = t.data_ptr()
    sizes = (tuple(luts.brdf.shape) + tuple(luts.brdf_avg.shape)
             + tuple(luts.brdf_dielectric.shape[1:])
             + tuple(luts.brdf_dielectric_avg.shape[1:])
             + tuple(luts.bsdf.shape[1:]) + tuple(luts.bsdf_avg.shape[1:]))
    return tabs, (ctypes.c_int * len(sizes))(*sizes)


def _inputs(itx, device, **lanes):
    out = dict(lanes, **{name: getattr(itx, name) for name in _ITX_FIELDS})
    for name, x in out.items():
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, wo on {device}")
    return out


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def launch_eval(lib, luts, wi, wo, itx, use_vndf, stream=None):
    """Run a library's `dcrt_bsdf_eval` over the lanes: (error, (value
    (R, 3), pdf (R,))). stream None: the host build's (no stream)."""
    n = wo.shape[0]
    ptrs, strides, keep = _lane_args(_inputs(itx, wo.device, wo=wo, wi=wi),
                                     n)
    tabs, sizes = _lut_args(luts, wo.device)
    value = torch.empty((n, 3), dtype=torch.float32, device=wo.device)
    pdf = torch.empty(n, dtype=torch.float32, device=wo.device)
    err = lib.dcrt_bsdf_eval(ptrs, strides, tabs, sizes, n, int(use_vndf),
                             value.data_ptr(), pdf.data_ptr(), stream)
    return err, (value, pdf)


def launch_sample(lib, luts, wo, u2, u_sel, itx, use_vndf, stream=None):
    """Run a library's `dcrt_bsdf_sample` over the lanes: (error, (wi_w
    (R, 3), value (R, 3), pdf (R,), is_delta (R,) bool))."""
    n = wo.shape[0]
    ptrs, strides, keep = _lane_args(
        _inputs(itx, wo.device, wo=wo, u2=u2, u_sel=u_sel), n)
    tabs, sizes = _lut_args(luts, wo.device)
    f32 = dict(dtype=torch.float32, device=wo.device)
    wi = torch.empty((n, 3), **f32)
    value = torch.empty((n, 3), **f32)
    pdf = torch.empty(n, **f32)
    is_delta = torch.empty(n, dtype=torch.bool, device=wo.device)
    err = lib.dcrt_bsdf_sample(ptrs, strides, tabs, sizes, n, int(use_vndf),
                               wi.data_ptr(), value.data_ptr(),
                               pdf.data_ptr(), is_delta.data_ptr(), stream)
    return err, (wi, value, pdf, is_delta)


def _launched():
    """1 where a call on the current stream launched its kernel, 0 where
    a CUDA graph capture recorded it."""
    return 0 if torch.cuda.is_current_stream_capturing() else 1


def evaluate_bsdf_value_pdf(luts, wi, wo, itx, use_vndf=True):
    """NEE's f(wi, wo) (R, 3) and the pdf of sampling wi (R,), as
    `dispatch.evaluate_bsdf` and `dispatch.evaluate_bsdf_pdf` give them:
    one `bsdf_eval_kernel` launch on CUDA tensors."""
    if wo.device.type != "cuda":
        return (dispatch.evaluate_bsdf(luts, wi, wo, itx, use_vndf),
                dispatch.evaluate_bsdf_pdf(luts, wi, wo, itx, use_vndf))
    with torch.cuda.device(wo.device):
        err, out = launch_eval(kernels().lib, luts, wi, wo, itx, use_vndf,
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "bsdf_eval")
    evaluate_bsdf_value_pdf.launches += _launched()
    return out


def sample_bsdf(luts, wo, u2, u_sel, itx, use_vndf=True):
    """Sample wi given wo: (wi_w (R, 3), value (R, 3), pdf (R,), is_delta
    (R,) bool), as `dispatch.sample_bsdf` gives them, consuming exactly
    (u_sel, u2): one `bsdf_sample_kernel` launch on CUDA tensors."""
    if wo.device.type != "cuda":
        return dispatch.sample_bsdf(luts, wo, u2, u_sel, itx, use_vndf)
    with torch.cuda.device(wo.device):
        err, out = launch_sample(kernels().lib, luts, wo, u2, u_sel, itx,
                                 use_vndf,
                                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "bsdf_sample")
    sample_bsdf.launches += _launched()
    return out


evaluate_bsdf_value_pdf.launches = 0
sample_bsdf.launches = 0
