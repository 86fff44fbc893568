"""The C++ SAH BVH builder, built with g++ on first use and loaded with
ctypes.

`bvh_builder.cpp` is the numpy builder of `accel.build` (`build_bvh`
with `use_native=False`) in C++: the same node arrays, bit for bit,
signed zeros included, from a build that does no Python work a node.
`utils.cuda_build.load_library` compiles it with g++ into the package's
git-ignored `_build/` under a name hashed from the source and the flags
(a temporary file renamed into place, so concurrent first uses are
safe); nothing is written beside the source. Unlike the reference's
loader, which falls back to numpy on any failure, a failed build or a
failed call raises: `build_bvh` chooses the builder, never this module.
"""

import ctypes
import functools
import os
import shutil
import threading

import numpy as np
import numpy.ctypeslib as npc

from ...accel.build import BVH
from ...utils.cuda_build import load_library

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = "bvh_builder.cpp"
# -ffp-contract=off and no -ffast-math: a contracted or reassociated
# float32 sum is another value than numpy's
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC")
_LOCK = threading.Lock()


def find_gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native BVH builder "
                           "needs it (DCRT_NATIVE_BVH=0 selects the numpy "
                           "builder)")
    return gxx


@functools.cache
def _load():
    built = load_library(_SOURCE, csrc=_DIR, compiler=find_gxx,
                         flags=GXX_FLAGS)
    lib = built.lib
    f32 = npc.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u32 = npc.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64 = npc.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32 = npc.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.dcrt_build_bvh.restype = ctypes.c_int
    lib.dcrt_build_bvh.argtypes = [
        f32, f32, ctypes.c_int64, ctypes.c_int32,
        f32, f32, u32, u32, i64, i32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def load_native():
    """The loaded ctypes library, built on the first call. Raises
    (RuntimeError with g++'s output) where it cannot be built."""
    with _LOCK:
        return _load()


def build_bvh_native(prim_bbox_min, prim_bbox_max, max_prims_in_node=2):
    """C++ SAH build over (n, 3) primitive boxes, node for node the numpy
    `build_bvh`: a `BVH` with float32 boxes, uint32 fields, int64
    `prim_order` and int32 `leaf_depths`. Raises ValueError on an empty
    or misshapen input and RuntimeError where the build fails."""
    pmin = np.ascontiguousarray(prim_bbox_min, np.float32)
    pmax = np.ascontiguousarray(prim_bbox_max, np.float32)
    if pmin.ndim != 2 or pmin.shape[1] != 3 or pmax.shape != pmin.shape:
        raise ValueError(f"primitive boxes must be two (n, 3) arrays, got "
                         f"{pmin.shape} and {pmax.shape}")
    n = pmin.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    lib = load_native()
    cap = 2 * n
    out_min = np.empty((cap, 3), np.float32)
    out_max = np.empty((cap, 3), np.float32)
    out_rop = np.empty(cap, np.uint32)
    out_misc = np.empty(cap, np.uint32)
    out_order = np.empty(n, np.int64)
    out_depths = np.empty(n, np.int32)
    node_count = ctypes.c_int64()
    max_depth = ctypes.c_int32()
    rc = lib.dcrt_build_bvh(pmin, pmax, n, max_prims_in_node,
                            out_min, out_max, out_rop, out_misc,
                            out_order, out_depths,
                            ctypes.byref(node_count),
                            ctypes.byref(max_depth))
    if rc != 0:
        raise RuntimeError(f"dcrt_build_bvh returned {rc} for {n} "
                           f"primitives")
    k = node_count.value
    return BVH(bbox_min=out_min[:k].copy(), bbox_max=out_max[:k].copy(),
               right_or_prim=out_rop[:k].copy(), misc=out_misc[:k].copy(),
               prim_order=out_order, max_depth=max_depth.value,
               leaf_depths=out_depths)
