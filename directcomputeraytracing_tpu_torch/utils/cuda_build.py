"""Build a source of this package into a shared library and load it.

Route: `nvcc` compiles one `.cu` file with a plain C interface (or
another compiler, such as g++ for the native BVH builder, one `.cpp`
file) into a `.so` under the package's `_build/` directory
(git-ignored), and `ctypes` loads it. Nothing here runs at import time;
a module calls `load_library` on its first use. The library's file name
carries a hash of the source, the shared headers (`*.cuh` beside it)
and the flags, so an edited source or header rebuilds, and the build
writes to a temporary name and renames it, so concurrent first uses
never load a half-written file. Each call leaves a `dcrt.setup.library`
set-up record (`utils.trace`): the seconds from the library's name to
its handle, with the build's (`build_s`, 0 when reused) and the `ctypes`
load's (`load_s`).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

from .trace import setup

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class Built:
    """A loaded library with how it was obtained: `seconds` of build
    (0 when an earlier build was reused) and the compiler's `log`
    (ptxas register and spill report), kept beside the library."""

    def __init__(self, lib, path, seconds, log):
        self.lib, self.path, self.seconds, self.log = lib, path, seconds, log


def load_library(source_name, extra_flags=(), csrc=CSRC, name=None,
                 compiler=find_nvcc, flags=NVCC_FLAGS):
    """Compile `<csrc>/<source_name>` (the package's `csrc/` by default)
    with `compiler()`'s executable and `flags` (nvcc for sm_90a by
    default) plus `extra_flags`, once per source and flag set, into
    `lib<name>-<hash>.so` (name: the source's stem by default) and load
    it with ctypes. A failed build raises with the compiler's output."""
    src = os.path.join(csrc, source_name)
    flags = tuple(flags) + tuple(extra_flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = name or os.path.splitext(source_name)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")
    with setup("dcrt.setup.library", library=os.path.basename(out)) as rec:
        seconds = 0.0
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            tool = compiler()
            proc = subprocess.run([tool, *flags, "-o", tmp, src],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(tool)} failed on {src}:\n{log}")
            with open(f"{tmp}.log", "w") as f:
                f.write(log)
            os.replace(f"{tmp}.log", f"{out}.log")
            os.replace(tmp, out)
        log = ""
        if os.path.exists(f"{out}.log"):
            with open(f"{out}.log") as f:
                log = f.read()
        t0 = time.perf_counter()
        lib = ctypes.CDLL(out)
        rec.add(build_s=seconds, load_s=time.perf_counter() - t0)
    return Built(lib, out, seconds, log)
