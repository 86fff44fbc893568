"""Build a CUDA source of this package into a shared library and load it.

Route: `nvcc` compiles one `.cu` file with a plain C interface into a
`.so` under the package's `_build/` directory (git-ignored), and `ctypes`
loads it. Nothing here runs at import time; a kernel module calls
`load_library` on its first launch. The library's file name carries a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so
an edited source or header rebuilds, and the
build writes to a temporary name and renames it, so concurrent first
uses never load a half-written file.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

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
    (ptxas register and spill report)."""

    def __init__(self, lib, path, seconds, log):
        self.lib, self.path, self.seconds, self.log = lib, path, seconds, log


def load_library(source_name, extra_flags=()):
    """Compile `csrc/<source_name>` for sm_90a (once per source and flag
    set) and load it with ctypes."""
    src = os.path.join(CSRC, source_name)
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source_name)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
    return Built(ctypes.CDLL(out), out, seconds, log)
