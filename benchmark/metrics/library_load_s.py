"""library_load_s: host seconds the program spent obtaining its built
libraries, summed over its `dcrt.setup.library` set-up records
(`spans.py`): each the build (nvcc or g++, 0 where an earlier build is
reused) and the `ctypes` load. Part of `setup_s`. Layer: kernels."""

from ..spans import setup_records


def read(run):
    recs = setup_records("dcrt.setup.library")
    return sum(r.seconds for r in recs) if recs else None
