"""first_pass_s: host seconds of the renderer's first `render` call, the
warm-up pass, from the program's `dcrt.setup.first_pass` set-up record
(`spans.py`): the pass, the built libraries' first loads (their builds on
a fresh checkout), CUDA's lazy module loads and the allocator's growth;
it ends in the image's copy to the host. Part of `setup_s`. Layer:
renderer."""

from ..spans import setup_records


def read(run):
    recs = setup_records("dcrt.setup.first_pass")
    return recs[0].seconds if recs else None
