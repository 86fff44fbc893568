"""The item-list probe: the per-item step cost of a data-driven item list
on one GPU (kernel row 18).

    python -m directcomputeraytracing_tpu_torch.tools.probe_worklist

Counterpart of the reference's `experiments/probe_worklist.py`, which
measured on its accelerator what one item of a scalar-prefetched item
list costs. An item is an i32 (block << 18) | (slab << 2) | (first << 1)
| valid; the items are sorted by block. For each valid item, per lane x
of the block's RB rays: the min over the item's 64 slab rows of
sum_c tab[row, c] * o[0, x] over the 12 columns (c = 0 a product, then
adds in c order), min-accumulated into the block's output, which restarts
at 3e38 at a valid item whose first bit is set. Invalid items are
skipped. A block with no valid item reads 3e38 (the reference leaves its
output unset).

`item_list` launches `item_list_kernel` of `csrc/probes.cu` on CUDA
tensors (counter `item_list.launches`) and runs the twin `item_list_torch`
on CPU tensors; any other device raises. `csrc/probes.cu` also holds the
layout probe's transpose (`tools/prof_prep.py`); `kernels()` loads both.

`main` builds the reference's inputs (64 ray blocks, 4096 slabs; the
reference draws them with jax.random, here they come from a numpy seed)
at its four capacities, 1,024 to 262,144 items, times the kernel with CUDA
events and prints ms and ns per item with the card's name and power
limit. Needs a CUDA device; with none it exits non-zero.
"""

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

RB = 1024                     # lanes of a ray block
CS = 64                       # rows of a slab
COLS = 12                     # columns of a slab
INIT = 3e38
N_BLOCKS = 64                 # the reference's ray blocks
N_CLUSTERS = 4096             # the reference's slabs
CAPACITIES = (1024, 16384, 65536, 262144)
TWIN_ITEMS = 64               # items per chunk of the twin

_NVCC_EXTRA = ("-fmad=false",)   # round like the twins
_built = None


def kernels():
    """The loaded probe library (`csrc/probes.cu`, built on first call)."""
    global _built
    if _built is None:
        from ..utils.cuda_build import load_library

        built = load_library("probes.cu", _NVCC_EXTRA)
        c_p, c_i = ctypes.c_void_p, ctypes.c_int
        built.lib.dcrt_probe_item_list.argtypes = [c_p, c_p, c_i, c_p, c_p,
                                                   c_p, c_p]
        built.lib.dcrt_transpose16.argtypes = [c_p, c_i, c_p, c_p]
        built.lib.dcrt_probe_item_list.restype = c_i
        built.lib.dcrt_transpose16.restype = c_i
        _built = built
    return _built


def make_items(capacity, n_blocks=N_BLOCKS, n_clusters=N_CLUSTERS):
    """The reference's item list: each block visits capacity // n_blocks
    slabs in order, the first item of a block flagged."""
    per = capacity // n_blocks
    blk = np.repeat(np.arange(n_blocks, dtype=np.int64), per)
    cl = np.tile(np.arange(per, dtype=np.int64) % n_clusters, n_blocks)
    first = np.concatenate([[1], (blk[1:] != blk[:-1]).astype(np.int64)])
    return ((blk << 18) | (cl << 2) | (first << 1) | 1).astype(np.int32)


def make_inputs(seed=0, n_blocks=N_BLOCKS, n_clusters=N_CLUSTERS):
    """(tab (n_clusters * 64, 12), o (3, n_blocks * RB)) f32, normal."""
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(n_clusters * CS, COLS)).astype(np.float32)
    o = rng.normal(size=(3, n_blocks * RB)).astype(np.float32)
    return tab, o


def _check(items, tab, o):
    if items.dtype != torch.int32 or items.dim() != 1:
        raise ValueError(f"items: need (n,) int32, got {tuple(items.shape)} "
                         f"{items.dtype}")
    for name, x, cols in (("tab", tab, COLS), ("o", o, None)):
        if x.dtype != torch.float32 or x.dim() != 2 or (
                cols is not None and x.shape[1] != cols):
            raise ValueError(f"{name}: float32 of 2 dims"
                             f"{'' if cols is None else f', {cols} columns'}"
                             f", got {tuple(x.shape)} {x.dtype}")
    if o.shape[1] % RB:
        raise ValueError(f"o: {o.shape[1]} lanes, not a multiple of {RB}")


def item_list_torch(items, tab, o):
    """Twin of `item_list_kernel`: items (n,) i32 sorted by block, tab
    (slabs * 64, 12), o (3, n_blocks * RB) -> (1, n_blocks * RB)."""
    n_blocks = o.shape[1] // RB
    it = items.long()
    valid = (it & 1) == 1
    blk, slab = it >> 18, (it >> 2) & 0xFFFF
    idx = torch.arange(it.shape[0], device=it.device)
    # the running min restarts at the block's last valid first-flagged item
    restart = valid & ((it & 2) != 0)
    start = torch.full((n_blocks,), -1, dtype=torch.int64,
                       device=it.device).scatter_reduce(
        0, blk[restart], idx[restart], "amax")
    keep = torch.nonzero(valid & (idx >= start[blk]))[:, 0]
    rows = tab.view(-1, CS, COLS)
    lanes = o[0].view(n_blocks, RB)
    out = torch.full((n_blocks, RB), INIT, dtype=torch.float32,
                     device=o.device)
    for chunk in torch.split(keep, TWIN_ITEMS):
        s = rows[slab[chunk]]
        x = lanes[blk[chunk]][:, None, :]
        acc = s[:, :, 0:1] * x
        for c in range(1, COLS):
            acc = acc + s[:, :, c:c + 1] * x
        out.scatter_reduce_(0, blk[chunk, None].expand(-1, RB),
                            acc.amin(1), "amin")
    return out.view(1, -1)


def item_list(items, tab, o):
    """The item-list probe: kernel on CUDA tensors, twin on CPU tensors."""
    _check(items, tab, o)
    dev = items.device
    if tab.device != dev or o.device != dev:
        raise ValueError("items, tab and o on different devices")
    if dev.type == "cpu":
        return item_list_torch(items, tab, o)
    if dev.type != "cuda":
        raise NotImplementedError(f"no item-list probe for device {dev}")
    n_blocks = o.shape[1] // RB
    seg = torch.searchsorted(
        items >> 18, torch.arange(n_blocks + 1, dtype=torch.int32,
                                  device=dev)).to(torch.int32)
    tab, ox = tab.contiguous(), o[0].contiguous()
    out = torch.empty((1, n_blocks * RB), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernels().lib.dcrt_probe_item_list(
            items.contiguous().data_ptr(), seg.data_ptr(), n_blocks,
            tab.data_ptr(), ox.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"item_list launch failed: cudaError {err}")
    item_list.launches += 1
    return out


item_list.launches = 0


def timed_ms(fn, reps):
    """Mean ms of fn() over reps calls after one warm-up call (CUDA
    events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def measure(device, reps=5):
    """Kernel ms and ns per item at the reference's four capacities:
    one row per capacity."""
    tab, o = (torch.from_numpy(x).to(device) for x in make_inputs())
    rows = []
    for cap in CAPACITIES:
        items = torch.from_numpy(make_items(cap)).to(device)
        ms = timed_ms(lambda: item_list(items, tab, o), reps)
        rows.append(dict(capacity=cap, blocks=N_BLOCKS, slabs=N_CLUSTERS,
                         ms=ms, ns_per_item=1e6 * ms / cap))
    return rows


def main():
    if not torch.cuda.is_available():
        print("probe_worklist: no CUDA device", file=sys.stderr)
        return 1
    print(card())
    for row in measure(torch.device("cuda")):
        print("item-list", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
