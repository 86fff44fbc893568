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
output unset). Every min is the reference's (`jnp.minimum` / `jnp.min`
under XLA): a NaN on either side gives NaN, and -0 is below +0. That
total order makes the min of a set the same in any order and split.

`item_list` launches `item_list_kernel` of `csrc/probes.cu` on CUDA
tensors (counter `item_list.launches`) and runs the twin `item_list_torch`
on CPU tensors; any other device raises. `csrc/probes.cu` also holds the
layout probe's transpose (`tools/prof_prep.py`); `kernels()` loads both.

`main` builds the reference's inputs (64 ray blocks, 4096 slabs; the
reference draws them with jax.random, here they come from a numpy seed)
at its four capacities, 1,024 to 262,144 items, times the kernel with CUDA
events and the profiler and prints ms and ns per item with the card's
name and power limit. Needs a CUDA device; with none it exits non-zero.

    python -m directcomputeraytracing_tpu_torch.tools.probe_worklist \
        --parent DIR [--parent DIR2 ...]

times the kernel in turns against the `probes.cu` of each DIR (an earlier
version, with the same C entry) at the four capacities, CUDA events and
profiler, prints the SASS instruction counts of each build's
`item_list_kernel`, holds every output to the twin and the parents bit
for bit on the normal data and the kernel to the twin on `crafted_inputs`,
and exits non-zero on any difference.
"""

import argparse
import ctypes
import json
import os
import re
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
        _bind_item_list(built.lib)
        built.lib.dcrt_transpose16.argtypes = [c_p, c_i, c_p, c_p]
        built.lib.dcrt_transpose16.restype = c_i
        built.lib.dcrt_probe_resources.argtypes = [c_p]
        built.lib.dcrt_probe_resources.restype = c_i
        _built = built
    return _built


def _bind_item_list(lib):
    c_p, c_i = ctypes.c_void_p, ctypes.c_int
    lib.dcrt_probe_item_list.argtypes = [c_p, c_p, c_i, c_p, c_p, c_p, c_p]
    lib.dcrt_probe_item_list.restype = c_i


def resources():
    """`item_list_kernel` on the current card: resident blocks per SM,
    registers, static shared bytes, local (spill) bytes per thread,
    threads per block and CUDA blocks per ray block (`split`)."""
    out = (ctypes.c_int * 6)()
    err = kernels().lib.dcrt_probe_resources(out)
    if err:
        raise RuntimeError(f"probe_resources failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "registers", "static_smem",
                     "local_bytes", "threads", "split"), out))


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


def crafted_inputs(seed=7):
    """Items, tab (8 slabs) and o (3, 4 * RB) that reach the min's edges:
    lanes with x = +0, -0, NaN, +inf and -inf (lane % 16 = 0-4, the rest
    normal); slab 0 positive (its sums are -0 where x = -0, +0 where x =
    +0), 1 the same with a negative first column (+0 for both zeros), 2
    rows alternating between the two, 3 all negative (-0 where x = +0), 4
    normal with one NaN entry, 5-7 normal. Blocks 0 and 1 meet -0 and +0
    sums in both orders, across items and within a slab; block 2 meets the
    NaN slab, then restarts; block 3 takes it after an invalid copy of it
    and keeps NaN."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, 2.0, size=(CS, COLS)).astype(np.float32)
    firstneg = pos.copy()
    firstneg[:, 0] *= -1
    alt = np.where((np.arange(CS) % 2 == 0)[:, None], pos, firstneg)
    nan = rng.normal(size=(CS, COLS)).astype(np.float32)
    nan[5, 7] = np.nan
    normal = rng.normal(size=(3, CS, COLS)).astype(np.float32)
    tab = np.concatenate([pos, firstneg, alt, -pos, nan,
                          *normal]).astype(np.float32)
    o = rng.normal(size=(3, 4 * RB)).astype(np.float32)
    for k, v in enumerate((0.0, -0.0, np.nan, np.inf, -np.inf)):
        o[0, k::16] = v
    # (block, slab, first, valid)
    spec = [(0, 0, 1, 1), (0, 1, 0, 1), (0, 2, 0, 1), (0, 3, 0, 1),
            (1, 3, 1, 1), (1, 1, 0, 1), (1, 2, 0, 1), (1, 0, 0, 1),
            (2, 4, 1, 1), (2, 5, 0, 1), (2, 0, 1, 1), (2, 3, 0, 1),
            (2, 4, 0, 0),
            (3, 6, 1, 1), (3, 4, 0, 0), (3, 7, 0, 1), (3, 4, 0, 1),
            (3, 2, 0, 1)]
    items = np.array([(b << 18) | (c << 2) | (f << 1) | v
                      for b, c, f, v in spec], dtype=np.int32)
    return items, tab, o


def diff(a, b):
    """Elements whose bits differ, a NaN equal to any NaN (a zero's sign
    counts); -1 when the shapes differ."""
    if a.shape != b.shape:
        return -1
    both = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(torch.int32) != b.view(torch.int32)) & ~both).sum())


def _key(v):
    """float32 -> int32 keys in the reference's order: NaN lowest, then
    -inf < ... < -0 < +0 < ... < +inf."""
    bits = v.view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(v), torch.iinfo(torch.int32).min, key)


def _unkey(key):
    """The inverse of `_key` (its NaN key reads back as a NaN)."""
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)


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
    # the mins on int keys, which order as the reference's min does
    out = _key(torch.full((n_blocks, RB), INIT, dtype=torch.float32,
                          device=o.device))
    for chunk in torch.split(keep, TWIN_ITEMS):
        s = rows[slab[chunk]]
        x = lanes[blk[chunk]][:, None, :]
        acc = s[:, :, 0:1] * x
        for c in range(1, COLS):
            acc = acc + s[:, :, c:c + 1] * x
        out.scatter_reduce_(0, blk[chunk, None].expand(-1, RB),
                            _key(acc).amin(1), "amin")
    return _unkey(out).view(1, -1)


def _aligned(x):
    """x, or a copy of it where its data is not 16-byte aligned (the
    kernel reads tab and o as float4)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(lib, items, tab, o):
    """One launch of `lib`'s `dcrt_probe_item_list` on CUDA tensors
    (uncounted)."""
    n_blocks = o.shape[1] // RB
    dev = items.device
    seg = torch.searchsorted(
        items >> 18, torch.arange(n_blocks + 1, dtype=torch.int32,
                                  device=dev)).to(torch.int32)
    tab, ox = _aligned(tab.contiguous()), _aligned(o[0].contiguous())
    out = torch.empty((1, n_blocks * RB), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dcrt_probe_item_list(
            items.contiguous().data_ptr(), seg.data_ptr(), n_blocks,
            tab.data_ptr(), ox.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"item_list launch failed: cudaError {err}")
    return out


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
    out = _launch(kernels().lib, items, tab, o)
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
    """Kernel ms (CUDA events; `kernel_ms`: the profiler's) and ns per
    item at the reference's four capacities: one row per capacity."""
    from .common import kernel_ms

    tab, o = (torch.from_numpy(x).to(device) for x in make_inputs())
    rows = []
    for cap in CAPACITIES:
        items = torch.from_numpy(make_items(cap)).to(device)
        ms = timed_ms(lambda: item_list(items, tab, o), reps)
        rows.append(dict(capacity=cap, blocks=N_BLOCKS, slabs=N_CLUSTERS,
                         ms=ms, ns_per_item=1e6 * ms / cap,
                         kernel_ms=kernel_ms(lambda: item_list(items, tab, o),
                                             reps, "item_list_kernel")))
    return rows


def sass_counts(path, kernel="item_list_kernel"):
    """Instruction counts by opcode of `kernel` in a built library's SASS
    (`cuobjdump -sass`, beside nvcc), or None where the tool is missing."""
    from ..utils.cuda_build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        m = inside and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            op = m.group(1)
            counts[op] = counts.get(op, 0) + 1
    return counts


def compare(parents, reps=5):
    """The kernel against the `probes.cu` of each parent directory, in
    turns, at the four capacities (module docstring). Returns the report
    lines and whether every output was equal where it must be."""
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.cuda_build import load_library
    from .common import kernel_ms

    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(parents) + 1) as pool:
        new = pool.submit(kernels)
        olds = [pool.submit(load_library, "probes.cu", _NVCC_EXTRA,
                            csrc=os.path.abspath(p), name=f"probes_parent{i}")
                for i, p in enumerate(parents)]
    builds = {"new": new.result()}
    for p, fut in zip(parents, olds):
        _bind_item_list(fut.result().lib)
        builds[os.path.basename(os.path.normpath(p))] = fut.result()
    lines, ok = [], True
    for name, built in builds.items():
        lines.append(("sass", dict(build=name,
                                   counts=sass_counts(built.path))))
    lines.append(("resources", resources()))
    tab, o = (torch.from_numpy(x).to(dev) for x in make_inputs())
    for cap in CAPACITIES:
        items = torch.from_numpy(make_items(cap)).to(dev)
        twin = item_list_torch(items, tab, o)
        diffs = {name: diff(_launch(b.lib, items, tab, o), twin)
                 for name, b in builds.items()}
        ok &= not any(diffs.values())
        order = list(builds) + list(builds)[::-1]
        turns = {name: [] for name in builds}
        for name in order:
            turns[name].append(timed_ms(
                lambda: _launch(builds[name].lib, items, tab, o), reps))
        prof = {name: kernel_ms(lambda: _launch(b.lib, items, tab, o), reps,
                                "item_list_kernel")
                for name, b in builds.items()}
        lines.append(("item-list-ab", dict(
            capacity=cap, order=order, reps=reps, ms=turns, kernel_ms=prof,
            diff_vs_twin=diffs)))
    items, tab, o = (torch.from_numpy(x).to(dev) for x in crafted_inputs())
    twin = item_list_torch(items, tab, o)
    crafted = {name: diff(_launch(b.lib, items, tab, o), twin)
               for name, b in builds.items()}
    ok &= crafted["new"] == 0
    lines.append(("item-list-crafted", dict(
        diff_vs_twin=crafted, nan_lanes=int(torch.isnan(twin).sum()),
        negative_zero_lanes=int(((twin == 0) & torch.signbit(twin)).sum()))))
    return lines, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="a directory holding an earlier probes.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_worklist: no CUDA device", file=sys.stderr)
        return 1
    print(card())
    if args.parent:
        lines, ok = compare(args.parent)
        for tag, line in lines:
            print(tag, json.dumps(line), flush=True)
        return 0 if ok else 1
    for row in measure(torch.device("cuda")):
        print("item-list", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
