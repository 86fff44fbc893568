"""The layout probe: what the (R, 3) x 2 -> (9, R) ray layout costs on one
GPU (kernel row 19).

    python -m directcomputeraytracing_tpu_torch.tools.prof_prep

Counterpart of the reference's `experiments/prof_prep.py`, which timed
layout strategies for the work list's ray rows on its accelerator. The
table is the reference's: base = [o, d, inv, 0 x 7] (R, 16) with
inv = 1 / where(|d| < 1e-30, 1e-30, d) (no sign, unlike `prep_rays`),
transposed to (16, R), of which rows [:9] are kept.

`transpose16` launches `transpose16_kernel` of `csrc/probes.cu` on CUDA
tensors (counter `transpose16.launches`) and runs the twin
`transpose16_torch`, a column-by-column stack, on CPU tensors; any other
device raises.

`main` times, at R = 2^20 rays from a numpy seed (CUDA events, mean of
repeated calls after a warm-up): the kernel on the table; the library
call `x.T.contiguous()` on the same table; the whole layout route of the
reference's probe (table, kernel, rows [:9]); `prep_rays_torch` of the
work list (its `cat(...).T.contiguous()` route) and `prep_rays` (the
prep kernel, row 6); and a 36 MB elementwise copy of the (R, 9) table,
the memory roofline of the layout. It prints them with the card's name
and power limit. Needs a CUDA device; with none it exits non-zero.
"""

import json
import sys

import numpy as np
import torch

from .probe_worklist import card, kernels, timed_ms

R = 1 << 20
COLS = 16


def build_table(o, d):
    """The reference probe's (R, 16) table [o, d, inv, 0 x 7]."""
    inv = 1.0 / torch.where(d.abs() < 1e-30, 1e-30, d)
    return torch.cat([o, d, inv, torch.zeros((o.shape[0], 7),
                                             dtype=o.dtype,
                                             device=o.device)], dim=1)


def transpose16_torch(x):
    """Twin of `transpose16_kernel`: (R, 16) -> (16, R), column by
    column."""
    return torch.stack([x[:, c] for c in range(COLS)])


def transpose16(x):
    """(R, 16) f32 -> (16, R): kernel on CUDA tensors, twin on CPU
    tensors."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != COLS:
        raise ValueError(f"x: need (R, {COLS}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return transpose16_torch(x)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no transpose for device {x.device}")
    x = x.contiguous()
    out = torch.empty((COLS, x.shape[0]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = kernels().lib.dcrt_transpose16(
            x.data_ptr(), x.shape[0], out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"transpose16 launch failed: cudaError {err}")
    transpose16.launches += 1
    return out


transpose16.launches = 0


def layout_rows(o, d):
    """The probe's layout route: table, kernel, rows [:9]."""
    return transpose16(build_table(o, d))[:9]


def make_rays(n=R, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def measure(device, reps=20):
    """ms of each route at R rays (see the module docstring)."""
    from ..accel.worklist import prep_rays, prep_rays_torch

    o, d = (torch.from_numpy(x).to(device) for x in make_rays())
    base = build_table(o, d)
    base9 = base[:, :9].contiguous()
    return dict(
        rays=o.shape[0],
        kernel_ms=timed_ms(lambda: transpose16(base), reps),
        library_ms=timed_ms(lambda: base.T.contiguous(), reps),
        twin_ms=timed_ms(lambda: transpose16_torch(base), reps),
        layout_route_ms=timed_ms(lambda: layout_rows(o, d), reps),
        prep_rays_torch_ms=timed_ms(lambda: prep_rays_torch(o, d), reps),
        prep_kernel_ms=timed_ms(lambda: prep_rays(o, d), reps),
        copy36_ms=timed_ms(lambda: base9 * 1.0000001, reps))


def main():
    if not torch.cuda.is_available():
        print("prof_prep: no CUDA device", file=sys.stderr)
        return 1
    print(card())
    print("layout", json.dumps(measure(torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
