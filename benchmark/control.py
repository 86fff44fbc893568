"""The check's control: the reference in the program's place, one
precision below the configuration's.

    python -m benchmark.control --workload <name> --passes <n> \
        --seeds <s> [<s> ...] [--device cuda]

The configurations state float32 and take no matrix products, so the
step below is bfloat16: the control is the plain reference with its
scene tables, its LUTs and its path state rounded to bfloat16 wherever
one stage hands them to the next (the camera ray, each hit, the shading
record, each light and BSDF sample, the throughput and the radiance sum),
each stage's arithmetic in float32: a path state kept in bfloat16, the
step a later change could take to cut memory traffic. For each seed it
takes the tiles a run of that seed checks, renders `--passes` passes of
the cell's traffic from the seed's first sample index with the control
and with the reference, and prints the numbers `benchmark.check`
compares, one JSON line a seed. The benchmark's runs do not run it; it
sets the upper readings of the check's limits (PERF.md).
"""

import argparse
import json
import sys
import tempfile


def bf16(x):
    """x rounded to bfloat16 and back (floating tensors only)."""
    import torch

    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def readings(workload, seeds, passes, device, overrides=None):
    """[{seed, pixel_gap_median, diverged_share}] of the control against
    the reference over passes passes of each seed."""
    from . import check
    from .reference.render import render_tiles
    from .run import resolve

    c = resolve(workload, overrides)
    out = []
    with tempfile.TemporaryDirectory(prefix="benchmark-control-") as work:
        inputs = c.kind.inputs(c.config, work)
        for seed in seeds:
            tiles, plan = c.tiles(seed), c.plan(seed, passes)
            films = []
            for q in (bf16, lambda x: x):
                scene, camera = c.kind.reference(c.config, inputs)
                films.append([t.cpu().numpy() for t in render_tiles(
                    scene, camera, c.width, c.height,
                    int(c.config["max_bounce"]), c.filt, tiles, plan, device,
                    q)])
            out.append({"seed": seed, **check.numbers(*films)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--passes", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for r in readings(args.workload, args.seeds, args.passes, args.device):
        print(json.dumps({"workload": args.workload, "passes": args.passes,
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
