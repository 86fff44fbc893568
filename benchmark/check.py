"""The comparison that decides `correct`.

The window's passes leave the program's film; the run's last pass
returns it resolved, the image a user sees. A sample of tiles of that
image, drawn from the run's seed (half in the top half of the frame, half
in the bottom, so a frame of two 2^20-pixel chunks has both in it),
is held against the plain reference's film of the same tiles after the
same samples (`reference.render.render_tiles`). Both follow the same
per-pixel random streams, so a pixel's paths are the same paths, and the
two films agree to rounding but where a path parts ways at a near tie
(an edge graze, a sample at a lobe's threshold).

Per checked pixel p, its gap is the largest over the channels of
|program - reference| / (|reference| + 0.01 * mean |reference|), the
mean over all checked pixels and channels; a non-finite value's gap is
infinite. Two numbers are compared with their limits
(`benchmark/limits/<workload>.json`): `pixel_gap_median`, the median gap,
which a change to the rounding of every path moves, and `diverged_share`,
the share of checked pixels whose gap exceeds `DIVERGED`, which paths
that part ways move.
"""

import json

import numpy as np

from .named import path

DIVERGED = 1e-3


def pick_tiles(seed, width, height, n_tiles, tile):
    """n_tiles (x0, y0, tile, tile) tiles drawn from seed: the first half
    with y0 in the top half of the frame, the rest in the bottom half."""
    rng = np.random.default_rng(seed)
    half = height // 2
    tiles = []
    for k in range(n_tiles):
        lo, hi = (0, max(half - tile, 0)) if k < n_tiles // 2 \
            else (half, height - tile)
        tiles.append((int(rng.integers(0, width - tile + 1)),
                      int(rng.integers(lo, hi + 1)), tile, tile))
    return tiles


def pixel_gaps(program_tiles, reference_tiles):
    """Each checked pixel's gap, in tile order."""
    p = np.concatenate([t.reshape(-1, 3) for t in program_tiles])
    r = np.concatenate([t.reshape(-1, 3) for t in reference_tiles])
    p = p.astype(np.float64)
    r = r.astype(np.float64)
    scale = float(np.mean(np.abs(r)))
    with np.errstate(invalid="ignore"):
        gap = np.abs(p - r) / (np.abs(r) + 0.01 * scale + 1e-30)
    return np.where(np.isfinite(gap), gap, np.inf).max(axis=1)


def numbers(program_tiles, reference_tiles):
    """{"pixel_gap_median", "diverged_share"} of program against
    reference tiles ((th, tw, 3) numpy arrays each)."""
    gap = pixel_gaps(program_tiles, reference_tiles)
    return {"pixel_gap_median": float(np.median(gap)),
            "diverged_share": float(np.mean(gap > DIVERGED))}


def tile_gaps(tiles, program_tiles, reference_tiles):
    """[[x0, y0, median gap of the tile's pixels]]: where the gap lies."""
    gap = pixel_gaps(program_tiles, reference_tiles)
    n = gap.shape[0] // max(len(tiles), 1)
    return [[x0, y0, float(np.median(gap[k * n:(k + 1) * n]))]
            for k, (x0, y0, _, _) in enumerate(tiles)]


def limits(workload):
    with open(path("limits", workload, ".json")) as f:
        return json.load(f)


def judge(values, lim):
    """(correct, {name: {"value", "limit"}}): correct where every number
    is at most its limit."""
    table = {k: {"value": values[k], "limit": lim[k]} for k in lim}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
