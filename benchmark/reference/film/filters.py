"""PBRT-style splatting film reconstruction filters.

Counterpart of `directcomputeraytracing_tpu.film.filters` (the reference
renderer's sample-convolution pass, Shaders/SampleConvolution.hlsl: per
output pixel, gather every neighbour pixel's (sample position, sample
value) within the filter radius, accumulate sum(w * v) into the film's
value and sum(w) into its weight; defaults radius 1 box, Gaussian alpha
1.5, Mitchell B = C = 1/3, Lanczos tau 3).

The frame convolves as a sum of shifted-plane terms: for each (dy, dx)
of the filter footprint the sample plane is shifted by zero padding and
slicing and weighted by the filter at each sample's offset. These are
plain torch ops on whatever device the planes lie on; the reference's
version is XLA code, not a kernel.
"""

import math
from typing import NamedTuple

import torch

PI = 3.1415926535


class FilterParams(NamedTuple):
    """Static (hashable) filter configuration."""
    kind: str = "box"          # box | triangle | gaussian | mitchell | lanczos
    radius: float = 1.0
    gaussian_alpha: float = 1.5
    mitchell_b: float = 1.0 / 3.0
    mitchell_c: float = 1.0 / 3.0
    lanczos_tau: int = 3


def _gaussian_1d(d, alpha, radius):
    return torch.clamp(torch.exp(-alpha * d * d)
                       - math.exp(-alpha * radius * radius), min=0.0)


def _mitchell_1d(x, b, c):
    x = torch.abs(2.0 * x)
    f0 = -b - 6 * c
    f1 = 6 * b + 30 * c
    f2 = -12 * b - 48 * c
    f3 = 8 * b + 24 * c
    f4 = 12 - 9 * b - 6 * c
    f5 = -18 + 12 * b + 6 * c
    f6 = 6 - 2 * b
    near = f4 * x * x * x + f5 * x * x + f6
    far = f0 * x * x * x + f1 * x * x + f2 * x + f3
    return torch.where(x < 1.0, near,
                       torch.where(x < 2.0, far, 0.0)) * (1.0 / 6.0)


def _sinc(x):
    x = torch.abs(x)
    return torch.where(x >= 1e-5,
                       torch.sin(PI * x) / torch.clamp(PI * x, min=1e-20),
                       1.0)


def _windowed_sinc(x, radius, tau):
    x = torch.abs(x)
    return torch.where(x > radius, 0.0, _sinc(x) * _sinc(x / tau))


def filter_weight(p: FilterParams, dx, dy):
    """2-D filter weight at offset (dx, dy) from the pixel centre, for
    float32 tensors dx, dy (reference: EvaluateFilter,
    SampleConvolution.hlsl:52-65)."""
    r = p.radius
    if p.kind == "box":
        return ((torch.abs(dx) <= r) & (torch.abs(dy) <= r)).to(dx.dtype)
    if p.kind == "triangle":
        return (torch.clamp(r - torch.abs(dx), min=0.0)
                * torch.clamp(r - torch.abs(dy), min=0.0))
    if p.kind == "gaussian":
        return (_gaussian_1d(dx, p.gaussian_alpha, r)
                * _gaussian_1d(dy, p.gaussian_alpha, r))
    if p.kind == "mitchell":
        return _mitchell_1d(dx / r, p.mitchell_b, p.mitchell_c) \
            * _mitchell_1d(dy / r, p.mitchell_b, p.mitchell_c)
    if p.kind == "lanczos":
        return _windowed_sinc(dx, r, p.lanczos_tau) \
            * _windowed_sinc(dy, r, p.lanczos_tau)
    raise ValueError(p.kind)


def convolve_sample_pass(sample_pos, sample_value, p: FilterParams):
    """One sample per pixel -> (weighted value sum (H, W, 3), weight sum
    (H, W)) under filter p.

    sample_pos: (H, W, 2) in-pixel jitter in [0, 1); sample_value
    (H, W, 3), both float32. The reference's gather bounds: output pixel
    centre c = q + 0.5 collects source pixels x in [floor(c - r),
    floor(c + r)] clamped to the frame (zero padding, a valid mask).
    """
    h, w = sample_value.shape[:2]
    dev = sample_value.device
    lo = math.floor(0.5 - p.radius)
    hi = math.floor(0.5 + p.radius)
    pad = max(-lo, hi)

    def padded(arr):
        out = torch.zeros((h + 2 * pad, w + 2 * pad) + arr.shape[2:],
                          dtype=arr.dtype, device=dev)
        out[pad:pad + h, pad:pad + w] = arr
        return out

    pos_p, val_p = padded(sample_pos), padded(sample_value)
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]

    vsum = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for dy in range(lo, hi + 1):
        for dx in range(lo, hi + 1):
            jit = pos_p[pad + dy: pad + dy + h, pad + dx: pad + dx + w]
            val = val_p[pad + dy: pad + dy + h, pad + dx: pad + dx + w]
            valid = ((row + dy >= 0) & (row + dy < h)
                     & (col + dx >= 0) & (col + dx < w))
            # offset = pixel centre - absolute sample position
            ox = 0.5 - dx - jit[..., 0]
            oy = 0.5 - dy - jit[..., 1]
            wgt = filter_weight(p, ox, oy) * valid
            vsum = vsum + wgt[..., None] * val
            wsum = wsum + wgt
    return vsum, wsum
