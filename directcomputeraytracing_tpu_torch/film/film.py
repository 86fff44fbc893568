"""Splatting film: per-pixel sums of weighted radiance and weights.

Counterpart of `directcomputeraytracing_tpu.film.film`. The box filter
of radius 0.5 (each sample lands in its own pixel with weight 1) adds
straight into the film (`accumulate_box`); the other reconstruction
filters convolve a sample plane first (`film.filters`).
"""

from typing import NamedTuple

import torch


class Film(NamedTuple):
    value: torch.Tensor   # (H, W, 3) sum of w * v
    weight: torch.Tensor  # (H, W) sum of w


def create_film(height, width, device):
    return Film(value=torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=device),
                weight=torch.zeros((height, width), dtype=torch.float32,
                                   device=device))


def accumulate_box(film: Film, sample_value, height, width, weight=1.0):
    """Add raster-ordered (H*W, 3) values, each of `weight` samples, into
    their own pixels."""
    return Film(value=film.value + sample_value.reshape(height, width, 3),
                weight=film.weight + weight)


def resolve(film: Film):
    """Filtered radiance estimate: value / weight."""
    return film.value / torch.clamp(film.weight[..., None], min=1e-10)
