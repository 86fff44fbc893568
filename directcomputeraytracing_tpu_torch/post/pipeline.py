"""Post-processing: frame luminance, exposure, Reinhard tone map, sRGB.

Counterpart of `directcomputeraytracing_tpu.post.pipeline`.
"""

import math
from typing import NamedTuple

import torch

# Rec. 601 luma + black bias
LUM_VECTOR = (0.299, 0.587, 0.114)
BLACK_BIAS = 1e-4
FILM_CLAMP = 65000.0


class PostParams(NamedTuple):
    enabled: bool = True
    auto_exposure: bool = True
    manual_ev100: float = 15.0
    relative_aperture: float = 8.0      # f-number
    shutter_time: float = 1.0
    iso: float = 100.0
    ev100_from_camera: bool = True
    luminance_white: float = 1.0


def resolve_film(value, weight):
    """(H, W, 3), (H, W) -> radiance, 0 where no weight, clamped to
    [0, 65000]."""
    safe = torch.clamp(weight[..., None], min=1e-20)
    out = torch.where(weight[..., None] > 0.0, value / safe, 0.0)
    return torch.clamp(out, 0.0, FILM_CLAMP)


def average_log_luminance(color):
    """Mean log(luma + bias) over the frame."""
    lum = (color[..., 0] * LUM_VECTOR[0] + color[..., 1] * LUM_VECTOR[1]
           + color[..., 2] * LUM_VECTOR[2])
    return torch.mean(torch.log(BLACK_BIAS + lum))


def ev100_from_camera(relative_aperture, shutter_time, iso):
    """EV100 = log2(N^2 / t * 100 / S)."""
    return math.log2(relative_aperture * relative_aperture / shutter_time
                     * 100.0 / iso)


def ev100_from_average_luminance(avg_lum):
    return torch.log2(avg_lum * 100.0 / 12.5)


def ev100_to_exposure(ev100):
    """exposure = 1 / (1.2 * 2^EV100)."""
    return 1.0 / (1.2 * torch.exp2(torch.as_tensor(ev100,
                                                   dtype=torch.float32)))


def reinhard(color, max_white_sqr):
    """Extended Reinhard with white point."""
    return color * (1.0 + color / max_white_sqr) / (1.0 + color)


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(torch.clamp(c, min=1e-10), 1.0 / 2.4)
                       - 0.055)


def post_process(film_value, film_weight, params: PostParams,
                 aperture_is_pinhole=False):
    """resolve -> exposure -> Reinhard -> sRGB; (H, W, 3) in [0, 1]."""
    color = resolve_film(film_value, film_weight)
    if not params.enabled:
        return linear_to_srgb(color)
    if params.auto_exposure:
        ev100 = ev100_from_average_luminance(
            torch.exp(average_log_luminance(color)))
    elif params.ev100_from_camera and not aperture_is_pinhole:
        ev100 = ev100_from_camera(params.relative_aperture,
                                  params.shutter_time, params.iso)
    else:
        ev100 = params.manual_ev100
    exposure = ev100_to_exposure(ev100).to(color.device)
    color = reinhard(color * exposure,
                     params.luminance_white * params.luminance_white)
    return linear_to_srgb(color)
