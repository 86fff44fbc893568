"""Camera rays: pinhole or thin lens with a polygonal aperture.

PyTorch counterpart of `directcomputeraytracing_tpu.camera.camera`. The
reference's `generate_ray_rows` serves only the TPU's rows layout and has
no counterpart here.
"""

import math

import numpy as np
import torch

from ..core.types import CameraParams, transform_point44, transform_vector44
from ..sampling.montecarlo import concentric_sample_disk, norm, sample_triangle


def _normalize(v):
    return v / norm(v)[..., None]


def sample_aperture(u3, aperture_radius, blade_count, blade_vertex_pos,
                    blade_angle, base_angle):
    """2D aperture point: concentric disk for <= 2 blades, else a uniform
    point of one triangle of the unit polygon, rotated to a random blade."""
    disk = concentric_sample_disk(u3[..., :2]) * aperture_radius[..., None]
    uv = sample_triangle(u3[..., :2])
    px = blade_vertex_pos[0] * (uv[..., 0] + uv[..., 1])
    py = blade_vertex_pos[1] * (uv[..., 0] - uv[..., 1])
    n = torch.floor(u3[..., 2] * blade_count)
    theta = n * blade_angle + base_angle
    c, s = torch.cos(theta), torch.sin(theta)
    poly = torch.stack([px * c - py * s, py * c + px * s], dim=-1) \
        * aperture_radius[..., None]
    return torch.where(blade_count <= 2, disk, poly)


def generate_ray(cam: CameraParams, film_sample, aperture_sample):
    """film_sample (R, 2) in [0,1)^2, aperture_sample (R, 3) ->
    (origin (R, 3), direction (R, 3)) in world space."""
    fx = film_sample[..., 0]
    film_pos = torch.stack(
        [(-fx + 0.5) * cam.film_size[0],
         (film_sample[..., 1] - 0.5) * cam.film_size[1],
         (-cam.film_distance).expand(fx.shape)], dim=-1)
    pin_dir = _normalize(-film_pos)

    blade_count = cam.blade_count.to(torch.float32)
    # a tensor numerator: `float / tensor` would round twice (reciprocal,
    # then product)
    blade_angle = torch.full_like(blade_count, 2.0 * math.pi) \
        / torch.clamp(blade_count, min=1.0)
    aperture_pos = sample_aperture(
        aperture_sample, cam.aperture_radius.expand(fx.shape), blade_count,
        cam.blade_vertex_pos, blade_angle, cam.aperture_base_angle)
    lens_origin = torch.cat(
        [aperture_pos, torch.zeros_like(aperture_pos[..., :1])], dim=-1)
    focus_point = pin_dir * (cam.focal_distance / pin_dir[..., 2:3])
    lens_dir = _normalize(focus_point - lens_origin)

    use_lens = cam.aperture_radius > 0.0
    origin = torch.where(use_lens, lens_origin, 0.0)
    direction = torch.where(use_lens, lens_dir, pin_dir)
    return (transform_point44(origin, cam.transform),
            transform_vector44(direction, cam.transform))


def look_at_transform(eye, target, up=(0.0, 1.0, 0.0)):
    """Row-vector camera->world matrix for a LHS +z-forward camera
    (numpy, float64 arithmetic, float32 result)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = fwd
    m[3, :3] = eye
    return m
