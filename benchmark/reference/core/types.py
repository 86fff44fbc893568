"""Records that cross the reference's function boundaries: a frozen
copy of the port's `core/types.py` records the shading and the camera
read (`Intersection`, `CameraParams`) and its row-vector transforms,
world = [p, 1] @ M for a (4, 3) matrix M."""

from typing import NamedTuple

import numpy as np
import torch


class Intersection(NamedTuple):
    """Batched surface interaction record; all fields (R, ...)."""

    albedo: torch.Tensor          # (R, 3) (conductor: absorption k)
    alpha: torch.Tensor           # (R,) GGX alpha = roughness^2
    position: torch.Tensor        # (R, 3) world
    normal: torch.Tensor          # (R, 3) shading normal, world
    tangent: torch.Tensor         # (R, 3) world
    geometry_normal: torch.Tensor  # (R, 3) world
    ior: torch.Tensor             # (R, 3)
    is_two_sided: torch.Tensor    # (R,) bool
    backface: torch.Tensor        # (R,) bool
    multiscattering: torch.Tensor  # (R,) bool
    internal_mode: torch.Tensor   # (R,) i64
    material_type: torch.Tensor   # (R,) i64
    light_index: torch.Tensor     # (R,) i64
    triangle_index: torch.Tensor  # (R,) i32


class CameraParams(NamedTuple):
    """Thin-lens / pinhole camera constants (0-d or small tensors)."""

    transform: torch.Tensor        # (4, 4) f32 row-vector camera->world
    film_size: torch.Tensor        # (2,) f32 meters
    aperture_radius: torch.Tensor  # () f32, 0 = pinhole
    focal_distance: torch.Tensor   # () f32
    film_distance: torch.Tensor    # () f32
    blade_count: torch.Tensor      # () i64, <= 2 = circular
    blade_vertex_pos: torch.Tensor  # (2,) f32 unit-polygon vertex
    aperture_base_angle: torch.Tensor  # () f32 radians

    @staticmethod
    def create(transform=None, film_size=(0.05333, 0.03), aperture_radius=0.0,
               focal_distance=2.0, film_distance=None, focal_length=0.05,
               fov_x=None, blade_count=0, aperture_rotation=0.0):
        """Host-side camera description (CPU tensors; `to_device` moves
        it), with the reference's defaults and the same float64 host
        arithmetic before the float32 cast."""
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        if film_distance is None:
            if fov_x is not None:
                film_distance = 0.5 * film_size[0] / max(
                    np.tan(0.5 * fov_x), 1e-4)
            else:
                film_distance = (focal_length * focal_distance) / (
                    focal_length + focal_distance)
        blade_angle = np.pi / max(int(blade_count), 1)
        blade_vertex = (np.cos(blade_angle), np.sin(blade_angle))

        def f32(x):
            return torch.from_numpy(np.array(x, np.float32))

        return CameraParams(
            transform=f32(transform),
            film_size=f32(film_size),
            aperture_radius=f32(aperture_radius),
            focal_distance=f32(focal_distance),
            film_distance=f32(film_distance),
            blade_count=torch.tensor(int(blade_count), dtype=torch.int64),
            blade_vertex_pos=f32(blade_vertex),
            aperture_base_angle=f32(aperture_rotation),
        )


def to_device(record, device):
    """The same NamedTuple of tensors, placed on `device`."""
    return type(record)(*(x.to(device) for x in record))


def transform_point(p, m):
    """[p, 1] @ m for (..., 3) points and (..., 4, 3) matrices."""
    return (p[..., 0:1] * m[..., 0, :] + p[..., 1:2] * m[..., 1, :]
            + p[..., 2:3] * m[..., 2, :] + m[..., 3, :])


def transform_vector(v, m):
    return (v[..., 0:1] * m[..., 0, :] + v[..., 1:2] * m[..., 1, :]
            + v[..., 2:3] * m[..., 2, :])


def transform_point44(p, m):
    """Row-vector transform of (..., 3) points by a (4, 4) matrix."""
    return transform_point(p, m[:, :3])


def transform_vector44(v, m):
    return transform_vector(v, m[:, :3])
