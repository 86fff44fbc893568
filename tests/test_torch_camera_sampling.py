"""The port's camera and Monte-Carlo sampling against the reference's.

Inputs are numpy-seeded uniforms fed to both packages. Tolerance: 2e-6
absolute on unit-scale outputs. Both sides compute in float32, but XLA's
CPU and PyTorch's CPU kernels round sin, cos, sqrt and division by up to
a few ulp apart, and the camera chains several of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu.camera import camera as ref_cam
from directcomputeraytracing_tpu.core.types import CameraParams as RefCamera
from directcomputeraytracing_tpu.sampling import montecarlo as ref_mc
from directcomputeraytracing_tpu_torch.camera import camera as port_cam
from directcomputeraytracing_tpu_torch.core.types import (
    CameraParams as PortCamera,
)
from directcomputeraytracing_tpu_torch.sampling import montecarlo as port_mc

ATOL = 2e-6


def _u(n, k, seed=0):
    return np.random.default_rng(seed).random((n, k), dtype=np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=atol)


CAMERAS = {
    "pinhole": dict(),
    "thin_lens_disk": dict(aperture_radius=0.02, focal_distance=3.0),
    "thin_lens_5_blades": dict(aperture_radius=0.03, focal_distance=2.5,
                               blade_count=5, aperture_rotation=0.3),
    "thin_lens_6_blades": dict(aperture_radius=0.01, focal_distance=4.0,
                               blade_count=6),
}


@pytest.mark.parametrize("name", list(CAMERAS))
def test_generate_ray(name):
    xf = ref_cam.look_at_transform((0.2, 1.0, -3.5), (0.0, 1.0, 0.0))
    np.testing.assert_array_equal(
        xf, port_cam.look_at_transform((0.2, 1.0, -3.5), (0.0, 1.0, 0.0)))
    kw = dict(CAMERAS[name], transform=xf)
    rc, pc = RefCamera.create(**kw), PortCamera.create(**kw)
    # the port's own constructor gives the reference's constants
    for f in RefCamera._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(rc, f)), getattr(pc, f).numpy(), err_msg=f)
    film, ap = _u(4096, 2, 1), _u(4096, 3, 2)
    o_r, d_r = ref_cam.generate_ray(rc, jnp.asarray(film), jnp.asarray(ap))
    o_p, d_p = port_cam.generate_ray(pc, torch.from_numpy(film),
                                     torch.from_numpy(ap))
    assert o_p.dtype == d_p.dtype == torch.float32
    _close(o_r, o_p)
    _close(d_r, d_p)


@pytest.mark.parametrize("blades", [0, 5, 6])
def test_sample_aperture(blades):
    u3 = _u(4096, 3, blades)
    radius = np.full(4096, 0.05, np.float32)
    angle = np.float32(2.0 * np.pi / max(blades, 1))
    vertex = np.array([np.cos(np.pi / max(blades, 1)),
                       np.sin(np.pi / max(blades, 1))], np.float32)
    r = ref_cam.sample_aperture(jnp.asarray(u3), jnp.asarray(radius),
                                jnp.float32(blades), jnp.asarray(vertex),
                                jnp.float32(angle), jnp.float32(0.2))
    p = port_cam.sample_aperture(torch.from_numpy(u3),
                                 torch.from_numpy(radius),
                                 torch.tensor(float(blades)),
                                 torch.from_numpy(vertex),
                                 torch.tensor(angle), torch.tensor(0.2))
    _close(r, p)


@pytest.mark.parametrize("fn", ["concentric_sample_disk",
                                "cosine_sample_hemisphere",
                                "sample_triangle", "sample_sphere"])
def test_warps(fn):
    u = _u(8192, 2, 5)
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.0], [0.0, 0.5]]  # centre, edges
    _close(getattr(ref_mc, fn)(jnp.asarray(u)),
           getattr(port_mc, fn)(torch.from_numpy(u)))


def test_power_heuristic():
    a, b = _u(1024, 2, 9).T * 10.0
    a[:3], b[:3] = 0.0, [0.0, 1.0, 0.0]
    _close(ref_mc.power_heuristic(1, jnp.asarray(a), 1, jnp.asarray(b)),
           port_mc.power_heuristic(1, torch.from_numpy(a), 1,
                                   torch.from_numpy(b)))


def test_uniform_sphere_pdf():
    want = np.asarray(ref_mc.uniform_sphere_pdf())
    got = port_mc.uniform_sphere_pdf()
    assert got.dtype == torch.float32 and got.shape == want.shape == ()
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
