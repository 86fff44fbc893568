"""BSDF dispatch and light sampling: the port against the reference.

Inputs are numpy-seeded shading frames, directions and uniforms, fed to
both packages; the LUTs are the committed Kulla-Conty bake. Tolerance:
relative 2e-4 with an absolute floor of 1e-5 (1e-4 for radiance and
pdf, which reach 1e3 near grazing angles). Both sides
run float32, but XLA's CPU and PyTorch's CPU kernels round pow, exp,
sqrt and division a few ulp apart, and the GGX and Fresnel terms chain
many of them; selection masks (lobe choice, total internal reflection)
must agree exactly on these seeded inputs. The rough dielectric's
half-vector denominator (eta_i wi.h + eta_o wo.h)^2 nears zero at
grazing refraction, which takes its largest relative difference to 1.1e-4
on these inputs, hence 2e-4 rather than 1e-4. Rough lobes are drawn with
alpha >= 1/16: at smaller alpha the GGX peak turns a one-ulp difference
in a sampled direction into a relative difference of up to 1e-1 in the
sample's value and pdf, which the render tests bound instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu.bsdf import dispatch as ref_bsdf
from directcomputeraytracing_tpu.core import constants as C
from directcomputeraytracing_tpu.core.types import Intersection as RefItx
from directcomputeraytracing_tpu.lights import lights as ref_lights
from directcomputeraytracing_tpu.lut.bake import bake_luts_cached
from directcomputeraytracing_tpu.scene import presets as ref_presets
from directcomputeraytracing_tpu.scene import scene as ref_scene
from directcomputeraytracing_tpu_torch.bsdf import dispatch as port_bsdf
from directcomputeraytracing_tpu_torch.core.types import (
    Intersection as PortItx,
)
from directcomputeraytracing_tpu_torch.core.types import from_reference
from directcomputeraytracing_tpu_torch.lights import lights as port_lights
from directcomputeraytracing_tpu_torch.lut.textures import load_luts
from directcomputeraytracing_tpu_torch.scene import presets as port_presets
from directcomputeraytracing_tpu_torch.scene import scene as port_scene

RTOL, ATOL = 2e-4, 1e-5
N = 4096


def _close(want, got, scale=1.0):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(want, got)
        return
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _itx_fields(material_type, seed):
    """Random shading records of one material type (numpy)."""
    rs = np.random.default_rng(seed)
    normal = _unit(rs, N)
    tangent = _unit(rs, N)
    tangent -= (tangent * normal).sum(1, keepdims=True) * normal
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    geo = normal + 0.2 * _unit(rs, N)
    geo /= np.linalg.norm(geo, axis=1, keepdims=True)
    # rough lobes from alpha = 1/16 up; below that GGX's peak amplifies
    # ulp differences in the sampled microfacet normal by ~1/alpha^2
    roughness = rs.uniform(0.25, 1.0, N)
    roughness[:64] = 0.0          # smooth: delta lobes
    f32 = np.float32
    return dict(
        albedo=rs.uniform(0.05, 0.95, (N, 3)).astype(f32),
        alpha=(roughness * roughness).astype(f32),
        position=rs.uniform(-1, 1, (N, 3)).astype(f32),
        normal=normal, tangent=tangent.astype(f32),
        geometry_normal=geo.astype(f32),
        ior=rs.uniform(1.1, 2.4, (N, 3)).astype(f32),
        is_two_sided=rs.random(N) < 0.5,
        backface=rs.random(N) < 0.3,
        multiscattering=rs.random(N) < 0.5,
        internal_mode=rs.integers(0, 3, N).astype(np.int32),
        material_type=np.full(N, material_type, np.int32),
        light_index=np.full(N, C.LIGHT_INDEX_INVALID, np.uint32),
        triangle_index=np.zeros(N, np.int32),
    )


def _ref_itx(f):
    return RefItx(**{k: jnp.asarray(v) for k, v in f.items()})


def _port_itx(f):
    return PortItx(**{k: torch.from_numpy(
        v.astype(np.int64) if v.dtype.kind in "ui" else v)
        for k, v in f.items()})


MATERIALS = {"diffuse": C.MATERIAL_TYPE_DIFFUSE,
             "plastic": C.MATERIAL_TYPE_PLASTIC,
             "conductor": C.MATERIAL_TYPE_CONDUCTOR,
             "dielectric": C.MATERIAL_TYPE_DIELECTRIC,
             "thin_dielectric": C.MATERIAL_TYPE_THIN_DIELECTRIC}


@pytest.fixture(scope="module")
def luts():
    return bake_luts_cached(), load_luts("cpu")


@pytest.mark.parametrize("material", list(MATERIALS))
def test_bsdf(material, luts):
    ref_luts, port_luts = luts
    f = _itx_fields(MATERIALS[material], seed=len(material))
    rs = np.random.default_rng(100 + len(material))
    wo, wi = _unit(rs, N), _unit(rs, N)
    u2 = rs.random((N, 2), dtype=np.float32)
    u_sel = rs.random(N, dtype=np.float32)
    ri, pi = _ref_itx(f), _port_itx(f)
    j, t = jnp.asarray, torch.from_numpy
    for use_vndf in (True, False):
        _close(ref_bsdf.evaluate_bsdf(ref_luts, j(wi), j(wo), ri, use_vndf),
               port_bsdf.evaluate_bsdf(port_luts, t(wi), t(wo), pi, use_vndf))
        _close(ref_bsdf.evaluate_bsdf_pdf(ref_luts, j(wi), j(wo), ri,
                                          use_vndf),
               port_bsdf.evaluate_bsdf_pdf(port_luts, t(wi), t(wo), pi,
                                           use_vndf), scale=10.0)
        want = ref_bsdf.sample_bsdf(ref_luts, j(wo), j(u2), j(u_sel), ri,
                                    use_vndf)
        got = port_bsdf.sample_bsdf(port_luts, t(wo), t(u2), t(u_sel), pi,
                                    use_vndf)
        for w, g, scale in zip(want, got, (1.0, 10.0, 10.0, 1.0)):
            _close(w, g, scale)


def _light_scene(env):
    """Cornell glossy plus point, directional and environment lights, built
    by both packages; the port's inputs come from the reference's flatten
    through from_reference, so both see identical tables."""
    rng = np.random.default_rng(7)
    tex = {"latlong": rng.uniform(0.1, 2.0, (8, 16, 3)),
           "cubemap": rng.uniform(0.1, 2.0, (6, 4, 4, 3))}[env]
    scenes = []
    for mod, presets in ((ref_scene, ref_presets), (port_scene,
                                                    port_presets)):
        s, cam = presets.cornell_box("area", "glossy")
        s.lights = [mod.PunctualLight("point", (2.0, 1.5, 1.0),
                                      (0.2, 1.8, 0.1)),
                    mod.PunctualLight("directional", (0.5, 0.5, 0.4),
                                      (0.3, -0.9, 0.3)),
                    mod.PunctualLight("env", (0.3, 0.3, 0.3))]
        s.env_texture = tex.astype(np.float32)
        scenes.append((s, cam))
    ref_arrays, ref_meta = ref_scene.flatten_scene(scenes[0][0])
    port_arrays, port_meta = port_scene.flatten_scene(scenes[1][0], "cpu")
    scene, _, _ = from_reference(ref_arrays, bake_luts_cached(),
                                 scenes[0][1], "cpu")
    for f in scene._fields:   # the port flattens env scenes identically
        assert torch.equal(getattr(scene, f), getattr(port_arrays, f)), f
    assert port_meta.light_count == ref_meta.light_count == 4
    return ref_arrays, scene, ref_meta.light_count


@pytest.mark.parametrize("env", ["latlong", "cubemap"])
def test_lights(env):
    ref_arrays, scene, n_lights = _light_scene(env)
    rs = np.random.default_rng(21)
    p = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N, 3)) \
        .astype(np.float32)
    u_sel, u_tri = rs.random(N, dtype=np.float32), rs.random(N,
                                                             dtype=np.float32)
    u2 = rs.random((N, 2), dtype=np.float32)
    j, t = jnp.asarray, torch.from_numpy
    want = ref_lights.sample_light_direct(ref_arrays, n_lights, True, j(p),
                                          j(u_sel), j(u_tri), j(u2))
    got = port_lights.sample_light_direct(scene, n_lights, True, t(p),
                                          t(u_sel), t(u_tri), t(u2))
    for f in want._fields:
        _close(getattr(want, f), getattr(got, f), scale=10.0)

    # implicit hits: every light, plus the invalid index of a miss
    light_idx = rs.integers(0, n_lights + 1, N).astype(np.uint32)
    light_idx[light_idx == n_lights] = C.LIGHT_INDEX_INVALID
    tri = rs.integers(0, 32, N).astype(np.int32)
    normal, wi = _unit(rs, N), _unit(rs, N)
    dist = rs.uniform(0.1, 3.0, N).astype(np.float32)
    want = ref_lights.evaluate_light_direct(
        ref_arrays, n_lights, True, j(light_idx), j(tri), j(normal), j(wi),
        j(dist))
    got = port_lights.evaluate_light_direct(
        scene, n_lights, True, t(light_idx.astype(np.int64)), t(tri),
        t(normal), t(wi), t(dist))
    for w, g in zip(want, got):
        _close(w, g, scale=10.0)
    _close(ref_lights.evaluate_env(ref_arrays, j(wi), 2, True),
           port_lights.evaluate_env(scene, t(wi), 2, True))
