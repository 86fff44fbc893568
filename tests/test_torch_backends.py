"""Backend names and slab marching in the megakernel, against the
reference on the CPU.

- "brute" and "pallas" cast the dense sweep over the world soup on any
  scene that has one (the Cornell soup and the small sphere grid's), as
  the reference's names do; instanced tables, which build no soup, raise
  ValueError. Tolerances against the reference's `backend="brute"`: hit
  masks and occlusion equal, t within 2e-6 relative (XLA and PyTorch
  round the Moeller chain apart, measured up to 1.1e-6 in
  `tests/test_torch_clustered.py`), ids, u, v and sides equal but at
  exact-t ties.
- `slab_march` > 0 marches the megakernel's camera and sorted bounce
  casts where the backend takes t_cap (the work list, the pair sweep),
  as the reference's `slab_enabled` has it, and is ignored elsewhere: on
  Cornell the marched image is the unmarched one bit for bit, and no
  cast marches; on the small sphere grid one marched cast per closest
  cast of a pass. (The marched grid images are held to the unmarched
  ones in `tests/test_torch_pairsweep.py`.)
"""

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import brute
from directcomputeraytracing_tpu_torch.accel.traverse import (
    _resolve_backend,
    intersect_any,
    intersect_closest,
)
from directcomputeraytracing_tpu_torch.integrator import megakernel
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod
from directcomputeraytracing_tpu_torch.scene.presets import (
    cornell_box,
    sphere_grid,
)
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

CPU = torch.device("cpu")
GRID = (3, 3)
GRID_KW = dict(stacks=12, slices=16)
T_MIN = 1e-4
T_RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel pytest workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(name):
    """(port scene, reference scene, reference stack size) of a preset."""
    from directcomputeraytracing_tpu.scene import presets as ref_presets
    from directcomputeraytracing_tpu.scene.scene import (
        flatten_scene as ref_flatten,
    )

    if name == "cornell":
        scene = cornell_box("area", "glossy")[0]
        ref_scene = ref_presets.cornell_box("area", "glossy")[0]
    else:
        scene = sphere_grid(*GRID, **GRID_KW)[0]
        ref_scene = ref_presets.sphere_grid(*GRID, **GRID_KW)[0]
    arrays, meta = ref_flatten(ref_scene)
    return flatten_scene(scene, CPU)[0], arrays, meta.stack_size


def _rays(n, seed, lo, hi):
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 3.0, n).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("name", ["cornell", "grid"])
def test_dense_names_match_reference_brute(name):
    import jax.numpy as jnp

    from directcomputeraytracing_tpu.accel import traverse as rtr

    scene, ref, stack = _scenes(name)
    assert (scene.cluster_bbox.shape[0] > 1) == (name == "grid")
    lo, hi = ((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95)) if name == "cornell" \
        else ((-3.0, 0.2, -3.0), (3.0, 4.0, 3.0))
    o, d, t_max = _rays(1000, 8, lo, hi)
    oj, dj, tj = (jnp.asarray(x) for x in (o, d, t_max))
    want = rtr.intersect_closest(ref, oj, dj, stack, T_MIN, backend="brute")
    occ_w = np.asarray(rtr.intersect_any(ref, oj, dj, tj, stack, T_MIN,
                                         backend="brute"))
    o, d, t_max = (torch.from_numpy(x) for x in (o, d, t_max))
    brute.brute_closest.launches = brute.brute_any.launches = 0
    for backend in ("brute", "pallas"):
        assert _resolve_backend(scene, backend) == "dense"
        got = intersect_closest(scene, o, d, T_MIN, backend=backend)
        hit = np.asarray(want.hit)
        np.testing.assert_array_equal(got.hit.numpy(), hit)
        assert 100 < hit.sum() < hit.size
        t_w, t_g = np.asarray(want.t)[hit], got.t.numpy()[hit]
        np.testing.assert_allclose(t_g, t_w, rtol=T_RTOL, atol=0)
        same = got.triangle.numpy()[hit] == np.asarray(want.triangle)[hit]
        assert (np.abs(t_g - t_w) <= T_RTOL * t_w)[~same].all()
        for f in ("instance", "backface"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy()[hit][same],
                np.asarray(getattr(want, f))[hit][same])
        np.testing.assert_allclose(got.u.numpy()[hit][same],
                                   np.asarray(want.u)[hit][same], atol=1e-5)
        assert not got.iterations.any()
        occ = intersect_any(scene, o, d, t_max, T_MIN, backend=backend)
        np.testing.assert_array_equal(occ.numpy(), occ_w)
        assert 0 < occ.sum() < occ.numel()
    # CPU tensors run the twins
    assert brute.brute_closest.launches == brute.brute_any.launches == 0


def test_dense_names_raise_on_instanced_tables(monkeypatch):
    monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", 2048)
    inst, _ = flatten_scene(sphere_grid(*GRID, **GRID_KW)[0], CPU)
    assert inst.isup_inst.shape[0] > 1
    for backend in ("brute", "pallas"):
        with pytest.raises(ValueError, match="soup"):
            _resolve_backend(inst, backend)


def _count_marched(monkeypatch):
    """Count the megakernel's slab-marched casts."""
    calls = []
    real = megakernel.intersect_closest_slab

    def counted(*args, **kw):
        calls.append(args[1].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(megakernel, "intersect_closest_slab", counted)
    return calls


def test_cornell_slab_march_renders_unmarched(monkeypatch):
    """On a dense scene the field is ignored: the marched render is the
    unmarched one, bit for bit, and no cast marches."""
    calls = _count_marched(monkeypatch)
    scene, cam = cornell_box("area", "diffuse")
    a = Renderer(scene, cam, 8, 8, device=CPU).render(2)
    b = Renderer(scene, cam, 8, 8, slab_march=0.03, device=CPU).render(2)
    np.testing.assert_array_equal(a, b)
    assert b.mean() > 0 and not calls


@pytest.mark.parametrize("backend", ["auto", "pallas_pair"])
def test_grid_megakernel_marches_every_closest_cast(monkeypatch, backend):
    """On the work list and the pair sweep the camera cast and every sorted
    extension cast march: 1 + (max_bounce + 1) marched casts a pass."""
    calls = _count_marched(monkeypatch)
    r = Renderer(*sphere_grid(*GRID, **GRID_KW), 8, 8, max_bounce=2,
                 slab_march=0.03, traversal_backend=backend, device=CPU)
    img = r.render(1)
    assert np.isfinite(img).all() and img.mean() > 0
    assert calls == [64] * (1 + 3)
