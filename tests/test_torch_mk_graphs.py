"""The megakernel's pass in segments, and the renderer's CUDA graphs of
them (`integrator/megakernel.py` `render_samples`, `PassGraphs`).

On the CPU:
- the segmented pass, run eagerly, equals bit for bit the pass written
  straight through with its casts inline (`_straight_pass`, the pass as
  the port ran it before it was cut into segments): Cornell glossy at
  32x32 under two seeds, the alpha panel (alpha draws and alpha-tested
  casts) and the forced instanced sphere grid (sorted extension casts),
  with and without slab marching;
- the key of a captured pass changes with each `set_*` edit and with a
  new camera, and stays across `reset()`;
- `PassGraphs` runs a new key's first pass eagerly without a capture,
  its second eagerly and then hands the capture buffers shaped like each
  cast's result, replays a captured key, and keeps the two keys used
  last, captured or seen once.

On a card (`cuda`): a graphed Cornell render over passes with changing
seeds is bit-equal to the eager one, after a `set_material` edit too and
at two chunk lengths; the casts' launch counters move alike both ways,
and the BSDF wrappers count their eager launches alone (none on a
replayed pass); the profiler sees the same hand-written kernels a pass
both ways.
"""

import collections

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel.traverse import (
    HitInfo,
    intersect_any,
    intersect_closest,
    intersect_closest_slab,
)
from directcomputeraytracing_tpu_torch.bsdf import fused
from directcomputeraytracing_tpu_torch.bsdf.fused import (
    evaluate_bsdf_value_pdf,
    sample_bsdf,
)
from directcomputeraytracing_tpu_torch.camera.camera import generate_ray
from directcomputeraytracing_tpu_torch.core.constants import (
    LIGHT_INDEX_INVALID,
)
from directcomputeraytracing_tpu_torch.integrator import megakernel
from directcomputeraytracing_tpu_torch.integrator import renderer as rmod
from directcomputeraytracing_tpu_torch.integrator.common import (
    has_worklist_tables,
    megakernel_slab_depth,
    offset_ray_origin,
    park_rays,
    shade_hit,
    sort_order,
)
from directcomputeraytracing_tpu_torch.integrator.megakernel import (
    _Carry,
    _masked_1d,
    _masked_2d,
    _mesh_light_camera_eval,
    _sel,
    render_samples,
)
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.lights.lights import (
    evaluate_env,
    evaluate_light_direct,
    sample_light_direct,
)
from directcomputeraytracing_tpu_torch.rng.xoshiro import (
    init_rng,
    next_sample_1d,
    next_sample_2d,
    next_sample_3d,
)
from directcomputeraytracing_tpu_torch.sampling.montecarlo import (
    dot,
    power_heuristic,
)
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod

CPU = torch.device("cpu")
W = H = 32
MAX_BOUNCE = 4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the pass written straight through, its casts inline
# ---------------------------------------------------------------------------

def _closest(scene, cfg, depth, origin, direction, opacity_u, live=None):
    alpha = dict(opacity_u=opacity_u, alpha_textures=cfg.any_hit_texture)
    if depth is None:
        return intersect_closest(scene, origin, direction,
                                 backend=cfg.traversal_backend,
                                 watertight=cfg.watertight, **alpha)
    return intersect_closest_slab(scene, origin, direction, depth,
                                  backend=cfg.traversal_backend,
                                  watertight=cfg.watertight, live=live,
                                  phases=cfg.slab_phases, **alpha)


def _straight_bounce(scene, luts, cfg, depth, c):
    active, itx, rng = c.active, c.itx, c.rng
    wo = -c.wi
    l_acc = c.l
    if cfg.light_count > 0:
        rng, u_sel = _masked_1d(rng, active)
        rng, u_tri = _masked_1d(rng, active)
        rng, u2 = _masked_2d(rng, active)
        ls = sample_light_direct(scene, cfg.light_count,
                                 cfg.has_env_texture, itx.position, u_sel,
                                 u_tri, u2)
        shadow_o = offset_ray_origin(itx.position, itx.geometry_normal,
                                     ls.wi)
        ou_s = None
        if cfg.any_hit:
            rng, ou_s = _masked_1d(rng, active)
        occluded = intersect_any(
            scene, *park_rays(active, shadow_o, ls.wi),
            torch.where(active, ls.distance, 0.0),
            backend=cfg.traversal_backend, watertight=cfg.watertight,
            opacity_u=ou_s, alpha_textures=cfg.any_hit_texture)
        f, f_pdf = evaluate_bsdf_value_pdf(luts, ls.wi, wo, itx,
                                           cfg.use_vndf)
        n_dot_wi = torch.abs(dot(itx.normal, ls.wi))
        w = torch.where(ls.is_delta, 1.0,
                        power_heuristic(1, ls.pdf, 1, f_pdf))
        contrib = (c.throughput * ls.radiance * f
                   * (n_dot_wi * w
                      / torch.clamp(ls.pdf, min=1e-20))[..., None])
        ok = (active & ~occluded & (ls.pdf > 0.0)
              & (ls.radiance > 0.0).any(-1))
        l_acc = c.l + _sel(ok, contrib, torch.zeros_like(contrib))

    rng, u_sel_b = _masked_1d(rng, active)
    rng, u2_b = _masked_2d(rng, active)
    wi_new, f, f_pdf, is_delta = sample_bsdf(luts, wo, u2_b, u_sel_b, itx,
                                             cfg.use_vndf)
    dead = (f == 0.0).all(-1) | (f_pdf == 0.0)
    n_dot_wi = torch.abs(dot(itx.normal, wi_new))
    throughput = c.throughput * f * (
        n_dot_wi / torch.clamp(f_pdf, min=1e-20))[..., None]
    alive = active & ~dead
    throughput = _sel(alive, throughput, c.throughput)
    ext_o = offset_ray_origin(itx.position, itx.geometry_normal, wi_new)
    ou_e = None
    if cfg.any_hit:
        rng, ou_e = _masked_1d(rng, alive)
    if has_worklist_tables(scene):
        order = sort_order(scene, ext_o, wi_new, alive)
        o, d = park_rays(alive, ext_o, wi_new)
        hit = _closest(scene, cfg, depth, o[order], d[order],
                       None if ou_e is None else ou_e[order], alive[order])
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        hit2 = HitInfo(*(x[inv] for x in hit))
    else:
        hit2 = _closest(scene, cfg, None, ext_o, wi_new, ou_e)
    itx2 = shade_hit(scene, ext_o, wi_new, hit2)
    env_idx = cfg.env_light_index if cfg.has_env_light \
        else LIGHT_INDEX_INVALID
    light_idx = torch.where(hit2.hit, itx2.light_index, env_idx)
    rad, l_pdf = evaluate_light_direct(
        scene, max(cfg.light_count, 1), cfg.has_env_texture, light_idx,
        itx2.triangle_index, itx2.geometry_normal, wi_new, hit2.t)
    w = torch.where(is_delta, 1.0, power_heuristic(1, f_pdf, 1, l_pdf))
    ok = alive & (l_pdf > 0.0)
    l_acc = l_acc + _sel(ok, throughput * rad * w[..., None],
                         torch.zeros_like(rad))
    itx_next = type(itx)(*(_sel(alive, new, old)
                           for new, old in zip(itx2, itx)))
    itx_next = itx_next._replace(
        position=_sel(alive & hit2.hit, itx2.position, itx.position))
    return _Carry(rng=rng, l=l_acc, throughput=throughput,
                  wi=_sel(alive, wi_new, c.wi), itx=itx_next,
                  active=alive & hit2.hit)


def _straight_pass(scene, luts, cam, cfg, pixel_x, pixel_y, frame_seed):
    rng = init_rng(pixel_x, pixel_y, frame_seed)
    rng, pixel_sample = next_sample_2d(rng)
    res = torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                       device=pixel_x.device)
    pix = torch.stack([pixel_x, pixel_y], dim=-1).to(torch.float32)
    rng, aperture_sample = next_sample_3d(rng)
    origin, wi = generate_ray(cam, (pixel_sample + pix) / res,
                              aperture_sample)
    ou = None
    if cfg.any_hit:
        rng, ou = next_sample_1d(rng)
    depth = megakernel_slab_depth(scene, cfg)
    hit = _closest(scene, cfg, depth, origin, wi, ou)
    itx = shade_hit(scene, origin, wi, hit)
    itx = itx._replace(position=_sel(hit.hit, itx.position, origin))
    l = torch.zeros_like(origin)
    if cfg.light_visible:
        cam_light = hit.hit & (itx.light_index != LIGHT_INDEX_INVALID)
        l = l + _sel(cam_light,
                     _mesh_light_camera_eval(scene, itx.light_index, -wi,
                                             itx.geometry_normal),
                     torch.zeros_like(l))
        if cfg.has_env_light:
            l = _sel(~hit.hit, evaluate_env(scene, wi, cfg.env_light_index,
                                            cfg.has_env_texture), l)
    c = _Carry(rng=rng, l=l, throughput=torch.ones_like(origin), wi=wi,
               itx=itx, active=hit.hit)
    for _ in range(cfg.max_bounce + 1):
        c = _straight_bounce(scene, luts, cfg, depth, c)
    return pixel_sample, c.l


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _renderer(name, **kw):
    if name == "cornell":
        return Renderer(*presets.cornell_box("area", "glossy"), W, H,
                        max_bounce=MAX_BOUNCE, device=CPU, **kw)
    if name == "alpha":
        return Renderer(*presets.alpha_panel(), W, H, max_bounce=MAX_BOUNCE,
                        device=CPU, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene_mod, "SOUP_MAX_TRIS", 256)
        r = Renderer(*presets.sphere_grid(3, 3, stacks=12, slices=16), W, H,
                     max_bounce=MAX_BOUNCE, device=CPU, **kw)
    assert r.arrays.isup_inst.shape[0] > 1 and r._inv is not None
    return r


CASES = {"cornell-3": ("cornell", 3, {}),
         "cornell-big-seed": ("cornell", 2**31 + 77, {}),
         "alpha": ("alpha", 5, {}),
         "sorted": ("sorted", 7, {}),
         "sorted-slab": ("sorted", 9, dict(slab_march=0.03))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segmented_pass_equals_the_straight_pass(case):
    name, seed, kw = CASES[case]
    r = _renderer(name, **kw)
    if name == "alpha":
        assert r.cfg.any_hit
    args = (r.arrays, r.luts, r.camera, r.cfg, r._px, r._py, seed)
    before = megakernel.graph_counters()["eager_segments"]
    pos, val = render_samples(*args)
    n_segments = 2 * (MAX_BOUNCE + 2)
    assert megakernel.graph_counters()["eager_segments"] == \
        before + n_segments
    want_pos, want_val = _straight_pass(*args)
    assert torch.equal(pos, want_pos)
    assert torch.equal(val, want_val)
    assert float(val.abs().sum()) > 0.0


def test_pass_key_follows_edits_and_cameras():
    r = _renderer("cornell")

    def key():
        return megakernel.PassKey(r._px.shape[0], r.cfg, r.arrays, r.luts,
                                  r.camera)

    k0 = key()
    assert key() == k0
    r.render(1)
    r.reset()
    assert key() == k0
    seen = [k0]
    for edit in (lambda: r.set_material(0, albedo=(0.2, 0.3, 0.4)),
                 lambda: r.set_light(0, radiance=(5.0, 5.0, 5.0)),
                 lambda: r.set_instance_override(0, 1),
                 lambda: r.set_emitter_radiance(
                     int(np.flatnonzero(
                         (r.arrays.instance_light_indices
                          != LIGHT_INDEX_INVALID).numpy())[0]),
                     (3.0, 3.0, 3.0)),
                 lambda: setattr(r, "camera", r.camera._replace(
                     focal_distance=r.camera.focal_distance * 2.0))):
        edit()
        k = key()
        assert all(k != s for s in seen)
        r.reset()
        assert key() == k
        seen.append(k)
    # another chunk length, another config: other keys
    assert megakernel.PassKey(7, r.cfg, r.arrays, r.luts, r.camera) != key()
    import dataclasses
    assert megakernel.PassKey(
        r._px.shape[0], dataclasses.replace(r.cfg, max_bounce=2), r.arrays,
        r.luts, r.camera) != key()


class _FakeGraphedPass:
    """Stands in for the CUDA graphs on the CPU: a replay runs the pass
    eagerly, so results can be compared."""

    made = []

    def __init__(self, key, depth, device):
        self.key, self.replays, self.results = key, 0, None
        _FakeGraphedPass.made.append(self)

    def capture(self, results):
        self.results = results

    def replay(self, pixel_x, pixel_y, frame_seed):
        self.replays += 1
        return render_samples(*self.key.refs[:3], self.key.cfg, pixel_x,
                              pixel_y, frame_seed)


def test_pass_graphs_capture_replay_and_evict(monkeypatch):
    monkeypatch.setattr(megakernel, "_GraphedPass", _FakeGraphedPass)
    _FakeGraphedPass.made = []
    r = _renderer("cornell")
    graphs = megakernel.PassGraphs()
    args = (r.arrays, r.luts, r.camera, r.cfg)
    px, py = r._px, r._py
    n_seg = 2 * (MAX_BOUNCE + 2)
    before = megakernel.graph_counters()["eager_segments"]
    out = graphs.run(*args, px, py, 3)
    # the first pass for a key is eager and captures nothing
    want = render_samples(*args, px, py, 3)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert megakernel.graph_counters()["eager_segments"] == \
        before + 2 * n_seg
    assert _FakeGraphedPass.made == [] and len(graphs.seen) == 1
    # the second is eager too, and then captures
    out = graphs.run(*args, px, py, 4)
    want = render_samples(*args, px, py, 4)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert megakernel.graph_counters()["eager_segments"] == \
        before + 4 * n_seg
    assert graphs.seen == []
    (p,) = _FakeGraphedPass.made
    # one buffer a cast, shaped like its result: closest, then per bounce
    # the shadow and the extension cast
    kinds = [type(x) for x in p.results]
    assert kinds == [HitInfo] + [torch.Tensor, HitInfo] * (MAX_BOUNCE + 1)
    for buf in p.results:
        first = buf[0] if isinstance(buf, HitInfo) else buf
        assert first.shape[0] == W * H
    # a known key replays
    out = graphs.run(*args, px, py, 5)
    assert p.replays == 1 and len(_FakeGraphedPass.made) == 1
    want = render_samples(*args, px, py, 5)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    # a second key captures beside the first; a third evicts the least
    # recently used
    for _ in range(2):
        graphs.run(*args, px[:100], py[:100], 5)
    graphs.run(*args, px, py, 6)
    assert [q.key.n for q in graphs.passes] == [100, W * H]
    for _ in range(2):
        graphs.run(*args, px[:50], py[:50], 6)
    assert [q.key.n for q in graphs.passes] == [W * H, 50]
    assert len(_FakeGraphedPass.made) == 3 and p.replays == 2
    # keys seen once are kept two at most, the least recently used
    # dropped, and a dropped key starts over
    for n in (10, 20, 30):
        graphs.run(*args, px[:n], py[:n], 7)
    assert [k.n for k in graphs.seen] == [20, 30]
    graphs.run(*args, px[:10], py[:10], 7)
    assert [k.n for k in graphs.seen] == [30, 10]
    assert len(_FakeGraphedPass.made) == 3


def test_renderer_graphs_only_the_cuda_megakernel():
    assert _renderer("cornell")._graphs is None
    assert Renderer(*presets.cornell_box("area", "glossy"), 8, 8,
                    max_bounce=1, integrator="wavefront",
                    device=CPU)._graphs is None


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _launches():
    """(the dense sweeps' launch counters, the BSDF wrappers' ones)."""
    from directcomputeraytracing_tpu_torch.accel import brute

    return ((brute.brute_closest.launches, brute.brute_any.launches),
            (fused.evaluate_bsdf_value_pdf.launches,
             fused.sample_bsdf.launches))


def _moved(a, b):
    return [[y - x for x, y in zip(p, q)] for p, q in zip(a, b)]


def _cuda_cornell(dev, size, graphed):
    r = Renderer(*presets.cornell_box("area", "glossy"), size, size,
                 max_bounce=MAX_BOUNCE, device=dev)
    assert r._graphs is not None
    if not graphed:
        r._graphs = None
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 2500], ids=["one_chunk",
                                                     "two_chunks"])
def test_cuda_graphed_render_equals_eager(monkeypatch, chunk):
    """64x64 Cornell, passes of 1 spp with progressive seeds: the graphed
    renderer's images equal the eager renderer's bit for bit, before and
    after a `set_material` edit; with 2500-pixel chunks a pass replays two
    keys' graphs (2500 and 1596 pixels). Every pass launches the same
    casts both ways; the BSDF wrappers count the eager passes' launches
    and none of a replayed pass (the profiler test sees its kernels)."""
    dev = _cuda()
    if chunk:
        monkeypatch.setattr(rmod, "CHUNK_PIXELS", chunk)
    g, e = _cuda_cornell(dev, 64, True), _cuda_cornell(dev, 64, False)
    counts0 = megakernel.graph_counters()
    # passes 0 and 4 (a new renderer, an edit) run eagerly, passes 1 and 5
    # run eagerly and capture, the rest replay
    replayed = {2, 3, 6}
    for step in range(7):
        if step == 4:
            for r in (g, e):
                r.set_material(1, albedo=(0.1, 0.7, 0.2), roughness=0.4)
        n0 = _launches()
        img_g = g.render(1)
        torch.cuda.synchronize()
        n1 = _launches()
        img_e = e.render(1)
        torch.cuda.synchronize()
        n2 = _launches()
        assert np.array_equal(img_g, img_e), step
        (casts_g, bsdf_g), (casts_e, bsdf_e) = _moved(n0, n1), _moved(n1, n2)
        assert casts_g == casts_e, step
        assert bsdf_e == [(MAX_BOUNCE + 1) * g.n_chunks] * 2, step
        assert bsdf_g == ([0, 0] if step in replayed else bsdf_e), step
    counts = megakernel.graph_counters()
    keys = 2 if chunk else 1
    n_seg = 2 * (MAX_BOUNCE + 2)
    assert counts["captures"] - counts0["captures"] == 2 * keys * n_seg
    assert counts["replays"] - counts0["replays"] == \
        len(replayed) * keys * n_seg
    # the graphs of the two keys used last stay, the edited scene's last
    assert len(g._graphs.passes) == megakernel.PassGraphs.MAX_KEYS
    assert g._graphs.passes[-1].key.refs[0] is g.arrays


@pytest.mark.cuda
def test_cuda_profiler_sees_the_same_kernels():
    """One replayed pass and one eager pass under the profiler: the same
    hand-written kernels, as many of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda()
    g, e = _cuda_cornell(dev, 64, True), _cuda_cornell(dev, 64, False)
    # the graphed renderer's second pass captures, its third replays
    for r in (g, e):
        r.render(1)
        r.render(1)
    torch.cuda.synchronize()
    assert len(g._graphs.passes) == 1

    def kernels(r):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r.render(1)
            torch.cuda.synchronize()
        return collections.Counter(
            ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA)

    got, want = kernels(g), kernels(e)
    mine = [n for n in want if "bsdf_" in n or "closest_kernel" in n
            or "any_kernel" in n]
    assert len(mine) >= 4, sorted(want)
    for n in mine:
        assert got[n] == want[n], n
    print("graphed - eager:", dict(got - want), "eager - graphed:",
          dict(want - got))
