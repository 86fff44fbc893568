"""Scene edits (`scene.edit`), the renderer's `set_*` and `preview`, on
the CPU: each edit against the port's re-flatten of the edited scene and
against the reference's edit of the reference's flatten (through
`from_reference`).

Scenes: Cornell (area or point light; with material 1 at opacity 0.6
where the alpha tables must exist, as the reference's `test_edit.py`
does), the small alpha grid (`alpha_sphere_grid(3, 3, stacks=12,
slices=16)`, 3172 world triangles with the opaque/masked split) and the
small sphere grid (work-list tables, tiled pixels).

Tolerances:
- table fields: equal, bit for bit (the same float32 values written, the
  same comparisons); the split fields of an opacity or override edit are
  the placeholders, as the reference's edit writes them.
- an edited renderer against a fresh renderer of the edited scene (box
  film, fixed seed): equal images; through the dropped split against a
  fresh renderer with the split: image RMSE <= 1e-3
  (`test_torch_render.py`'s gate), since the split and the full recast
  find the same hits up to the casts' rounding.
- `preview` against a fresh reduced-size render: equal; against the
  reference's preview: RMSE <= 1e-3.
- on the card (`cuda`): edited tables equal the CPU's bit for bit;
  `preview` within `chip_smoke.py`'s CPU-vs-card gate (RMSE <= 0.02, at
  most 1 % diverged pixels).
"""

import copy

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.accel import traverse
from directcomputeraytracing_tpu_torch.accel import worklist as wl
from directcomputeraytracing_tpu_torch.core.constants import (
    MATERIAL_TYPE_PLASTIC,
)
from directcomputeraytracing_tpu_torch.core.types import from_reference
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.scene import edit
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene import scene as scene_mod

CPU = torch.device("cpu")
W = H = 32
GATE_RMSE = 1e-3
CARD_GATE_RMSE, CARD_GATE_DIVERGED = 0.02, 0.01
GRID = (3, 3)
GRID_KW = dict(stacks=12, slices=16)
FIELDS = [
    ("albedo", (0.1, 0.6, 0.2)),
    ("roughness", 0.37),
    ("ior", (1.9, 1.9, 1.9)),
    ("tiling", (2.0, 3.0)),
    ("opacity", 0.25),
]
ALPHA_FIELDS = ("mat_table", "tri_opacity", "world_tri_opacity",
                "instance_flags", "instance_material_overrides")
SPLIT = scene_mod._SPLIT_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cornell(light="area", alpha=True, ref=False):
    """Cornell (port's or reference's); alpha: material 1 at opacity 0.6,
    so the flatten builds the alpha tables."""
    if ref:
        from directcomputeraytracing_tpu.scene.presets import cornell_box
    else:
        cornell_box = presets.cornell_box
    scene, cam = cornell_box(light=light)
    if alpha:
        scene.materials[1].opacity = 0.6
    return scene, cam


def _alpha_grid(ref=False):
    if not ref:
        return presets.alpha_sphere_grid(*GRID, **GRID_KW)
    from directcomputeraytracing_tpu.scene import scene as rs
    from directcomputeraytracing_tpu.scene.presets import sphere_grid

    scene, cam = sphere_grid(*GRID, **GRID_KW)
    presets.set_alpha_material(scene, rs.Material, False, **GRID_KW)
    return scene, cam


def _flat(scene):
    """The port's flatten of a copy of scene."""
    return scene_mod.flatten_scene(copy.deepcopy(scene), CPU)[0]


def _ref_flat(scene):
    from directcomputeraytracing_tpu.scene.scene import flatten_scene

    return flatten_scene(copy.deepcopy(scene))[0]


def _as_port(ref_arrays, ref_cam):
    """The reference's SceneArrays as the port's SceneTensors."""
    from directcomputeraytracing_tpu.lut.textures import placeholder_luts

    return from_reference(ref_arrays, placeholder_luts(), ref_cam, CPU)[0]


def _ref_edit():
    from directcomputeraytracing_tpu.scene import edit as ref_edit

    return ref_edit


def _assert_fields(got, want, fields):
    for f in fields:
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


@pytest.mark.parametrize("field,value", FIELDS, ids=[f[0] for f in FIELDS])
def test_update_material_matches_reflatten_and_reference(field, value):
    scene, _ = _cornell()
    ref_scene, ref_cam = _cornell(ref=True)
    arrays = _flat(scene)
    got = edit.update_material(arrays, 2, **{field: value})
    setattr(scene.materials[2], field, value)
    _assert_fields(got, _flat(scene), ALPHA_FIELDS)

    ref = _ref_edit().update_material(_ref_flat(ref_scene), 2,
                                      **{field: value})
    _assert_fields(got, _as_port(ref, ref_cam), ALPHA_FIELDS + SPLIT)
    # the reference's material columns are the port's mat_table columns
    for name, col, width in (("mat_albedo", 0, 3), ("mat_ior", 3, 3),
                             ("mat_roughness", 6, 1), ("mat_tiling", 7, 2),
                             ("mat_opacity", 9, 1)):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, name)).reshape(-1, width),
            got.mat_table[:, col:col + width].numpy(), err_msg=name)


def test_update_material_flags():
    scene, _ = _cornell(alpha=False)
    ref_scene, ref_cam = _cornell(alpha=False, ref=True)
    arrays = _flat(scene)
    m = scene.materials[2]
    m.mtype, m.two_sided, m.multiscattering = MATERIAL_TYPE_PLASTIC, True, True
    flags = m.flags()
    got = edit.update_material_flags(arrays, 2, flags)
    _assert_fields(got, _flat(scene), ("mat_table",))
    ref = _ref_edit().update_material_flags(_ref_flat(ref_scene), 2, flags)
    _assert_fields(got, _as_port(ref, ref_cam), ("mat_table",))
    assert int(np.asarray(ref.mat_flags)[2]) == flags == \
        int(got.mat_table[2, 10])


def test_update_light():
    scene, _ = _cornell("point", alpha=False)
    ref_scene, ref_cam = _cornell("point", alpha=False, ref=True)
    arrays = _flat(scene)
    rad, pos = (5.0, 4.0, 3.0), (0.1, 4.0, 0.2)
    got = edit.update_light(arrays, 0, radiance=rad, position=pos)
    scene.lights[0].radiance, scene.lights[0].position = rad, pos
    fields = ("light_radiance", "light_position")
    _assert_fields(got, _flat(scene), fields)
    ref = _ref_edit().update_light(_ref_flat(ref_scene), 0, radiance=rad,
                                   position=pos)
    _assert_fields(got, _as_port(ref, ref_cam), fields)
    only = edit.update_light(arrays, 0, radiance=rad)
    assert torch.equal(only.light_position, arrays.light_position)


def test_update_instance_override_set_and_clear():
    scene, _ = _cornell()
    ref_scene, ref_cam = _cornell(ref=True)
    arrays = _flat(scene)
    ref_arrays = _ref_flat(ref_scene)
    got = edit.update_instance_override(arrays, 1, 1)   # a non-opaque one
    edited = copy.deepcopy(scene)
    edited.instances[1].material_override = 1
    _assert_fields(got, _flat(edited), ALPHA_FIELDS)
    ref = _ref_edit().update_instance_override(ref_arrays, 1, 1)
    _assert_fields(got, _as_port(ref, ref_cam), ALPHA_FIELDS + SPLIT)
    assert int(got.instance_flags[1]) == 0

    cleared = edit.update_instance_override(got, 1, -1)
    _assert_fields(cleared, arrays, ALPHA_FIELDS)
    ref_cleared = _ref_edit().update_instance_override(ref, 1, -1)
    _assert_fields(cleared, _as_port(ref_cleared, ref_cam), ALPHA_FIELDS)
    with pytest.raises(IndexError):
        edit.update_instance_override(arrays, 1, len(scene.materials))


def test_update_emitter_radiance():
    scene, _ = _cornell(alpha=False)
    ref_scene, ref_cam = _cornell(alpha=False, ref=True)
    arrays = _flat(scene)
    ref_arrays = _ref_flat(ref_scene)
    em = next(i for i, inst in enumerate(scene.instances) if inst.is_emitter)
    rad = (9.0, 8.0, 7.0)
    got = edit.update_emitter_radiance(arrays, em, rad)
    scene.instances[em].radiance = rad
    _assert_fields(got, _flat(scene), ("light_radiance",))
    ref = _ref_edit().update_emitter_radiance(ref_arrays, em, rad)
    _assert_fields(got, _as_port(ref, ref_cam), ("light_radiance",))
    # a non-emitter changes nothing, in either package
    non_em = next(i for i, inst in enumerate(scene.instances)
                  if not inst.is_emitter)
    same = edit.update_emitter_radiance(arrays, non_em, rad)
    _assert_fields(same, arrays, ("light_radiance",))
    ref_same = _ref_edit().update_emitter_radiance(ref_arrays, non_em, rad)
    _assert_fields(same, _as_port(ref_same, ref_cam), ("light_radiance",))


def test_light_index_of():
    scene, _ = _cornell("area", alpha=False)
    ref_scene, _ = _cornell("area", alpha=False, ref=True)
    arrays, ref_arrays = _flat(scene), _ref_flat(ref_scene)
    got = [edit.light_index_of(arrays, i) for i in range(len(scene.instances))]
    want = [_ref_edit().light_index_of(ref_arrays, i)
            for i in range(len(scene.instances))]
    assert got == want
    assert sum(li is not None for li in got) == 1


def test_opacity_edit_drops_the_split():
    """An opacity edit on the split grid writes the six placeholders, as
    the reference's edit does; the other alpha fields equal the
    re-flatten's, which keeps a split."""
    scene, _ = _alpha_grid()
    ref_scene, ref_cam = _alpha_grid(ref=True)
    arrays = _flat(scene)
    assert traverse._has_alpha_split(arrays, "wl")
    got = edit.update_material(arrays, 1, opacity=0.7)
    assert not traverse._has_alpha_split(got, "wl")
    for f, placeholder in zip(SPLIT, scene_mod._no_clusters() * 2):
        assert torch.equal(getattr(got, f), torch.from_numpy(placeholder)), f
    ref = _ref_edit().update_material(_ref_flat(ref_scene), 1, opacity=0.7)
    _assert_fields(got, _as_port(ref, ref_cam), ALPHA_FIELDS + SPLIT)
    scene.materials[1].opacity = 0.7
    want = _flat(scene)
    _assert_fields(got, want, ALPHA_FIELDS)
    assert traverse._has_alpha_split(want, "wl")


def test_render_through_the_dropped_split():
    """An edited split grid renders through the full recast path what a
    fresh renderer renders through the split."""
    scene, cam = _alpha_grid()
    r = Renderer(copy.deepcopy(scene), cam, W, H, max_bounce=2, device=CPU)
    r.set_material(1, opacity=0.7)
    assert r.arrays.mclu_bbox.shape[0] == 1 and r.cfg.any_hit
    got = r.render(spp=2)
    scene.materials[1].opacity = 0.7
    fresh = Renderer(scene, cam, W, H, max_bounce=2, device=CPU)
    assert fresh.arrays.mclu_bbox.shape[0] > 1
    want = fresh.render(spp=2)
    assert got.mean() > 0.0
    assert _rmse(got, want) <= GATE_RMSE


def test_non_soup_scene_rejects_opacity_edits(monkeypatch):
    """Scenes without the world soup (here the small grid forced onto the
    instanced tables) carry no triangle-to-instance table: opacity and
    override edits raise, the other edits work."""
    monkeypatch.setattr(scene_mod, "SOUP_MAX_TRIS", 2048)
    arrays = _flat(_alpha_grid()[0])
    assert wl.instanced(arrays) and arrays.world_tris.shape[0] == 1
    with pytest.raises(ValueError, match="world soup"):
        edit.update_material(arrays, 1, opacity=0.7)
    with pytest.raises(ValueError, match="world soup"):
        edit.update_instance_override(arrays, 1, 0)
    got = edit.update_material(arrays, 1, albedo=(0.1, 0.2, 0.3))
    assert got.mat_table[1, 0:3].tolist() == pytest.approx([0.1, 0.2, 0.3])


EDITS = {
    "albedo": lambda a: edit.update_material(a, 0, albedo=(0.2, 0.3, 0.4)),
    "opacity": lambda a: edit.update_material(a, 0, opacity=0.5),
    "flags": lambda a: edit.update_material_flags(a, 0, MATERIAL_TYPE_PLASTIC),
    "light": lambda a: edit.update_light(a, 0, radiance=(1.0, 2.0, 3.0)),
    "override_set": lambda a: edit.update_instance_override(a, 1, 1),
    "override_clear": lambda a: edit.update_instance_override(a, 1, -1),
    "emitter": lambda a: edit.update_emitter_radiance(
        a, a.instance_flags.shape[0] - 1, (5.0, 5.0, 5.0)),
}


@pytest.mark.parametrize("name", list(EDITS))
def test_edits_keep_table_identity(name):
    """The traversal table caches key on the geometry tensors: an edit
    keeps them, so no table is rebuilt (split grid, work-list tables
    and node tables built before the edit)."""
    arrays = _flat(_alpha_grid()[0])
    tables, nodes = wl.scene_tables(arrays), traverse.node_tables(arrays)
    got = EDITS[name](arrays)
    for f in ("cluster_bbox", "inst_rows", "world_tris", "world_tri_meta",
              "cluster_tris", "cluster_bw", "isup_sbox", "vtx_table",
              "triangles"):
        assert getattr(got, f) is getattr(arrays, f), f
    assert wl.scene_tables(got) is tables
    assert traverse.node_tables(got) is nodes


def test_renderer_edit_equals_fresh_renderer():
    """An edited renderer renders exactly what a renderer of the edited
    scene renders (fixed seed, box film); the edit restarts the film and
    keeps frame_index."""
    scene, cam = presets.cornell_box(light="area")
    r = Renderer(copy.deepcopy(scene), cam, W, H, max_bounce=2, device=CPU)
    before = r.render(spp=1, seed_mode="fixed")
    frames = r.frame_index
    r.set_material(2, albedo=(0.9, 0.1, 0.1))
    assert r.spp == 0 and r.frame_index == frames
    assert float(r.film.weight.max()) == 0.0
    after = r.render(spp=1, seed_mode="fixed")
    assert np.abs(after - before).max() > 1e-4
    scene.materials[2].albedo = (0.9, 0.1, 0.1)
    fresh = Renderer(scene, cam, W, H, max_bounce=2,
                     device=CPU).render(spp=1, seed_mode="fixed")
    np.testing.assert_array_equal(after, fresh)


def test_renderer_light_edit_scales_radiance():
    scene, cam = presets.cornell_box(light="point")
    r = Renderer(scene, cam, W, H, max_bounce=2, device=CPU)
    base = r.render(spp=1, seed_mode="fixed")
    r.set_light(0, radiance=tuple(np.asarray(scene.lights[0].radiance) * 2))
    assert r.spp == 0
    doubled = r.render(spp=1, seed_mode="fixed")
    # direct lighting scales linearly with the only light's radiance
    lit = base.sum(-1) > 1e-6
    assert lit.mean() > 0.3
    np.testing.assert_allclose(doubled.sum(-1)[lit] / base.sum(-1)[lit], 2.0,
                               rtol=1e-4)


def test_renderer_override_and_emitter_edits_equal_fresh_renderers():
    scene, cam = presets.cornell_box(light="area")
    r = Renderer(copy.deepcopy(scene), cam, W, H, max_bounce=2, device=CPU)
    em = next(i for i, inst in enumerate(scene.instances) if inst.is_emitter)
    r.set_emitter_radiance(em, (3.0, 6.0, 9.0))
    r.set_instance_override(0, 2)
    got = r.render(spp=1, seed_mode="fixed")
    scene.instances[em].radiance = (3.0, 6.0, 9.0)
    scene.instances[0].material_override = 2
    want = Renderer(scene, cam, W, H, max_bounce=2,
                    device=CPU).render(spp=1, seed_mode="fixed")
    np.testing.assert_array_equal(got, want)


def _preview_scene(name):
    if name == "cornell":
        return presets.cornell_box("area", "glossy")
    return presets.sphere_grid(*GRID, **GRID_KW)


@pytest.mark.parametrize("name", ["cornell", "grid"])
def test_preview_equals_reduced_render(name):
    """preview(1, s) equals a fresh render(1, seed_mode="fixed") at
    (W//s, H//s), full-frame on Cornell and in tiles on the grid, at a
    size that is no multiple of the 32-pixel tile."""
    w, h, s = 75, 90, 2
    r = Renderer(*_preview_scene(name), w, h, max_bounce=2, device=CPU)
    got = r.preview(spp=1, scale=s)
    small = Renderer(*_preview_scene(name), w // s, h // s, max_bounce=2,
                     device=CPU)
    assert (small._inv is not None) == (name == "grid")
    want = small.render(spp=1, seed_mode="fixed")
    assert got.shape == (h // s, w // s, 3) and got.mean() > 0.0
    np.testing.assert_array_equal(got, want)


def test_preview_leaves_the_film():
    r = Renderer(*presets.cornell_box("area"), W, H, max_bounce=1,
                 device=CPU)
    img = r.render(spp=2)
    two = r.preview(spp=2, scale=4)
    assert r.spp == 2 and r.frame_index == 2
    np.testing.assert_array_equal(r.image(), img)
    one = r.preview(spp=1, scale=4)
    assert two.shape == one.shape == (H // 4, W // 4, 3)
    assert not np.array_equal(one, two)
    with pytest.raises(ValueError):
        r.preview(spp=0)


def test_preview_matches_reference_preview():
    """The port's preview and the reference's, same scene, same seeds."""
    from directcomputeraytracing_tpu.integrator.renderer import (
        Renderer as RefRenderer,
    )

    ref = RefRenderer(*_cornell(alpha=False, ref=True), W, H, max_bounce=2)
    want = ref.preview(spp=2, scale=2)
    got = Renderer(*_cornell(alpha=False), W, H, max_bounce=2,
                   device=CPU).preview(spp=2, scale=2)
    assert got.shape == want.shape == (H // 2, W // 2, 3)
    assert got.mean() > 0.0
    assert _rmse(got, np.asarray(want)) <= GATE_RMSE


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EDITS))
def test_cuda_edits_match_cpu(name):
    """Each edit on the card's tensors gives the CPU's tables bit for
    bit."""
    dev = _card()
    arrays = _flat(_alpha_grid()[0])
    want = EDITS[name](arrays)
    got = EDITS[name](type(arrays)(*(x.to(dev) for x in arrays)))
    for f in type(arrays)._fields:
        x = getattr(got, f)
        assert x.device.type == "cuda", f
        assert torch.equal(x.cpu(), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "grid"])
def test_cuda_preview_matches_cpu(name):
    dev = _card()
    imgs = [Renderer(*_preview_scene(name), 75, 90, max_bounce=2,
                     device=d).preview(spp=2, scale=2) for d in (CPU, dev)]
    a, b = imgs
    diverged = (np.abs(a - b).max(-1) > 1e-3 * (1.0 + np.abs(a).max(-1)))
    assert _rmse(a, b) <= CARD_GATE_RMSE
    assert diverged.mean() <= CARD_GATE_DIVERGED
