"""The port's scene ingestion against the reference's, on the CPU.

Both packages load the same files: the reference tests' OBJ/MTL pair
and XML scenes (`tests/test_obj_loader.py`, `tests/test_xml_loader.py`,
textures written with PIL as those tests write them) and the small
stand-in, `write_standin_scene(d, nx=2, nz=2, stacks=8, slices=12)`.
Tolerance: none. The loaders, MikkTSpace and the stand-in writer are
the same numpy code in both packages, so every `Mesh`, `Material`,
`Instance`, light, texture and `XmlRenderSettings` field is equal bit for
bit, the camera equals the reference's through `from_reference`, and
`flatten_scene` gives equal tensors, as `test_torch_scene.py` holds them.
The stand-in's files are equal byte for byte. `generate_tangents` is
held to the reference's bit for bit on the cases of
`tests/test_mikktspace.py` (whose own asserts then run on the port's
tangents) and on the welded mesh of `tests/test_mikktspace_oracle.py`,
in place of that test's C oracle, which needs sources outside the repo.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu.lut.textures import (
    placeholder_luts as ref_placeholder_luts,
)
from directcomputeraytracing_tpu.scene import mikktspace as ref_mikkt
from directcomputeraytracing_tpu.scene import obj_loader as ref_obj
from directcomputeraytracing_tpu.scene import standin as ref_standin
from directcomputeraytracing_tpu.scene import xml_loader as ref_xml
from directcomputeraytracing_tpu.scene.scene import flatten_scene as ref_flatten
from directcomputeraytracing_tpu_torch.core.types import (
    CameraParams,
    SceneTensors,
    from_reference,
)
from directcomputeraytracing_tpu_torch.scene import mikktspace as port_mikkt
from directcomputeraytracing_tpu_torch.scene import obj_loader as port_obj
from directcomputeraytracing_tpu_torch.scene import standin as port_standin
from directcomputeraytracing_tpu_torch.scene import xml_loader as port_xml
from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene

TESTS = os.path.dirname(os.path.abspath(__file__))
SMALL_STANDIN = dict(nx=2, nz=2, stacks=8, slices=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _test_module(name):
    """A reference test module, loaded from its file for its inputs."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(TESTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same(want, got, where="scene"):
    """Recursive equality: dataclasses field by field, arrays by dtype,
    shape and bits, containers item by item, scalars by type and value."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        assert type(got).__module__.startswith(
            "directcomputeraytracing_tpu_torch."), where
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)], where
        for f in dataclasses.fields(want):
            if f.name != "camera":
                _assert_same(getattr(want, f.name), getattr(got, f.name),
                             f"{where}.{f.name}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert want.dtype == got.dtype and want.shape == got.shape, where
        assert np.array_equal(want, got, equal_nan=True), where
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{where}[{i}]")
    else:
        assert type(got) is type(want), (where, type(want), type(got))
        assert got == want or (want != want and got != got), where


def _cornell_camera():
    from directcomputeraytracing_tpu.scene.presets import cornell_box

    return cornell_box("area", "diffuse")[1]


def _assert_flatten_equal(ref_scene, scene, ref_camera=None, camera=None):
    """flatten_scene's tensors (and the camera, where given) equal the
    reference's through `from_reference`."""
    ref_arrays, ref_meta = ref_flatten(ref_scene)
    want, _, want_cam = from_reference(
        ref_arrays, ref_placeholder_luts(),
        _cornell_camera() if ref_camera is None else ref_camera, "cpu")
    got, meta = flatten_scene(scene, "cpu")
    for f in SceneTensors._fields:
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
    for f in ("light_count", "env_light_index", "has_env_texture",
              "any_non_opaque", "any_opacity_texture"):
        assert getattr(meta, f) == getattr(ref_meta, f), f
    if camera is not None:
        assert isinstance(camera, CameraParams)
        for f in CameraParams._fields:
            x, y = getattr(want_cam, f), getattr(camera, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f


def _write_scene(kind, d):
    """The scene file of `kind` in directory d (both loaders read it)."""
    d = str(d)
    if kind == "obj":
        mod = _test_module("test_obj_loader")
        with open(os.path.join(d, "test.obj"), "w") as f:
            f.write(mod.OBJ)
        with open(os.path.join(d, "test.mtl"), "w") as f:
            f.write(mod.MTL)
        return os.path.join(d, "test.obj")
    if kind == "standin":
        return ref_standin.write_standin_scene(d, **SMALL_STANDIN)
    mod = _test_module("test_xml_loader")
    path = os.path.join(d, "scene.xml")
    if kind == "xml":
        text = mod.XML
    else:
        from PIL import Image

        a = np.zeros((4, 8, 3), np.uint8)
        a[..., 0] = 255
        Image.fromarray(a, "RGB").save(os.path.join(d, "albedo.png"))
        o = np.zeros((4, 4), np.uint8)
        o[:2] = 255
        Image.fromarray(o, "L").save(os.path.join(d, "alpha.png"))
        text = mod.TEXTURED_XML
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("kind", ["obj", "xml", "textured_xml", "standin"])
def test_loaders_match_reference(kind, tmp_path):
    path = _write_scene(kind, tmp_path)
    ref_camera = camera = None
    if kind == "obj":
        want, got = ref_obj.load_obj(path), port_obj.load_obj(path)
    else:
        want, ref_settings = ref_xml.load_mitsuba_xml(path)
        got, settings = port_xml.load_mitsuba_xml(path)
        _assert_same(ref_settings, settings, "settings")
        ref_camera, camera = ref_settings.camera, settings.camera
    _assert_same(want, got)
    assert got.meshes and got.materials
    if kind in ("textured_xml", "standin"):
        assert got.textures
        assert any(m.opacity_texture >= 0 for m in got.materials)
    _assert_flatten_equal(want, got, ref_camera, camera)


def test_parse_mtl_matches_reference(tmp_path):
    path = _write_scene("obj", tmp_path)
    mtl = os.path.join(os.path.dirname(path), "test.mtl")
    want, got = ref_obj.parse_mtl(mtl), port_obj.parse_mtl(mtl)
    assert list(want) == list(got) == ["red", "blue"]
    for k in want:
        _assert_same(want[k], got[k], k)
    assert port_obj.parse_mtl(os.path.join(str(tmp_path), "none.mtl")) == {}


def test_standin_files_equal_reference(tmp_path):
    a = ref_standin.write_standin_scene(str(tmp_path / "ref"),
                                        **SMALL_STANDIN)
    b = port_standin.write_standin_scene(str(tmp_path / "port"),
                                         **SMALL_STANDIN)
    assert os.path.basename(a) == os.path.basename(b) == "standin.xml"
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 4
    for n in names:
        assert (tmp_path / "ref" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


def test_standin_defaults_equal_reference(tmp_path):
    """The full stand-in's XML (144 spheres) equals the reference's; its
    sphere has 1472 triangles (212k in the world)."""
    a = ref_standin.write_standin_scene(str(tmp_path / "ref"))
    b = port_standin.write_standin_scene(str(tmp_path / "port"))
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    assert port_standin._write_sphere_obj(str(tmp_path / "s.obj")) == 1472


def _checked(ref_fn, port_fn):
    """port_fn, after asserting that ref_fn gives the same bits."""
    def fn(*args, **kw):
        want = ref_fn(*args, **kw)
        got = port_fn(*args, **kw)
        _assert_same(want, got, port_fn.__name__)
        return got
    return fn


_MIKKT = _test_module("test_mikktspace")
_MIKKT_CASES = sorted(n for n in dir(_MIKKT) if n.startswith("test_"))


@pytest.mark.parametrize("case", _MIKKT_CASES)
def test_mikktspace_cases_on_the_port(case, monkeypatch):
    """Each case of `tests/test_mikktspace.py` with the port's functions
    in place of the reference's, every call checked against the
    reference's bit for bit."""
    assert len(_MIKKT_CASES) == 9
    for name in ("generate_tangents", "corner_tangents_for_mesh"):
        monkeypatch.setattr(_MIKKT, name, _checked(
            getattr(ref_mikkt, name), getattr(port_mikkt, name)))
    monkeypatch.setattr(ref_obj, "compute_tangents", _checked(
        ref_obj.compute_tangents, port_obj.compute_tangents))
    getattr(_MIKKT, case)()


def test_mikktspace_welded_mesh_matches_reference():
    """The oracle test's welded mesh (a sphere with a UV seam, two fans on
    one apex, mirrored UVs, degenerate triangles)."""
    pos, nrm, uv = _test_module("test_mikktspace_oracle")._welded_test_mesh()
    want = ref_mikkt.generate_tangents(pos, nrm, uv)
    got = port_mikkt.generate_tangents(pos, nrm, uv)
    _assert_same(want, got, "generate_tangents")
    assert (np.linalg.norm(got[0], axis=-1) > 0.5).all()


def test_compute_tangents_matches_reference(monkeypatch):
    """The OBJ test's angle-weighted, handedness-split case on the port."""
    monkeypatch.setattr(ref_obj, "compute_tangents", _checked(
        ref_obj.compute_tangents, port_obj.compute_tangents))
    _test_module("test_obj_loader") \
        .test_tangents_angle_weighted_and_handedness_split()
