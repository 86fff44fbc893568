"""The port's C++ SAH builder (`ops/native`) against its numpy builder
(`accel/build.py` `build_bvh(..., use_native=False)`) and the
reference's numpy builder, bit for bit: every field of the `BVH`, float
fields compared as their bits (so -0 and +0 differ), dtypes and
`max_depth` included.

Sets: the reference test's random boxes (`tests/test_native_bvh.py`),
identical centroids, signed zeros (four boxes whose x-minimum runs +0,
-0, +0, -0, and seeded boxes with many +-0 faces), seeded jittered grids
(near-tied SAH costs, where an area in double splits otherwise), and
real meshes and a TLAS (Cornell, `sphere_grid(3, 3)`'s meshes,
`walker_grid(20, 20)`'s instance boxes with one primitive a leaf). Then
the `DCRT_NATIVE_BVH` / `use_native` switch, and the raising: an empty
input, a missing compiler, a source that does not compile.
"""

import os
import re
import time

import numpy as np
import pytest

from directcomputeraytracing_tpu_torch.accel import build as port_build
from directcomputeraytracing_tpu_torch.ops import native
from directcomputeraytracing_tpu_torch.scene import presets
from directcomputeraytracing_tpu_torch.scene.scene import triangle_bounds
from directcomputeraytracing_tpu_torch.utils import cuda_build

FIELDS = ("bbox_min", "bbox_max", "right_or_prim", "misc", "prim_order",
          "leaf_depths")
DTYPES = dict(bbox_min=np.float32, bbox_max=np.float32,
              right_or_prim=np.uint32, misc=np.uint32, prim_order=np.int64,
              leaf_depths=np.int32)
# the spacings of the jittered grids: near-ties at every scale
SPACINGS = (0.001, 0.1, 0.3, 1.0 / 3.0, 0.7, 1.1, 2.9, 37.3)


def _random_boxes(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return c - h, c + h


def _signed_zero_boxes(seed):
    rs = np.random.default_rng(seed)
    n = int(rs.integers(50, 600))
    lo = rs.normal(size=(n, 3)).astype(np.float32)
    lo[rs.random((n, 3)) < 0.3] = -0.0
    lo[rs.random((n, 3)) < 0.2] = 0.0
    hi = lo + np.abs(rs.normal(size=(n, 3))).astype(np.float32)
    hi[rs.random((n, 3)) < 0.3] = 0.0
    hi[rs.random((n, 3)) < 0.2] = -0.0
    return lo, np.maximum(hi, lo)


def _jittered_grid(seed):
    """A grid of 1-11 boxes an axis, its spacing from SPACINGS, an offset
    u in [0, 1e-3) added to a random half of the coordinates, one
    half-width of 0.01-0.6 spacings."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 12, 3)
    s = float(rng.choice(SPACINGS))
    g = np.stack(np.meshgrid(*[np.arange(c) for c in counts],
                             indexing="ij"), -1).reshape(-1, 3) * s
    u = rng.uniform(0.0, 1e-3)
    c = g + np.where(rng.random(g.shape) < 0.5, u, 0.0)
    h = rng.uniform(0.01, 0.6) * s
    return (c - h).astype(np.float32), (c + h).astype(np.float32)


def _mesh_sets(scene):
    return [triangle_bounds(m.positions, m.indices) for m in scene.meshes]


def _walker_tlas(nx, nz):
    """`build_two_level`'s instance boxes of walker_grid(nx, nz)."""
    scene, _ = presets.walker_grid(nx, nz)
    blas = [port_build.build_bvh(*b, use_native=False)
            for b in _mesh_sets(scene)]
    boxes = [port_build.transform_aabb(blas[i.mesh].bbox_min[0],
                                       blas[i.mesh].bbox_max[0], i.transform)
             for i in scene.instances]
    return (np.stack([b[0] for b in boxes]), np.stack([b[1] for b in boxes]))


def _case(name):
    """[(bbox_min, bbox_max)] and max_prims_in_node of a named set."""
    kind, _, arg = name.partition(":")
    if kind == "random":
        n, max_prims = map(int, arg.split("x"))
        return [_random_boxes(n, seed=n)], max_prims
    if kind == "same_centroid":
        return [(np.zeros((9, 3), np.float32),
                 np.ones((9, 3), np.float32))], int(arg)
    if kind == "zeros4":
        lo = np.array([[0.0, 0, 0], [-0.0, 1, 0], [0.0, 2, 0], [-0.0, 3, 0]],
                      np.float32)
        return [(lo, lo + 1)], 2
    if kind == "zeros":
        return [_signed_zero_boxes(int(arg))], 2
    if kind == "grid":
        return [_jittered_grid(int(arg))], 2
    if kind == "cornell":
        return _mesh_sets(presets.cornell_box("area", "glossy")[0]), 2
    if kind == "sphere_grid":
        return _mesh_sets(presets.sphere_grid(3, 3)[0]), 2
    assert kind == "walker_tlas"
    return [_walker_tlas(20, 20)], 1


CASES = ([f"random:{n}x{m}" for n, m in [(1, 2), (3, 2), (7, 1), (64, 2),
                                          (500, 2), (500, 1), (2000, 2)]]
         + ["same_centroid:1", "same_centroid:2", "zeros4", "zeros:0",
            "zeros:1"]
         + [f"grid:{s}" for s in range(20)]
         + ["cornell", "sphere_grid", "walker_tlas"])


def assert_bits_equal(want, got):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype == DTYPES[f], f
        assert a.shape == b.shape, f
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert want.max_depth == got.max_depth


@pytest.mark.parametrize("name", CASES)
def test_native_bits_equal_the_numpy_builder(name):
    sets, max_prims = _case(name)
    for bmin, bmax in sets:
        want = port_build.build_bvh(bmin, bmax, max_prims, use_native=False)
        got = native.build_bvh_native(bmin, bmax, max_prims)
        assert_bits_equal(want, got)
    if name == "zeros4":
        # the set reaches a tie: numpy keeps the last zero, -0
        assert np.signbit(got.bbox_min[0, 0])


@pytest.mark.parametrize("name", CASES)
def test_native_bits_equal_the_reference_numpy_builder(name):
    from directcomputeraytracing_tpu.accel import build as ref_build

    sets, max_prims = _case(name)
    for bmin, bmax in sets:
        want = ref_build.build_bvh(bmin, bmax, max_prims, use_native=False)
        got = port_build.build_bvh(bmin, bmax, max_prims, use_native=True)
        assert_bits_equal(want, got)


@pytest.mark.parametrize("env,use_native,native_calls", [
    (None, None, 1), ("1", None, 1), ("0", None, 0), (None, False, 0),
    ("1", False, 0), ("0", True, 1)])
def test_switch(monkeypatch, env, use_native, native_calls):
    calls = []
    inner = native.build_bvh_native

    def counted(*args):
        calls.append(1)
        return inner(*args)

    monkeypatch.setattr(native, "build_bvh_native", counted)
    if env is None:
        monkeypatch.delenv("DCRT_NATIVE_BVH", raising=False)
    else:
        monkeypatch.setenv("DCRT_NATIVE_BVH", env)
    bmin, bmax = _random_boxes(64, seed=3)
    got = port_build.build_bvh(bmin, bmax, 2, use_native=use_native)
    assert len(calls) == native_calls
    assert_bits_equal(port_build.build_bvh(bmin, bmax, 2, use_native=False),
                      got)


@pytest.mark.parametrize("use_native", [True, False])
def test_empty_input_raises(use_native):
    empty = np.zeros((0, 3), np.float32)
    with pytest.raises((ValueError, AssertionError)):
        port_build.build_bvh(empty, empty, 2, use_native=use_native)


def test_misshapen_input_raises():
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native.build_bvh_native(np.zeros((4, 2), np.float32),
                                np.ones((4, 2), np.float32))


def test_library_is_built_into_the_build_dir_under_a_hash():
    path = native.load_native()._name
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert re.fullmatch(r"libbvh_builder-[0-9a-f]{12}\.so",
                        os.path.basename(path))
    beside = {f for f in os.listdir(os.path.dirname(native.__file__))
              if f != "__pycache__"}
    assert beside == {"__init__.py", "bvh_builder.cpp"}


@pytest.fixture
def fresh_build_dir(tmp_path, monkeypatch):
    """An empty build directory and no loaded library; the cache is
    cleared again afterwards, so later tests load the package's own."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    native._load.cache_clear()
    yield tmp_path
    native._load.cache_clear()


def test_missing_compiler_raises(fresh_build_dir, monkeypatch):
    empty = fresh_build_dir / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        port_build.build_bvh(*_random_boxes(8, seed=0))
    assert not os.path.exists(cuda_build.BUILD_DIR) or not os.listdir(
        cuda_build.BUILD_DIR)


def test_failed_compile_raises_with_the_compiler_output(fresh_build_dir):
    src = fresh_build_dir / "broken.cpp"
    src.write_text('extern "C" int f() { return undeclared; }\n')
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*undeclared"):
        cuda_build.load_library("broken.cpp", csrc=str(fresh_build_dir),
                                compiler=native.find_gxx,
                                flags=native.GXX_FLAGS)


@pytest.mark.slow
def test_native_is_faster_at_scale():
    bmin, bmax = _random_boxes(100_000, seed=42)
    native.load_native()
    t0 = time.perf_counter()
    want = port_build.build_bvh(bmin, bmax, 2, use_native=False)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = port_build.build_bvh(bmin, bmax, 2, use_native=True)
    t_cc = time.perf_counter() - t0
    assert_bits_equal(want, got)
    assert t_cc < t_py
