"""The port stands alone: no module of `directcomputeraytracing_tpu_torch`
and not `chip_smoke.py` imports the JAX package, and the port's own
copies of what it took from there (the constants, the BVH builder, the
committed LUT bake) equal the reference's.
"""

import ast
import os

import numpy as np
import pytest

import directcomputeraytracing_tpu_torch as port_pkg
from directcomputeraytracing_tpu_torch.accel import build as port_build
from directcomputeraytracing_tpu_torch.core import constants as port_const
from directcomputeraytracing_tpu_torch.lut.textures import committed_lut_path
from directcomputeraytracing_tpu_torch.scene import presets as port_presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "directcomputeraytracing_tpu"


def _port_sources():
    root = os.path.dirname(port_pkg.__file__)
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    """Absolute module names the file imports (relative imports resolve
    inside the port, so they are skipped)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_the_reference():
    bad = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            if mod == REF or mod.startswith(REF + ".") or mod == "jax" \
                    or mod.startswith("jax."):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad
    assert len(list(_port_sources())) > 30


def test_constants_equal_the_reference():
    from directcomputeraytracing_tpu.core import constants as ref_const

    names = [k for k in vars(ref_const) if k.isupper()]
    assert len(names) > 40
    for k in names:
        want, got = getattr(ref_const, k), getattr(port_const, k)
        assert type(want) is type(got) and want == got, k


def test_committed_lut_bake_equals_the_reference():
    import directcomputeraytracing_tpu

    ref = os.path.join(os.path.dirname(directcomputeraytracing_tpu.__file__),
                       "lut", "_bxdf_luts_s0_q1.npz")
    with open(ref, "rb") as a, open(committed_lut_path(), "rb") as b:
        assert a.read() == b.read()


def _mesh_boxes(scene):
    for mesh in scene.meshes:
        v = np.asarray(mesh.positions)[np.asarray(mesh.indices)]
        yield v.min(axis=1), v.max(axis=1)


@pytest.mark.parametrize("preset", ["cornell", "small_grid"])
def test_build_bvh_equals_the_reference(preset):
    from directcomputeraytracing_tpu.accel import build as ref_build

    if preset == "cornell":
        scene = port_presets.cornell_box("area", "glossy")[0]
    else:
        scene = port_presets.sphere_grid(3, 3, stacks=12, slices=16)[0]
    n = 0
    for bmin, bmax in _mesh_boxes(scene):
        want = ref_build.build_bvh(bmin, bmax, max_prims_in_node=2,
                                   use_native=False)
        got = port_build.build_bvh(bmin, bmax, max_prims_in_node=2)
        for field in ("bbox_min", "bbox_max", "right_or_prim", "misc",
                      "prim_order", "leaf_depths"):
            a, b = getattr(want, field), getattr(got, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert want.max_depth == got.max_depth
        n += 1
    assert n >= 2


# the reference's exports whose module the port does not have yet, each
# with the ROADMAP queue 1 item that ports it
_NOT_YET = {}


def _ref_exports():
    import directcomputeraytracing_tpu as ref_pkg

    return list(ref_pkg.__all__)


@pytest.mark.parametrize("name", _ref_exports())
def test_reference_exports_resolve_in_the_port(name):
    """Every name the reference's package serves lazily resolves in the
    port where the port has its module, to the port's own object from the
    counterpart module; a name whose module the port lacks does not
    resolve yet, and `_NOT_YET` names its queue 1 item."""
    import importlib.util

    import directcomputeraytracing_tpu as ref_pkg

    want = getattr(ref_pkg, name)
    if not hasattr(want, "__module__") or isinstance(want, str):
        assert getattr(port_pkg, name) == want
        return
    module = want.__module__.replace(REF, port_pkg.__name__, 1)
    try:
        has_module = importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:     # its package is missing too
        has_module = False
    assert has_module == (name not in _NOT_YET), (name, module)
    if name in _NOT_YET:
        with pytest.raises(AttributeError):
            getattr(port_pkg, name)
    else:
        got = getattr(port_pkg, name)
        assert got.__module__ == module and got.__name__ == want.__name__
        assert name in port_pkg.__all__
