"""The port's headless CLI (`python -m directcomputeraytracing_tpu_torch.
cli.render`) against the reference's `cli.render.main` on the CPU.

- preset:cornell, preset:cornell-glossy, an .obj (under an --env map)
  and a Mitsuba .xml scene (`tests/test_obj_loader.py`'s and
  `tests/test_xml_loader.py`'s) at 16x16, 2 spp, with --checkpoint,
  through both CLIs: the JSON lines carry the same keys, and the
  checkpoints' films agree under the render gates of
  `test_torch_alpha.py` (per pixel 1e-4 (1 + |reference|) on all but 1
  pixel in 64, RMSE <= 1e-3; the weights within rtol 1e-6, sums of
  float32 filter values under the XML's Gaussian film); a second run
  with --spp 3 resumes at 2.
- --aov, every kind: the image the CLI writes is the port's `render_aov`
  of the scene, and the JSON line has the reference's keys.
- --output-bvh: the dump, through the port's numpy builder and through
  its C++ builder, equals the reference's (with its numpy builder,
  `DCRT_NATIVE_BVH=0`) string for string.
- --device cuda raises where CUDA is absent.
"""

import json

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.cli import render as cli

PIXEL_TOL, GATE_RMSE = 1e-4, 1e-3
SIZE = ["--resx", "16", "--resy", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _ref_cache(tmp_path, monkeypatch):
    """The reference CLI's compile cache goes under the test's tmp_path."""
    monkeypatch.setenv("DCRT_JAX_CACHE", str(tmp_path / "jaxcache"))


def _scene_spec(name, tmp_path):
    """The scene argument (and any flags it needs): the OBJ scene has no
    light, so it renders under an environment map (--env, an .npy)."""
    if name == "obj":
        from test_obj_loader import MTL, OBJ

        (tmp_path / "test.obj").write_text(OBJ)
        (tmp_path / "test.mtl").write_text(MTL)
        env = np.random.default_rng(2).random((8, 16, 3), dtype=np.float32)
        np.save(tmp_path / "env.npy", env)
        return [str(tmp_path / "test.obj"), "--env",
                str(tmp_path / "env.npy"), "--env-scale", "1.5"]
    if name == "xml":
        from test_xml_loader import XML

        (tmp_path / "scene.xml").write_text(XML)
        return [str(tmp_path / "scene.xml")]
    return [f"preset:{name}"]


def _run(main, argv, capsys, err=None):
    """The JSON line the CLI printed last; err (a list) gets its stderr."""
    main(argv)
    out = capsys.readouterr()
    if err is not None:
        err.append(out.err)
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["cornell", "cornell-glossy", "obj",
                                  "xml"])
def test_cli_matches_the_reference(tmp_path, capsys, name):
    from directcomputeraytracing_tpu.cli.render import main as ref_main

    spec = _scene_spec(name, tmp_path)
    got = _run(cli.main, [*spec, *SIZE, "--spp", "2", "--device", "cpu",
                          "--checkpoint", str(tmp_path / "port.npz"),
                          "-o", str(tmp_path / "port.png")], capsys)
    want = _run(ref_main, [*spec, *SIZE, "--spp", "2", "--checkpoint",
                           str(tmp_path / "ref.npz"),
                           "-o", str(tmp_path / "ref.png")], capsys)
    assert got.keys() == want.keys()
    assert (got["spp"], got["resolution"]) == (want["spp"],
                                               want["resolution"]) \
        == (2, [16, 16])
    assert (tmp_path / "port.png").exists()
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "ref.npz") \
            as r:
        # a splatting filter's weights are sums of float32 filter values
        np.testing.assert_allclose(p["weight"], r["weight"], rtol=1e-6)
        assert int(p["spp"]) == int(r["spp"]) == 2
        a = p["value"] / np.maximum(p["weight"][..., None], 1e-10)
        b = r["value"] / np.maximum(r["weight"][..., None], 1e-10)
    assert np.isfinite(a).all() and a.mean() > 0
    rel = np.abs(a - b).max(-1) / (1 + np.abs(b).max(-1))
    assert (rel > PIXEL_TOL).mean() <= 1 / 64, rel.max()
    assert np.sqrt(((a - b) ** 2).mean()) <= GATE_RMSE
    if name == "cornell":
        err = []
        again = _run(cli.main, [*spec, *SIZE, "--spp", "3", "--device",
                                "cpu", "--checkpoint",
                                str(tmp_path / "port.npz"),
                                "-o", str(tmp_path / "port.png")], capsys,
                     err)
        assert again["spp"] == 3 and "resumed at 2 spp" in err[0]


@pytest.mark.parametrize("kind", ["normal", "tangent", "albedo",
                                  "negative_ndotv", "backface",
                                  "iteration_count"])
def test_cli_aov(tmp_path, capsys, kind):
    from directcomputeraytracing_tpu_torch.integrator.aov import render_aov
    from directcomputeraytracing_tpu_torch.integrator.megakernel import (
        full_frame_pixels,
    )
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
    from directcomputeraytracing_tpu_torch.utils.image import (
        linear_to_srgb,
        load_image,
    )

    out = tmp_path / f"{kind}.png"
    got = _run(cli.main, ["preset:cornell", *SIZE, "--device", "cpu",
                          "--aov", kind, "-o", str(out)], capsys)
    assert got == {"output": str(out), "aov": kind, "resolution": [16, 16]}
    r = Renderer(*cornell_box("area"), 16, 16, device="cpu")
    v = render_aov(r.arrays, r.camera, r.cfg,
                   *full_frame_pixels(r.cfg, "cpu"), 0, kind).numpy()
    v = v.reshape(16, 16, 3)
    if kind == "iteration_count":
        v = v / max(v.max(), 1.0)
    want = np.clip(linear_to_srgb(np.clip(v, 0.0, 1.0)), 0, 1)
    img = load_image(str(out))[..., :3]
    np.testing.assert_allclose(img, want, rtol=0, atol=1.0 / 255 + 1e-6)
    if kind in ("normal", "tangent", "albedo", "iteration_count"):
        assert img.max() > 0


@pytest.mark.parametrize("native", ["0", "1"])
def test_cli_output_bvh(tmp_path, capsys, monkeypatch, native):
    """The port's dump through its numpy builder (DCRT_NATIVE_BVH=0) or
    its C++ builder (=1) against the reference's numpy dump."""
    from directcomputeraytracing_tpu.accel.build import (
        serialize_bvh_to_xml as ref_dump,
    )
    from directcomputeraytracing_tpu.scene.presets import (
        cornell_box as ref_cornell,
    )

    monkeypatch.setenv("DCRT_NATIVE_BVH", native)
    path = tmp_path / "bvh.xml"
    _run(cli.main, ["preset:cornell", *SIZE, "--spp", "1", "--device", "cpu",
                    "--output-bvh", str(path), "-o",
                    str(tmp_path / "o.png")], capsys)
    monkeypatch.setenv("DCRT_NATIVE_BVH", "0")
    assert path.read_text() == ref_dump(ref_cornell("area")[0])


def test_cli_device_cuda_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["preset:cornell", *SIZE, "--device", "cuda", "-o",
                  str(tmp_path / "o.png")])
    assert not (tmp_path / "o.png").exists()
