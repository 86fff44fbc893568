"""The port's interactive editor (`tools/editor.py`) on the CPU: the five
cases of `tests/test_editor_tool.py` with the port's session
(`device="cpu"`), the saved still, the session's state against the
reference session's on the same scene, and the command line's device
default.

The session object is driven directly and once end to end over HTTP on
a loopback socket: state JSON, material, light and camera edits that
restart the accumulation, progressive preview PNG bytes.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
from directcomputeraytracing_tpu_torch.tools.editor import (
    EditorSession,
    _png_bytes,
    build_parser,
    serve,
)

STATE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session(scene, cam):
    return EditorSession(scene, cam, width=64, height=64, preview_scale=4,
                         max_bounce=1, device="cpu")


@pytest.fixture(scope="module")
def session():
    # one shared session; edits restart the accumulation, so the tests
    # stay independent
    return _session(*cornell_box(light="area"))


def test_png_encoder_roundtrip():
    from PIL import Image

    img = np.random.default_rng(0).uniform(size=(5, 7, 3))
    data = _png_bytes(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data[:40] and data[-8:-4] == b"IEND"
    back = np.asarray(Image.open(io.BytesIO(data)))
    assert back.shape == (5, 7, 3)
    np.testing.assert_allclose(
        back, np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8))


def test_state_lists_scene_objects(session):
    s = session
    st = s.state()
    assert st["materials"] and (st["lights"] or st["emitters"])
    assert len(st["instances"]) == len(s.scene.instances)
    assert st["spp"] == 0
    assert st["camera"]["fov_x_deg"] > 0


def test_edit_resets_accumulation_and_changes_image(session):
    s = session
    a = s.preview_step(spp=1).copy()
    assert s._spp == 1
    s.edit_material(0, albedo=(0.9, 0.05, 0.05))
    assert s._spp == 0
    b = s.preview_step(spp=1)
    assert not np.allclose(a, b)
    assert s.state()["materials"][0]["albedo"][0] == 0.9


def test_camera_move_changes_state_and_resets(session):
    s = session
    eye0 = s.state()["camera"]["position"]
    s.preview_step(spp=1)
    s.move_camera(forward=0.5, yaw_deg=10.0, pitch_deg=5.0)
    assert s._spp == 0
    eye1 = s.state()["camera"]["position"]
    assert not np.allclose(eye0, eye1)
    cam = s.renderer.camera
    assert cam.transform.device.type == "cpu"
    assert cam.transform.dtype == torch.float32
    s.set_camera(eye=[0, 1, -4], target=[0, 1, 0], fov_x_deg=60.0)
    st = s.state()["camera"]
    np.testing.assert_allclose(st["position"], [0, 1, -4], atol=1e-5)
    np.testing.assert_allclose(st["fov_x_deg"], 60.0, atol=0.1)
    assert s.renderer.camera.film_distance.dtype == torch.float32


def test_http_roundtrip(session):
    s = session
    started = threading.Event()
    th = threading.Thread(target=serve, args=(s, 0), daemon=True,
                          kwargs={"started": started})
    th.start()
    assert started.wait(10)
    port = started.server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        st = json.loads(urllib.request.urlopen(base + "/state").read())
        assert st["materials"]

        req = urllib.request.Request(
            base + "/edit",
            data=json.dumps({"kind": "material", "index": 0,
                             "fields": {"roughness": 0.2}}).encode(),
            method="POST")
        assert json.loads(urllib.request.urlopen(req).read())["ok"]
        st = json.loads(urllib.request.urlopen(base + "/state").read())
        assert abs(st["materials"][0]["roughness"] - 0.2) < 1e-6

        png = urllib.request.urlopen(base + "/preview?spp=1").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"

        page = urllib.request.urlopen(base + "/").read()
        assert b"dcrt-tpu editor" in page
    finally:
        started.server.shutdown()
        th.join(10)
    assert not th.is_alive()


def test_save_image_writes_the_postprocessed_still(tmp_path):
    """Save renders 4 spp on an empty film and writes `postprocessed()`,
    already sRGB, as it is."""
    from PIL import Image

    s = _session(*cornell_box(light="area"))
    out = s.save_image(str(tmp_path / "still.png"))
    assert out["spp"] == 4
    back = np.asarray(Image.open(out["path"]))
    want = (np.clip(s.renderer.postprocessed(), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(back, want)


def _close(a, b, path="state"):
    """Equal JSON trees, floats within STATE_TOL."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= STATE_TOL, (path, a, b)
    else:
        assert a == b, path


def test_state_equals_the_reference_session():
    """The port's state() is the reference session's on the same scene,
    after the same camera moves."""
    from directcomputeraytracing_tpu.scene.presets import (
        cornell_box as ref_cornell,
    )
    from directcomputeraytracing_tpu.tools.editor import (
        EditorSession as RefSession,
    )

    ref = RefSession(*ref_cornell(light="area", material_set="glossy"),
                     width=64, height=64, preview_scale=4, max_bounce=1)
    port = _session(*cornell_box(light="area", material_set="glossy"))
    _close(port.state(), ref.state())
    for s in (ref, port):
        s.move_camera(forward=0.25, right=-0.1, yaw_deg=7.0, pitch_deg=-3.0)
        s.set_camera(fov_x_deg=50.0)
    _close(port.state(), ref.state())


def test_main_defaults_to_the_card():
    args = build_parser().parse_args(["scene.xml"])
    assert args.device == "cuda"
    assert (args.port, args.width, args.height, args.preview_scale) == (
        8008, 960, 540, 3)
