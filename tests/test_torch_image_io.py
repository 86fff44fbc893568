"""The port's image I/O (`utils.image`, `utils.hdr`, `utils.bc6h`) against
the reference's, on the CPU.

Each case of `tests/test_hdr_io.py` (Radiance HDR flat and RLE, the EXR
compressions and channel types, the DDS formats, cubemaps, the env-map
dispatch, BC6H against Pillow) runs with the port's functions in place of
the reference's: every call is also made to the reference's function on
the same arguments and must give the same arrays, bit for bit, and the
files `save_hdr` writes must be equal byte for byte; the case's own
asserts then run on the port's results. The LDR helpers (`save_image`,
`load_image`, `load_texture_rgba`, the sRGB transfer pair) are held to
the reference's the same way on random images from a numpy seed. The
two are the same numpy (and PIL) code, so there is no tolerance.
"""

import importlib.util
import os

import numpy as np
import pytest

from directcomputeraytracing_tpu.utils import bc6h as ref_bc6h
from directcomputeraytracing_tpu.utils import hdr as ref_hdr
from directcomputeraytracing_tpu.utils import image as ref_image
from directcomputeraytracing_tpu_torch.utils import bc6h as port_bc6h
from directcomputeraytracing_tpu_torch.utils import hdr as port_hdr
from directcomputeraytracing_tpu_torch.utils import image as port_image

TESTS = os.path.dirname(os.path.abspath(__file__))


def _load_hdr_tests():
    spec = importlib.util.spec_from_file_location(
        "_ref_test_hdr_io", os.path.join(TESTS, "test_hdr_io.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_HDR_TESTS = _load_hdr_tests()
_HDR_CASES = sorted(n for n in dir(_HDR_TESTS) if n.startswith("test_"))


def _assert_same(want, got, where):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for a, b in zip(want, got):
            _assert_same(a, b, where)
        return
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, where
    assert np.array_equal(want, got, equal_nan=True), where


def _checked(ref_fn, port_fn):
    """port_fn, after asserting that ref_fn gives the same bits."""
    def fn(*args, **kw):
        want = ref_fn(*args, **kw)
        got = port_fn(*args, **kw)
        _assert_same(want, got, port_fn.__name__)
        return got
    return fn


def _checked_writer(ref_fn, port_fn):
    """A file writer: the port's file must equal the reference's."""
    def fn(path, *args, **kw):
        ref_fn(path, *args, **kw)
        with open(path, "rb") as f:
            want = f.read()
        os.remove(path)
        port_fn(path, *args, **kw)
        with open(path, "rb") as f:
            assert f.read() == want, port_fn.__name__
    return fn


class _CheckedHdr:
    """`utils.hdr` as the reference's tests use it (`H.<name>`): the
    port's functions, checked against the reference's, and the port's
    constants, equal to the reference's."""

    def __getattr__(self, name):
        want, got = getattr(ref_hdr, name), getattr(port_hdr, name)
        if name.startswith("save"):
            return _checked_writer(want, got)
        if callable(want):
            return _checked(want, got)
        assert got == want, name
        return got


@pytest.mark.parametrize("case", _HDR_CASES)
def test_hdr_io_cases_on_the_port(case, tmp_path, monkeypatch):
    assert len(_HDR_CASES) == 12
    monkeypatch.setattr(_HDR_TESTS, "H", _CheckedHdr())
    monkeypatch.setattr(_HDR_TESTS, "load_env_map", _checked(
        ref_image.load_env_map, port_image.load_env_map))
    # the BC6H cases import the decoder from the reference's module
    monkeypatch.setattr(ref_bc6h, "decode_bc6h", _checked(
        ref_bc6h.decode_bc6h, port_bc6h.decode_bc6h))
    fn = getattr(_HDR_TESTS, case)
    if case == "test_exr":
        for compression in (0, 2, 3):
            for half in (True, False):
                fn(tmp_path, compression, half)
    elif "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


def _random_images(rng):
    yield "gray", rng.integers(0, 256, (9, 13), dtype=np.uint8), "L"
    yield "rgb", rng.integers(0, 256, (9, 13, 3), dtype=np.uint8), "RGB"
    yield "rgba", rng.integers(0, 256, (9, 13, 4), dtype=np.uint8), "RGBA"


def test_ldr_textures_match_reference(tmp_path):
    from PIL import Image

    for name, img, mode in _random_images(np.random.default_rng(5)):
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(img, mode).save(path)
        for fn in ("load_image", "load_texture_rgba", "load_env_map"):
            want = getattr(ref_image, fn)(path)
            got = getattr(port_image, fn)(path)
            _assert_same(want, got, f"{fn}({name})")
        assert port_image.load_texture_rgba(path).shape == (9, 13, 4)


def test_save_image_matches_reference(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.uniform(0.0, 1.2, (7, 11, 3)).astype(np.float32)
    for srgb in (True, False):
        path = str(tmp_path / "out.png")
        _checked_writer(ref_image.save_image, port_image.save_image)(
            path, img, srgb=srgb)
        back = port_image.load_image(path)
        assert back.shape == (7, 11, 3) and back.dtype == np.float32


def test_srgb_transfer_matches_reference():
    x = np.linspace(0.0, 1.25, 1001, dtype=np.float32)
    for fn in ("linear_to_srgb", "srgb_to_linear"):
        _assert_same(getattr(ref_image, fn)(x), getattr(port_image, fn)(x),
                     fn)


def test_env_map_arrays_match_reference(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 3.0, (4, 8, 3)).astype(np.float32)
    np.save(tmp_path / "env.npy", img)
    np.savez(tmp_path / "env.npz", radiance=img[..., 0])
    for name in ("env.npy", "env.npz"):
        path = str(tmp_path / name)
        want = ref_image.load_env_map(path)
        got = port_image.load_env_map(path)
        _assert_same(want, got, name)
        assert got.shape == (4, 8, 3)
