"""Image I/O and color transfer helpers (PNG/BMP export via PIL).

The port's copy of `directcomputeraytracing_tpu.utils.image` (numpy and
PIL, the same code, held to it by `tests/test_torch_image_io.py`).
Replaces the reference's WIC/BMP readback path
(reference: Source/SaveImageToFile.cpp). `load_env_map` reaches the
port's `utils.hdr` for HDR, EXR and DDS files.
"""

import numpy as np


def linear_to_srgb(x):
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def save_image(path, rgb_linear, srgb=True):
    """rgb_linear: (H, W, 3) float array in [0, inf); tone-mapped values
    expected in [0, 1]. Writes PNG or BMP by extension."""
    from PIL import Image

    img = np.asarray(rgb_linear, np.float64)
    if srgb:
        img = linear_to_srgb(img)
    img8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(img8, mode="RGB").save(path)


def load_image(path):
    """Returns (H, W, C) float32 in [0, 1] (no transfer decode)."""
    from PIL import Image

    return np.asarray(Image.open(path), np.float32) / 255.0


def srgb_to_linear(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def load_texture_rgba(path):
    """Decode a material texture to (H, W, 4) linear float32 (RGB
    sRGB->linear, alpha kept linear) — the reference's WIC
    R8G8B8A8_sRGB load (reference: Source/Texture.cpp:87-162). Raises
    on unreadable files (callers decide the fallback policy)."""
    img = load_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    rgba = np.ones(img.shape[:2] + (4,), np.float32)
    rgba[..., :3] = srgb_to_linear(img[..., :3])
    if img.shape[2] == 4:
        rgba[..., 3] = img[..., 3]
    return rgba


def load_env_map(path, cubemap="faces"):
    """Load an environment radiance map: (H, W, 3) float32 lat-long, or
    (6, S, S, 3) D3D-order cube faces for cubemap DDS files (sampled
    directly, matching the reference's native cubemap path —
    Source/GPUTexture.cpp:165-245 CreateFromFile via DDSTextureLoader12
    + the TextureCube sample in Shaders/Light.inc.hlsl:77-81).
    Pass cubemap="latlong" to resample cube faces to an equirectangular
    panorama instead.
    Formats: .hdr (Radiance RGBE), .exr (OpenEXR scanline), .dds (float
    formats incl. BC6H; cubemaps), .npy/.npz (linear float), anything
    PIL decodes (sRGB LDR images are linearized).
    """
    lower = path.lower()
    if lower.endswith(".hdr"):
        from .hdr import load_hdr

        img = load_hdr(path)
    elif lower.endswith(".exr"):
        from .hdr import load_exr

        img = load_exr(path)
    elif lower.endswith(".dds"):
        from .hdr import load_dds

        img = load_dds(path, cubemap=cubemap)
    elif lower.endswith(".npy"):
        img = np.load(path)
    elif lower.endswith(".npz"):
        data = np.load(path)
        img = data[list(data.keys())[0]]
    else:
        from PIL import Image

        raw = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        img = srgb_to_linear(raw)
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
