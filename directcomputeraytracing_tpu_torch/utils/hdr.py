"""HDR image decoding: Radiance .hdr (RGBE), OpenEXR scanlines, DDS.

The port's copy of `directcomputeraytracing_tpu.utils.hdr` (the same
numpy code, held to it by `tests/test_torch_image_io.py`). It fills the
reference's HDR-environment ingestion role (reference:
Source/GPUTexture.cpp:165-245 loads DDS cubemaps via DDSTextureLoader12
and binds them as IBL sources). Cubemap DDS files load as six faces, or
resample to a lat-long panorama (`cubemap_to_latlong`).

Pure numpy; all decoding is offline scene-ingestion work.

Supported:
  .hdr  Radiance RGBE, flat and adaptive-RLE scanlines.
  .exr  OpenEXR 2.0 single-part scanline images, compression NONE /
        ZIPS / ZIP, channel types HALF and FLOAT. (PIZ/B44/DWA are not
        supported — re-export or use .hdr.)
  .dds  Legacy and DX10 headers. Formats: R32G32B32A32_FLOAT,
        R32G32B32_FLOAT, R16G16B16A16_FLOAT, R9G9B9E5_SHAREDEXP,
        B8G8R8A8/R8G8B8A8_UNORM(_SRGB), and BC6H_UF16/SF16 compressed
        blocks. Cubemaps (6 faces, +X -X +Y -Y +Z -Z) are detected and
        resampled.
"""

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE)
# ---------------------------------------------------------------------------

def load_hdr(path):
    """Radiance RGBE -> (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # header: text lines until a blank line, then the resolution line
    pos = data.index(b"\n") + 1
    exposure = 1.0
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if not line:
            break
        if line.startswith(b"EXPOSURE="):
            exposure *= float(line.split(b"=", 1)[1])
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] not in (b"-Y", b"+Y"):
        raise ValueError(f"{path}: unsupported resolution line {res}")
    h, w = int(res[1]), int(res[3])
    flip_y = res[0] == b"+Y"
    flip_x = res[2] == b"-X"

    rgbe = np.empty((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        if (w < 8 or w > 0x7FFF or buf[pos] != 2 or buf[pos + 1] != 2
                or (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) != w):
            # flat scanline (may still be old-style RLE: not emitted by
            # modern writers; treat 1,1,1 runs as errors)
            row = buf[pos:pos + w * 4]
            if row.size < w * 4:
                raise ValueError(f"{path}: truncated scanline {y}")
            rgbe[y] = row.reshape(w, 4)
            pos += w * 4
            continue
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                n = int(buf[pos])
                pos += 1
                if n > 128:  # run
                    rgbe[y, x:x + n - 128, c] = buf[pos]
                    pos += 1
                    x += n - 128
                else:        # literal
                    rgbe[y, x:x + n, c] = buf[pos:pos + n]
                    pos += n
                    x += n
    mant = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(np.float32(1.0), exp - 136)[..., None]  # 2^(e-128)/256
    out = (mant + 0.5) * scale
    out[exp == 0] = 0.0
    out /= exposure
    if flip_y:
        out = out[::-1]
    if flip_x:
        out = out[:, ::-1]
    return np.ascontiguousarray(out.astype(np.float32))


def save_hdr(path, rgb):
    """Write (H, W, 3) float32 as flat (non-RLE) Radiance RGBE."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    m = np.max(rgb, axis=2)
    exp = np.zeros((h, w), np.int32)
    nz = m > 1e-38
    exp[nz] = np.floor(np.log2(m[nz])).astype(np.int32) + 1
    scale = np.where(nz, np.ldexp(np.float32(1.0), -exp + 8), 0.0)
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe = np.concatenate(
        [mant, np.where(nz, exp + 128, 0).astype(np.uint8)[..., None]],
        axis=2)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---------------------------------------------------------------------------
# OpenEXR (single-part scanline, NONE/ZIPS/ZIP, HALF/FLOAT)
# ---------------------------------------------------------------------------

_EXR_PIXELTYPE_SIZE = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT


def _exr_read_string(data, pos):
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def load_exr(path):
    """OpenEXR -> (H, W, C) float32; channels ordered R, G, B[, A]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack_from("<I", data, 4)[0]
    if version & 0x200:
        raise ValueError(f"{path}: multi-part EXR not supported")
    if version & 0x800:
        raise ValueError(f"{path}: deep EXR not supported")
    pos = 8
    channels = []
    compression = None
    data_window = None
    while True:
        if data[pos] == 0:
            pos += 1
            break
        name, pos = _exr_read_string(data, pos)
        _type, pos = _exr_read_string(data, pos)
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        val = data[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while val[cpos] != 0:
                cname_end = val.index(b"\0", cpos)
                cname = val[cpos:cname_end].decode("latin-1")
                cpos = cname_end + 1
                ptype = struct.unpack_from("<I", val, cpos)[0]
                cpos += 16  # pixel type, pLinear+pad, xSampling, ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)
    if compression not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(
            f"{path}: EXR compression {compression} not supported "
            "(only NONE/ZIPS/ZIP)")
    xmin, ymin, xmax, ymax = data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lines_per_block = 1 if compression in (0, 2) else 16
    n_blocks = -(-h // lines_per_block)
    # channel order in the file is alphabetical by name
    ch_sorted = sorted(channels, key=lambda c: c[0])
    row_bytes = sum(w * _EXR_PIXELTYPE_SIZE[t] for _, t in ch_sorted)

    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)
    planes = {name: np.empty((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y0 = struct.unpack_from("<i", data, off)[0] - ymin
        size = struct.unpack_from("<I", data, off + 4)[0]
        raw = data[off + 8:off + 8 + size]
        ny = min(lines_per_block, h - y0)
        expect = row_bytes * ny
        if compression == 0 or size >= expect:
            block = raw[:expect]
        else:
            dec = zlib.decompress(raw)
            # EXR zip post-process: undo delta predictor, de-interleave.
            # Spec: first byte raw, then out[i] = out[i-1] + raw[i] - 128
            # => out = cumsum(raw - 128) + 128 (the +128 restores the
            # first byte the blanket -128 took away).
            arr = np.frombuffer(dec, np.uint8)
            arr = ((np.cumsum(arr.astype(np.int64) - 128) + 128)
                   % 256).astype(np.uint8)
            half = (len(arr) + 1) // 2
            out = np.empty(len(arr), np.uint8)
            out[0::2] = arr[:half]
            out[1::2] = arr[half:]
            block = out.tobytes()
        bpos = 0
        for y in range(y0, y0 + ny):
            for cname, ptype in ch_sorted:
                nb = w * _EXR_PIXELTYPE_SIZE[ptype]
                seg = block[bpos:bpos + nb]
                bpos += nb
                if ptype == 1:
                    vals = np.frombuffer(seg, np.float16).astype(
                        np.float32)
                elif ptype == 2:
                    vals = np.frombuffer(seg, np.float32)
                else:
                    vals = np.frombuffer(seg, np.uint32).astype(
                        np.float32)
                planes[cname][y] = vals
    order = [c for c in ("R", "G", "B", "A") if c in planes]
    if not order:
        order = sorted(planes.keys())
    return np.ascontiguousarray(
        np.stack([planes[c] for c in order], axis=2))


# ---------------------------------------------------------------------------
# DDS
# ---------------------------------------------------------------------------

_DDPF_FOURCC = 0x4
_DDSCAPS2_CUBEMAP = 0x200
_D3D10_CUBE = 0x4

# DXGI formats we decode
_DXGI_R32G32B32A32F = 2
_DXGI_R32G32B32F = 6
_DXGI_R16G16B16A16F = 10
_DXGI_R9G9B9E5 = 67
_DXGI_R8G8B8A8_UNORM = 28
_DXGI_R8G8B8A8_SRGB = 29
_DXGI_B8G8R8A8_UNORM = 87
_DXGI_B8G8R8A8_SRGB = 91
_DXGI_BC6H_UF16 = 95
_DXGI_BC6H_SF16 = 96


def _dds_bytes_per_image(fmt, w, h):
    if fmt in (_DXGI_BC6H_UF16, _DXGI_BC6H_SF16):
        return ((w + 3) // 4) * ((h + 3) // 4) * 16
    bpp = {_DXGI_R32G32B32A32F: 16, _DXGI_R32G32B32F: 12,
           _DXGI_R16G16B16A16F: 8, _DXGI_R9G9B9E5: 4,
           _DXGI_R8G8B8A8_UNORM: 4, _DXGI_R8G8B8A8_SRGB: 4,
           _DXGI_B8G8R8A8_UNORM: 4, _DXGI_B8G8R8A8_SRGB: 4}[fmt]
    return w * h * bpp


def _dds_decode_image(fmt, raw, w, h):
    if fmt == _DXGI_R32G32B32A32F:
        return np.frombuffer(raw, np.float32).reshape(h, w, 4)[..., :3]
    if fmt == _DXGI_R32G32B32F:
        return np.frombuffer(raw, np.float32).reshape(h, w, 3)
    if fmt == _DXGI_R16G16B16A16F:
        return np.frombuffer(raw, np.float16).reshape(
            h, w, 4)[..., :3].astype(np.float32)
    if fmt == _DXGI_R9G9B9E5:
        v = np.frombuffer(raw, np.uint32).reshape(h, w)
        e = (v >> 27).astype(np.int32)
        scale = np.ldexp(np.float32(1.0), e - 24)
        out = np.empty((h, w, 3), np.float32)
        for c in range(3):
            out[..., c] = ((v >> (9 * c)) & 0x1FF).astype(
                np.float32) * scale
        return out
    if fmt in (_DXGI_R8G8B8A8_UNORM, _DXGI_R8G8B8A8_SRGB,
               _DXGI_B8G8R8A8_UNORM, _DXGI_B8G8R8A8_SRGB):
        v = np.frombuffer(raw, np.uint8).reshape(h, w, 4).astype(
            np.float32) / 255.0
        rgb = v[..., :3]
        if fmt in (_DXGI_B8G8R8A8_UNORM, _DXGI_B8G8R8A8_SRGB):
            rgb = rgb[..., ::-1]
        if fmt in (_DXGI_R8G8B8A8_SRGB, _DXGI_B8G8R8A8_SRGB):
            rgb = np.where(rgb <= 0.04045, rgb / 12.92,
                           ((rgb + 0.055) / 1.055) ** 2.4)
        return np.ascontiguousarray(rgb.astype(np.float32))
    if fmt in (_DXGI_BC6H_UF16, _DXGI_BC6H_SF16):
        from .bc6h import decode_bc6h

        return decode_bc6h(np.frombuffer(raw, np.uint8), w, h,
                           signed=(fmt == _DXGI_BC6H_SF16))
    raise ValueError(f"DDS DXGI format {fmt} not supported")


def load_dds(path, cubemap="faces"):
    """DDS -> float32 linear. 2D textures return (H, W, 3). Cubemaps
    return the D3D-order faces (6, S, S, 3) ready for direct cube
    sampling (`lights.sample_env_radiance`, the reference's native
    addressing, Source/GPUTexture.cpp:165-245) when cubemap="faces"
    (default), or a (2S, 4S... ) lat-long panorama via
    `cubemap_to_latlong` (2:1 aspect, height = 2 * face size) when
    cubemap="latlong"."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"DDS ":
        raise ValueError(f"{path}: not a DDS file")
    (hsize, flags, h, w, _pitch, _depth, mips) = struct.unpack_from(
        "<7I", data, 4)
    pf_flags, fourcc = struct.unpack_from("<2I", data, 80)
    caps2 = struct.unpack_from("<I", data, 112)[0]
    pos = 4 + 124
    fmt = None
    is_cube = bool(caps2 & _DDSCAPS2_CUBEMAP)
    if (pf_flags & _DDPF_FOURCC) and fourcc == 0x30315844:  # 'DX10'
        dxgi, _dim, misc, _asize, _misc2 = struct.unpack_from(
            "<5I", data, pos)
        pos += 20
        fmt = dxgi
        is_cube = is_cube or bool(misc & _D3D10_CUBE)
    elif pf_flags & _DDPF_FOURCC:
        legacy = {113: _DXGI_R16G16B16A16F, 116: _DXGI_R32G32B32A32F}
        if fourcc not in legacy:
            raise ValueError(
                f"{path}: legacy fourcc 0x{fourcc:x} not supported")
        fmt = legacy[fourcc]
    else:
        # uncompressed RGB masks: assume 32-bit BGRA/RGBA
        rbit = struct.unpack_from("<I", data, 92)[0]
        fmt = (_DXGI_R8G8B8A8_UNORM if rbit == 0xFF
               else _DXGI_B8G8R8A8_UNORM)
    mips = max(1, mips)
    faces = 6 if is_cube else 1
    images = []
    for _face in range(faces):
        fw, fh = w, h
        img = None
        for m in range(mips):
            nbytes = _dds_bytes_per_image(fmt, fw, fh)
            if m == 0:
                img = _dds_decode_image(fmt, data[pos:pos + nbytes],
                                        fw, fh)
            pos += nbytes
            fw, fh = max(1, fw // 2), max(1, fh // 2)
        images.append(img)
    if not is_cube:
        return np.ascontiguousarray(images[0])
    if cubemap == "faces":
        return np.ascontiguousarray(np.stack(images))
    return cubemap_to_latlong(np.stack(images), 2 * h)


# ---------------------------------------------------------------------------
# Cubemap -> lat-long resample
# ---------------------------------------------------------------------------

def cubemap_to_latlong(faces, height):
    """(6, S, S, 3) D3D-order faces (+X -X +Y -Y +Z -Z) -> (height,
    2*height, 3) equirectangular, bilinear per face (matches the
    cubemap addressing the reference samples in
    Shaders/Light.inc.hlsl:77-81)."""
    faces = np.asarray(faces, np.float32)
    s = faces.shape[1]
    hh, ww = height, 2 * height
    theta = (np.arange(hh, dtype=np.float32) + 0.5) / hh * np.pi
    phi = (np.arange(ww, dtype=np.float32) + 0.5) / ww * 2 * np.pi - np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    # lat-long convention: +Y up, and the exact inverse of
    # `lights.sample_env_radiance`'s lookup (u = atan2(z, x)/2pi + 0.5),
    # so a resampled cubemap renders identically to direct sampling
    x = st * cp
    y = np.broadcast_to(ct, (hh, ww))
    z = st * sp
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    face = np.zeros((hh, ww), np.int32)
    u = np.zeros((hh, ww), np.float32)
    v = np.zeros((hh, ww), np.float32)

    m = (ax >= ay) & (ax >= az) & (x > 0)
    face[m], u_, v_ = 0, -z / ax, -y / ax
    u[m], v[m] = u_[m], v_[m]
    m = (ax >= ay) & (ax >= az) & (x <= 0)
    face[m] = 1
    u_, v_ = z / ax, -y / ax
    u[m], v[m] = u_[m], v_[m]
    m = (ay > ax) & (ay >= az) & (y > 0)
    face[m] = 2
    u_, v_ = x / ay, z / ay
    u[m], v[m] = u_[m], v_[m]
    m = (ay > ax) & (ay >= az) & (y <= 0)
    face[m] = 3
    u_, v_ = x / ay, -z / ay
    u[m], v[m] = u_[m], v_[m]
    m = (az > ax) & (az > ay) & (z > 0)
    face[m] = 4
    u_, v_ = x / az, -y / az
    u[m], v[m] = u_[m], v_[m]
    m = (az > ax) & (az > ay) & (z <= 0)
    face[m] = 5
    u_, v_ = -x / az, -y / az
    u[m], v[m] = u_[m], v_[m]

    fu = (u * 0.5 + 0.5) * s - 0.5
    fv = (v * 0.5 + 0.5) * s - 0.5
    x0 = np.clip(np.floor(fu).astype(np.int32), 0, s - 1)
    y0 = np.clip(np.floor(fv).astype(np.int32), 0, s - 1)
    x1 = np.minimum(x0 + 1, s - 1)
    y1 = np.minimum(y0 + 1, s - 1)
    tx = np.clip(fu - x0, 0.0, 1.0)[..., None]
    ty = np.clip(fv - y0, 0.0, 1.0)[..., None]
    c00 = faces[face, y0, x0]
    c10 = faces[face, y0, x1]
    c01 = faces[face, y1, x0]
    c11 = faces[face, y1, x1]
    out = ((c00 * (1 - tx) + c10 * tx) * (1 - ty)
           + (c01 * (1 - tx) + c11 * tx) * ty)
    return np.ascontiguousarray(out.astype(np.float32))
