"""BC6H (BPTC float) block-compressed HDR texture decode.

The port's copy of `directcomputeraytracing_tpu.utils.bc6h` (the same
numpy code, held to it by `tests/test_torch_image_io.py`). The
reference accepts BC6H DDS cubemaps by passing the compressed resource
straight to hardware via DDSTextureLoader12 (reference:
Source/GPUTexture.cpp:165-245, DDSTextureLoader12/); here the decode
runs on the host (vectorized numpy, scene-load time) and the result is
uploaded as plain float data.

Format: 4x4 texel blocks of 128 bits, 14 modes (10 two-subset, 4
one-subset). Each block carries quantized RGB endpoints (optionally
delta-compressed against the first endpoint), a partition id for
two-subset modes, and per-texel palette indices; decoded values are
IEEE half bit patterns. Layout tables transcribed from the D3D11.3
functional spec / Khronos Data Format spec "BPTC" section and verified
texel-for-texel against Pillow's independent native BC6H decoder
(tests/test_hdr_io.py), so a transcription slip cannot hide behind an
encode/decode round-trip.
"""

import numpy as np

# Per-mode field layout. Fields fill the block bits LSB-first starting
# right after the mode id (2 bits for modes 0/1, else 5). Tokens:
#   "rw9:0"  -> the next 10 block bits are rw bit 0 .. rw bit 9
#   "gy4"    -> one block bit -> gy bit 4
#   "rw15:10"-> the next 6 block bits are rw bit 15 DOWN TO rw bit 10
#               (the spec stores the extended-precision base bits of
#               modes 11/15 most-significant-first)
# Endpoints: w = subset-0 endpoint A, x = subset-0 endpoint B,
#            y = subset-1 endpoint A, z = subset-1 endpoint B.
# d4:0 = partition id. Mode key = the 5-bit (or 2-bit) mode value.
#   (num_subsets, base_bits, delta_bits or None (raw endpoints), layout)
_MODES = {
    0b00: (2, 10, (5, 5, 5),
           "gy4,by4,bz4,rw9:0,gw9:0,bw9:0,rx4:0,gz4,gy3:0,gx4:0,bz0,"
           "gz3:0,bx4:0,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,d4:0"),
    0b01: (2, 7, (6, 6, 6),
           "gy5,gz4,gz5,rw6:0,bz0,bz1,by4,gw6:0,by5,bz2,gy4,bw6:0,bz3,"
           "bz5,bz4,rx5:0,gy3:0,gx5:0,gz3:0,bx5:0,by3:0,ry5:0,rz5:0,"
           "d4:0"),
    0b00010: (2, 11, (5, 4, 4),
              "rw9:0,gw9:0,bw9:0,rx4:0,rw10,gy3:0,gx3:0,gw10,bz0,gz3:0,"
              "bx3:0,bw10,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,d4:0"),
    0b00110: (2, 11, (4, 5, 4),
              "rw9:0,gw9:0,bw9:0,rx3:0,rw10,gz4,gy3:0,gx4:0,gw10,gz3:0,"
              "bx3:0,bw10,bz1,by3:0,ry3:0,bz0,bz2,rz3:0,gy4,bz3,d4:0"),
    0b01010: (2, 11, (4, 4, 5),
              "rw9:0,gw9:0,bw9:0,rx3:0,rw10,by4,gy3:0,gx3:0,gw10,bz0,"
              "gz3:0,bx4:0,bw10,by3:0,ry3:0,bz1,bz2,rz3:0,bz4,bz3,d4:0"),
    0b01110: (2, 9, (5, 5, 5),
              "rw8:0,by4,gw8:0,gy4,bw8:0,bz4,rx4:0,gz4,gy3:0,gx4:0,bz0,"
              "gz3:0,bx4:0,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,d4:0"),
    0b10010: (2, 8, (6, 5, 5),
              "rw7:0,gz4,by4,gw7:0,bz2,gy4,bw7:0,bz3,bz4,rx5:0,gy3:0,"
              "gx4:0,bz0,gz3:0,bx4:0,bz1,by3:0,ry5:0,rz5:0,d4:0"),
    0b10110: (2, 8, (5, 6, 5),
              "rw7:0,bz0,by4,gw7:0,gy5,gy4,bw7:0,gz5,bz4,rx4:0,gz4,"
              "gy3:0,gx5:0,gz3:0,bx4:0,bz1,by3:0,ry4:0,bz2,rz4:0,bz3,"
              "d4:0"),
    0b11010: (2, 8, (5, 5, 6),
              "rw7:0,bz1,by4,gw7:0,by5,gy4,bw7:0,bz5,bz4,rx4:0,gz4,"
              "gy3:0,gx4:0,bz0,gz3:0,bx5:0,by3:0,ry4:0,bz2,rz4:0,bz3,"
              "d4:0"),
    0b11110: (2, 6, None,
              "rw5:0,gz4,bz0,bz1,by4,gw5:0,gy5,by5,bz2,gy4,bw5:0,gz5,"
              "bz3,bz5,bz4,rx5:0,gy3:0,gx5:0,gz3:0,bx5:0,by3:0,ry5:0,"
              "rz5:0,d4:0"),
    0b00011: (1, 10, None, "rw9:0,gw9:0,bw9:0,rx9:0,gx9:0,bx9:0"),
    0b00111: (1, 11, (9, 9, 9),
              "rw9:0,gw9:0,bw9:0,rx8:0,rw10,gx8:0,gw10,bx8:0,bw10"),
    0b01011: (1, 12, (8, 8, 8),
              "rw9:0,gw9:0,bw9:0,rx7:0,rw11:10,gx7:0,gw11:10,"
              "bx7:0,bw11:10"),
    0b01111: (1, 16, (4, 4, 4),
              "rw9:0,gw9:0,bw9:0,rx3:0,rw15:10,gx3:0,gw15:10,bx3:0,"
              "bw15:10"),
}

# BC6H/BC7 two-subset partition masks (bit t set = texel t in subset 1)
# and the subset-1 anchor texel per partition (its index loses one bit).
_P2 = np.asarray([
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
], np.uint32)
_ANCHOR2 = np.asarray([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
], np.int64)

_W3 = np.asarray([0, 9, 18, 27, 37, 46, 55, 64], np.int64)
_W4 = np.asarray([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                  60, 64], np.int64)


def _parse_layout(spec, start):
    """Layout string -> list of (channel_key, dst_lo, width, reversed_,
    src_bit) with src_bit the block bit where the field starts."""
    out = []
    pos = start
    for tok in spec.split(","):
        key = "d4" if tok[0] == "d" else tok[:2]
        rng = tok[1:] if tok[0] == "d" else tok[2:]
        if ":" in rng:
            a, b = map(int, rng.split(":"))
            lo, width = min(a, b), abs(a - b) + 1
            # "9:0" -> stored low-bit-first; "15:10" (the extended base
            # bits of modes 11/15) -> stored MSB-first
            rev = a > b and lo >= 10
        else:
            lo, width, rev = int(rng), 1, False
        out.append((key, lo, width, rev, pos))
        pos += width
    return out, pos


_PARSED = {}
for _m, (_ns, _wb, _db, _spec) in _MODES.items():
    _start = 2 if _m < 2 else 5
    _fields, _end = _parse_layout(_spec, _start)
    _PARSED[_m] = (_ns, _wb, _db, _fields)
    assert _end == (82 if _ns == 2 else 65), (_m, _end)
    # structural invariant: every endpoint bit appears exactly once
    _seen = {}
    for _k, _lo, _w, _rev, _ in _fields:
        for _i in range(_w):
            _bit = (_k, (_lo + _w - 1 - _i) if _rev else (_lo + _i))
            assert _bit not in _seen, (_m, _bit)
            _seen[_bit] = True
    _widths = {"rw": _wb, "gw": _wb, "bw": _wb}
    _d = _db if _db is not None else (_wb, _wb, _wb)
    for _c, _dw in zip("rgb", _d):
        for _e in ("x", "y", "z")[: 1 if _ns == 1 else 3]:
            _widths[_c + _e] = _dw
    if _ns == 2:
        _widths["d4"] = 0   # partition handled via the d4:0 token
    for _key, _nb in _widths.items():
        if _key == "d4":
            continue
        for _i in range(_nb):
            assert (_key, _i) in _seen, (_m, _key, _i)


def _extract(lo, hi, start, width):
    """Vectorized [start, start+width) bit read from (lo, hi) uint64
    pairs of a 128-bit little-endian block."""
    mask = np.uint64((1 << width) - 1)
    s = np.uint64(start)
    if start >= 64:
        return (hi >> np.uint64(start - 64)) & mask
    v = lo >> s
    if start + width > 64:
        v = v | (hi << np.uint64(64 - start))
    return v & mask


def _reverse_bits(v, width):
    out = np.zeros_like(v)
    for i in range(width):
        out |= ((v >> np.uint64(i)) & np.uint64(1)) << np.uint64(
            width - 1 - i)
    return out


def _sign_extend(v, bits):
    sign = np.int64(1) << (bits - 1)
    return (v.astype(np.int64) ^ sign) - sign


def _unquantize_unsigned(comp, bits):
    comp = comp.astype(np.int64)
    if bits >= 15:
        return comp
    full = (1 << bits) - 1
    unq = ((comp << 16) + 0x8000) >> bits
    unq = np.where(comp == 0, 0, unq)
    return np.where(comp == full, 0xFFFF, unq)


def _unquantize_signed(comp, bits):
    comp = comp.astype(np.int64)
    if bits >= 16:
        return comp
    s = comp < 0
    a = np.abs(comp)
    full = (1 << (bits - 1)) - 1
    unq = ((a << 15) + 0x4000) >> (bits - 1)
    unq = np.where(a == 0, 0, np.where(a >= full, 0x7FFF, unq))
    return np.where(s, -unq, unq)


def _finish_half(val, signed):
    """Interpolated value -> IEEE half bit pattern (the hardware's
    final scale: x*31/64 unsigned, x*31/32 signed, sign-magnitude)."""
    if signed:
        v = (val * 31) >> 5
        neg = v < 0
        bits = np.where(neg, 0x8000 | (-v), v).astype(np.uint16)
    else:
        bits = ((val * 31) >> 6).astype(np.uint16)
    return bits.view(np.float16).astype(np.float32)


def _decode_mode(lo, hi, mode, signed):
    """Decode all blocks of one mode -> (N, 16, 3) float32 texels."""
    ns, wb, db, fields = _PARSED[mode]
    n = lo.shape[0]
    ep = {k: np.zeros(n, np.uint64)
          for k in ("rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy",
                    "by", "rz", "gz", "bz", "d4")}
    for key, dlo, width, rev, src in fields:
        k = "d4" if key == "d4" else key
        v = _extract(lo, hi, src, width)
        if rev:
            v = _reverse_bits(v, width)
        ep[k] |= v << np.uint64(dlo)

    d = ep["d4"].astype(np.int64) if ns == 2 else np.zeros(n, np.int64)
    dw = db if db is not None else (wb, wb, wb)
    ends = []   # per subset: (e0, e1) as (N, 3) int64
    base = np.stack([ep["rw"], ep["gw"], ep["bw"]], 1).astype(np.int64)
    if signed:
        base = _sign_extend(base, wb)
    emask = (1 << wb) - 1
    for names in (("rx", "gx", "bx"), ("ry", "gy", "by"),
                  ("rz", "gz", "bz"))[: 2 * ns - 1]:
        raw = np.stack([ep[c] for c in names], 1).astype(np.int64)
        if db is not None:
            delta = np.stack(
                [_sign_extend(raw[:, c], dw[c]) for c in range(3)], 1)
            e = (base + delta) & emask
            if signed:
                e = _sign_extend(e, wb)
        else:
            e = _sign_extend(raw, wb) if signed else raw
        ends.append(e)
    e_b, e_c, e_d = ends[0], ends[0], ends[0]
    if ns == 2:
        e_c, e_d = ends[1], ends[2]
    unq = _unquantize_signed if signed else _unquantize_unsigned
    ua = unq(base, wb)
    ub = unq(e_b, wb)
    uc = unq(e_c, wb)
    ud = unq(e_d, wb)

    # per-texel palette indices
    texel = np.arange(16)
    if ns == 2:
        ibits = np.full((n, 16), 3, np.int64)
        ibits[:, 0] = 2
        anchor = _ANCHOR2[d]
        ibits[np.arange(n), anchor] = 2
        starts = np.cumsum(
            np.concatenate([np.full((n, 1), 82, np.int64),
                            ibits[:, :-1]], 1), 1)
        weights, wmax = _W3, 7
    else:
        ibits = np.full((n, 16), 4, np.int64)
        ibits[:, 0] = 3
        starts = np.cumsum(
            np.concatenate([np.full((n, 1), 65, np.int64),
                            ibits[:, :-1]], 1), 1)
        weights, wmax = _W4, 15
    idx = np.zeros((n, 16), np.int64)
    for t in range(16):
        st = starts[:, t]
        wdt = ibits[:, t]
        # general per-element extract (start varies per block)
        v = np.where(
            st >= 64,
            (hi >> np.clip(st - 64, 0, 63).astype(np.uint64)),
            (lo >> np.clip(st, 0, 63).astype(np.uint64))
            | np.where(st + wdt > 64,
                       hi << np.clip(64 - st, 0, 63).astype(np.uint64),
                       np.uint64(0)))
        idx[:, t] = (v & ((np.uint64(1) << wdt.astype(np.uint64))
                          - np.uint64(1))).astype(np.int64)
    idx = np.clip(idx, 0, wmax)

    in1 = ((_P2[d, None] >> texel[None, :]) & 1).astype(bool) \
        if ns == 2 else np.zeros((n, 16), bool)
    w = weights[idx]                                   # (N, 16)
    a = np.where(in1[..., None], uc[:, None, :], ua[:, None, :])
    b = np.where(in1[..., None], ud[:, None, :], ub[:, None, :])
    val = (a * (64 - w[..., None]) + b * w[..., None] + 32) >> 6
    return _finish_half(val, signed)


def decode_bc6h(raw, w, h, signed=False):
    """BC6H surface bytes -> (h, w, 3) float32.

    raw: uint8 array of ceil(w/4)*ceil(h/4) 16-byte blocks, row-major.
    Reserved mode ids (10011/10111/11011/11111) decode to zero per
    spec.
    """
    bw_, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.asarray(raw, np.uint8).reshape(bw_ * bh, 16)
    u64 = blocks.view("<u8").reshape(-1, 2)
    lo, hi = u64[:, 0].copy(), u64[:, 1].copy()
    mode2 = (lo & np.uint64(3)).astype(np.int64)
    mode5 = (lo & np.uint64(31)).astype(np.int64)
    mode = np.where(mode2 < 2, mode2, mode5)
    texels = np.zeros((bw_ * bh, 16, 3), np.float32)
    for m in _MODES:
        sel = np.nonzero(mode == m)[0]
        if sel.size:
            texels[sel] = _decode_mode(lo[sel], hi[sel], m, signed)
    img = texels.reshape(bh, bw_, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw_ * 4, 3)
    return np.ascontiguousarray(img[:h, :w])
