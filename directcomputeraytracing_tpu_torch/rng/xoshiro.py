"""Per-pixel xoshiro128** streams seeded by SplitMix64.

PyTorch counterpart of `directcomputeraytracing_tpu.rng.xoshiro`, bit
exact: the state is an int64 tensor (..., 4) holding 32-bit words, masked
after every shift and product (see `uint64`). Identical streams are what
let the port be compared with the reference ray for ray.
"""

import torch

from .uint64 import M32, u64, u64_add, u64_mul, u64_shift_right


def _rotl(x, k):
    return ((x << k) | (x >> (32 - k))) & M32


def xoshiro_next(state):
    """Advance xoshiro128**; returns (new_state (..., 4), result (...))."""
    s0, s1, s2, s3 = state.unbind(-1)
    result = (_rotl((s0 * 5) & M32, 7) * 9) & M32
    t = (s1 << 9) & M32
    s2 = s2 ^ s0
    s3 = s3 ^ s1
    s1 = s1 ^ s2
    s0 = s0 ^ s3
    s2 = s2 ^ t
    s3 = _rotl(s3, 11)
    return torch.stack([s0, s1, s2, s3], dim=-1), result


def morton_interleave_32(x, y):
    """Interleave the low 16 bits of x (even bits) and y (odd bits)."""

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(x.long() & 0xFFFF) | (spread(y.long() & 0xFFFF) << 1)


def splitmix64_next(state):
    """One SplitMix64 step on a (lo, hi) pair; returns (state, output)."""
    state = u64_add(state, u64(0x7F4A7C15, 0x9E3779B9, state[0]))

    def mix(z, shift, mul_lo, mul_hi):
        s = u64_shift_right(z, shift)
        return u64_mul((z[0] ^ s[0], z[1] ^ s[1]),
                       u64(mul_lo, mul_hi, z[0]))

    z = mix(state, 30, 0x1CE4E5B9, 0xBF58476D)
    z = mix(z, 27, 0x133111EB, 0x94D049BB)
    s = u64_shift_right(z, 31)
    return state, (z[0] ^ s[0], z[1] ^ s[1])


def init_rng(pixel_x, pixel_y, frame_seed):
    """Per-pixel state (..., 4) int64 from integer pixel coordinates and a
    frame seed, a scalar or an integer tensor of one seed per pixel (taken
    modulo 2^32, like the reference's uint32)."""
    lo = morton_interleave_32(pixel_x, pixel_y)
    if torch.is_tensor(frame_seed):
        hi = (frame_seed.long() & M32).expand_as(lo)
    else:
        hi = torch.full_like(lo, int(frame_seed) & M32)
    sm, s0 = splitmix64_next((lo, hi))
    _, s1 = splitmix64_next(sm)
    return torch.stack([s0[0], s0[1], s1[0], s1[1]], dim=-1)


def next_sample_1d(state):
    """(new_state, u in [0, 1) float32): the top 24 bits over 2^24."""
    state, bits = xoshiro_next(state)
    return state, (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def next_sample_2d(state):
    state, ux = next_sample_1d(state)
    state, uy = next_sample_1d(state)
    return state, torch.stack([ux, uy], dim=-1)


def next_sample_3d(state):
    state, uxy = next_sample_2d(state)
    state, uz = next_sample_1d(state)
    return state, torch.cat([uxy, uz[..., None]], dim=-1)
