"""64-bit unsigned arithmetic on (lo, hi) pairs of 32-bit words.

PyTorch counterpart of `directcomputeraytracing_tpu.rng.uint64`. torch has
no usable uint32 arithmetic on either device, so every 32-bit word is an
int64 tensor holding a value in [0, 2^32). Sums and products stay below
2^63 (products are split into 16-bit limbs), and every result is masked
back to 32 bits, so the ops wrap modulo 2^64 exactly like the reference.
"""

import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF


def u64(lo, hi, like):
    """A (lo, hi) pair of constants shaped and placed like `like`."""
    return (torch.full_like(like, lo & M32), torch.full_like(like, hi & M32))


def u64_add(a, b):
    lo = a[0] + b[0]
    hi = (a[1] + b[1] + (lo >> 32)) & M32
    return lo & M32, hi


def u64_shift_right(a, n):
    """Logical right shift by a static 0 < n < 32 (operands are
    non-negative, so the arithmetic int64 shift is logical here)."""
    lo, hi = a
    assert 0 < n < 32
    return ((lo >> n) | (hi << (32 - n))) & M32, hi >> n


def _mul_lo32(a, b):
    """Low 32 bits of a * b for 32-bit words: a0*b + (a1*b0 << 16) stays
    below 2^49, and a1*b1 only reaches bits >= 32."""
    return ((a & M16) * b + (((a >> 16) * (b & M16)) << 16)) & M32


def u32_mul_to_u64(a, b):
    """Full 32x32 -> 64 bit product as (lo, hi) (16-bit limbs)."""
    a0, a1 = a & M16, a >> 16
    b0, b1 = b & M16, b >> 16
    p11 = a1 * b1
    p01 = a0 * b1
    p10 = a1 * b0
    p00 = a0 * b0
    middle = p10 + (p00 >> 16) + (p01 & M16)
    hi = (p11 + (middle >> 16) + (p01 >> 16)) & M32
    lo = ((middle << 16) | (p00 & M16)) & M32
    return lo, hi


def u64_mul(a, b):
    """64x64 -> low 64 bits of the product."""
    lo, hi = u32_mul_to_u64(a[0], b[0])
    hi = (hi + _mul_lo32(a[1], b[0]) + _mul_lo32(a[0], b[1])) & M32
    return lo, hi
