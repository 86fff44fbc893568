"""The port's RNG against the reference's, bit for bit.

The port carries 32-bit words in int64 tensors; every stream must equal
the reference's uint32 stream exactly (tolerance: none), because the
render tests compare the two packages path for path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directcomputeraytracing_tpu.rng import uint64 as ref_u64
from directcomputeraytracing_tpu.rng import xoshiro as ref
from directcomputeraytracing_tpu_torch.rng import uint64 as port_u64
from directcomputeraytracing_tpu_torch.rng import xoshiro as port


def _grid(n=16):
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return xs.reshape(-1).astype(np.uint32), ys.reshape(-1).astype(np.uint32)


def _same_state(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_streams_bit_equal(seed):
    px, py = _grid()
    a = ref.init_rng(jnp.asarray(px), jnp.asarray(py), jnp.uint32(seed))
    b = port.init_rng(torch.from_numpy(px.astype(np.int64)),
                      torch.from_numpy(py.astype(np.int64)), seed)
    _same_state(a, b)
    for draw in ("next_sample_1d", "next_sample_2d", "next_sample_3d") * 3:
        a, ua = getattr(ref, draw)(a)
        b, ub = getattr(port, draw)(b)
        _same_state(a, b)
        np.testing.assert_array_equal(np.asarray(ua), ub.numpy())
        assert ub.dtype == torch.float32


def test_far_pixels_and_large_seed():
    # Morton interleave keeps the low 16 bits of each coordinate
    rs = np.random.default_rng(3)
    px = rs.integers(0, 1 << 20, 256).astype(np.uint32)
    py = rs.integers(0, 1 << 20, 256).astype(np.uint32)
    a = ref.init_rng(jnp.asarray(px), jnp.asarray(py), jnp.uint32(123456789))
    b = port.init_rng(torch.from_numpy(px.astype(np.int64)),
                      torch.from_numpy(py.astype(np.int64)), 123456789)
    _same_state(a, b)


@pytest.mark.parametrize("op", ["u64_add", "u64_mul", "u32_mul_to_u64",
                                "u64_shift_right", "u64_xor",
                                "u64_shift_left"])
def test_uint64_ops_bit_equal(op):
    """Full-range words, where int64 products would overflow without the
    16-bit limbs, and words at 0 and 2^32 - 1 in both halves (a left
    shift must drop the bits past 32 that an int64 word keeps)."""
    rs = np.random.default_rng(11)
    words = [rs.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
             for _ in range(4)]
    words[0][:4] = [0xFFFFFFFF, 0, 0x80000000, 1]
    words[1][:4] = [0xFFFFFFFF, 0xFFFFFFFF, 0, 0]
    words[2][:2] = [0, 0xFFFFFFFF]
    ja = (jnp.asarray(words[0]), jnp.asarray(words[1]))
    jb = (jnp.asarray(words[2]), jnp.asarray(words[3]))
    ta = tuple(torch.from_numpy(w.astype(np.int64)) for w in words[:2])
    tb = tuple(torch.from_numpy(w.astype(np.int64)) for w in words[2:])
    if op == "u32_mul_to_u64":
        got_r = ref_u64.u32_mul_to_u64(ja[0], jb[0])
        got_p = port_u64.u32_mul_to_u64(ta[0], tb[0])
    elif op.startswith("u64_shift"):
        for n in (1, 13, 31):
            for r, p in zip(getattr(ref_u64, op)(ja, n),
                            getattr(port_u64, op)(ta, n)):
                _same_state(r, p)
        return
    else:
        got_r = getattr(ref_u64, op)(ja, jb)
        got_p = getattr(port_u64, op)(ta, tb)
    for r, p in zip(got_r, got_p):
        _same_state(r, p)
