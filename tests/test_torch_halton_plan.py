"""The radical inverse of ``ops/csrc/halton.cuh`` as a numpy model, held
bit-equal to the port's ``sampling.halton`` and to the JAX package's (no
kernel, no interpret mode).

The header computes the Halton draws of K1, K2 / K2g (hdr, records_only),
K3 / K3g (draws regenerated), K6 and K7 in two forms: the digit loop for any
uint32 index, and below ``HALTON_SHORT`` (every index a render makes) a short
form: a fixed digit count per base, each weight f_k a compile-time constant,
the quotient one multiply-high by ceil(2^32 / B), base 2 a bit reversal.
The
model below is that C source, step for step, in numpy; the header's
constants are read from its text and held against the model's.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.sampling as jsmp
from gpuraytracer_tpu_torch import sampling as tsmp

HEADER = (Path(__file__).resolve().parents[1] / "gpuraytracer_tpu_torch" / "ops"
          / "csrc" / "halton.cuh").read_text()
HALTON_SHORT = (1 << 20) + (1 << 16)
# The dimensions a render draws from: at most 4 bounces (cuda_path._check_bounces).
DIMS = range(21)
# Every index a render at up to 400 spp makes: offsets in [0, 2^20) plus a sample.
RENDER_SPAN = (1 << 20) + 400
F32 = np.float32


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def short_digits(b: int) -> int:
    """halton.cuh short_digits: the least n with b^n >= HALTON_SHORT."""
    n, p = 1, b
    while p < HALTON_SHORT:
        p *= b
        n += 1
    return n


def digit_weight(b: int, k: int) -> np.float32:
    """halton.cuh digit_weight: k float32 products of fl(1/b) from 1."""
    inv_b, f = F32(1.0 / b), F32(1.0)
    for _ in range(k):
        f = F32(f * inv_b)
    return f


def short_magic(b: int) -> int:
    """halton.cuh short_magic: ceil(2^32 / b)."""
    return ((1 << 32) + b - 1) // b


def brev(i: np.ndarray) -> np.ndarray:
    i = i.astype(np.uint32)
    r = np.zeros_like(i)
    for _ in range(32):
        r = (r << np.uint32(1)) | (i & np.uint32(1))
        i = i >> np.uint32(1)
    return r


def radical_inverse_loop(i: np.ndarray, b: int) -> np.ndarray:
    """halton.cuh radical_inverse_loop: f *= fl(1/b), r += f * digit, each
    rounded, until the index is exhausted (here: to the count that exhausts
    any uint32, the further digits adding +0)."""
    i = i.astype(np.uint64)
    inv_b = F32(1.0 / b)
    f = np.ones(i.shape, np.float32)
    r = np.zeros(i.shape, np.float32)
    for _ in range(math.ceil(32 / math.log2(b))):
        f = f * inv_b
        r = r + f * (i % b).astype(np.float32)
        i = i // b
    return r


def radical_inverse_short(i: np.ndarray, b: int) -> np.ndarray:
    """halton.cuh radical_inverse_short, for i < HALTON_SHORT."""
    i = i.astype(np.uint64)
    if b == 2:
        return brev(i).astype(np.float32) * F32(2.0 ** -32)
    n = short_digits(b)
    r = None
    for k in range(1, n + 1):
        q = (i * np.uint64(short_magic(b))) >> np.uint64(32) if k < n else np.zeros_like(i)
        t = digit_weight(b, k) * (i - q * np.uint64(b)).astype(np.float32)
        r = t if k == 1 else r + t
        i = q
    return r


def radical_inverse(i: np.ndarray, b: int) -> np.ndarray:
    """halton.cuh radical_inverse: the short form below HALTON_SHORT, the
    loop above."""
    i = np.asarray(i, dtype=np.uint32)
    out = radical_inverse_loop(i, b)
    short = i < HALTON_SHORT
    out[short] = radical_inverse_short(i[short], b)
    return out


def _boundaries(b: int) -> list:
    out, p = [], b
    while p < (1 << 32):
        out += [p - 1, p]
        p *= b
    return out


def _jax_index_set(d: int) -> np.ndarray:
    """The index set of test_torch_sampling's Halton test for dimension d
    (seeded indices below 2^21 + 400, 0-63, two ends), every base's
    boundaries B^k - 1 and B^k below 2^32, HALTON_SHORT's neighbours and
    2^32 - 1."""
    top = (1 << 21) + 400
    rng = np.random.default_rng(d)
    return np.concatenate([
        rng.integers(0, top, size=4096), np.arange(64), [top - 1, (1 << 20) - 1],
        *[_boundaries(b) for b in tsmp.PRIMES],
        [HALTON_SHORT - 1, HALTON_SHORT, (1 << 32) - 1]]).astype(np.uint32)


def _header_constant(name: str) -> str:
    m = re.search(rf"constexpr uint32_t {name}(?:\[\d+\])? = ([^;]+);", HEADER)
    assert m, f"{name} not found in halton.cuh"
    return m.group(1)


def test_header_primes_are_the_samplers():
    primes = [int(x) for x in re.findall(r"\d+", _header_constant("HALTON_PRIMES")
                                         .strip("{}"))]
    assert primes == list(tsmp.PRIMES) == list(jsmp.PRIMES)


def test_header_short_limit_is_the_models():
    text = _header_constant("HALTON_SHORT")
    assert text == "(1u << 20) + (1u << 16)"
    assert eval(text.replace("1u", "1")) == HALTON_SHORT
    # The largest index of a launch: an offset of pixel_rng_offsets (below
    # 2^20) plus a sample (grt_pregen_draws takes at most 65,535).
    assert (1 << 20) - 1 + 65535 - 1 < HALTON_SHORT
    assert HALTON_SHORT <= 1 << 24      # base 2's bit reversal needs i < 2^24


@pytest.mark.parametrize("assertion", re.findall(
    r"static_assert\(digit_weight<(\d+)>\((\d+)\) == ([0-9a-fx.p+-]+)f", HEADER))
def test_header_weights_are_the_float32_chain(assertion):
    b, k, literal = int(assertion[0]), int(assertion[1]), assertion[2]
    assert digit_weight(b, k) == F32(float.fromhex(literal))


@pytest.mark.parametrize("b", tsmp.PRIMES)
def test_short_digits_cover_the_short_indices(b):
    n = short_digits(b)
    assert b ** (n - 1) < HALTON_SHORT <= b ** n
    # The header's comment: 21 for base 2, 13 for base 3, 4 from 37 up.
    assert {2: 21, 3: 13, 37: 4, 73: 4}.get(b, n) == n


@pytest.mark.parametrize("b", tsmp.PRIMES[1:])
def test_short_magic_divides_exactly_below_the_limit(b):
    i = np.arange(HALTON_SHORT, dtype=np.uint64)
    q = (i * np.uint64(short_magic(b))) >> np.uint64(32)
    np.testing.assert_array_equal(q, i // np.uint64(b))
    # The bound the header states: i e < 2^32 with e = M b - 2^32 < b.
    e = short_magic(b) * b - (1 << 32)
    assert 0 <= e < b and (HALTON_SHORT - 1) * e < 1 << 32


def test_base_two_bit_reversal_is_the_loop_below_2_24():
    # Every render index is checked below; here the rest of the range the
    # proof covers, every 7th index and the last 2^16.
    i = np.concatenate([np.arange(0, 1 << 24, 7), np.arange((1 << 24) - (1 << 16), 1 << 24)]
                       ).astype(np.uint32)
    np.testing.assert_array_equal(_bits(radical_inverse_short(i, 2)),
                                  _bits(radical_inverse_loop(i, 2)))


@pytest.mark.parametrize("d", DIMS)
def test_model_is_the_ports_halton_over_every_render_index(d):
    i = np.arange(RENDER_SPAN, dtype=np.uint32)
    got = radical_inverse(i, tsmp.PRIMES[d])
    ref = tsmp.halton(torch.from_numpy(i.astype(np.int64)), d).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("d", DIMS)
def test_model_is_the_jax_packages_halton(d):
    import jax
    i = _jax_index_set(d)
    with jax.disable_jit():   # op by op: see test_torch_sampling._op_by_op
        ref = np.asarray(jsmp.halton(jnp.asarray(i), d))
    got = radical_inverse(i, tsmp.PRIMES[d])
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    short = i < HALTON_SHORT
    np.testing.assert_array_equal(_bits(radical_inverse_short(i[short], tsmp.PRIMES[d])),
                                  _bits(ref[short]))
