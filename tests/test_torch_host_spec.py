"""The port's host codec (``minnow_torch.core``, ``minnow_torch.native``)
against the JAX package's (``minnow_tpu.core``, ``minnow_tpu.native``), on
the same numpy inputs, tolerance zero: bytes, integers and float bit
patterns must be equal."""

import numpy as np
import pytest

from minnow_tpu import native as ref_native
from minnow_tpu.core import dither as ref_dither
from minnow_tpu.core import gomath as ref_gomath
from minnow_tpu.core import spec as ref_spec
from minnow_tpu.core import types as ref_types
from minnow_torch import native
from minnow_torch.core import dither, gomath, spec, types


def _values(rng, bits, n):
    if bits == 0:
        return np.zeros(n, np.uint64)
    hi = (1 << bits) - 1
    v = rng.integers(0, hi, n, dtype=np.uint64, endpoint=True)
    v[-1] = hi
    v[0] = 0 if n > 1 else hi
    return v


@pytest.mark.parametrize("bits", range(65))
def test_pack_unpack_every_width(bits):
    rng = np.random.default_rng(bits)
    for n in (1, 31, 32, 33, 1000):
        v = _values(rng, bits, n)
        data = spec.pack_bits(v, bits)
        assert data == ref_spec.pack_bits(v, bits)
        assert len(data) == spec.array_bytes(bits, n) \
            == ref_spec.array_bytes(bits, n)
        np.testing.assert_array_equal(spec.unpack_bits(data, bits, n),
                                      ref_spec.unpack_bits(data, bits, n))
        np.testing.assert_array_equal(spec.unpack_bits(data, bits, n), v)
        if bits:
            assert native.pack_bits(v, bits) == ref_native.pack_bits(v, bits)
            np.testing.assert_array_equal(
                native.unpack_bits(data, bits, n),
                ref_native.unpack_bits(data, bits, n))


@pytest.mark.parametrize("value", [0, 1, 2, 255, 256, (1 << 32) - 1, 1 << 32,
                                   (1 << 53) + 1, (1 << 63) - 1,
                                   (1 << 64) - 1])
def test_precision_needed(value):
    assert spec.precision_needed(value) == ref_spec.precision_needed(value)
    assert spec.precision_needed_go(value) \
        == ref_spec.precision_needed_go(value)


# (low, high, dx): the catalog's position, velocity and log-mass configs
CONFIGS = [(0.0, 250.0, 0.001), (-1e4, 1e4, 0.1), (5.0, 16.0, 0.001),
           (-3.0, 3.0, 1e-6)]


@pytest.mark.parametrize("low,high,dx", CONFIGS)
def test_quantize_and_dequantize(low, high, dx):
    rng = np.random.default_rng(7)
    pixels = spec.float_group_pixels(low, high, dx)
    assert pixels == ref_spec.float_group_pixels(low, high, dx)
    assert spec.quantize_dx(low, high, pixels).view(np.int32) \
        == ref_spec.quantize_dx(low, high, pixels).view(np.int32)
    x = rng.uniform(low, high, 5000).astype(np.float32)
    x[:3] = (low, np.nextafter(np.float32(high), np.float32(low)),
             (low + high) / 2)
    q = spec.quantize(x, low, high, pixels)
    np.testing.assert_array_equal(q, ref_spec.quantize(x, low, high, pixels))
    for u in (None, 0.5, rng.random(len(q)).astype(np.float32)):
        got = spec.dequantize(q, low, high, pixels, u)
        want = ref_spec.dequantize(q, low, high, pixels, u)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _periodic_cases(rng, pixels, n):
    """Pixel sets: clustered, wrapping across the edge, spread wide."""
    h = max(pixels // 8, 1)
    return [rng.integers(pixels // 2, pixels // 2 + h, n),
            np.where(rng.random(n) < 0.5, rng.integers(pixels - h, pixels, n),
                     rng.integers(0, h, n)),
            rng.integers(0, pixels, n),
            np.full(n, pixels - 1), np.array([0]), np.array([], np.int64)]


@pytest.mark.parametrize("pixels", [1, 7, 250000, (1 << 31) - 1])
def test_periodic_min_and_bound(pixels):
    rng = np.random.default_rng(pixels % 1000)
    for q in _periodic_cases(rng, pixels, 300):
        q = np.asarray(q, np.int64)
        got, want = spec.periodic_min_fast(q, pixels), \
            ref_spec.periodic_min_fast(q, pixels)
        assert got == want
        assert spec.periodic_min(q, pixels) == ref_spec.periodic_min(q, pixels)
        assert native.periodic_min(q, pixels) \
            == ref_native.periodic_min(q, pixels)
        m = got[0] if isinstance(got, tuple) else got
        np.testing.assert_array_equal(spec.bound(q, int(m), pixels),
                                      ref_spec.bound(q, int(m), pixels))
    for x, x0 in ((0, pixels - 1), (pixels - 1, 0), (pixels // 2, 0)):
        assert spec.periodic_distance(x, x0, pixels) \
            == ref_spec.periodic_distance(x, x0, pixels)


def _float_blocks(rng, low, high, n):
    span = high - low
    return {
        "uniform": rng.uniform(low, high, n),
        "cluster": rng.uniform(low + 0.4 * span, low + 0.41 * span, n),
        "wrap": np.where(rng.random(n) < 0.5,
                         rng.uniform(high - 0.01 * span, high, n),
                         rng.uniform(low, low + 0.01 * span, n)),
        "at high": np.concatenate([rng.uniform(low, high, n - 1), [high]]),
        "nan": np.concatenate([rng.uniform(low, high, n - 1), [np.nan]]),
        "one": rng.uniform(low, high, 1),
    }


@pytest.mark.parametrize("clamp_q", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("low,high,dx", CONFIGS[:3])
def test_encode_float_block(low, high, dx, periodic, clamp_q):
    rng = np.random.default_rng(11)
    pixels = spec.float_group_pixels(low, high, dx)
    for name, x in _float_blocks(rng, low, high, 700).items():
        x = np.clip(x, low, high).astype(np.float32)
        kw = dict(periodic=periodic, clamp_q=clamp_q)
        got = spec.encode_float_block(x, low, high, pixels, **kw)
        want = ref_spec.encode_float_block(x, low, high, pixels, **kw)
        assert got[:3] == want[:3], name
        if np.isfinite(x).all():
            fast = native.encode_float_block(
                x, np.float32(low), np.float32(high), pixels, **kw)
            ref_fast = ref_native.encode_float_block(
                x, np.float32(low), np.float32(high), pixels, **kw)
            assert fast[:3] == ref_fast[:3] == got[:3], name


@pytest.mark.parametrize("lo", [0, -(1 << 63), (1 << 53) + 1])
def test_encode_int_block(lo):
    rng = np.random.default_rng(3)
    for bits in (0, 1, 20, 54, 63):
        d = _values(rng, bits, 500).view(np.int64)
        x = d + np.int64(lo) if lo >= 0 or bits < 63 else d
        got = spec.encode_int_block(x)
        want = ref_spec.encode_int_block(x)
        assert got[:3] == want[:3]
        np.testing.assert_array_equal(
            spec.decode_int_block(got[0], got[1], got[2], len(x)),
            ref_spec.decode_int_block(*want[:3], len(x)))
        np.testing.assert_array_equal(
            spec.decode_int_block(got[0], got[1], got[2], len(x)), x)


@pytest.mark.parametrize("mode", ["none", "midpoint", "uniform", "philox"])
def test_dither_streams(mode):
    for seed, block in ((0, 0), (7, 5), (3, 1 << 33), ((1 << 31) + 5, 12)):
        got = dither.dither_u(mode, seed, block, 257)
        want = ref_dither.dither_u(mode, seed, block, 257)
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_dither_keys_of_many_blocks():
    ids = np.array([0, 1, 2, 1 << 20, 1 << 33, (1 << 40) + 3])
    for seed in (0, 9, (1 << 32) - 1):
        for got, want in zip(dither._np_fold_in(seed, ids),
                             ref_dither._np_fold_in(seed, ids)):
            np.testing.assert_array_equal(got, want)


def test_go_logarithms():
    rng = np.random.default_rng(5)
    x = np.concatenate([10.0 ** rng.uniform(-30, 30, 4000),
                        [1.0, 10.0, 1e5, 2.0 ** -1022, 1e300]])
    for fn in ("log", "log2", "log10"):
        got = getattr(gomath, fn)(x)
        want = getattr(ref_gomath, fn)(x)
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
    x32 = x.astype(np.float32)
    x32 = x32[np.isfinite(x32) & (x32 > 0)]
    np.testing.assert_array_equal(native.log10_f32(x32).view(np.int32),
                                  ref_native.log10_f32(x32).view(np.int32))


def test_group_types():
    assert (types.MAGIC, types.VERSION) == (ref_types.MAGIC,
                                            ref_types.VERSION)
    assert types.GROUP_NAMES == ref_types.GROUP_NAMES
    for t in range(len(ref_types.GROUP_NAMES)):
        assert types.is_fixed(t) == ref_types.is_fixed(t)
        if types.is_fixed(t):
            assert types.group_dtype(t) == ref_types.group_dtype(t)
            assert types.fixed_group_for_dtype(types.group_dtype(t)) == t
