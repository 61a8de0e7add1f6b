"""minnow_torch.ops.codec (plain PyTorch codec arithmetic) against the
normative spec and the JAX package's codec, bitwise."""

import numpy as np
import pytest
import torch

from minnow_tpu.core import spec
from minnow_tpu.ops import codec as jax_codec
from minnow_torch.ops import codec

# quantisation configs of ops/validate.py:40-42 and :81
CONFIGS = [(0.0, 250.0, 0.001), (-50.0, 100.0, 1.0), (0.0, 1.0, 1 / 7),
           (1.0, 5.0, 1e-4), (5.0, 16.0, 0.001), (-50.0, 100.0, 0.25)]


def _params(low, high, pixels, b=1, periodic=True):
    return codec.block_params(np.full(b, low), np.full(b, high),
                              np.full(b, pixels), np.full(b, periodic),
                              "cpu")


def _quantize(x, low, high, pixels):
    p = _params(low, high, pixels)
    q, ok = codec.quantize(torch.from_numpy(x[None, :]), p.low, p.dx)
    return q[0].numpy(), ok[0].numpy()


def _adversarial(rng, low, high, pixels, k=5000):
    """Values one ulp around pixel boundaries (ops/validate.py:56-62),
    plus signed zeros, subnormals and huge values."""
    dxq = spec.quantize_dx(low, high, pixels)
    ks = rng.integers(1, pixels, k)
    grid = (np.float32(low) + (ks.astype(np.float32) * dxq)).astype(
        np.float32)
    special = np.array([0.0, -0.0, 1e-38, -1e-38, 2.0 ** -149, 1e38,
                        -5.5, np.float32(high), np.float32(low)],
                       np.float32)
    return np.concatenate([np.nextafter(grid, -np.inf), grid,
                           np.nextafter(grid, np.inf), special])


@pytest.mark.parametrize("low,high,dx", CONFIGS)
def test_quantize_matches_spec(low, high, dx):
    rng = np.random.default_rng(int(dx * 1e4) + 17)
    pixels = spec.float_group_pixels(low, high, dx)
    x = np.concatenate([
        rng.uniform(low, high, 20000).astype(np.float32),
        _adversarial(rng, low, high, pixels)])
    q, ok = _quantize(x, low, high, pixels)
    with np.errstate(all="ignore"):
        qf = np.floor(np.float32(x - np.float32(low))
                      / spec.quantize_dx(low, high, pixels))
        want = spec.quantize(x, low, high, pixels)
    np.testing.assert_array_equal(ok, np.isfinite(qf)
                                  & (np.abs(qf) < 2.0 ** 31))
    assert ok.sum() >= x.size - 2  # only the huge specials are refused
    np.testing.assert_array_equal(q[ok], want[ok])


def test_quantize_flags_what_it_cannot_certify():
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 1.5], np.float32)
    q, ok = _quantize(x, 0.0, 1.0, 1)
    np.testing.assert_array_equal(ok, [False] * 5 + [True])
    assert q[5] == 1 and (q[:5] == 0).all()


@pytest.mark.parametrize("low,high,dx", CONFIGS[:3] + [(5.0, 16.0, 0.001)])
def test_dequantize_matches_spec_and_dequantize24(low, high, dx):
    rng = np.random.default_rng(3)
    pixels = spec.float_group_pixels(low, high, dx)
    q = rng.integers(0, pixels, 20000)
    q[0] = min(6276, pixels - 1)  # the FMA-contraction case of validate
    p = _params(low, high, pixels)
    u = rng.random(q.size).astype(np.float32)
    for uu in (None, 0.5, u):
        ut = torch.from_numpy(uu[None, :]) if isinstance(uu, np.ndarray) \
            else uu
        got = codec.dequantize(torch.from_numpy(q[None, :]), p.low, p.dx,
                               ut)[0].numpy()
        su = None if uu is None else np.broadcast_to(
            np.asarray(uu, np.float64), q.shape)
        want = spec.dequantize(q, low, high, pixels, u=su)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        j24 = np.asarray(jax_codec.dequantize24(
            q.astype(np.int32), np.float32(low), np.float32(high), pixels,
            None if uu is None else np.broadcast_to(
                np.asarray(uu, np.float32), q.shape)))
        np.testing.assert_array_equal(got.view(np.int32),
                                      j24.view(np.int32))


def test_block_params_dx_is_spec_and_jax_dx():
    rng = np.random.default_rng(5)
    low = rng.uniform(-100, 100, 64).astype(np.float32)
    high = (low + rng.uniform(0.5, 300, 64)).astype(np.float32)
    pixels = rng.integers(1, 1 << 30, 64)
    p = codec.block_params(low, high, pixels, np.ones(64, bool), "cpu")
    want = np.array([spec.quantize_dx(lo, hi, px)
                     for lo, hi, px in zip(low, high, pixels)], np.float32)
    np.testing.assert_array_equal(p.dx.numpy().view(np.int32),
                                  want.view(np.int32))
    jdx = np.asarray(jax_codec._dx64(low, high, pixels)).astype(np.float32)
    np.testing.assert_array_equal(p.dx.numpy().view(np.int32),
                                  jdx.view(np.int32))
    assert p.pixels.dtype == torch.int64 and p.periodic.dtype == torch.bool
    # any count from 1 up is taken: the kernels judge a block by its data
    wide = np.array([1 << 31, (1 << 31) + 5, 1 << 33, 10 ** 10,
                     (1 << 53) + 1, (1 << 63) - 1], np.int64)
    pw = codec.block_params(low[:6], high[:6], wide, np.ones(6, bool), "cpu")
    np.testing.assert_array_equal(pw.pixels.numpy(), wide)
    want = np.array([spec.quantize_dx(lo, hi, int(px))
                     for lo, hi, px in zip(low, high, wide)], np.float32)
    np.testing.assert_array_equal(pw.dx.numpy().view(np.int32),
                                  want.view(np.int32))
    with pytest.raises(ValueError):
        codec.block_params([0.0], [1.0], [0], [True], "cpu")


def test_dither_keys_and_hash_match_jax():
    ids = np.array([0, 1, 2, 77, 123456, 2**31 + 5], np.int64)
    for seed in (0, 9, 2**40 + 3):
        k1, k2 = codec.dither_keys(ids, seed, "cpu")
        j1, j2 = (np.asarray(k) for k in jax_codec.dither_keys(ids, seed))
        np.testing.assert_array_equal(k1.numpy().view(np.uint32), j1)
        np.testing.assert_array_equal(k2.numpy().view(np.uint32), j2)
        c = np.arange(5000, dtype=np.uint32)
        c[-3:] = [2**31, 2**32 - 2, 2**32 - 1]
        got = codec.dither_hash_u(torch.from_numpy(c.astype(np.int64))[None],
                                  k1[:, None], k2[:, None]).numpy()
        want = np.stack([np.asarray(jax_codec.dither_hash_u(
            c, np.uint32(a), np.uint32(b))) for a, b in zip(j1, j2)])
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_periodic_min_fast_matches_spec():
    """The batched periodic minimum (the stats pass plus its finish, as
    the float encode runs it) against spec.periodic_min_fast."""
    rng = np.random.default_rng(11)
    p, n = 1000, 300
    rows = [rng.integers(0, p, n),                               # wide
            rng.integers(400, 460, n),                           # cluster
            np.where(rng.random(n) < 0.5, rng.integers(980, 1000, n),
                     rng.integers(0, 15, n)),                    # wrap
            np.full(n, 999),                                     # constant
            np.concatenate([rng.integers(0, 10, n - 1), [1000]]),  # bad
            np.concatenate([rng.integers(0, 10, n - 1), [-1]])]    # bad
    # dx = 1, so the pixel of q + 0.5 is q
    x = torch.from_numpy((np.stack(rows) + 0.5).astype(np.float32))
    params = codec.block_params(np.zeros(6), np.full(6, float(p)),
                                np.full(6, p), np.ones(6, bool), "cpu")
    lens = torch.tensor([n, n, n, n, n, n - 1])
    st = codec.float_block_stats(x, params, lens)
    m, _, _, valid = codec.finish_float_stats(st, params.pixels,
                                              params.periodic, lens)
    for r in range(6):
        want_m, want_valid = spec.periodic_min_fast(rows[r][:int(lens[r])],
                                                    p)
        assert bool(valid[r]) == want_valid, r
        if want_valid:
            assert int(m[r]) == want_m, r


def test_float_stats_finish_matches_spec_encode():
    """The stats pass plus its finish give spec.encode_float_block's
    block minimum and width for every valid block."""
    rng = np.random.default_rng(21)
    low, high, dx = 0.0, 250.0, 0.001
    pixels = spec.float_group_pixels(low, high, dx)
    n = 777
    x = rng.uniform(0, 249.9, (6, n)).astype(np.float32)
    x[1] = rng.uniform(120, 120.5, n)
    x[2] = np.where(rng.random(n) < 0.5, rng.uniform(249.5, 249.99, n),
                    rng.uniform(0, 0.3, n))
    x[3, 9] = np.nan
    x[4, 2] = 251.0
    periodic = np.array([1, 1, 1, 1, 1, 0], bool)
    p = codec.block_params(np.full(6, low), np.full(6, high),
                           np.full(6, pixels), periodic, "cpu")
    lens = torch.full((6,), n)
    st = codec.float_block_stats(torch.from_numpy(x), p, lens)
    m, mn, maxd, valid = codec.finish_float_stats(st, p.pixels, p.periodic,
                                                  lens)
    np.testing.assert_array_equal(valid.numpy(),
                                  [True, True, True, False, False, True])
    for r in (0, 1, 2, 5):
        _, want_mn, want_bits, _ = spec.encode_float_block(
            x[r], low, high, pixels, periodic=bool(periodic[r]))
        assert int(mn[r]) == want_mn, r
        assert spec.precision_needed(int(maxd[r])) == want_bits, r


def test_int_block_stats_match_jax():
    rng = np.random.default_rng(31)
    x = rng.integers(-2**62, 2**62, (4, 100))
    x[1, :] = 2**60 + rng.integers(0, 1000, 100)
    x[2, 3] = 2**63 - 1
    x[2, 4] = -2**63
    lens = np.array([100, 50, 100, 0])
    mn, maxd = codec.int_block_stats(torch.from_numpy(x),
                                     torch.from_numpy(lens))
    jmn, jmaxd = (np.asarray(a) for a in jax_codec.int_block_stats(x, lens))
    np.testing.assert_array_equal(mn.numpy()[lens > 0], jmn[lens > 0])
    np.testing.assert_array_equal(maxd.numpy().view(np.uint64), jmaxd)
