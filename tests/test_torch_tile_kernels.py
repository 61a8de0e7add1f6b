"""The TPU package's experimental and per-tile kernels against their
counterparts in minnow_torch, bitwise (tolerance zero), on the CPU:

* B7 ``pack_q_pallas_group``, through
  ``encode_float_pallas_bigblock(reuse_q=True)``, against
  ``encode.encode_float_group(reuse_q=True)`` (K5's plain version);
* B9 ``decode_float_pallas`` against ``decode.decode_float_group`` (K2);
* B10 ``unpack_pallas`` against ``decode.decode_int_group`` with zero
  minimums (K4);
* B11 ``pack_batch_pallas`` against ``encode.pack_batch`` (K3).

The Pallas kernels run in interpret mode, as the JAX package's tests run
them; inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from minnow_tpu.core import spec
from minnow_tpu.ops import fastdiv, pallas_codec, pallas_encode, pallas_pack
from minnow_tpu.ops.pallas_codec import group_tiles
from minnow_torch.ops import bitpack, codec, decode, encode

LOW, HIGH, DX = 0.0, 250.0, 0.001
PIXELS = spec.float_group_pixels(LOW, HIGH, DX)  # 250000: 18 bits


def _words_for(vals, bits, n):
    """Rows of ``spec.pack_bits`` streams, zero-padded to whole words."""
    return np.stack([bitpack.bytes_to_words(
        spec.pack_bits(v, bits), bits, n) for v in vals])


def _bigblock_inputs():
    """tests/test_pipeline.py's q-reuse inputs: a uniform block, a
    periodic block wrapping the edge, a non-periodic block."""
    rng = np.random.default_rng(23)
    b, n = 3, 16384
    x = rng.uniform(0, 249.9, (b, n)).astype(np.float32)
    x[1] = np.concatenate([rng.uniform(0, 2, n // 2),
                           250.0 - rng.uniform(0, 2, n - n // 2)])
    return x, np.array([True, True, False])


def test_b7_reuse_q_matches_port():
    x, per = _bigblock_inputs()
    b, n = x.shape
    low = np.full(b, LOW, np.float32)
    pix = np.full(b, PIXELS, np.int64)
    dxq = np.full(b, spec.quantize_dx(LOW, HIGH, PIXELS), np.float32)
    db, deb, dm0, dm1, ok = fastdiv.divisor_magic(dxq)
    assert ok.all()
    g = group_tiles(18)
    jw, jmins, jmaxd, jvalid = (np.asarray(a) for a in
                                pallas_encode.encode_float_pallas_bigblock(
        x.reshape(-1, g * 32), low, db, deb, dm0, dm1, pix, per, 18, n,
        interpret=True, reuse_q=True))
    jw = jw.reshape(b, n * 18 // 32)

    params = codec.block_params(low, np.full(b, HIGH), pix, per, "cpu")
    lens = torch.full((b,), n)
    words, plan = encode.encode_float_group(torch.from_numpy(x), params,
                                            lens, reuse_q=True)
    again, plan2 = encode.encode_float_group(torch.from_numpy(x), params,
                                             lens)
    assert torch.equal(words, again)
    np.testing.assert_array_equal(plan.bits, plan2.bits)

    np.testing.assert_array_equal(plan.valid, jvalid)
    np.testing.assert_array_equal(plan.mins, jmins)
    np.testing.assert_array_equal(
        plan.bits, [spec.precision_needed(int(d)) for d in jmaxd])
    assert list(plan.bits) == [18, 12, 18]  # block 1 wraps: narrower
    for i in range(b):
        width = int(plan.bits[i])
        got = words.numpy()[plan.offsets[i]:plan.offsets[i]
                            + bitpack.words_per_block(width, n)]
        # the TPU kernel packs every block at the predicted 18 bits
        deltas = spec.unpack_bits(bitpack.words_to_bytes(jw[i], 18, n), 18,
                                  n)
        assert bitpack.words_to_bytes(got, width, n) == \
            spec.pack_bits(deltas, width), i


@pytest.mark.parametrize("dither", ["none", "midpoint"])
def test_b9_decode_float_pallas_matches_port(dither):
    # tests/test_pallas_codec.py's inputs
    rng = np.random.default_rng(9)
    bits, n, b = 18, 4096, 5
    vals = rng.integers(0, PIXELS, (b, n), dtype=np.uint64)
    words = _words_for(vals, bits, n)
    mins = rng.integers(-3, 3, b).astype(np.int64)
    low = rng.uniform(-10, 0, b).astype(np.float32)
    high = (low + rng.uniform(100, 300, b)).astype(np.float32)
    pix = np.full(b, PIXELS, np.int64)
    periodic = np.array([True, True, False, True, False])
    ref = np.asarray(pallas_codec.decode_float_pallas(
        words, mins, low, high, pix, periodic, bits, n, dither=dither,
        interpret=True))
    got = decode.decode_float_group(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(mins),
        codec.block_params(low, high, pix, periodic, "cpu"), bits, n,
        dither)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))


@pytest.mark.parametrize("bits", [1, 7, 13, 18, 24, 32])
def test_b10_unpack_pallas_matches_port(bits):
    rng = np.random.default_rng(3)
    n, b = 2048, 3
    vals = rng.integers(0, 1 << bits, (b, n), dtype=np.uint64)
    words = _words_for(vals, bits, n)
    ref = np.asarray(pallas_codec.unpack_pallas(words, bits, n,
                                                interpret=True))
    got = decode.decode_int_group(torch.from_numpy(words.view(np.int32)),
                                  torch.zeros(b, dtype=torch.int64), bits, n)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), vals.astype(np.int64))


@pytest.mark.parametrize("bits", [16, 18, 32])  # t*bits lane-aligned
def test_b11_pack_batch_pallas_matches_port(bits):
    rng = np.random.default_rng(bits)
    b, n = 8, 2048
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.int64)
    if bits < 32:
        assert (x >= 1 << bits).any()  # values the width must mask
    ref = np.asarray(pallas_pack.pack_batch_pallas(x.astype(np.uint32), bits,
                                                   interpret=True))
    got = encode.pack_batch(torch.from_numpy(x), bits).numpy()
    assert got.shape == (b, bitpack.words_per_block(bits, n))
    np.testing.assert_array_equal(got.view(np.uint32), ref)
    mask = np.uint64((1 << bits) - 1)
    for i in range(b):
        assert bitpack.words_to_bytes(got[i].view(np.uint32), bits, n) == \
            spec.pack_bits(x[i].astype(np.uint64) & mask, bits)


@pytest.mark.parametrize("bits", [0, 33])
def test_pack_batch_refuses_widths(bits):
    with pytest.raises(ValueError, match="widths 1..32"):
        encode.pack_batch(torch.zeros((2, 64), dtype=torch.int64), bits)


def test_wrappers_refuse_bad_arguments():
    with pytest.raises(TypeError):
        encode.pack_batch(torch.zeros((2, 64), dtype=torch.int32), 8)
    params = codec.block_params([0.0], [1.0], [10], [True], "cpu")
    words = torch.zeros((1, 4), dtype=torch.int32)
    mins = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="uniform dither needs the keys"):
        decode.decode_float_group(words, mins, params, 4, 32, "uniform")
    x = torch.zeros((1, 8))
    lens = torch.full((1,), 8)
    with pytest.raises(TypeError):  # the q buffer must be int32
        encode.float_stats(x, params, lens,
                           q_out=torch.zeros((1, 8), dtype=torch.int64))
    with pytest.raises(ValueError):  # ... and shaped like x
        encode.float_stats(x, params, lens,
                           q_out=torch.zeros((1, 9), dtype=torch.int32))
