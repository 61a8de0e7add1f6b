"""Float and int block encode of minnow_torch (the plain versions of
kernels K1 and K3, as the CPU runs them) against the JAX package: its
Pallas kernels in interpret mode, its BlockEncoder and the normative
spec, bitwise."""

import numpy as np
import pytest
import torch

from minnow_tpu.core import spec
from minnow_tpu.ops import fastdiv, pallas_encode
from minnow_tpu.ops.pallas_codec import group_tiles
from minnow_tpu.parallel.pipeline import BlockEncoder as JaxBlockEncoder
from minnow_torch.ops import bitpack, codec, encode
from minnow_torch.parallel.pipeline import BlockEncoder

LOW, HIGH, DX = 0.0, 250.0, 0.001
PIXELS = spec.float_group_pixels(LOW, HIGH, DX)  # 250000: 18 bits


def _block_words(words, plan, i, n):
    nw = bitpack.words_per_block(int(plan.bits[i]), n)
    off = plan.offsets[i]
    return words.numpy()[off:off + nw].view(np.uint32)


def test_encode_float_group_matches_pallas_kernel():
    """Port K1 (plain) == encode_float_pallas_group (interpret) on words,
    mins and maxd of every block both certify."""
    rng = np.random.default_rng(13)
    bits = 18
    g = group_tiles(bits)
    b, n = 5, 32 * g * 8
    x = rng.uniform(0, 249.9, (b, n)).astype(np.float32)
    x[1] = rng.uniform(0, 2.0, n)                      # narrow width
    x[2] = np.where(rng.random(n) < 0.5, rng.uniform(249.7, 249.99, n),
                    rng.uniform(0, 0.2, n))            # wraps the edge
    x[3, 100] = np.nan                                 # not certified
    low = np.full(b, LOW, np.float32)
    pix = np.full(b, PIXELS, np.int64)
    per = np.ones(b, bool)
    dxq = np.full(b, spec.quantize_dx(LOW, HIGH, PIXELS), np.float32)
    db, deb, dm0, dm1, dok = fastdiv.divisor_magic(dxq)
    jw, jmins, jmaxd, jvalid = (np.asarray(a) for a in
                                pallas_encode.encode_float_pallas_group(
        x.reshape(-1, g * 32), low, db, deb, dm0, dm1, pix, per, bits, n,
        interpret=True))
    jw = jw.reshape(b, (n // 32) * bits)

    params = codec.block_params(low, np.full(b, HIGH), pix, per, "cpu")
    words, plan = encode.encode_float_group(torch.from_numpy(x), params,
                                            torch.full((b,), n))
    both = plan.valid & jvalid
    np.testing.assert_array_equal(both, [True, True, True, False, True])
    np.testing.assert_array_equal(plan.mins[both], jmins[both])
    np.testing.assert_array_equal(plan.maxd[both], jmaxd[both])
    for i in np.nonzero(both)[0]:
        if plan.bits[i] == bits:  # the kernel packs at its predicted width
            np.testing.assert_array_equal(_block_words(words, plan, i, n),
                                          jw[i])
    assert list(plan.bits[both]) == [18, 11, 9, 18]


def _float_batch(rng, n):
    """Clustered, wrapping, NaN and out-of-range blocks, two columns'
    configs (positions and a linear velocity column)."""
    b = 8
    x = rng.uniform(0, 249.9, (b, n)).astype(np.float32)
    x[1] = rng.uniform(77.0, 77.3, n)
    x[2] = np.where(rng.random(n) < 0.5, rng.uniform(249.5, 249.99, n),
                    rng.uniform(0, 0.5, n))
    x[3, n // 2] = np.nan
    x[4, min(3, n - 1)] = 260.0              # q >= pixels: not in range
    x[5] = rng.uniform(-9000, 9000, n)       # velocity column
    x[6] = rng.uniform(-5, 5, n)
    x[7] = np.float32(12.5)                  # constant: width 0
    low = np.array([0, 0, 0, 0, 0, -10000, -10000, 0], np.float32)
    high = np.array([250] * 5 + [10000, 10000, 250], np.float32)
    dx = np.array([0.001] * 5 + [0.1, 0.1, 0.001])
    pixels = np.array([spec.float_group_pixels(lo, hi, d)
                       for lo, hi, d in zip(low, high, dx)], np.int64)
    periodic = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    return x, low, high, pixels, periodic


@pytest.mark.parametrize("n", [1, 37, 4096 + 77])
def test_block_encoder_float_matches_jax_and_spec(n):
    rng = np.random.default_rng(n)
    x, low, high, pixels, periodic = _float_batch(rng, n)
    lens = np.full(len(x), n, np.int64)
    lens[6] = max(n - 5, 0)
    got = BlockEncoder("cpu").encode_float_blocks(x, low, high, pixels,
                                                  lens=lens,
                                                  periodic=periodic)
    ref = JaxBlockEncoder().encode_float_blocks(x, low, high, pixels,
                                                lens=lens,
                                                periodic=periodic)
    # block 3 (a NaN, width 63): the reference's XLA path writes the host
    # encoder's uint64 deltas into its uint32 delta rows and loses their
    # high halves (ROADMAP C); the port equals spec there, checked below
    agree = [i for i in range(len(x)) if i != 3 or n == 1]
    assert [got.payloads[i] for i in agree] == \
        [ref.payloads[i] for i in agree]
    np.testing.assert_array_equal(got.mins, ref.mins)
    np.testing.assert_array_equal(got.bits, ref.bits)
    for i in range(len(x)):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :lens[i]], low[i], high[i], int(pixels[i]),
            periodic=bool(periodic[i]))
        assert (got.payloads[i], got.mins[i], got.bits[i]) == \
            (payload, mn, bits), i


# interpret mode costs ~1 s a width, so the Pallas kernel is held to the
# port at four widths (one-limb, two-word, three-word, full); the full
# 1..64 sweep runs against spec below
@pytest.mark.parametrize("bits", [1, 18, 41, 64])
def test_delta_pack_int_matches_pallas_kernel(bits):
    rng = np.random.default_rng(41 + bits)
    g = group_tiles(bits)
    n = 32 * g * 8
    hi = (1 << bits) - 1 if bits == 64 else (1 << bits)
    vals = rng.integers(0, hi, (2, n), dtype=np.uint64)
    mins = rng.integers(-1000, 1000, 2).astype(np.int64)
    x = vals.view(np.int64) + mins[:, None]
    lens = np.array([n, n - 37], np.int64)
    ref = np.asarray(pallas_encode.delta_pack_int_pallas(
        x, mins, lens, bits, n, n, interpret=True))
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    plan = encode.plan_int(xt, lt)
    np.testing.assert_array_equal(plan.bits, [bits, bits])
    plan = plan._replace(mins=mins)  # the kernel's mins, not the minima
    words = encode.delta_pack_int(xt, lt, plan).numpy()
    offsets = plan.offsets
    for i in range(2):
        nw = bitpack.words_per_block(bits, int(lens[i]))
        got = bitpack.words_to_bytes(words[offsets[i]:offsets[i] + nw],
                                     bits, int(lens[i]))
        assert got == bitpack.words_to_bytes(ref[i], bits, int(lens[i]))


def test_delta_pack_int_width_sweep_matches_spec():
    rng = np.random.default_rng(43)
    n = 301
    rows, want = [], []
    for bits in range(1, 65):
        # values in [lo, lo + 2**bits): the width is exactly `bits`
        lo = -(1 << (bits - 1))
        d = rng.integers(0, (1 << bits) - 1 if bits == 64 else 1 << bits,
                         n, dtype=np.uint64)
        d[0], d[1] = 0, (1 << bits) - 1
        x = d.view(np.int64) + np.int64(lo)
        rows.append(x)
        want.append(spec.encode_int_block(x))
    words, plan = encode.encode_int_group(torch.from_numpy(np.stack(rows)),
                                          torch.full((64,), n))
    assert list(plan.bits) == list(range(1, 65))
    for i, (payload, mn, bits) in enumerate(want):
        assert plan.mins[i] == mn and plan.bits[i] == bits
        nw = bitpack.words_per_block(bits, n)
        off = plan.offsets[i]
        assert bitpack.words_to_bytes(words.numpy()[off:off + nw],
                                      bits, n) == payload, bits


def test_block_encoder_int_matches_jax():
    """Int blocks, IDs above 2^53 included, with a constant, a short and
    an empty block."""
    rng = np.random.default_rng(45)
    n = 999
    x = rng.integers(0, 1 << 40, (5, n), dtype=np.int64)
    x[0] = (1 << 60) + rng.integers(0, 1 << 20, n)   # IDs above 2^53
    x[0, 5] = (1 << 62) + 12345
    x[1] = rng.integers(-(1 << 62), 1 << 62, n)      # width 63
    x[2] = -7
    lens = np.array([n, n, n, 10, 0], np.int64)
    got = BlockEncoder("cpu").encode_int_blocks(x, lens=lens)
    ref = JaxBlockEncoder().encode_int_blocks(x, lens=lens)
    assert got.payloads == ref.payloads
    np.testing.assert_array_equal(got.mins, ref.mins)
    np.testing.assert_array_equal(got.bits, ref.bits)
    for i in range(5):
        assert (got.payloads[i], got.mins[i], got.bits[i]) == \
            spec.encode_int_block(x[i, :lens[i]]), i


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8))
    params = codec.block_params([0, 0], [1, 1], [10, 10], [True, True],
                                "cpu")
    with pytest.raises(TypeError):
        encode.float_stats(x.double(), params, torch.full((2,), 8))
    with pytest.raises(ValueError):
        encode.float_stats(x.t(), params, torch.full((2,), 2))
    with pytest.raises(TypeError):
        encode.float_stats(x, params, torch.full((2,), 8,
                                                 dtype=torch.int32))
    with pytest.raises(ValueError):
        encode.float_stats(x[:1], params, torch.full((1,), 8))
