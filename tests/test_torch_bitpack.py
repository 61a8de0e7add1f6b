"""minnow_torch.ops.bitpack (plain PyTorch stream packing) against the
normative spec packer and the JAX package's packer, bitwise."""

import numpy as np
import pytest
import torch

from minnow_tpu.core import spec
from minnow_tpu.ops import bitpack as jax_bitpack
from minnow_torch.ops import bitpack

N = 203  # ragged: not a multiple of 32


def _values(rng, b, n):
    """Random uint64 bit patterns, the top bit included."""
    v = rng.integers(0, 2**63, (b, n), dtype=np.uint64)
    return v | (rng.integers(0, 2, (b, n), dtype=np.uint64) << np.uint64(63))


def _mask(bits):
    return np.uint64(~0 & 0xFFFFFFFFFFFFFFFF) if bits >= 64 \
        else np.uint64((1 << bits) - 1)


def _pack(v, bits, lens):
    """Port pack of rows of ``v`` at one width; returns (words, offsets)."""
    widths = np.full(len(v), bits, np.int64)
    offsets, total = bitpack.block_layout(widths, lens)
    words = bitpack.pack(torch.from_numpy(v.view(np.int64)),
                         torch.from_numpy(widths), torch.from_numpy(lens),
                         torch.from_numpy(offsets), total)
    return words.numpy(), offsets


@pytest.mark.parametrize("bits", range(65))
def test_pack_unpack_match_spec(bits):
    rng = np.random.default_rng(100 + bits)
    v = _values(rng, 3, N)
    lens = np.array([N, N - 29, 1], np.int64)
    words, offsets = _pack(v, bits, lens)
    for r in range(3):
        nw = bitpack.words_per_block(bits, int(lens[r]))
        got = bitpack.words_to_bytes(words[offsets[r]:offsets[r] + nw],
                                     bits, int(lens[r]))
        assert got == spec.pack_bits(v[r, :lens[r]], bits), r
    back = bitpack.unpack(torch.from_numpy(words),
                          torch.from_numpy(offsets),
                          torch.full((3,), bits, dtype=torch.int64),
                          N).numpy().view(np.uint64)
    for r in range(3):
        n = int(lens[r])
        want = spec.unpack_bits(spec.pack_bits(v[r, :n], bits), bits, n)
        np.testing.assert_array_equal(back[r, :n], want)
        np.testing.assert_array_equal(back[r, :n], v[r, :n] & _mask(bits))


# the JAX packer compiles once per width (~0.5 s each on the CPU), so it
# is held to the port at widths covering every word-split case: in-word,
# two words, exactly 32, and the three-word widths above 32
@pytest.mark.parametrize("bits", [0, 1, 7, 13, 18, 31, 32, 33, 47, 64])
def test_pack_matches_jax_pack_batch(bits):
    rng = np.random.default_rng(200 + bits)
    v = _values(rng, 2, N)
    lens = np.full(2, N, np.int64)
    words, offsets = _pack(v, bits, lens)
    ref = np.asarray(jax_bitpack.pack_batch(v, bits))
    nw = bitpack.words_per_block(bits, N)
    for r in range(2):
        np.testing.assert_array_equal(
            words[offsets[r]:offsets[r] + nw].view(np.uint32), ref[r, :nw])


def test_mixed_widths_back_to_back():
    """Blocks of different widths share one buffer at their offsets."""
    rng = np.random.default_rng(7)
    widths = np.array([5, 0, 64, 33, 17], np.int64)
    lens = np.array([N, N, 40, N - 3, 0], np.int64)
    v = _values(rng, 5, N)
    offsets, total = bitpack.block_layout(widths, lens)
    words = bitpack.pack(torch.from_numpy(v.view(np.int64)),
                         torch.from_numpy(widths), torch.from_numpy(lens),
                         torch.from_numpy(offsets), total).numpy()
    assert total == sum(bitpack.words_per_block(int(b), int(n))
                        for b, n in zip(widths, lens))
    for r, (b, n) in enumerate(zip(widths, lens)):
        nw = bitpack.words_per_block(int(b), int(n))
        got = bitpack.words_to_bytes(words[offsets[r]:offsets[r] + nw],
                                     int(b), int(n))
        assert got == spec.pack_bits(v[r, :n], int(b)), r


@pytest.mark.parametrize("bits,n", [(1, 1), (7, 33), (18, 1000), (32, 5),
                                    (41, 77), (64, 3)])
def test_byte_helpers_match_jax(bits, n):
    rng = np.random.default_rng(bits * 1000 + n)
    data = spec.pack_bits(_values(rng, 1, n)[0], bits)
    words = bitpack.bytes_to_words(data, bits, n)
    np.testing.assert_array_equal(
        words, jax_bitpack.bytes_to_words(data, bits, n))
    assert bitpack.words_to_bytes(words, bits, n) == \
        jax_bitpack.words_to_bytes(words, bits, n) == data
    # the int32 bit patterns the kernels return give the same bytes
    assert bitpack.words_to_bytes(words.view(np.int32), bits, n) == data
