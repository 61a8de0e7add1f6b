"""The float encode's plan on the device and the tile pack's cases, on the
CPU (the plain versions of K1's plan and pack launches and of K5):

* ``float_plan_plain`` (what ``encode_float_group`` runs on the CPU, and
  what K1's plan launch is held to on the card) against the host's
  ``plan_float``, against ``spec.encode_float_block`` and, through both
  ``BlockEncoder``s, against the JAX package's plan
  (``pallas_encode.py:591-617``), bitwise;
* at every width 1..32, at the lengths around the pack's word and tile
  edges (1, 31, 32, 33, 2049, 4096, 4097, 2^17 - 1), on ragged batches,
  periodic and non-periodic blocks and a block that is not certified
  beside valid ones;
* the capacity ``BlockEncoder`` gives the word buffer before the plan is
  known bounds the plan's total.

The batches are those ``chip_smoke.py`` gives the kernels on the card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from minnow_tpu.core import spec
from minnow_tpu.parallel.pipeline import BlockEncoder as JaxBlockEncoder
from minnow_torch.ops import bitpack, codec, encode
from minnow_torch.parallel import pipeline
from minnow_torch.parallel.pipeline import BlockEncoder

EDGE_LENS = [1, 31, 32, 33, 2049, 4096, 4097, 0]


def _tensors(batch):
    x, low, high, pixels, periodic, lens = batch
    params = codec.block_params(low, high, pixels, periodic, "cpu")
    return torch.from_numpy(x), params, torch.from_numpy(lens)


def _check_batch(batch, widths=None):
    """Every route to a plan and to the words agrees, and equals spec."""
    x, low, high, pixels, periodic, lens = batch
    xt, params, lt = _tensors(batch)
    stats = encode.float_stats(xt, params, lt)
    want = encode.plan_float(stats, params, lt)
    dplan = encode.float_plan(stats, params, lt)
    assert dplan.dtype == torch.int64
    assert dplan.shape == (6 * len(x) + 2,)
    got = encode.read_plan(dplan)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got.valid.dtype == bool and isinstance(got.total, int)
    assert torch.equal(encode._device_plan(want, "cpu"), dplan)

    q = torch.zeros(x.shape, dtype=torch.int32)
    encode.float_stats(xt, params, lt, q_out=q)
    words = encode.pack_float(xt, params, lt, want)
    assert torch.equal(encode.pack_float_q(q, params, lt, want), words)
    for reuse_q in (False, True):
        w, p = encode.encode_float_group(xt, params, lt, reuse_q=reuse_q,
                                         capacity=want.total)
        assert torch.equal(w, words)
        for a, b in zip(p, want):
            np.testing.assert_array_equal(a, b)
    assert want.total <= pipeline._float_capacity(pixels, periodic, lens)

    for i in np.nonzero(want.valid)[0]:
        n = int(lens[i])
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :n], low[i], high[i], int(pixels[i]),
            periodic=bool(periodic[i]))
        assert (want.mins[i], want.bits[i]) == (mn, bits), i
        nw = bitpack.words_per_block(bits, n)
        off = int(want.offsets[i])
        assert bitpack.words_to_bytes(words.numpy()[off:off + nw], bits,
                                      n) == payload, i
    if widths is not None:
        widths.update(int(b) for b in want.bits[want.valid])
    return want


@pytest.mark.parametrize("k", range(1, 32))
def test_plan_and_pack_at_width(k):
    rng = np.random.default_rng(k)
    widths = set()
    plan = _check_batch(chip_smoke.k1_batch(rng, k, 301), widths)
    assert k in widths
    # blocks 4 (a NaN) and 5 (a pixel beyond the range) are not certified
    # (nor is block 2 at the narrow widths, whose float32 values near the
    # edge round to the edge itself)
    np.testing.assert_array_equal(
        plan.valid[[0, 1, 3, 4, 5, 6, 7]],
        [True, True, True, False, False, True, True])
    assert plan.bits[4] == plan.bits[5] == 0


def test_plan_and_pack_at_32_bits_and_positions():
    rng = np.random.default_rng(32)
    widths = set()
    _check_batch(chip_smoke.wide_batch(rng, 301), widths)
    assert widths == {32}
    _check_batch(chip_smoke.k1_position_batch(rng, 301))


@pytest.mark.parametrize("k", [1, 7, 18, 30])
def test_plan_and_pack_on_ragged_edges(k):
    rng = np.random.default_rng(100 + k)
    lens = np.array(EDGE_LENS, np.int64)
    batch = chip_smoke.k1_batch(rng, k, 4097)[:5] + (lens,)
    plan = _check_batch(batch)
    assert plan.valid[7] and plan.bits[7] == 0 and plan.mins[7] == 0


def test_plan_and_pack_at_the_longest_block():
    rng = np.random.default_rng(17)
    for batch in chip_smoke.edge_batches(rng)[2:3]:
        plan = _check_batch(batch)
        assert not plan.valid[4] and plan.valid[0]
        assert batch[5][0] == (1 << 17) - 1


@pytest.mark.parametrize("k", [1, 5, 12, 18, 25, 31])
def test_block_encoder_plan_matches_jax_encoder(k):
    """mins, widths and payloads through the two BlockEncoders; the
    blocks the device does not certify are the host's in both."""
    rng = np.random.default_rng(200 + k)
    x, low, high, pixels, periodic, lens = chip_smoke.k1_batch(rng, k, 257)
    # one call for each kind: a BlockEncoder batch is one column
    for per in (True, False):
        rows = np.nonzero((periodic == per) & (np.arange(8) != 4)
                          & (np.arange(8) != 5))[0]
        kw = dict(lens=lens[rows], periodic=per)
        got = BlockEncoder("cpu").encode_float_blocks(
            x[rows], 0.0, float(1 << 30), 1 << 30, **kw)
        ref = JaxBlockEncoder().encode_float_blocks(
            x[rows], 0.0, float(1 << 30), 1 << 30, **kw)
        np.testing.assert_array_equal(got.mins, ref.mins)
        np.testing.assert_array_equal(got.bits, ref.bits)
        assert got.payloads == ref.payloads
        assert per or k in set(got.bits)


def test_no_blocks():
    x = torch.zeros((0, 16))
    params = codec.block_params([], [], [], [], "cpu")
    lens = torch.zeros(0, dtype=torch.int64)
    words, plan = encode.encode_float_group(x, params, lens)
    assert words.numel() == plan.total == plan.max_words == 0
    assert plan.bits.shape == (0,)


def test_capacity_bounds():
    rng = np.random.default_rng(5)
    for k in (3, 18, 30):
        x, low, high, pixels, periodic, lens = chip_smoke.k1_batch(rng, k, 99)
        cap = pipeline._float_capacity(pixels, periodic, lens)
        # periodic blocks at 30 bits (2^30 pixels), the others at 32
        want = sum(bitpack.words_per_block(30 if p else 32, int(n))
                   for p, n in zip(periodic, lens))
        assert cap == want
    assert pipeline._float_capacity(np.array([1, 2, 250000, 1 << 31]),
                                    np.ones(4, bool),
                                    np.full(4, 32)) == 0 + 1 + 18 + 31
