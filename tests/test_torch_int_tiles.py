"""K3 at the cases its tile pack makes new, on the CPU (its plain versions
``delta_pack_int_plain`` and ``int_stats_plain``, and the encode that runs
on them: ``encode_int_group``, ``delta_pack_int`` by a host plan,
``pack_batch``), against the JAX package, bitwise, tolerance zero:

* blocks of lengths 1, 31, 32, 33, 4,095, 4,096, 4,097, 8,191, 8,193 and
  0 -- whole, ragged and next-to-whole tiles of 4,096 elements -- with
  random words past each length, at n = 8,193 and 8,194;
* widths 1, 31, 32, 33, 54, 63 and 64 (either side of the point where a
  delta needs its high half, and the widest), and every width 1..64;
* a host plan in which a middle block's stream ends past the plan's total.

The references are B3, the Pallas kernel, in interpret mode
(``pallas_encode.delta_pack_int_pallas``; about a second a width, so at
four widths), ``spec.encode_int_block`` and the JAX
``bitpack.delta_pack_batch`` for the whole width sweep.  The batches are
``chip_smoke.k3_tile_batches``, which the card holds the kernel on.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from minnow_tpu.core import spec
from minnow_tpu.ops import bitpack as jax_bitpack
from minnow_tpu.ops import codec as jax_codec
from minnow_tpu.ops import pallas_encode
from minnow_tpu.ops.pallas_codec import group_tiles
from minnow_torch.ops import bitpack, encode

CASES = chip_smoke.k3_tile_batches(np.random.default_rng(21))
LENS = np.array(chip_smoke.TILE_LENS, np.int64)


def _tensors(x, lens):
    return torch.from_numpy(x), torch.from_numpy(lens)


def _rows(words, plan, lens):
    """Each block's words, (B, longest) uint32, zeros past its stream."""
    words = np.asarray(words).view(np.uint32)
    nw = bitpack.words_per_block(plan.bits, lens)
    out = np.zeros((len(lens), int(nw.max(initial=0))), np.uint32)
    for i, (off, k) in enumerate(zip(plan.offsets, nw)):
        out[i, :k] = words[off:off + k]
    return out


def _jax_words(x, mins, lens, bits):
    """``delta_pack_batch``'s rows cut to each block's stream."""
    ref = np.asarray(jax_bitpack.delta_pack_batch(x, mins, lens, bits))
    out = np.zeros_like(ref)
    for i, m in enumerate(lens):
        k = bitpack.words_per_block(bits, int(m))
        out[i, :k] = ref[i, :k]
    return out


def test_cases_are_the_tile_edges():
    for (x, lens), bits in zip(CASES, chip_smoke.TILE_WIDTHS):
        assert x.shape == (len(LENS), 8193 + (bits & 1))
        np.testing.assert_array_equal(lens, LENS)
        plan = encode.plan_int(*_tensors(x, lens))
        assert set(plan.bits[lens > 1].tolist()) == {bits}
        assert plan.bits[lens == 0].tolist() == [0]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_int_stats_plain_matches_jax(case):
    x, lens = CASES[case]
    stats = encode.int_stats_plain(*_tensors(x, lens)).numpy()
    jmn, jmaxd = (np.asarray(a) for a in jax_codec.int_block_stats(x, lens))
    live = lens > 0
    np.testing.assert_array_equal(stats[live, 0], jmn[live])
    np.testing.assert_array_equal(
        (stats[:, 1] - stats[:, 0]).view(np.uint64), jmaxd)
    np.testing.assert_array_equal(stats[~live], 0)
    for i in np.nonzero(live)[0]:
        row = x[i, :lens[i]]
        assert tuple(stats[i]) == (row.min(), row.max()), i


@pytest.mark.parametrize("case", range(len(CASES)))
def test_encode_matches_spec_and_delta_pack_batch(case):
    x, lens = CASES[case]
    bits = chip_smoke.TILE_WIDTHS[case]
    words, plan = encode.encode_int_group(*_tensors(x, lens))
    assert words.numel() == plan.total
    rows = _rows(words.numpy(), plan, lens)
    at = plan.bits == bits  # all but the empty block and the 1-element one
    assert at.sum() == len(lens) - 2
    want = _jax_words(x, plan.mins, lens, bits)[:, :rows.shape[1]]
    np.testing.assert_array_equal(rows[at], want[at])
    for i, m in enumerate(lens):
        payload, mn, w = spec.encode_int_block(x[i, :m])
        assert (plan.mins[i], plan.bits[i]) == (mn, w), i
        assert bitpack.words_to_bytes(rows[i], w, int(m)) == payload, i


# interpret mode costs about a second a width: the Pallas kernel at one
# width under the high half, at 32, at 54 and at 64 (its group sizes 128
# and 64); the width sweep below goes through delta_pack_batch
@pytest.mark.parametrize("bits", [1, 32, 54, 64])
def test_pack_by_a_host_plan_matches_the_pallas_kernel(bits):
    """``delta_pack_int`` by a host plan with the kernel's own minimums
    (one below each block's) against B3 on the same rows."""
    x, lens = CASES[chip_smoke.TILE_WIDTHS.index(bits)]
    n = x.shape[1]
    g = group_tiles(bits)
    align = 32 * g * 8
    n_pad = -(-n // align) * align
    xt, lt = _tensors(x, lens)
    plan = encode.plan_int(xt, lt)
    mins = np.where(bits < 64, plan.mins - 1, plan.mins)
    plan = plan._replace(mins=mins)
    ref = np.asarray(pallas_encode.delta_pack_int_pallas(
        x, mins, lens, bits, n, n_pad, interpret=True))
    rows = _rows(encode.delta_pack_int(xt, lt, plan).numpy(), plan, lens)
    for i, m in enumerate(lens):
        k = bitpack.words_per_block(int(plan.bits[i]), int(m))
        np.testing.assert_array_equal(rows[i, :k], ref[i, :k], err_msg=i)


def _sweep_batch(bits):
    """Blocks of ``LENS`` at n = 8,194 whose live elements span ``bits``
    bits, random words past them (the same draw for every width)."""
    rng = np.random.default_rng(64 + bits)
    x, lens = chip_smoke._k3_ragged(rng, bits, 8194, LENS)
    return x, lens


@pytest.mark.parametrize("bits", range(1, 65))
def test_width_sweep_matches_delta_pack_batch(bits):
    """Every width: the encode and ``delta_pack_int`` by its host plan
    against ``delta_pack_batch``; at widths 1..32 also ``pack_batch`` of
    the rows' low words against it with zero minimums."""
    x, lens = _sweep_batch(bits)
    xt, lt = _tensors(x, lens)
    words, plan = encode.encode_int_group(xt, lt)
    assert set(plan.bits[lens > 1].tolist()) == {bits}
    assert torch.equal(encode.delta_pack_int(xt, lt, plan), words)
    rows = _rows(words.numpy(), plan, lens)
    at = plan.bits == bits
    want = _jax_words(x, plan.mins, lens, bits)[:, :rows.shape[1]]
    np.testing.assert_array_equal(rows[at], want[at])
    if bits <= 32:
        low = x & 0xFFFFFFFF
        got = encode.pack_batch(torch.from_numpy(low), bits).numpy()
        full = np.full(len(lens), x.shape[1], np.int64)
        ref = np.asarray(jax_bitpack.delta_pack_batch(
            low, np.zeros(len(lens), np.int64), full, bits))
        np.testing.assert_array_equal(got.view(np.uint32), ref)


def test_host_plan_with_a_middle_block_past_its_total_raises():
    """A host plan whose total leaves a middle block's stream outside the
    buffer: refused, on the CPU as on the card, before anything is
    packed; the same plan with its total restored packs."""
    x, lens = CASES[3]
    xt, lt = _tensors(x, lens)
    plan = encode.plan_int(xt, lt)
    nw = bitpack.words_per_block(plan.bits, lens)
    # block 4 goes last in the buffer, and the total is cut by one word
    order = [0, 1, 2, 3, 5, 6, 7, 8, 9, 4]
    offsets = np.zeros(len(lens), np.int64)
    offsets[order] = np.cumsum(np.r_[0, nw[order][:-1]])
    moved = plan._replace(offsets=offsets)
    words = encode.delta_pack_int(xt, lt, moved).numpy()
    np.testing.assert_array_equal(_rows(words, moved, lens),
                                  _rows(encode.delta_pack_int(
                                      xt, lt, plan).numpy(), plan, lens))
    with pytest.raises(ValueError, match="block 4's stream ends at word"):
        encode.delta_pack_int(xt, lt, moved._replace(total=plan.total - 1))
    with pytest.raises(ValueError, match="widths in"):
        encode.delta_pack_int(xt, lt, plan._replace(bits=plan.bits + 32))
