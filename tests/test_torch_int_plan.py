"""The int encode's stats, plan and pack on the CPU (the plain versions of
K3's three launches), bitwise, tolerance zero:

* ``int_stats_plain`` (what K3's stats launch is held to) against the JAX
  package's ``codec.int_block_stats``;
* ``int_plan_plain`` (what K3's plan launch is held to) against the host
  plan's arithmetic (``encode._plan``, as ``plan_float`` plans) and
  against ``spec.encode_int_block``;
* ``start_int_group`` / ``finish_int_group`` and
  ``BlockEncoder.encode_int_blocks`` on 1, 2 and 3 CPU shares against the
  JAX ``BlockEncoder.encode_int_blocks``;

on every width 0..64, lengths 0, 1, 31, 32, 33, 2049 and 4097, ragged
batches, -2^63 beside 2^63 - 1 in one block and padding that holds
random words.  The batches are those ``chip_smoke.py`` gives K3 on the
card, and one of every width with ragged lengths.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from minnow_tpu.core import spec
from minnow_tpu.ops import codec as jax_codec
from minnow_tpu.parallel.pipeline import BlockEncoder as JaxBlockEncoder
from minnow_torch.ops import bitpack, encode
from minnow_torch.parallel.pipeline import BlockEncoder

def _every_width(rng, n=301):
    """Blocks whose live elements span exactly 0..64 bits, at lengths
    that cycle through 0..n with an empty block among them; random words
    past each length."""
    b = 65
    x = rng.integers(-(1 << 63), (1 << 63) - 1, (b, n), dtype=np.int64,
                     endpoint=True)
    lens = np.array([n, n - 1, 2, 33, 0, 7] * 11, np.int64)[:b]
    lens[[0, 1, 62, 63, 64]] = n
    for bits in range(b):
        m = int(lens[bits])
        lo = -(1 << 63) if bits == 64 else int(rng.integers(-(1 << 62),
                                                            1 << 62))
        d = rng.integers(0, (1 << 64) - 1 if bits == 64 else 1 << bits, m,
                         dtype=np.uint64) if bits else np.zeros(m, np.uint64)
        if bits and m >= 2:
            d[:2] = (0, (1 << bits) - 1)
        x[bits, :m] = d.view(np.int64) + np.int64(lo)
    return x, lens


def _cases():
    rng = np.random.default_rng(8)
    return [_every_width(rng)] + chip_smoke.k3_batches(rng)


CASES = _cases()


@pytest.fixture(scope="module")
def jax_every_width():
    """The JAX encoder's blocks of ``CASES[0]`` (one compile a width)."""
    x, lens = CASES[0]
    return JaxBlockEncoder().encode_int_blocks(x, lens=lens)


def _tensors(case):
    x, lens = case
    return torch.from_numpy(x), torch.from_numpy(lens)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_int_stats_plain_matches_jax(case):
    x, lens = CASES[case]
    stats = encode.int_stats_plain(*_tensors(CASES[case]))
    assert stats.dtype == torch.int64 and stats.shape == (len(x), 2)
    stats = stats.numpy()
    jmn, jmaxd = (np.asarray(a) for a in jax_codec.int_block_stats(x, lens))
    live = lens > 0
    np.testing.assert_array_equal(stats[live, 0], jmn[live])
    np.testing.assert_array_equal(
        (stats[:, 1] - stats[:, 0]).view(np.uint64), jmaxd)
    np.testing.assert_array_equal(stats[~live], 0)
    for i in np.nonzero(live)[0]:
        row = x[i, :lens[i]]
        assert tuple(stats[i]) == (row.min(), row.max()), i
    # what the public entry runs on the CPU
    assert np.array_equal(encode.int_stats(*_tensors(CASES[case])).numpy(),
                          stats)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_int_plan_plain_matches_host_plan_and_spec(case):
    x, lens = CASES[case]
    xt, lt = _tensors(CASES[case])
    b = len(x)
    stats = encode.int_stats_plain(xt, lt)
    dplan = encode.int_plan_plain(stats, lt)
    assert dplan.dtype == torch.int64 and dplan.shape == (6 * b + 2,)
    assert torch.equal(encode.int_plan(stats, lt), dplan)
    got = encode.read_plan(dplan)
    mn, mx = stats.numpy().T
    live = lens > 0
    want = encode._plan(np.where(live, mn, 0),
                        np.where(live, mx - mn, 0), np.ones(b, bool),
                        np.zeros(b, np.int64), lens)
    assert chip_smoke.plan_eq(got, want)
    assert torch.equal(encode._device_plan(want, "cpu"), dplan)
    assert chip_smoke.plan_eq(encode.plan_int(xt, lt), want)

    words, plan = encode.encode_int_group(xt, lt)
    assert chip_smoke.plan_eq(plan, want) and words.numel() == plan.total
    words = words.numpy()
    for i in range(b):
        m = int(lens[i])
        payload, want_mn, want_bits = spec.encode_int_block(x[i, :m])
        assert (plan.mins[i], plan.bits[i]) == (want_mn, want_bits), i
        assert plan.maxd[i] == 0 or spec.precision_needed(
            int(plan.maxd[i]) % (1 << 64)) == want_bits, i
        nw = bitpack.words_per_block(want_bits, m)
        off = int(plan.offsets[i])
        assert bitpack.words_to_bytes(words[off:off + nw], want_bits,
                                      m) == payload, i


def test_every_width_and_the_extremes_come_up():
    widths = set()
    for x, lens in CASES:
        widths.update(encode.plan_int(*_tensors((x, lens))).bits.tolist())
    assert widths == set(range(65))
    plan = encode.plan_int(*_tensors(CASES[-1]))
    assert plan.bits.tolist() == [64, 0]
    assert plan.mins.tolist() == [-(1 << 63), 42]
    assert plan.maxd[0] == -1  # the uint64 bit pattern 2^64 - 1


@pytest.mark.parametrize("shares", [1, 2, 3])
def test_block_encoder_matches_jax(shares, jax_every_width):
    x, lens = CASES[0]
    got = BlockEncoder(["cpu"] * shares).encode_int_blocks(x, lens=lens)
    ref = jax_every_width
    assert got.payloads == ref.payloads
    np.testing.assert_array_equal(got.mins, ref.mins)
    np.testing.assert_array_equal(got.bits, ref.bits)
    np.testing.assert_array_equal(got.lens, lens)


@pytest.mark.parametrize("case", range(1, len(CASES)))
def test_start_and_finish_match_the_call(case):
    xt, lt = _tensors(CASES[case])
    pending = encode.start_int_group(xt, lt)
    words, plan = encode.finish_int_group(pending)
    want_words, want_plan = encode.encode_int_group(xt, lt)
    assert torch.equal(words, want_words)
    assert chip_smoke.plan_eq(plan, want_plan)
    assert torch.equal(words, encode.delta_pack_int_plain(xt, lt, plan))


def test_block_encoder_starts_every_share_before_it_finishes_one(
        monkeypatch):
    calls = []
    for name in ("start_int_group", "finish_int_group"):
        real = getattr(encode, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(encode, name, spy)
    x, lens = CASES[0]
    got = BlockEncoder(["cpu"] * 3).encode_int_blocks(x, lens=lens)
    assert calls == ["start_int_group"] * 3 + ["finish_int_group"] * 3
    for i, m in enumerate(lens):
        assert (got.payloads[i], got.mins[i], got.bits[i]) == \
            spec.encode_int_block(x[i, :m]), i


def test_int_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8), dtype=torch.int64)
    lens = torch.full((2,), 8)
    with pytest.raises(TypeError):
        encode.int_stats(x.to(torch.int32), lens)
    with pytest.raises(ValueError):
        encode.int_stats(x, lens[:1])
    with pytest.raises(ValueError):
        encode.start_int_group(x.t(), lens)
    with pytest.raises(TypeError):
        encode.int_plan(torch.zeros((2, 2), dtype=torch.int32), lens)
    with pytest.raises(ValueError):
        encode.int_plan(torch.zeros((2, 3), dtype=torch.int64), lens)
