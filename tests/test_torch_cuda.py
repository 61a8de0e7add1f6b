"""The port's CUDA kernels on the card: each against its plain version,
and the converters and readers against the port's host mode, bitwise.

These tests need a CUDA device and skip without one.  The machine with
the card has no jax, and tests/conftest.py imports it, so run them there
from the repository root without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The last tests start two worker processes on the one card (gloo between
them), each with a time limit.
"""

import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
from minnow_torch.cli import convert_snapshot, minh_to_bnd, text_to_minh
from minnow_torch.core import spec
from minnow_torch.formats import device_common, minh, minh_device, minp
from minnow_torch.formats import minp_device
from minnow_torch.ingest import snapshot
from minnow_torch.ops import bitpack, cells, codec, decode, encode
from minnow_torch.ops import rebin
from minnow_torch.ops import selfcheck, validate
from minnow_torch.parallel.pipeline import BlockEncoder
from minnow_torch.tools import (dryrun, kernel_fuzz_soak,
                                multiprocess_gather_check)
from minnow_torch.utils import profiling
from test_torch_cells import halos
from test_torch_minh_to_bnd import BND, CELLS, write_catalog

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    assert a.shape == b.shape
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _float_batch(rng, n):
    """Position-config blocks: uniform, cluster, edge wrap, NaN, a pixel
    beyond the range, a short block and a non-periodic velocity block."""
    x = rng.uniform(0, 249.9, (7, n)).astype(np.float32)
    x[1] = rng.uniform(120, 120.3, n)
    x[2] = np.where(rng.random(n) < 0.5, rng.uniform(249.6, 249.99, n),
                    rng.uniform(0, 0.3, n))
    x[3, n // 2] = np.nan
    x[4, min(1, n - 1)] = 255.0
    x[6] = rng.uniform(-9000, 9000, n)
    low = np.array([0.0] * 6 + [-1e4], np.float32)
    high = np.array([250.0] * 6 + [1e4], np.float32)
    pixels = np.array([250000] * 6 + [200000], np.int64)
    periodic = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    lens = np.array([n] * 5 + [n // 2, n], np.int64)
    return x, low, high, pixels, periodic, lens


@pytest.mark.parametrize("n", [1, 999, 70001])
def test_k1_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    x, low, high, pixels, periodic, lens = _float_batch(rng, n)
    params = codec.block_params(low, high, pixels, periodic, dev)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    before = encode.K1_LAUNCHES
    stats = encode.float_stats(xt, params, lt)
    _same(stats, encode.float_stats_plain(xt, params, lt))
    plan = encode.plan_float(stats, params, lt)
    _same(encode.pack_float(xt, params, lt, plan),
          encode.pack_float_plain(xt, params, lt, plan))
    assert encode.K1_LAUNCHES == before + (2 if plan.total else 1)


def _check_float_encode(dev, batch):
    """K1's three launches, K5 and the whole call on one batch, against
    the plain versions and the host's plan."""
    x, low, high, pixels, periodic, lens = batch
    params = codec.block_params(low, high, pixels, periodic, dev)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    q = torch.zeros(x.shape, dtype=torch.int32, device=dev)
    stats = encode.float_stats(xt, params, lt, q_out=q)
    _same(stats, encode.float_stats_plain(xt, params, lt))
    plan = encode.plan_float(stats, params, lt)
    before = encode.K1_LAUNCHES
    dplan = encode.float_plan(stats, params, lt)
    assert encode.K1_LAUNCHES == before + 1
    assert torch.equal(dplan, encode.float_plan_plain(stats, params, lt))
    assert chip_smoke.plan_eq(encode.read_plan(dplan), plan)
    words = encode.pack_float(xt, params, lt, plan)
    _same(words, encode.pack_float_plain(xt, params, lt, plan))
    _same(encode.pack_float_q(q, params, lt, plan), words)
    for reuse_q in (False, True):
        before = encode.K1_LAUNCHES, encode.K5_LAUNCHES
        w, p = encode.encode_float_group(xt, params, lt, reuse_q=reuse_q,
                                         capacity=plan.total)
        packed = 1 if plan.total else 0
        assert (encode.K1_LAUNCHES, encode.K5_LAUNCHES) == (
            before[0] + 2 + (0 if reuse_q else packed),
            before[1] + (packed if reuse_q else 0))
        _same(w, words)
        assert chip_smoke.plan_eq(p, plan)
    return plan


@pytest.mark.parametrize("k", range(1, 33))
def test_float_encode_at_every_width(dev, k):
    rng = np.random.default_rng(k)
    batch = chip_smoke.wide_batch(rng, 3001) if k == 32 \
        else chip_smoke.k1_batch(rng, k, 3001)
    plan = _check_float_encode(dev, batch)
    assert k in set(plan.bits[plan.valid])


@pytest.mark.parametrize("k", [1, 7, 18, 30])
def test_float_encode_on_ragged_edges(dev, k):
    """Lengths around the pack's word and tile edges, up to 2^17 - 1, with
    a block that is not certified beside valid ones."""
    rng = np.random.default_rng(50 + k)
    lens = np.array([1, 31, 32, 33, 4095, 4096, 4097, 0], np.int64)
    _check_float_encode(dev, chip_smoke.k1_batch(rng, k, 4097)[:5] + (lens,))
    for batch in chip_smoke.edge_batches(rng):
        plan = _check_float_encode(dev, batch)
        assert not plan.valid[4] and plan.valid[0]


def test_float_encode_of_no_blocks(dev):
    x = torch.zeros((0, 16), device=dev)
    params = codec.block_params([], [], [], [], dev)
    lens = torch.zeros(0, dtype=torch.int64, device=dev)
    for reuse_q in (False, True):
        words, plan = encode.encode_float_group(x, params, lens,
                                                reuse_q=reuse_q)
        assert words.numel() == plan.total == plan.max_words == 0
        assert plan.bits.shape == (0,)
    torch.cuda.synchronize()


def test_float_encode_refuses_a_capacity_too_small(dev):
    rng = np.random.default_rng(2)
    x, low, high, pixels, periodic, lens = _float_batch(rng, 5000)
    params = codec.block_params(low, high, pixels, periodic, dev)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    words, plan = encode.encode_float_group(xt, params, lt)
    assert words.numel() == plan.total
    with pytest.raises(ValueError, match="capacity"):
        encode.encode_float_group(xt, params, lt, capacity=plan.total - 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [4097, 70001])
def test_wide_pixel_counts_match_plain_and_spec(dev, n):
    """K1, K5 and K2 at pixel counts of 2^31 and more (periodic with a
    window over the seam, non-periodic, 10^10 with pixels inside and
    beyond int32): the plain versions, ``spec`` and the host reader, at
    lengths other than ``chip_smoke.py``'s own sweep (200 and 2^17)."""
    before = encode.K1_LAUNCHES, encode.K5_LAUNCHES, decode.K2_LAUNCHES
    sent = chip_smoke.check_wide_batch(dev, np.random.default_rng(n), 12, n)
    assert sent == 2
    assert encode.K1_LAUNCHES > before[0] and encode.K5_LAUNCHES > before[1]
    assert decode.K2_LAUNCHES > before[2]


@pytest.mark.parametrize("n", [4097])
def test_pixel_counts_at_the_top_of_the_range(dev, n):
    """K1, K5 and K2 at 2^62 + 3 and 2^63 - 1 pixels, where the end of a
    periodic window passes 2^63: the plain versions, ``spec`` and the host
    reader; every block certified."""
    rng = np.random.default_rng(n)
    sent = chip_smoke.check_wide_batch(
        dev, rng, 12, n, chip_smoke.top_of_range_blocks(rng, 12, n))
    assert sent == 0


def test_wide_pixel_counts_in_selfcheck_and_validate(dev):
    selfcheck._check_encode_wide(dev)
    selfcheck._check_decode_wide(dev, tuple(codec.DITHER_MODES), seed=3)
    validate._validate_wide_pixels(np.random.default_rng(4), dev, 2051)
    torch.cuda.synchronize()


def test_wide_column_through_the_converter_on_card(dev, tmp_path):
    """A catalog with 10^10-pixel columns: the --device file, the reads
    on the card and inspect_minh --device against host mode."""
    launches = chip_smoke.wide_column_path(dev, str(tmp_path / "wide"), 3000)
    assert launches["K1"] >= 3 and launches["K2"] >= 6


@pytest.mark.parametrize("shares", [3])
def test_dry_runs_on_the_card(dev, shares):
    """Three shares on the one card (``chip_smoke.py`` drives one and
    two)."""
    before = encode.K1_LAUNCHES, decode.K2_LAUNCHES
    out = dryrun.dryrun([dev] * shares)
    assert list(out) == list(dryrun.STEPS)
    assert encode.K1_LAUNCHES > before[0] and decode.K2_LAUNCHES > before[1]


@pytest.mark.parametrize("mode", list(codec.DITHER_MODES))
def test_k2_matches_plain_at_every_width(dev, mode):
    rng = np.random.default_rng(3)
    b, n = 3, 1234
    k1, k2 = codec.dither_keys(np.array([1, 8, 1 << 40]), 11, dev)
    for bits in range(65):
        w = max((bits * n + 31) // 32, 1)
        words = torch.from_numpy(rng.integers(
            0, 1 << 32, (b, w), dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).to(dev)
        mins = torch.from_numpy(rng.integers(-1 << 30, 1 << 30, b)).to(dev)
        params = codec.block_params(rng.uniform(-5, 0, b),
                                    rng.uniform(10, 50, b),
                                    rng.integers(1, 1 << 34, b),
                                    np.array([1, 0, 1], bool), dev)
        _same(decode.decode_float_group(words, mins, params, bits, n, mode,
                                        k1, k2),
              decode.decode_float_plain(words, mins, params, bits, n, mode,
                                        k1, k2))


@pytest.mark.parametrize("n", [1, 999, 70001])
def test_k5_matches_plain_and_k1(dev, n):
    """The stats launch's pixels and K5's words against their plain
    versions, and K5's words against K1's pack for the same plan."""
    rng = np.random.default_rng(n + 1)
    x, low, high, pixels, periodic, lens = _float_batch(rng, n)
    params = codec.block_params(low, high, pixels, periodic, dev)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    q = torch.zeros(x.shape, dtype=torch.int32, device=dev)
    q_plain = q.clone()
    stats = encode.float_stats(xt, params, lt, q_out=q)
    _same(stats, encode.float_stats(xt, params, lt))
    _same(stats, encode.float_stats_plain(xt, params, lt, q_out=q_plain))
    _same(q, q_plain)
    plan = encode.plan_float(stats, params, lt)
    before = encode.K5_LAUNCHES
    words = encode.pack_float_q(q, params, lt, plan)
    assert encode.K5_LAUNCHES == before + (1 if plan.total else 0)
    _same(words, encode.pack_float_q_plain(q, params, lt, plan))
    _same(words, encode.pack_float(xt, params, lt, plan))


def test_pack_batch_matches_plain_and_spec(dev):
    rng = np.random.default_rng(12)
    b, n = 3, 777
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.int64)
    before = encode.K3_LAUNCHES
    for bits in range(1, 33):
        got = encode.pack_batch(torch.from_numpy(x).to(dev), bits).cpu()
        _same(got, encode.pack_batch(torch.from_numpy(x), bits))
        for i in range(b):
            assert bitpack.words_to_bytes(got[i].numpy(), bits, n) == \
                spec.pack_bits(x[i].astype(np.uint64)
                               & np.uint64((1 << bits) - 1), bits), bits
    assert encode.K3_LAUNCHES == before + 32


def _k3_launches():
    return (encode.K3_STATS_LAUNCHES, encode.K3_PLAN_LAUNCHES,
            encode.K3_LAUNCHES)


def test_k3_matches_plain_and_spec(dev):
    rng = np.random.default_rng(5)
    n = 777
    rows = []
    for bits in range(1, 65):
        lo = (1 << 53) + 99 if bits < 62 else -(1 << (bits - 1))
        d = rng.integers(0, (1 << 64) - 1 if bits == 64 else 1 << bits, n,
                         dtype=np.uint64)
        d[0], d[1] = 0, (1 << bits) - 1
        rows.append(d.view(np.int64) + np.int64(lo))
    x = np.stack(rows)
    xt = torch.from_numpy(x).to(dev)
    lt = torch.full((64,), n, dtype=torch.int64, device=dev)
    before = _k3_launches()
    words, plan = encode.encode_int_group(xt, lt)
    # three launches, and the host reads the plan once, after them
    assert _k3_launches() == tuple(k + 1 for k in before)
    _same(words, encode.delta_pack_int_plain(xt, lt, plan))
    assert list(plan.bits) == list(range(1, 65))
    enc = BlockEncoder(dev).encode_int_blocks(x)
    for i in range(64):
        assert (enc.payloads[i], enc.mins[i], enc.bits[i]) == \
            spec.encode_int_block(x[i])


@pytest.mark.parametrize(
    "case", range(len(chip_smoke.k3_batches(np.random.default_rng(9)))))
def test_k3_launches_match_plain(dev, case):
    """The stats, plan and pack launches and the whole call against their
    plain versions on ``chip_smoke.py``'s batches: widths 1..64, then 1,
    18, 37, 54 and 64 bits on lengths 0, 1, 31, 32, 33, 2049 and 4097
    with garbage past each length, then the tile cases (1, 31, 32, 33, 54,
    63 and 64 bits on lengths 1 to 8193 at n = 8193 and 8194), then -2^63
    beside 2^63 - 1; and ``BlockEncoder`` on the card against ``spec``."""
    x, lens = chip_smoke.k3_batches(np.random.default_rng(9))[case]
    chip_smoke.hold_k3(torch.from_numpy(x).to(dev),
                       torch.from_numpy(lens).to(dev), "case %d" % case)
    enc = BlockEncoder(dev).encode_int_blocks(x, lens=lens)
    for i, m in enumerate(lens):
        assert (enc.payloads[i], enc.mins[i], enc.bits[i]) == \
            spec.encode_int_block(x[i, :m]), i


@pytest.mark.parametrize("shape", [(0, 16), (3, 0), (0, 0)])
def test_int_encode_of_no_elements_launches_nothing(dev, shape):
    x = torch.zeros(shape, dtype=torch.int64, device=dev)
    lens = torch.zeros(shape[0], dtype=torch.int64, device=dev)
    before = _k3_launches()
    words, plan = encode.encode_int_group(x, lens)
    assert _k3_launches() == before
    assert words.numel() == plan.total == plan.max_words == 0
    assert plan.bits.shape == (shape[0],) and plan.valid.all()
    assert (plan.bits == 0).all() and (plan.mins == 0).all()
    torch.cuda.synchronize()


def test_int_encode_refuses_a_capacity_too_small(dev):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 1 << 40, (5, 3000))).to(dev)
    lens = torch.tensor([3000, 0, 1, 2999, 77], device=dev)
    words, plan = encode.encode_int_group(x, lens, capacity=2 * 15000)
    assert words.numel() == plan.total
    _same(encode.encode_int_group(x, lens, capacity=plan.total)[0], words)
    with pytest.raises(ValueError, match="capacity"):
        encode.encode_int_group(x, lens, capacity=plan.total - 1)
    torch.cuda.synchronize()


def _unaligned(x, dev):
    """``x`` on the card as a contiguous view that starts 8 bytes past a
    16-byte boundary, as a slice of a wider buffer does."""
    flat = torch.empty(x.size + 1, dtype=torch.int64, device=dev)[1:]
    assert flat.data_ptr() % 16 == 8
    flat.copy_(torch.from_numpy(x.reshape(-1)))
    return flat.view(x.shape)


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("bits", chip_smoke.TILE_WIDTHS)
def test_tile_pack_matches_plain_on_tile_edges(dev, bits, layout):
    """K3's tile pack on blocks of lengths 1..8193 (whole, ragged and
    next-to-whole tiles) with garbage past them, at n = 8193 and 8194,
    on rows as allocated and on a view 8 bytes off a 16-byte boundary:
    the whole call, and the pack by a host plan whose minimums are not
    the blocks' own, bitwise equal to the plain versions."""
    lens = np.array(chip_smoke.TILE_LENS, np.int64)
    rng = np.random.default_rng(bits)
    for n in (8193, 8194):
        x, _ = chip_smoke._k3_ragged(rng, bits, n, lens)
        xt = (torch.from_numpy(x).to(dev) if layout == "aligned"
              else _unaligned(x, dev))
        lt = torch.from_numpy(lens).to(dev)
        words, plan = chip_smoke.hold_k3(xt, lt, "%d bits, n %d" % (bits, n))
        assert set(plan.bits[lens > 1]) == {bits}
        # a host plan whose minimums lie one below the blocks' own: the
        # largest delta then needs a bit more than the plan gives it
        host = plan._replace(mins=plan.mins - 1)
        _same(encode.delta_pack_int(xt, lt, host),
              encode.delta_pack_int_plain(xt, lt, host))


@pytest.mark.parametrize("n", [1, 7, 8193, 8194, 40001])
def test_int_stats_on_odd_rows_and_empty_blocks(dev, n):
    """K3's stats launch on odd and even n, aligned and 8 bytes off, with
    empty blocks among live ones and random words in every padding; a
    row of 40,001 spreads over five runs."""
    rng = np.random.default_rng(n)
    b = 9
    x = rng.integers(-(1 << 63), (1 << 63) - 1, (b, n), dtype=np.int64,
                     endpoint=True)
    lens = rng.integers(0, n + 1, b).astype(np.int64)
    lens[[0, 4]] = 0
    lens[1] = n
    for xt in (torch.from_numpy(x).to(dev), _unaligned(x, dev)):
        lt = torch.from_numpy(lens).to(dev)
        stats = encode.int_stats(xt, lt)
        _same(stats.view(torch.int32), encode.int_stats_plain(
            xt, lt).view(torch.int32))
        assert (stats.cpu()[[0, 4]] == 0).all()


def test_pack_batch_on_unaligned_rows(dev):
    """``pack_batch`` at widths 1..32 on even rows 8 bytes off a 16-byte
    boundary, against the plain version on the same values."""
    rng = np.random.default_rng(13)
    x = rng.integers(0, 1 << 32, (3, 4098), dtype=np.int64)
    xt = _unaligned(x, dev)
    for bits in range(1, 33):
        _same(encode.pack_batch(xt, bits).cpu(),
              encode.pack_batch(torch.from_numpy(x), bits))


def test_host_plan_past_its_total_raises(dev):
    """A host plan in which a middle block's stream ends past the plan's
    total is refused before anything is launched, as on the CPU."""
    x, lens = chip_smoke.k3_tile_batches(np.random.default_rng(3))[0]
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    plan = encode.read_plan(encode.int_plan(encode.int_stats(xt, lt), lt))
    last = int(plan.offsets[4])  # block 4 of 10 moves past the end
    bad = plan._replace(offsets=np.where(np.arange(10) == 4, plan.total,
                                         plan.offsets))
    before = encode.K3_LAUNCHES
    with pytest.raises(ValueError, match="block 4's stream"):
        encode.delta_pack_int(xt, lt, bad)
    assert encode.K3_LAUNCHES == before and last < plan.total


def test_block_encoder_float_on_card_matches_spec(dev):
    rng = np.random.default_rng(7)
    n = 5003
    x, low, high, pixels, periodic, lens = _float_batch(rng, n)
    enc = BlockEncoder(dev).encode_float_blocks(x, low, high, pixels,
                                                lens=lens,
                                                periodic=periodic)
    for i in range(len(x)):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :lens[i]], low[i], high[i], int(pixels[i]),
            periodic=bool(periodic[i]))
        assert (enc.payloads[i], enc.mins[i], enc.bits[i]) == \
            (payload, mn, bits), i


# the snapshot cell's shape: particles a side, source files, box side
SNAP_SIDE, SNAP_FILES, SNAP_L = 256, 8, 31.25


@pytest.mark.parametrize("cells,first,count", [(1, 0, 1), (2, 0, 8),
                                               (2, 3, 4)])
def test_rebin_matches_plain_at_the_cells_shape(dev, cells, first, count):
    n = SNAP_SIDE ** 3
    rng = np.random.default_rng(cells + first)
    ids = rng.permutation(n) + 1
    x = rng.uniform(0, SNAP_L, (n, 3)).astype(np.float32)
    v = rng.normal(0, 300, (n, 3)).astype(np.float32)
    v[7] = np.array([0x7FC01234, 0xFFA00001, 0x80000000],
                    np.uint32).view(np.float32)
    parts = np.array_split(np.arange(n), SNAP_FILES)
    batches = []
    for where in (dev, torch.device("cpu")):
        batch = rebin.Batch(SNAP_SIDE, cells, first, count, where)
        before = rebin.REBIN_LAUNCHES
        for p in parts:
            batch.add(*(torch.from_numpy(a[p]).to(where)
                        for a in (ids, x, v)))
        assert rebin.REBIN_LAUNCHES - before == SNAP_FILES
        batch.check()
        batches.append(batch)
    for name in ("x", "v", "marks", "error"):
        _same(*(getattr(b, name).cpu() for b in batches))
    assert batches[0].marks.tolist() == [-1] * (
        count * (SNAP_SIDE // cells) ** 3 // 32)


def _small_snapshot(seed, files=3, n_side=16):
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    hd = minp.Header(z=0.0, scale=1.0, omega_m=0.3, omega_l=0.7, h100=0.7,
                     l=50.0, n_side=n_side, n_total=n)
    snapshot.calc_uniform_mass(hd)
    parts = np.array_split(rng.permutation(n), files)
    v = rng.normal(0, 50, (n, 3)).astype(np.float32)
    return snapshot.MockSnapshot(hd, [v[p] for p in parts],
                                 [v[p] for p in parts],
                                 [p + 1 for p in parts])


@pytest.mark.parametrize("fault", ["low", "high", "twice", "none"])
def test_rebin_on_card_finds_bad_ids(dev, fault):
    snap = _small_snapshot(5)
    if fault == "low":
        snap.ids[2][9] = 0
    elif fault == "high":
        snap.ids[0][0] = 16 ** 3 + 1
    elif fault == "twice":
        snap.ids[1][3] = snap.ids[2][0]
    grid = snapshot.Grid(snap, 2, device=dev)
    if fault == "none":
        host = snapshot.Grid(snap, 2)
        for i in range(8):
            np.testing.assert_array_equal(
                grid.read_v(i).cpu().numpy().view(np.uint32),
                host.read_v(i).view(np.uint32))
        return
    match = ("two particles have one ID" if fault == "twice"
             else "ID out of range for NSide=16")
    with pytest.raises(ValueError, match=match):
        grid.read_v(0)


def test_to_minp_on_card_matches_host_at_the_cells_shape(dev, tmp_path):
    gadget, on_card, host = (str(tmp_path / d)
                             for d in ("gadget", "device", "host"))
    for d in (gadget, on_card, host):
        os.makedirs(d)
    chip_smoke.write_snapshot(gadget, SNAP_SIDE, SNAP_L, SNAP_FILES)
    args = (1, 8, 0.001, 1.0)
    before = rebin.REBIN_LAUNCHES
    convert_snapshot.to_minp(gadget, on_card, *args, dev)
    assert rebin.REBIN_LAUNCHES - before == SNAP_FILES
    convert_snapshot.to_minp(gadget, host, *args)
    for name in ("x_0.minp", "v_0.minp"):
        with open(os.path.join(on_card, name), "rb") as a, \
                open(os.path.join(host, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("per_batch", [1, 64])
def test_to_minp_on_card_holds_a_batch_of_cells(dev, tmp_path, monkeypatch,
                                                per_batch):
    """At 4 file cells (64 of 32^3) in 16 source files, the card's peak
    over a conversion is the batch's grids, one source file's copies and
    an output file's encode, not the snapshot's grids; the files are host
    mode's."""
    n_side, cells, files = 128, 4, 16
    gadget, on_card, host = (str(tmp_path / d)
                             for d in ("gadget", "device", "host"))
    for d in (gadget, on_card, host):
        os.makedirs(d)
    chip_smoke.write_snapshot(gadget, n_side, SNAP_L, files)
    places = (n_side // cells) ** 3
    budget = per_batch * rebin.batch_bytes(n_side, cells, 1)
    monkeypatch.setattr(snapshot, "device_budget", lambda d: budget)
    args = (cells, 2, 0.001, 1.0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = rebin.REBIN_LAUNCHES
    convert_snapshot.to_minp(gadget, on_card, *args, dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert rebin.REBIN_LAUNCHES - before == files * 64 // per_batch
    # a source file's IDs twice (the next copied before the last is
    # freed) and its two vectors: 40 bytes a particle
    staging = 40 * n_side ** 3 // files
    snapshot_grids = rebin.batch_bytes(n_side, cells, cells ** 3)
    assert budget <= peak <= budget + staging + (4 << 20), peak
    if per_batch == 1:
        assert peak < snapshot_grids / 4, peak
    convert_snapshot.to_minp(gadget, host, *args)
    names = sorted(os.listdir(host))
    assert sorted(os.listdir(on_card)) == names and len(names) == 128
    for name in names:
        with open(os.path.join(on_card, name), "rb") as a, \
                open(os.path.join(host, name), "rb") as b:
            assert a.read() == b.read(), name


def test_text_to_minh_device_and_read_on_card(dev, tmp_path):
    rng = np.random.default_rng(9)
    n = 3000
    lines = ["#ID PID X Mvir"]
    for i in range(n):
        lines.append("%d %d %.5f %.5e" % (
            i + (1 << 54), -1 if i % 3 else i, rng.uniform(0, 250),
            10 ** rng.uniform(9, 15)))
    (tmp_path / "hlist_1.0.list").write_text("\n".join(lines) + "\n")
    (tmp_path / "names.txt").write_text("id ID\npid PID\nx X\nmvir Mvir\n")
    (tmp_path / "types.txt").write_text(
        "id int64\npid int\nx q_float position\n"
        "mvir q_float log 1e5 1e16 0.001\n")
    config = tmp_path / "run.config"
    config.write_text(
        "[minh]\nL = 250\nEpsilon = 0.001\nMp = 1.54975e+08\n"
        "MinParticles = 50\nMassName = mvir\nNameIndex = %s\n"
        "TypeIndex = %s\n" % (tmp_path / "names.txt",
                              tmp_path / "types.txt"))
    out = tmp_path / "out"
    out.mkdir()
    text_to_minh.main([str(config), "all", str(tmp_path / "hlist_1.0.list"),
                       str(out), "--device"])
    cfg = text_to_minh.parse_config(str(config))
    idx = text_to_minh.open_index(cfg["NameIndex"])
    host = tmp_path / "host.minh"
    # the same converter in host mode
    text_to_minh.convert_file(
        cfg, idx, text_to_minh.parse_types(cfg["TypeIndex"], idx),
        text_to_minh.parse_vars("all", idx),
        str(tmp_path / "hlist_1.0.list"), str(host), None)
    device_file = out / "hlist_1.0.minh"
    assert device_file.read_bytes() == host.read_bytes()
    for mode in codec.DITHER_MODES:
        r = minh.open(str(device_file), dither=mode, seed=2)
        try:
            got = minh_device.read_floats(r, ["x", "mvir"], dev)
            want = r.floats(["x", "mvir"])
        finally:
            r.close()
        for name in got:
            np.testing.assert_array_equal(got[name].view(np.int32),
                                          want[name].view(np.int32))


@pytest.mark.parametrize("n", [1, 45, 4099])
def test_k4_matches_plain_at_every_width(dev, n):
    """Rows exactly ``words_per_block`` long, row 0 starting with the
    widest delta on the minimum -2^63, row 1 on 2^63 - 1."""
    rng = np.random.default_rng(n)
    for bits in range(65):
        w = max(bitpack.words_per_block(bits, n), 1)
        words = rng.integers(0, 1 << 32, (3, w), dtype=np.uint64) \
            .astype(np.uint32)
        words[0, :-(-bits // 32)] = 0xFFFFFFFF
        wt = torch.from_numpy(words.view(np.int32)).to(dev)
        mt = torch.tensor([-(1 << 63), (1 << 63) - 1, -12345], device=dev)
        before = decode.K4_LAUNCHES
        got = decode.decode_int_group(wt, mt, bits, n)
        assert decode.K4_LAUNCHES == before + 1
        assert torch.equal(got, decode.decode_int_plain(wt, mt, bits, n)), \
            bits


@pytest.mark.parametrize("kind", ["K2", "K4"])
def test_ragged_sweep_matches_plain(dev, kind):
    """``chip_smoke.ragged_sweep``'s column (widths 0..64, start bytes 0..3
    mod 4, lengths 1 to 2^17 - 1, extreme minimums and pixel counts)
    through the ragged entry, one launch a mode, against the plain
    version on the same tensors."""
    counter = "K2_LAUNCHES" if kind == "K2" else "K4_LAUNCHES"
    before = getattr(decode, counter)
    assert chip_smoke.check_ragged(dev, np.random.default_rng(21),
                                   kind) == 0
    assert getattr(decode, counter) == before + (3 if kind == "K2" else 1)


@pytest.mark.parametrize("mode", list(codec.DITHER_MODES))
def test_reads_launch_once_a_column_on_card(dev, tmp_path, mode):
    """The source file of a 3,000-row catalog, its boundary layout (64
    ragged cells) and a minp file read on the card: bitwise the host
    reader, one K2 launch a Float column and one K4 launch an Int column,
    one K2 launch a minp file; ``decode_*_blocks`` on three shares of the
    card, one launch a share."""
    src = write_catalog(tmp_path, n=3000)
    bnd = tmp_path / "b.bnd.minh"
    minh_to_bnd.convert_file(str(src), str(bnd), CELLS, BND, None)
    for fname in (src, bnd):
        r = minh.open(str(fname), dither=mode, seed=3)
        try:
            types = [c.type for c in r.columns]
            before = decode.K2_LAUNCHES, decode.K4_LAUNCHES
            got = {n: minh_device.read_column(r, n, dev) for n in r.names}
            assert (decode.K2_LAUNCHES - before[0],
                    decode.K4_LAUNCHES - before[1]) == (
                types.count(minh.Float), types.count(minh.Int))
            for n in r.names:
                want = minh_device.read_column(r, n, None)
                assert got[n].tobytes() == want.tobytes(), n
        finally:
            r.close()

    rng = np.random.default_rng(4)
    fname, m = str(tmp_path / "s.minh"), 500
    w = minh.create(fname)
    w.header(["x"], "", [minh.Column(type=minh.Float, low=0.0, high=250.0,
                                     dx=0.001)])
    w.geometry(250.0, 0, 0)
    for k in range(7):
        w.block([rng.uniform(0, 25.0 * (k + 1), m).astype(np.float32)])
    w.close()
    r = minh.open(fname, dither=mode, seed=3)
    try:
        ids = list(range(r.blocks))
        payloads, tab = device_common.read_payloads(r.f, ids)
        want = r.floats(["x"])["x"]
    finally:
        r.close()
    before = decode.K2_LAUNCHES
    dec = BlockEncoder([dev] * 3).decode_float_blocks(
        payloads, tab.mins, tab.bits, *tab.config[:3], m,
        periodic=tab.config[3], dither=mode, seed=3, block_ids=ids)
    assert decode.K2_LAUNCHES == before + 3
    assert dec.reshape(-1).tobytes() == want.tobytes()

    hd = minp.Header(l=100.0, n_side=16, n_total=16 ** 3)
    fname = str(tmp_path / "v.minp")
    w = minp.Writer(fname)
    w.header(hd, b"h", minp.Cell(0, 1, 2), 0.01, True)
    w.vectors(rng.uniform(0, 99.9, (16 ** 3, 3)).astype(np.float32))
    w.close()
    r = minp.open(fname, dither=mode, seed=3)
    try:
        before = decode.K2_LAUNCHES
        got = minp_device.read_vectors(r, dev).cpu().numpy()
        assert decode.K2_LAUNCHES == before + 1
        assert got.tobytes() == r.vectors().tobytes()
    finally:
        r.close()


def test_reads_on_card_reuse_one_pinned_buffer(dev, tmp_path):
    """``x_0`` then ``v_0`` of a 256^3-particle cell read on the card with
    no synchronise between the calls, so that the second call stages
    into the buffer the first one's copy leaves from: both bitwise the
    host reader's; both copies leave from pinned memory, and the second
    call allocates no staging buffer."""
    gadget, out = str(tmp_path / "gadget"), str(tmp_path / "out")
    for d in (gadget, out):
        os.makedirs(d)
    chip_smoke.write_snapshot(gadget, SNAP_SIDE, SNAP_L, SNAP_FILES)
    convert_snapshot.to_minp(gadget, out, 1, 8, 0.001, 1.0, dev)
    readers = [minp.open(os.path.join(out, name), dither="uniform", seed=5)
               for name in ("x_0.minp", "v_0.minp")]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [minp_device.read_vectors(r, dev) for r in readers]
        stages = [s.counts for s in profiling.records(t0)[0]
                  if s.name == "read.stage"]
        for r, g in zip(readers, got):
            assert g.cpu().numpy().tobytes() == r.vectors().tobytes()
    finally:
        for r in readers:
            r.close()
    assert [c["pinned"] for c in stages] == [1, 1]
    assert stages[1]["staging_allocs"] == 0


@pytest.mark.parametrize("mode", list(codec.DITHER_MODES))
def test_minh_to_bnd_device_matches_reference_host(dev, tmp_path, mode):
    src = write_catalog(tmp_path, n=3000)
    ref = tmp_path / "ref.bnd.minh"
    port = tmp_path / "port.bnd.minh"
    minh_to_bnd.convert_file(str(src), str(ref), CELLS, BND, None,
                             dither=mode)
    before = decode.K4_LAUNCHES, encode.K3_LAUNCHES
    minh_to_bnd.convert_file(str(src), str(port), CELLS, BND, dev,
                             dither=mode)
    assert decode.K4_LAUNCHES > before[0] and encode.K3_LAUNCHES > before[1]
    assert port.read_bytes() == ref.read_bytes()


def _uniform_halos(n, seed, l=250.0):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, l, n).astype(np.float32) for _ in range(3))


# (cells, boundary, halos): the CPU tests' shapes, the boundary cell's
# (3.0 M halos in 8^3 cells), 12^3 cells, and 200^3 (more cells than the
# matrix's bound: one chunk, its length chosen from the cells)
CELL_TABLES = [(c, 5.0, None) for c in (1, 2, 4, 5, 8)] + [
    (8, 0.6 * 250 / 8, None), (8, 5.0, 3_000_000), (12, 5.0, 1_000_000),
    (200, 0.5, 20_000)]


@pytest.mark.parametrize("cells_,bnd,n", CELL_TABLES)
def test_cells_kernel_matches_plain(dev, cells_, bnd, n):
    pos = halos(cells_, bnd) if n is None else _uniform_halos(n, cells_)
    on_card = [torch.from_numpy(a).to(dev) for a in pos]
    before = cells.CELLS_LAUNCHES
    got = cells.build(*on_card, 250.0, bnd, cells_)
    torch.cuda.synchronize()
    assert cells.CELLS_LAUNCHES == before + 1
    assert got.perm.is_cuda and got.flags.is_cuda and got.offsets.is_cuda
    want = cells.table_plain(*on_card, 250.0, bnd, cells_)
    for name in ("perm", "flags", "offsets"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.host_offsets.tolist() == want.host_offsets.tolist()
    assert cells.CELLS_LAUNCHES == before + 1  # the plain version counts none


@pytest.mark.parametrize("where", ["below -dx", "NaN", "none"])
def test_cells_kernel_raises_for_a_halo_outside_the_box(dev, where):
    x, y, z = halos(8)
    if where != "none":
        z[-3] = {"below -dx": -40.0, "NaN": np.nan}[where]
    on_card = [torch.from_numpy(a).to(dev) for a in (x, y, z)]
    if where == "none":
        assert cells.build(*on_card, 250.0, 5.0, 8).perm.numel() > len(x)
        return
    with pytest.raises(ValueError, match="outside the box"):
        cells.build(*on_card, 250.0, 5.0, 8)


def test_cells_kernel_of_no_halos(dev):
    empty = torch.zeros(0, dtype=torch.float32, device=dev)
    t = cells.build(empty, empty, empty, 250.0, 5.0, 8)
    assert t.perm.numel() == 0 and t.host_offsets.tolist() == [0] * 513


def test_minh_to_bnd_device_builds_one_table_a_conversion(dev, tmp_path):
    """``minh_to_bnd --device`` over two catalogs: one cell table on the
    card a conversion, each file byte-identical to host mode's."""
    for d in ("a", "b", "out_dev", "out_host"):
        (tmp_path / d).mkdir()
    for i, d in enumerate(("a", "b")):
        src = write_catalog(tmp_path / d, n=2000 + i, seed=i)
        src.rename(tmp_path / ("cat_%d.minh" % i))
    pattern = str(tmp_path / "cat_*.minh")
    before = cells.CELLS_LAUNCHES
    minh_to_bnd.main([str(CELLS), str(BND), pattern,
                      str(tmp_path / "out_dev"), "--device"])
    assert cells.CELLS_LAUNCHES == before + 2
    minh_to_bnd.main([str(CELLS), str(BND), pattern,
                      str(tmp_path / "out_host")])
    assert cells.CELLS_LAUNCHES == before + 2
    for i in range(2):
        name = "cat_%d.bnd.minh" % i
        assert (tmp_path / "out_dev" / name).read_bytes() \
            == (tmp_path / "out_host" / name).read_bytes()


def test_read_ints_on_card(dev, tmp_path):
    """The source file (one row-block) and its boundary layout (one block
    per cell, ragged, some empty): every Int column equal to the host
    reader."""
    src = write_catalog(tmp_path, n=3000)
    bnd = tmp_path / "b.bnd.minh"
    minh_to_bnd.convert_file(str(src), str(bnd), CELLS, BND, None)
    for fname in (src, bnd):
        r = minh.open(str(fname))
        try:
            names = [n for n, c in zip(r.names, r.columns)
                     if c.type == minh.Int]
            got = minh_device.read_ints(r, names, dev)
            want = r.ints(names)
        finally:
            r.close()
        for name in names:
            np.testing.assert_array_equal(got[name], want[name], name)


def _same_blocks(a, b):
    assert a.payloads == b.payloads
    for name in ("mins", "bits", "lens"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("copies", [2, 3])
def test_block_encoder_on_one_card_twice(dev, copies):
    """The card standing in the device list several times (a stream per
    share): byte for byte the one-device result, floats (a NaN block and
    ragged lengths among them) and ints, and the decode methods give the
    host decode back."""
    rng = np.random.default_rng(copies)
    n = 5003
    x, low, high, pixels, periodic, lens = _float_batch(rng, n)
    one, many = BlockEncoder(dev), BlockEncoder([dev] * copies)
    before = encode.K1_LAUNCHES
    f = many.encode_float_blocks(x, low, high, pixels, lens=lens,
                                 periodic=periodic)
    assert encode.K1_LAUNCHES == before + 3 * copies
    _same_blocks(f, one.encode_float_blocks(x, low, high, pixels, lens=lens,
                                            periodic=periodic))
    ids = (1 << 53) + 1 + rng.integers(0, 1 << 40, (7, n))
    ids[3] = 5
    i = many.encode_int_blocks(ids, lens=lens)
    _same_blocks(i, one.encode_int_blocks(ids, lens=lens))
    for r in range(7):
        assert (i.payloads[r], i.mins[r], i.bits[r]) == \
            spec.encode_int_block(ids[r, :lens[r]])

    full = BlockEncoder("cpu").encode_int_blocks(ids)
    np.testing.assert_array_equal(
        many.decode_int_blocks(full.payloads, full.mins, full.bits, n), ids)
    keep = np.array([0, 1, 2, 6])  # the blocks K1 certifies at full length
    ff = one.encode_float_blocks(x[keep], low[keep], high[keep],
                                 pixels[keep], periodic=periodic[keep])
    args = (ff.payloads, ff.mins, ff.bits, low[keep], high[keep],
            pixels[keep], n)
    for mode in codec.DITHER_MODES:
        kw = dict(periodic=periodic[keep], dither=mode, seed=4,
                  block_ids=[9, 1 << 35, 2, 3])
        np.testing.assert_array_equal(
            many.decode_float_blocks(*args, **kw).view(np.uint32),
            BlockEncoder("cpu").decode_float_blocks(*args, **kw).view(
                np.uint32))


def test_entry_points_default_to_the_card(dev, tmp_path):
    src = write_catalog(tmp_path, n=500)
    x = np.arange(64, dtype=np.int64).reshape(2, 32)
    before = encode.K3_LAUNCHES, decode.K2_LAUNCHES, decode.K4_LAUNCHES
    enc = BlockEncoder()
    assert enc.device.type == "cuda"
    enc.encode_int_blocks(x)
    r = minh.open(str(src))
    try:
        floats = [n for n, c in zip(r.names, r.columns)
                  if c.type == minh.Float][:1]
        ints = [n for n, c in zip(r.names, r.columns) if c.type == minh.Int]
        got = minh_device.read_floats(r, floats)
        np.testing.assert_array_equal(
            got[floats[0]].view(np.int32),
            r.floats(floats)[floats[0]].view(np.int32))
        np.testing.assert_array_equal(
            minh_device.read_ints(r, ints[:1])[ints[0]],
            r.ints(ints[:1])[ints[0]])
    finally:
        r.close()
    after = encode.K3_LAUNCHES, decode.K2_LAUNCHES, decode.K4_LAUNCHES
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.parametrize("family", selfcheck.FAMILIES)
def test_selfcheck_passes_on_the_card(dev, family):
    selfcheck.reset()
    before = (encode.K1_LAUNCHES + encode.K3_LAUNCHES + decode.K2_LAUNCHES
              + decode.K4_LAUNCHES)
    assert selfcheck.kernel_ok(family, dev) is True
    after = (encode.K1_LAUNCHES + encode.K3_LAUNCHES + decode.K2_LAUNCHES
             + decode.K4_LAUNCHES)
    assert after > before  # the kernels ran, not their plain versions
    assert selfcheck.kernel_ok(family) is True
    assert (encode.K1_LAUNCHES + encode.K3_LAUNCHES + decode.K2_LAUNCHES
            + decode.K4_LAUNCHES) == after  # cached


def test_selfcheck_divergence_on_the_card_stops_the_encoder(dev,
                                                            monkeypatch):
    """A card whose kernel disagrees with spec (here: spec made to
    disagree) raises out of ``BlockEncoder`` before anything is queued."""
    selfcheck.reset()
    real = spec.encode_int_block

    def other(x, pack=None):
        # spec.encode_float_block packs through this function too: leave
        # the float check's 18 bits alone, so that K1 passes and K3 at 41
        # bits is the first to differ
        payload, mn, bits = real(x, pack)
        if bits > 32:
            payload = payload[:-1] + bytes([payload[-1] ^ 1])
        return payload, mn, bits

    monkeypatch.setattr(selfcheck.spec, "encode_int_block", other)
    x = np.arange(64, dtype=np.int64).reshape(2, 32)
    be = BlockEncoder(dev)
    with pytest.raises(selfcheck.SelfCheckError, match="'encode'.*K3"):
        be.encode_int_blocks(x)
    monkeypatch.undo()
    before = encode.K3_LAUNCHES
    with pytest.raises(selfcheck.SelfCheckError, match="'encode'.*K3"):
        be.encode_int_blocks(x)
    assert encode.K3_LAUNCHES == before
    selfcheck.reset()
    assert be.encode_int_blocks(x).payloads


def test_validate_backend_on_the_card(dev):
    report = validate.validate_backend()
    assert report["backend"] == "cuda" and report["exact"] is True
    assert all(report[k] is True for k in ("K1", "K2", "K3", "K4", "K5"))
    assert report["device"] == torch.cuda.get_device_name(0)


def test_soak_on_the_card(dev, capsys):
    before = (encode.K1_LAUNCHES, encode.K3_LAUNCHES, encode.K5_LAUNCHES,
              decode.K2_LAUNCHES, decode.K4_LAUNCHES)
    assert kernel_fuzz_soak.main(["20", "--reps=1"]) == 0  # no flag: the card
    out = capsys.readouterr().out
    assert "on the card, the CUDA kernels" in out
    assert "SOAK OK: 20 seeds" in out
    assert "SWEEP OK: 64 widths int, 23 widths float" in out
    after = (encode.K1_LAUNCHES, encode.K3_LAUNCHES, encode.K5_LAUNCHES,
             decode.K2_LAUNCHES, decode.K4_LAUNCHES)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.parametrize("mode", ["gather", "allgather"])
def test_two_processes_on_the_card(dev, tmp_path, mode):
    report = multiprocess_gather_check.run(
        2, mode, "cuda", rows=20 * multiprocess_gather_check.BASE_ROWS,
        timeout=240, work_dir=str(tmp_path))
    assert report["counts"] == [6, 5]
    for r in report["ranks"]:
        assert r["ok"] and r["device"].startswith("cuda")
        assert all(r["launches"][k] > 0 for k in ("K1", "K2", "K3", "K4"))
        assert all(w > 32 for w in r["int_widths"])
