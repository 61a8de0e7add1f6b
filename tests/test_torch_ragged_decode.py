"""The ragged decode of minnow_torch -- the plain versions of kernels K2 and
K4, as the CPU runs them, on a table of blocks that lie in one byte
stream as a file holds them -- and the device readers that go through it,
against the normative spec block by block, the (B, W) entries on the same
blocks, the JAX package's readers (Pallas in interpret mode) and the host
reader, bitwise, in the three dither modes; with one decode call a
column."""

import numpy as np
import pytest
import torch

import chip_smoke
from minnow_torch.cli import minh_to_bnd
from minnow_torch.core import dither as dither_mod
from minnow_torch.core import spec
from minnow_torch.formats import device_common, minh, minh_device, minp
from minnow_torch.formats import minp_device
from minnow_torch.ops import bitpack, codec, decode
from minnow_torch.parallel.pipeline import BlockEncoder
from minnow_tpu.formats import device_common as jax_device_common
from minnow_tpu.formats import minh as jax_minh
from minnow_tpu.formats import minh_device as jax_minh_device
from test_torch_minh_to_bnd import BND, CELLS, write_catalog

MODES = ["none", "midpoint", "uniform"]
# chip_smoke.py's sweep at a small size: its longest blocks 2^13 - 1
LONG = (1 << 13) - 1


def _spec_ints(span, col):
    """The host codec's decode of each int block of ``col`` in ``span``."""
    return [spec.decode_int_block(span[a:a + m].tobytes(), int(mn), int(bits),
                                  int(n))
            for a, m, bits, n, mn in zip(col.start, col.nbytes, col.bits,
                                         col.lens, col.mins)]


def _spec_floats(span, col, mode, seed):
    """The host reader's decode of each float block of ``col``:
    ``FloatGroup.read_data`` with its dither keyed on the block id."""
    out = []
    for i, q in enumerate(_spec_ints(span, col)):
        low, high, pixels, periodic = (c[i] for c in col.config)
        if periodic:
            q = spec.bound(q, 0, int(pixels))
        out.append(spec.dequantize(q, low, high, int(pixels),
                                   u=dither_mod.dither_u(
                                       mode, seed, int(col.ids[i]),
                                       int(col.lens[i]))))
    return out


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("mode", MODES)
def test_ragged_plain_matches_spec_per_block(mode):
    """Widths 0..64 in one column, start bytes 0..3 (mod 4), lengths 1,
    31, 33, 4099 and 2^13 - 1, minimums -2^63 and 2^63 - 1, pixel counts
    2^31 + 5 and 10^10 among the float blocks."""
    span, (ints, floats) = chip_smoke.ragged_sweep(np.random.default_rng(7),
                                                   LONG)
    assert sorted(ints.bits.tolist()) == list(range(65))
    assert set((ints.start % 4).tolist()) == {0, 1, 2, 3}
    src, (si, sf) = device_common.stage_columns(span, [ints, floats], "cpu",
                                                mode, seed=5)
    got = decode.decode_int_ragged(src, si.table).numpy()
    np.testing.assert_array_equal(got, np.concatenate(_spec_ints(span,
                                                                 ints)))
    got = decode.decode_float_ragged(src, sf.table, sf.params, mode, sf.k1,
                                     sf.k2).numpy()
    want = np.concatenate(_spec_floats(span, floats, mode, 5))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bits", [0, 1, 18, 33, 64])
@pytest.mark.parametrize("mode", MODES)
def test_ragged_plain_matches_group_decode(bits, mode):
    """Blocks of one width and length, as (B, W) word rows for
    ``decode_*_group`` and as payloads at odd byte offsets of one stream
    for ``decode_*_ragged``."""
    rng = np.random.default_rng(bits)
    b, n = 5, 1001
    vals = rng.integers(0, 1 << min(bits, 62), (b, n), dtype=np.uint64) \
        if bits else np.zeros((b, n), np.uint64)
    payloads = [spec.pack_bits(v, bits) for v in vals]
    words = np.zeros((b, max(bitpack.words_per_block(bits, n), 1)),
                     np.uint32)
    for i, p in enumerate(payloads):
        if bits:
            words[i] = bitpack.bytes_to_words(p, bits, n)
    span = b"\x01" + b"\x02\x03".join(payloads) + b"\x04"
    start = np.array([1 + i * (len(payloads[0]) + 2) for i in range(b)],
                     np.int64)
    mins = rng.integers(-(1 << 40), 1 << 40, b)
    ids = np.arange(b, dtype=np.int64) + 3
    config = (np.full(b, -5.0, np.float32), np.full(b, 245.0, np.float32),
              np.full(b, 250000, np.int64), np.arange(b) % 2 == 0)
    col = device_common.Blocks(start, np.full(b, bits, np.int64),
                               np.full(b, n, np.int64), mins, config, ids)
    src, (s,) = device_common.stage_columns(
        np.frombuffer(span, np.uint8), [col], "cpu", mode, seed=2)
    wt = torch.from_numpy(words.view(np.int32))
    mt = torch.from_numpy(mins)
    params = codec.block_params(*config, "cpu")
    k1, k2 = codec.dither_keys(ids, 2, "cpu")
    group = decode.decode_float_group(wt, mt, params, bits, n, mode, k1, k2)
    ragged = decode.decode_float_ragged(src, s.table, s.params, mode, s.k1,
                                        s.k2)
    assert torch.equal(ragged.view(torch.int32),
                       group.reshape(-1).view(torch.int32))
    assert torch.equal(decode.decode_int_ragged(src, s.table),
                       decode.decode_int_group(wt, mt, bits, n).reshape(-1))


def test_group_entries_take_the_ragged_route(monkeypatch):
    """On the CPU ``decode_*_group`` runs its own plain version; its table
    (row b at bit 32 W b, to elements [b n, (b + 1) n)) is the one the
    card's launch takes: the ragged plain version on it gives the same."""
    rng = np.random.default_rng(3)
    b, n, bits = 3, 77, 29
    words = torch.from_numpy(rng.integers(0, 1 << 32, (b, 72),
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    mins = torch.from_numpy(rng.integers(-9, 9, b))
    table = decode._rows_table(words, mins, bits, n)
    assert (table.total, table.max_len) == (b * n, n)
    assert torch.equal(
        decode.decode_int_ragged_plain(words.reshape(-1), table).view(b, n),
        decode.decode_int_group(words, mins, bits, n))


class _Spy:
    """Counts the calls of ``decode.decode_*_ragged``."""

    def __init__(self, monkeypatch):
        self.calls = {"K2": 0, "K4": 0}
        for kind, name in (("K2", "decode_float_ragged"),
                           ("K4", "decode_int_ragged")):
            real = getattr(decode, name)

            def spy(*args, _real=real, _kind=kind, **kw):
                self.calls[_kind] += 1
                return _real(*args, **kw)

            monkeypatch.setattr(decode, name, spy)


class _Reads:
    """Wraps a reader's file and counts its ``read`` and ``readinto``
    calls."""

    def __init__(self, f):
        self.f, self.reads = f, 0

    def read(self, *a):
        self.reads += 1
        return self.f.read(*a)

    def readinto(self, *a):
        self.reads += 1
        return self.f.readinto(*a)

    def __getattr__(self, name):
        return getattr(self.f, name)


def _basic_file(fname):
    """A basic minh file of 3 ragged row-blocks, so that its columns
    interleave: a position, a log mass, a narrow cluster, int IDs above
    2^53 (wider than 32 bits), flags and a constant (width 0)."""
    rng = np.random.default_rng(61)
    cols = [minh.Column(type=minh.Float, low=0.0, high=250.0, dx=0.001),
            minh.Column(type=minh.Float, log=1, low=9.0, high=16.0,
                        dx=0.001),
            minh.Column(type=minh.Float, low=-100.0, high=100.0, dx=0.01),
            minh.Column(type=minh.Int), minh.Column(type=minh.Int),
            minh.Column(type=minh.Int)]
    w = minh.create(fname)
    w.header(["x", "m", "c", "id", "flag", "const"], "", cols)
    w.geometry(250.0, 0, 0)
    for n in (3001, 257, 1999):
        w.block([rng.uniform(0, 249.9, n).astype(np.float32),
                 (10.0 ** rng.uniform(9.5, 15, n)).astype(np.float32),
                 rng.uniform(3.0, 3.5, n).astype(np.float32),
                 rng.integers(0, 1 << 40, n) + (1 << 53),
                 rng.integers(0, 2, n), np.full(n, -3)])
    w.close()


@pytest.mark.parametrize("mode", MODES)
def test_basic_file_reads_match_host_and_jax(tmp_path, monkeypatch, mode):
    """Columns that interleave: one read of their span for the call, one
    decode call a column, every value bitwise the host reader's and the
    JAX readers' (Pallas in interpret mode)."""
    fname = str(tmp_path / "b.minh")
    _basic_file(fname)
    floats, ints = ["x", "m", "c"], ["id", "flag", "const"]
    r = minh.open(fname, dither=mode, seed=4)
    try:
        r.f.f = _Reads(r.f.f)
        spy = _Spy(monkeypatch)
        got = minh_device.read_floats(r, floats, "cpu")
        assert (spy.calls, r.f.f.reads) == ({"K2": 3, "K4": 0}, 1)
        got.update(minh_device.read_ints(r, ints, "cpu"))
        assert (spy.calls, r.f.f.reads) == ({"K2": 3, "K4": 3}, 2)
        host = {**r.floats(floats), **r.ints(ints)}
    finally:
        r.close()
    monkeypatch.setattr(jax_device_common, "INTERPRET", True)
    jr = jax_minh.open(fname, dither=mode, seed=4)
    try:
        ref = {**jax_minh_device.read_floats(jr, floats),
               **jax_minh_device.read_ints(jr, ints)}
    finally:
        jr.close()
    for name in floats + ints:
        np.testing.assert_array_equal(_bits(got[name]), _bits(host[name]),
                                      name)
        np.testing.assert_array_equal(_bits(got[name]), _bits(ref[name]),
                                      name)


@pytest.mark.parametrize("mode", MODES)
def test_boundary_file_reads_one_call_a_column(tmp_path, monkeypatch, mode):
    """``minh_to_bnd`` of a 3,000-row catalog (64 cells, empty and short
    ones among them): every column read on the device route equals the
    host reader, with one decode call for each Float and Int column."""
    src = write_catalog(tmp_path, n=3000)
    bnd = str(tmp_path / "c.bnd.minh")
    minh_to_bnd.convert_file(str(src), bnd, CELLS, BND, None)
    r = minh.open(bnd, dither=mode, seed=8)
    try:
        types = {n: c.type for n, c in zip(r.names, r.columns)}
        spy = _Spy(monkeypatch)
        got = {n: minh_device.read_column(r, n, "cpu") for n in r.names}
        host = {n: minh_device.read_column(r, n, None) for n in r.names}
        assert r.blocks == CELLS ** 3
    finally:
        r.close()
    assert spy.calls == {
        "K2": sum(t == minh.Float for t in types.values()),
        "K4": sum(t == minh.Int for t in types.values())}
    assert spy.calls["K2"] >= 5 and spy.calls["K4"] >= 2
    for name in host:
        np.testing.assert_array_equal(_bits(got[name]), _bits(host[name]),
                                      name)


def _minp_file(fname, periodic):
    rng = np.random.default_rng(9)
    n_side, sub = 8, 2
    hd = minp.Header(l=100.0, n_side=n_side, n_total=n_side ** 3)
    vec = rng.uniform(0, 99.9, (n_side ** 3, 3)).astype(np.float32) \
        if periodic else rng.normal(0, 50, (n_side ** 3, 3)).astype(
            np.float32)
    w = minp.Writer(fname)
    w.header(hd, b"h", minp.Cell(0, 1, sub), 0.01, periodic)
    w.vectors(vec)
    w.close()


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_read_vectors_one_read_and_one_call_a_file(tmp_path, monkeypatch,
                                                   mode, periodic):
    fname = str(tmp_path / "v.minp")
    _minp_file(fname, periodic)
    r = minp.open(fname, dither=mode, seed=6)
    try:
        r.f.f = _Reads(r.f.f)
        spy = _Spy(monkeypatch)
        got = minp_device.read_vectors(r, "cpu").numpy()
        assert (spy.calls, r.f.f.reads) == ({"K2": 1, "K4": 0}, 1)
        host = r.vectors()
    finally:
        r.close()
    np.testing.assert_array_equal(_bits(got), _bits(host))


@pytest.mark.parametrize("mode", MODES)
def test_decode_blocks_on_three_shares(tmp_path, monkeypatch, mode):
    """``BlockEncoder(["cpu"] * 3)``'s decode methods on a file's blocks
    (payloads from one read of their span): one call a share, values
    bitwise the host reader's."""
    fname = str(tmp_path / "s.minh")
    rng = np.random.default_rng(12)
    m = 500
    w = minh.create(fname)
    w.header(["id", "x"], "", [minh.Column(type=minh.Int),
                               minh.Column(type=minh.Float, low=0.0,
                                           high=250.0, dx=0.001)])
    w.geometry(250.0, 0, 0)
    for k in range(7):
        w.block([rng.integers(0, 1 << (20 + 5 * k), m),
                 rng.uniform(0, 25.0 * (k + 1), m).astype(np.float32)])
    w.close()
    be = BlockEncoder(["cpu"] * 3)
    r = minh.open(fname, dither=mode, seed=2)
    try:
        host = {**r.ints(["id"]), **r.floats(["x"])}
        idx = {c: [r._block_idx(c, b) for b in range(r.blocks)]
               for c in (0, 1)}
        pay_i, tab_i = device_common.read_payloads(r.f, idx[0])
        pay_f, tab_f = device_common.read_payloads(r.f, idx[1])
    finally:
        r.close()
    spy = _Spy(monkeypatch)
    dec_i = be.decode_int_blocks(pay_i, tab_i.mins, tab_i.bits, m)
    dec_f = be.decode_float_blocks(pay_f, tab_f.mins, tab_f.bits,
                                   *tab_f.config[:3], m,
                                   periodic=tab_f.config[3], dither=mode,
                                   seed=2, block_ids=idx[1])
    assert spy.calls == {"K2": 3, "K4": 3}
    assert len(set(tab_f.bits.tolist())) > 2
    np.testing.assert_array_equal(dec_i.reshape(-1), host["id"])
    np.testing.assert_array_equal(_bits(dec_f.reshape(-1)), _bits(host["x"]))


def test_tail_blocks_need_no_payload_read(tmp_path):
    """The table of a column comes from the parsed tail: places, widths,
    lengths and minimums equal to what ``raw_block`` reads block by
    block."""
    fname = str(tmp_path / "t.minh")
    _basic_file(fname)
    r = minh.open(fname)
    try:
        for c in range(6):
            ids = [r._block_idx(c, b) for b in range(r.blocks)]
            r.f.f = _Reads(r.f.f)
            tab = device_common.tail_blocks(r.f, ids)
            assert r.f.f.reads == 0
            raw = [r.f.raw_block(i) for i in ids]
            assert tab.bits.tolist() == [x[2] for x in raw]
            assert tab.mins.tolist() == [x[1] for x in raw]
            assert tab.lens.tolist() == [x[3] for x in raw]
            assert [len(x[0]) for x in raw] == tab.nbytes.tolist()
            assert (tab.config is None) == (raw[0][4] is None)
            payloads, _ = device_common.read_payloads(r.f, ids)
            assert payloads == [x[0] for x in raw]
        with pytest.raises(TypeError):
            device_common.tail_blocks(r.f, [0, 3])  # a float and an int
    finally:
        r.close()


def test_stage_refuses_blocks_outside_their_span():
    span = np.zeros(10, np.uint8)

    def col(start, bits, n):
        return device_common.Blocks(np.array([start], np.int64),
                                    np.array([bits], np.int64),
                                    np.array([n], np.int64),
                                    np.zeros(1, np.int64), None,
                                    np.zeros(1, np.int64))

    device_common.stage_columns(span, [col(2, 8, 8)], "cpu")
    for bad in (col(3, 8, 8), col(-1, 1, 1), col(0, 65, 1), col(0, 1, -1)):
        with pytest.raises(ValueError):
            device_common.stage_columns(span, [bad], "cpu")


def test_stage_is_one_copy_of_every_array():
    arrays = [np.arange(5, dtype=np.int64), np.array([True, False]),
              np.arange(3, dtype=np.float32), np.zeros(0, np.int32),
              np.arange(7, dtype=np.int32)]
    got = device_common.stage("cpu", arrays)
    base = got[0].untyped_storage().data_ptr()
    for a, t in zip(arrays, got):
        assert t.untyped_storage().data_ptr() == base
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)
