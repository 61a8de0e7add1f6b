"""Int block decode of minnow_torch (the plain version of kernel K4, as the
CPU runs it) and its bulk int reader against the JAX package: its Pallas
group unpack kernels B4 and B5 in interpret mode, its device reader, the
host reader and the normative spec, bitwise."""

import numpy as np
import pytest
import torch

from minnow_tpu.core import spec
from minnow_tpu.formats import device_common as jax_device_common
from minnow_tpu.formats import minh
from minnow_tpu.formats import minh_device as jax_minh_device
from minnow_tpu.ops import codec as jax_codec
from minnow_tpu.ops import pallas_codec
from minnow_torch.formats import device_common, minh_device
from minnow_torch.ops import bitpack, decode

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _deltas(rng, b, n, bits):
    """(b, n) uint64 deltas of width ``bits``; the first row holds 0 and
    the widest delta, 2^bits - 1."""
    if bits == 0:
        return np.zeros((b, n), np.uint64)
    d = rng.integers(0, 1 << bits, (b, n), dtype=np.uint64,
                     endpoint=False) if bits < 64 else \
        rng.integers(0, 1 << 64, (b, n), dtype=np.uint64, endpoint=False)
    d[0, :2] = 0, (1 << bits) - 1
    return d


def _words(d, bits, n):
    """Each row packed by ``spec`` into a row exactly ``words_per_block``
    long, no padding."""
    return np.stack([bitpack.bytes_to_words(spec.pack_bits(v, bits), bits, n)
                     for v in d])


def _decode(words, mins, bits, n):
    return decode.decode_int_group(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(mins), bits, n).numpy()


# interpret mode costs ~0.5 s a call: B4 at three widths, B5 at three
@pytest.mark.parametrize("bits", [1, 17, 32, 33, 54, 64])
def test_decode_matches_pallas_group_unpack(bits):
    rng = np.random.default_rng(bits)
    n = 32 * pallas_codec.group_tiles(bits) * 8
    b = 2
    d = _deltas(rng, b, n, bits)
    words = _words(d, bits, n)
    mins = np.array([I64_MIN, 12345], np.int64)
    got = _decode(words, mins, bits, n)
    ref = np.asarray(jax_codec.decode_int_blocks_group(
        words.reshape(-1, pallas_codec.group_tiles(bits) * bits), mins,
        bits, n, interpret=True))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", range(65))
def test_decode_matches_spec_at_every_width(bits):
    """Extreme minimums, the widest delta, and a length whose last
    element ends inside the last word of an unpadded row."""
    rng = np.random.default_rng(100 + bits)
    n = 45
    d = _deltas(rng, 4, n, bits)
    mins = np.array([I64_MIN, I64_MAX, 0, -(1 << 40)], np.int64)
    words = _words(d, bits, n) if bits else np.zeros((4, 1), np.uint32)
    assert words.shape[1] == max(bitpack.words_per_block(bits, n), 1)
    got = _decode(words, mins, bits, n)
    for r in range(4):
        want = spec.decode_int_block(spec.pack_bits(d[r], bits),
                                     int(mins[r]), bits, n)
        np.testing.assert_array_equal(got[r], want, err_msg="row %d" % r)


def test_decode_add_wraps_in_int64():
    """min -2^63 plus delta 2^64 - 1 is 2^63 - 1: the uint64 add of
    spec.decode_int_block, modulo 2^64."""
    words = np.array([[0xFFFFFFFF, 0xFFFFFFFF, 0x1]], np.uint32)
    got = _decode(words, np.array([I64_MIN], np.int64), 64, 1)
    assert got.tolist() == [[I64_MAX]]
    got = _decode(words[:, 1:], np.array([I64_MAX], np.int64), 33, 1)
    assert got.tolist() == [[I64_MAX + (1 << 33) - 1 - (1 << 64)]]


def test_decode_width_zero_writes_the_minimums():
    words = np.zeros((3, 1), np.uint32)
    mins = np.array([I64_MIN, 5, I64_MAX], np.int64)
    got = _decode(words, mins, 0, 7)
    np.testing.assert_array_equal(got, np.repeat(mins[:, None], 7, axis=1))
    assert _decode(words, mins, 5, 0).shape == (3, 0)


def test_decode_refuses_what_the_kernel_does_not_take():
    words = torch.zeros((2, 4), dtype=torch.int32)
    mins = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        decode.decode_int_group(words, mins, 65, 1)
    with pytest.raises(ValueError):
        decode.decode_int_group(words, mins, -1, 1)
    with pytest.raises(ValueError):  # 9 x 15 bits need 5 words
        decode.decode_int_group(words, mins, 15, 9)
    with pytest.raises(ValueError):
        decode.decode_int_group(words, mins[:1], 4, 8)
    with pytest.raises(TypeError):
        decode.decode_int_group(words.long(), mins, 4, 8)
    with pytest.raises(TypeError):
        decode.decode_int_group(words, mins.int(), 4, 8)


def test_group_decode_ints_returns_a_tensor_on_the_device():
    rng = np.random.default_rng(3)
    d = _deltas(rng, 3, 100, 23)
    mins = np.array([-7, 0, 1 << 50], np.int64)
    out = device_common.group_decode_ints(_words(d, 23, 100), mins, 23, 100,
                                          "cpu")
    assert out.dtype == torch.int64 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(),
                                  d.view(np.int64) + mins[:, None])


def _int_file(fname, lengths, seed):
    """A minh file of ``Int`` columns: 40-bit IDs, 1-bit flags and a
    constant (width 0), one row-block per entry of ``lengths``."""
    rng = np.random.default_rng(seed)
    w = minh.create(fname)
    w.header(["id", "flag", "const"], "t",
             [minh.Column(type=minh.Int)] * 3)
    w.geometry(250, 0, 0)
    for n in lengths:
        ids = rng.integers(0, 10**12, n) - (1 << 62)
        ids[0], ids[-1] = -(1 << 62), (1 << 40) + 5  # pin width > 32
        w.block([ids, rng.integers(0, 2, n), np.full(n, -3)])
    w.close()


# n = 32768 is a whole group alignment of the TPU kernels; 30000 is not
@pytest.mark.parametrize("n", [32768, 30000])
def test_read_ints_matches_host_and_jax_readers(tmp_path, monkeypatch, n):
    fname = str(tmp_path / "c.minh")
    _int_file(fname, [n], seed=4)
    names = ["id", "flag", "const"]
    r = minh.open(fname)
    try:
        got = minh_device.read_ints(r, names, "cpu")
        host = r.ints(names)
        monkeypatch.setattr(jax_device_common, "INTERPRET", True)
        ref = jax_minh_device.read_ints(r, names)
    finally:
        r.close()
    for name in names:
        assert got[name].dtype == np.int64
        np.testing.assert_array_equal(got[name], host[name], name)
        np.testing.assert_array_equal(got[name], ref[name], name)


def test_read_ints_ragged_row_blocks(tmp_path):
    """Row-blocks of several lengths (one bucket each, two of one
    length) and a one-row block."""
    fname = str(tmp_path / "r.minh")
    _int_file(fname, [3001, 257, 1, 3001, 64], seed=8)
    r = minh.open(fname)
    try:
        got = minh_device.read_ints(r, ["id", "flag", "const"], "cpu")
        host = r.ints(["id", "flag", "const"])
    finally:
        r.close()
    for name in host:
        np.testing.assert_array_equal(got[name], host[name], name)


def test_block_widths_lists_each_columns_distinct_widths(tmp_path):
    """A 3001-row block (IDs spanning 2^62 + 2^40 + 5: 63 bits; flags 1
    bit) and a one-row block (width 0 in every column)."""
    fname = str(tmp_path / "w.minh")
    _int_file(fname, [3001, 1], seed=9)
    r = minh.open(fname)
    try:
        got = {n: minh_device.block_widths(r, n)
               for n in ("id", "flag", "const")}
    finally:
        r.close()
    assert got == {"id": [0, 63], "flag": [0, 1], "const": [0]}
