"""``BlockEncoder`` on several devices and its decode methods against the
one-device encoder, the JAX package's ``BlockEncoder`` and the normative
spec, bitwise (tolerance zero); ``mesh.block_shards`` against the
reference tool's owner table; and the entry points' default device."""

import numpy as np
import pytest
import torch

from minnow_tpu.core import spec
from minnow_tpu.parallel.pipeline import BlockEncoder as JaxBlockEncoder
from minnow_torch.formats import minh_device, minp_device
from minnow_torch.parallel import mesh
from minnow_torch.parallel.pipeline import BlockEncoder

MODES = ("none", "midpoint", "uniform")


def _float_batch(rng, b, n):
    """``b`` ragged blocks with per-block configs: positions (periodic,
    some clustered, some wrapping the edge), velocities and log masses."""
    kind = rng.integers(0, 3, b)
    low = np.choose(kind, [0.0, -1e4, 5.0]).astype(np.float32)
    high = np.choose(kind, [250.0, 1e4, 16.0]).astype(np.float32)
    dx = np.choose(kind, [0.001, 0.1, 0.001])
    pixels = np.array([spec.float_group_pixels(lo, hi, d)
                       for lo, hi, d in zip(low, high, dx)], np.int64)
    periodic = kind == 0
    x = (low[:, None] + rng.uniform(0, 0.999, (b, n))
         * (high - low)[:, None]).astype(np.float32)
    for i in np.nonzero(periodic)[0]:
        if i % 3 == 1:
            x[i] = rng.uniform(120, 120.3, n)
        elif i % 3 == 2:
            x[i] = np.where(rng.random(n) < 0.5, rng.uniform(249.6, 249.99, n),
                            rng.uniform(0, 0.3, n))
    lens = rng.integers(0, n + 1, b)
    lens[0] = n
    return x, low, high, pixels, periodic, lens.astype(np.int64)


def _int_batch(rng, b, n):
    """Rows of widths 0..64 on minimums from -2^63 to above 2^53."""
    rows = []
    for i in range(b):
        bits = int(rng.integers(0, 65))
        lo = (1 << 53) + 1 if bits < 62 else -(1 << 63)
        d = rng.integers(0, (1 << 64) - 1 if bits == 64 else 1 << bits, n,
                         dtype=np.uint64)
        rows.append(d.view(np.int64) + np.int64(lo))
    lens = rng.integers(0, n + 1, b)
    lens[-1] = n
    return np.stack(rows), lens.astype(np.int64)


def _same_blocks(a, b):
    assert a.payloads == b.payloads
    for name in ("mins", "bits", "lens"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("parts,b", [(1, 11), (2, 11), (3, 11), (4, 11),
                                     (8, 11), (3, 2), (5, 0)])
def test_block_shards_is_the_owner_table(parts, b):
    """``tools/multiprocess_gather_check.py`` ``owner_counts``: a
    contiguous split, earlier shares taking the remainder."""
    shards = mesh.block_shards(b, parts)
    base, rem = divmod(b, parts)
    assert [s.stop - s.start for s in shards] == \
        [base + (1 if i < rem else 0) for i in range(parts)]
    assert shards[0].start == 0 and shards[-1].stop == b
    assert all(s.stop == t.start for s, t in zip(shards, shards[1:]))


def test_block_mesh_lists_devices():
    assert mesh.block_mesh("cpu") == [torch.device("cpu")]
    assert mesh.block_mesh(["cpu", torch.device("cpu")]) == \
        [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one"):
        mesh.block_mesh([])
    with pytest.raises(ValueError, match="parts"):
        mesh.block_shards(4, 0)


@pytest.mark.parametrize("devices", [2, 3, 8])
@pytest.mark.parametrize("seed,b,n", [(0, 7, 300), (1, 11, 97), (2, 2, 64),
                                      (3, 1, 33)])
def test_float_encode_on_several_devices(devices, seed, b, n):
    """Unequal shares (7 over 3, 11 over 8) and more devices than blocks:
    byte for byte the one-device result, the JAX encoder's and spec's."""
    rng = np.random.default_rng(seed)
    x, low, high, pixels, periodic, lens = _float_batch(rng, b, n)
    one = BlockEncoder("cpu").encode_float_blocks(
        x, low, high, pixels, lens=lens, periodic=periodic)
    many = BlockEncoder(["cpu"] * devices).encode_float_blocks(
        x, low, high, pixels, lens=lens, periodic=periodic)
    _same_blocks(many, one)
    ref = JaxBlockEncoder().encode_float_blocks(
        x, low, high, pixels, lens=lens, periodic=periodic)
    _same_blocks(many, ref)
    for i in range(b):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :lens[i]], low[i], high[i], int(pixels[i]),
            periodic=bool(periodic[i]))
        assert (many.payloads[i], many.mins[i], many.bits[i]) == \
            (payload, mn, bits)


@pytest.mark.parametrize("clamp_q", [False, True])
def test_float_encode_on_several_devices_reroutes_to_spec(clamp_q):
    """Blocks K1 does not certify (a NaN, a pixel beyond a periodic
    range) in different shares, and ``clamp_q`` on a block whose largest
    pixel reaches ``pixels``: the one normative re-route, per block."""
    rng = np.random.default_rng(5)
    b, n = 7, 200
    x = rng.uniform(0, 249.9, (b, n)).astype(np.float32)
    x[1, 5] = np.nan
    x[4, 0] = 251.0
    x[6, 3] = np.float32(250.0)
    periodic = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    args = (x, 0.0, 250.0, 250000)
    one = BlockEncoder("cpu").encode_float_blocks(
        *args, periodic=periodic, clamp_q=clamp_q)
    many = BlockEncoder(["cpu"] * 3).encode_float_blocks(
        *args, periodic=periodic, clamp_q=clamp_q)
    _same_blocks(many, one)
    for i in range(b):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i], 0.0, 250.0, 250000, periodic=bool(periodic[i]),
            clamp_q=clamp_q)
        assert (many.payloads[i], many.mins[i], many.bits[i]) == \
            (payload, mn, bits), i


@pytest.mark.parametrize("devices", [2, 3, 8])
@pytest.mark.parametrize("seed,b,n", [(0, 7, 300), (1, 11, 97), (2, 1, 64)])
def test_int_encode_on_several_devices(devices, seed, b, n):
    rng = np.random.default_rng(seed)
    x, lens = _int_batch(rng, b, n)
    one = BlockEncoder("cpu").encode_int_blocks(x, lens=lens)
    many = BlockEncoder(["cpu"] * devices).encode_int_blocks(x, lens=lens)
    _same_blocks(many, one)
    _same_blocks(many, JaxBlockEncoder().encode_int_blocks(x, lens=lens))
    for i in range(b):
        assert (many.payloads[i], many.mins[i], many.bits[i]) == \
            spec.encode_int_block(x[i, :lens[i]])


@pytest.mark.parametrize("devices", [1, 3])
def test_encode_of_no_blocks(devices):
    be = BlockEncoder(["cpu"] * devices)
    enc = be.encode_int_blocks(np.zeros((0, 8), np.int64))
    assert enc.payloads == [] and enc.total_bytes() == 0
    enc = be.encode_float_blocks(np.zeros((0, 8), np.float32), 0.0, 1.0, 10)
    assert enc.payloads == [] and len(enc.mins) == len(enc.bits) == 0
    assert be.decode_int_blocks([], [], [], 8).shape == (0, 8)
    assert be.decode_float_blocks([], [], [], 0.0, 1.0, 10, 8).shape == (0, 8)


@pytest.mark.parametrize("devices", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_int_blocks_matches_jax(devices, seed):
    """Full-length blocks of mixed widths (0 and above 32 among them):
    the port's sharded decode == the JAX method == the input."""
    rng = np.random.default_rng(seed)
    b, n = 9, 130
    x, _ = _int_batch(rng, b, n)
    x[2] = 77  # width 0
    enc = BlockEncoder("cpu").encode_int_blocks(x)
    assert 0 in enc.bits and enc.bits.max() > 32
    got = BlockEncoder(["cpu"] * devices).decode_int_blocks(
        enc.payloads, enc.mins, enc.bits, n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, JaxBlockEncoder().decode_int_blocks(
        enc.payloads, enc.mins, enc.bits, n))


@pytest.mark.parametrize("devices", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_decode_float_blocks_matches_jax(devices, mode):
    """Per-block configs, mixed widths (a constant block at width 0),
    block ids beyond 2^32 and a seed: bitwise the JAX method and the host
    reader's arithmetic."""
    from minnow_torch.ops.selfcheck import spec_decode_float
    from minnow_torch.ops import bitpack

    rng = np.random.default_rng(3)
    b, n = 8, 150
    x, low, high, pixels, periodic, _ = _float_batch(rng, b, n)
    x[5] = x[5, 0]  # one pixel: width 0
    enc = BlockEncoder("cpu").encode_float_blocks(x, low, high, pixels,
                                                  periodic=periodic)
    assert len(set(enc.bits)) > 2 and 0 in enc.bits
    ids = rng.integers(0, 1 << 40, b)
    args = (enc.payloads, enc.mins, enc.bits, low, high, pixels, n)
    kw = dict(periodic=periodic, dither=mode, seed=9, block_ids=ids)
    got = BlockEncoder(["cpu"] * devices).decode_float_blocks(*args, **kw)
    want = JaxBlockEncoder().decode_float_blocks(*args, **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for i in range(b):
        bits = int(enc.bits[i])
        host = spec_decode_float(
            bitpack.bytes_to_words(enc.payloads[i], bits, n),
            int(enc.mins[i]), bits, n, low[i], high[i], int(pixels[i]),
            bool(periodic[i]), mode, 9, int(ids[i]))
        np.testing.assert_array_equal(got[i].view(np.uint32),
                                      host.view(np.uint32))
    assert np.abs(got - x).max() < 2 * 0.1


def test_decode_float_blocks_defaults_match_jax():
    """Scalar configs, default block ids (0..B-1) and seed."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 249.9, (5, 64)).astype(np.float32)
    enc = BlockEncoder("cpu").encode_float_blocks(x, 0.0, 250.0, 250000)
    args = (enc.payloads, enc.mins, enc.bits, 0.0, 250.0, 250000, 64)
    for mode in MODES:
        np.testing.assert_array_equal(
            BlockEncoder(["cpu", "cpu"]).decode_float_blocks(
                *args, dither=mode).view(np.uint32),
            JaxBlockEncoder().decode_float_blocks(
                *args, dither=mode).view(np.uint32))


@pytest.mark.parametrize("entry", ["BlockEncoder", "read_floats", "read_ints",
                                   "read_vectors", "block_mesh"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"BlockEncoder": BlockEncoder,
            "read_floats": lambda: minh_device.read_floats(None, ["x"]),
            "read_ints": lambda: minh_device.read_ints(None, ["id"]),
            "read_vectors": lambda: minp_device.read_vectors(None),
            "block_mesh": mesh.block_mesh}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
