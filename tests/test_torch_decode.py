"""Float block decode of minnow_torch (the plain version of kernel K2, as
the CPU runs it) and its bulk minh reader against the JAX package: its
Pallas decode kernel in interpret mode, its device reader, the host
reader and the normative spec, bitwise, in all three dither modes."""

import numpy as np
import pytest
import torch

from minnow_tpu.core import dither as dither_mod
from minnow_tpu.core import spec
from minnow_tpu.formats import device_common as jax_device_common
from minnow_tpu.formats import minh
from minnow_tpu.formats import minh_device as jax_minh_device
from minnow_tpu.ops import codec as jax_codec
from minnow_tpu.ops import pallas_codec
from minnow_torch.formats import minh_device
from minnow_torch.ops import bitpack, codec, decode

MODES = ["none", "midpoint", "uniform"]


def _blocks(rng, b, n, bits, pixels, hi=1 << 62):
    """Random packed blocks at one width with their metadata; the packed
    values lie below ``hi``."""
    hi = min(1 << bits, hi)
    vals = rng.integers(0, hi, (b, n), dtype=np.uint64)
    words = np.stack([bitpack.bytes_to_words(spec.pack_bits(v, bits), bits,
                                             n) for v in vals])
    mins = rng.integers(-3, 3, b).astype(np.int64)
    low = rng.uniform(-10, 0, b).astype(np.float32)
    high = (low + rng.uniform(100, 300, b)).astype(np.float32)
    pix = np.full(b, pixels, np.int64)
    periodic = np.arange(b) % 3 != 1
    return vals, words, mins, low, high, pix, periodic


def _decode(words, mins, low, high, pix, periodic, bits, n, mode, ids,
            seed):
    params = codec.block_params(low, high, pix, periodic, "cpu")
    k1, k2 = codec.dither_keys(ids, seed, "cpu")
    return decode.decode_float_group(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(mins),
        params, bits, n, mode, k1, k2).numpy()


# interpret mode costs ~0.5 s a call: three widths x three modes
@pytest.mark.parametrize("bits", [1, 18, 32])
@pytest.mark.parametrize("mode", MODES)
def test_decode_matches_pallas_kernel(bits, mode):
    rng = np.random.default_rng(bits)
    g = pallas_codec.group_tiles(bits)
    b, n = 4, 32 * g * 8
    pixels = 250000 if bits <= 18 else (1 << 24) - 3
    # the TPU kernel works in int32 pixels: keep q inside [0, pixels)
    _, words, mins, low, high, pix, periodic = _blocks(
        rng, b, n, bits, pixels, hi=pixels - 3)
    ids = np.arange(10, 10 + b, dtype=np.int64)
    got = _decode(words, mins, low, high, pix, periodic, bits, n, mode,
                  ids, 9)
    keys = {}
    if mode == "uniform":
        k1, k2 = (np.asarray(k) for k in jax_codec.dither_keys(ids, 9))
        keys = dict(key1=k1, key2=k2)
    ref = np.asarray(pallas_codec.decode_float_pallas_group(
        words.reshape(-1, g * bits), mins, low, high, pix, periodic, bits,
        n, dither=mode, interpret=True, **keys)).reshape(b, n)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("mode", MODES)
def test_decode_width_sweep_matches_spec(mode):
    """Every width 0..64 (the kernel takes them all) against the host
    reader's arithmetic: spec.decode_int_block, spec.bound,
    spec.dequantize with core/dither's stream."""
    rng = np.random.default_rng(7)
    n, b = 45, 2
    for bits in range(65):
        pixels = int(rng.integers(1, 1 << 31))
        vals, words, mins, low, high, pix, periodic = _blocks(
            rng, b, n, bits, pixels)
        if bits == 0:
            words = np.zeros((b, 1), np.uint32)
        ids = np.array([3, 1000 + bits])
        got = _decode(words, mins, low, high, pix, periodic, bits, n, mode,
                      ids, 5)
        for r in range(b):
            q = spec.decode_int_block(spec.pack_bits(vals[r], bits),
                                      int(mins[r]), bits, n)
            if periodic[r]:
                q = spec.bound(q, 0, pixels)
            u = dither_mod.dither_u(mode, 5, int(ids[r]), n)
            want = spec.dequantize(q, low[r], high[r], pixels, u=u)
            np.testing.assert_array_equal(got[r].view(np.int32),
                                          want.view(np.int32),
                                          err_msg="bits=%d" % bits)


@pytest.fixture
def minh_file(tmp_path):
    """A minh file of three row-blocks (ragged lengths), a position
    column, a log column and a narrow cluster column."""
    rng = np.random.default_rng(53)
    cols = [minh.Column(type=minh.Float, low=0.0, high=250.0, dx=0.001),
            minh.Column(type=minh.Float, log=1, low=9.0, high=16.0,
                        dx=0.001),
            minh.Column(type=minh.Float, low=-100.0, high=100.0, dx=0.01)]
    fname = str(tmp_path / "f.minh")
    w = minh.create(fname)
    w.header(["x", "m", "c"], "", cols)
    w.geometry(250.0, 0, 0)
    blocks = []
    for n in (3001, 257, 3001):
        x = [rng.uniform(0, 249.9, n).astype(np.float32),
             (10.0 ** rng.uniform(9.5, 15, n)).astype(np.float32),
             rng.uniform(3.0, 3.5, n).astype(np.float32)]
        w.block(x)
        blocks.append(x)
    w.close()
    return fname, blocks


@pytest.mark.parametrize("mode", MODES)
def test_read_floats_matches_host_and_jax_readers(minh_file, monkeypatch,
                                                  mode):
    fname, blocks = minh_file
    names = ["x", "m", "c"]
    r = minh.open(fname, dither=mode, seed=4)
    try:
        got = minh_device.read_floats(r, names, "cpu")
        host = r.floats(names)
        monkeypatch.setattr(jax_device_common, "INTERPRET", True)
        ref = jax_minh_device.read_floats(r, names)
    finally:
        r.close()
    for name in names:
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      host[name].view(np.int32), name)
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      ref[name].view(np.int32), name)
    # decoded values within 2*dx of the source (docs/FORMAT.md:145)
    x = np.concatenate([b[0] for b in blocks])
    assert np.abs(got["x"] - x).max() < 2 * 0.001


def test_decode_refuses_what_the_kernel_does_not_take():
    params = codec.block_params([0.0], [1.0], [10], [True], "cpu")
    words = torch.zeros((1, 4), dtype=torch.int32)
    mins = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        decode.decode_float_group(words, mins, params, 18, 100, "none")
    with pytest.raises(ValueError):
        decode.decode_float_group(words, mins, params, 4, 8, "philox")
    with pytest.raises(ValueError):
        decode.decode_float_group(words, mins, params, 4, 8, "uniform")
    with pytest.raises(TypeError):
        decode.decode_float_group(words.long(), mins, params, 4, 8, "none")
