"""Float columns of 2^31 pixels and more through the port on the CPU:
the encoder against ``spec`` and the JAX encoder byte for byte, the
decoder against the JAX decoder and the host reader bitwise in the three
dither modes, the plain versions of K1's launches at the top of the
64-bit range, and a minh file with a 10^10-pixel column end to end.
Tolerance zero throughout."""

import numpy as np
import pytest
import torch

from minnow_tpu.cli import text_to_minh as jax_text_to_minh
from minnow_tpu.core import dither as jax_dither
from minnow_tpu.core import spec
from minnow_tpu.formats import minh
from minnow_tpu.formats import minh_device as jax_minh_device
from minnow_tpu.parallel.pipeline import BlockEncoder as JaxBlockEncoder
from minnow_torch.cli import text_to_minh
from minnow_torch.formats import minh_device
from minnow_torch.ops import codec, encode, selfcheck, validate
from minnow_torch.parallel import pipeline
from minnow_torch.parallel.pipeline import BlockEncoder

LOW, HIGH = 0.0, 1.0e6
# name -> (pixels, periodic, largest value): the last two at 10^10 pixels
# with every pixel below 2^31 (K1's plain version certifies the blocks)
# and with pixels beyond (the host re-route)
CASES = {
    "2^31+5 periodic": ((1 << 31) + 5, True, 1e6),
    "2^33": (1 << 33, False, 1e6),
    "2^31": (1 << 31, False, 1e6),
    "1e10 periodic inside": (10 ** 10, True, 2e5),
    "1e10 periodic beyond": (10 ** 10, True, 1e6),
}
MODES = ("none", "midpoint", "uniform")


def _batch(name, shape=(4, 200)):
    pixels, periodic, top = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.uniform(0, top, shape).astype(np.float32)
    x[x >= np.float32(top)] = 0
    return x, pixels, periodic


def _assert_same_blocks(got, want):
    assert got.payloads == want.payloads
    np.testing.assert_array_equal(got.mins, want.mins)
    np.testing.assert_array_equal(got.bits, want.bits)
    np.testing.assert_array_equal(got.lens, want.lens)


@pytest.mark.parametrize("name", CASES)
def test_encode_equals_spec_and_the_jax_encoder(name):
    x, pixels, periodic = _batch(name)
    before = pipeline.HOST_BLOCKS
    got = BlockEncoder("cpu").encode_float_blocks(x, LOW, HIGH, pixels,
                                                  periodic=periodic)
    # a block goes to the host encoder for its pixels, never for its count
    sent = pipeline.HOST_BLOCKS - before
    q = spec.quantize(x, LOW, HIGH, pixels)
    assert sent == int((np.abs(q) >= 1 << 31).any(axis=1).sum())
    assert (sent > 0) == (name in ("2^33", "1e10 periodic beyond"))
    for i in range(len(x)):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i], LOW, HIGH, pixels, periodic=periodic)
        assert (got.payloads[i], got.mins[i], got.bits[i]) == (payload, mn,
                                                               bits)
    want = JaxBlockEncoder(pallas=False).encode_float_blocks(
        x, LOW, HIGH, pixels, periodic=periodic)
    _assert_same_blocks(got, want)


@pytest.mark.parametrize("name", CASES)
def test_encode_on_three_shares_equals_one(name):
    x, pixels, periodic = _batch(name)
    one = BlockEncoder("cpu").encode_float_blocks(x, LOW, HIGH, pixels,
                                                  periodic=periodic)
    three = BlockEncoder(["cpu"] * 3).encode_float_blocks(
        x, LOW, HIGH, pixels, periodic=periodic)
    _assert_same_blocks(three, one)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASES)
def test_decode_equals_the_jax_decoder_and_the_host_reader(name, mode):
    x, pixels, periodic = _batch(name)
    n = x.shape[1]
    blocks = [spec.encode_float_block(row, LOW, HIGH, pixels,
                                      periodic=periodic) for row in x]
    payloads = [b[0] for b in blocks]
    mins = np.array([b[1] for b in blocks], np.int64)
    bits = np.array([b[2] for b in blocks], np.int64)
    ids = np.arange(len(x)) + (1 << 33)
    args = (payloads, mins, bits, LOW, HIGH, pixels, n)
    kw = dict(periodic=periodic, dither=mode, seed=5, block_ids=ids)
    for devices in ("cpu", ["cpu"] * 3):
        got = BlockEncoder(devices).decode_float_blocks(*args, **kw)
        for i, (payload, mn, width, _) in enumerate(blocks):
            q = spec.decode_int_block(payload, mn, width, n)
            if periodic:
                q = spec.bound(q, 0, pixels)
            want = spec.dequantize(q, LOW, HIGH, pixels,
                                   u=jax_dither.dither_u(mode, 5,
                                                         int(ids[i]), n))
            np.testing.assert_array_equal(got[i].view(np.int32),
                                          want.view(np.int32))
    jax_got = JaxBlockEncoder(pallas=False).decode_float_blocks(*args, **kw)
    np.testing.assert_array_equal(got.view(np.int32),
                                  jax_got.view(np.int32))


@pytest.mark.parametrize("pixels", [(1 << 31) + 5, (1 << 32) - 1, 1 << 32,
                                    10 ** 10, (1 << 53) + 1,
                                    (1 << 63) - (1 << 39), (1 << 63) - 1])
def test_plain_launches_equal_spec_up_to_the_top_of_the_range(pixels):
    """The plain versions of K1's stats, plan and pack launches (and of
    K5) on periodic blocks whose window lies over the circle's seam where
    the pixels allow one, spread blocks and clusters, at counts up to
    2^63 - 1: certified, and ``spec``'s bytes."""
    rng = np.random.default_rng(pixels % 1000)
    b, n = 4, 300
    dx = spec.quantize_dx(LOW, HIGH, pixels)
    top = float(np.float32(min(pixels, 1 << 31) - 1024) * dx)
    x = rng.uniform(0, 1, (b, n)) * top
    x[0, ::2] = rng.uniform(0, 3 * dx * 100, n // 2)  # both sides of 0
    x[0, 1::2] = top - rng.uniform(0, 3 * dx * 100, n // 2)
    x[1] = top * 0.5 + rng.uniform(0, dx * 1000, n)   # a cluster
    x = x.astype(np.float32)
    lens = np.array([n, n, n - 7, 1], np.int64)
    params = codec.block_params(np.full(b, LOW), np.full(b, HIGH),
                                np.full(b, pixels), np.ones(b, bool), "cpu")
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    stats = encode.float_stats(xt, params, lt)
    plan = encode.read_plan(encode.float_plan(stats, params, lt))
    host = encode.plan_float(stats, params, lt)
    for a, c in zip(plan, host):
        np.testing.assert_array_equal(a, c)
    assert plan.valid.all()
    words = encode.pack_float(xt, params, lt, plan).numpy()
    q = torch.zeros(x.shape, dtype=torch.int32)
    encode.float_stats(xt, params, lt, q_out=q)
    np.testing.assert_array_equal(
        encode.pack_float_q(q, params, lt, plan).numpy(), words)
    for i in range(b):
        m = int(lens[i])
        payload, mn, bits, _ = spec.encode_float_block(x[i, :m], LOW, HIGH,
                                                       pixels)
        assert (int(plan.mins[i]), int(plan.bits[i])) == (mn, bits)
        assert selfcheck.payload_of(words, plan, i, m) == payload


@pytest.mark.parametrize("pixels", [(1 << 31) + 5, 10 ** 10, (1 << 62) + 3,
                                    (1 << 63) - 1])
def test_bound_and_distance_equal_spec_at_wide_counts(pixels):
    rng = np.random.default_rng(3)
    lim = min(pixels, 1 << 31)
    q = rng.integers(0, lim, 2000)
    q[:4] = (0, lim - 1, lim // 2, 1)
    for m in (0, 1, lim - 1, min(pixels - 1, (1 << 31) + 2)):
        got = codec.bound(torch.from_numpy(q), torch.tensor(m),
                          torch.tensor(pixels)).numpy()
        np.testing.assert_array_equal(got, spec.bound(q, m, pixels))
    # the decoder's wrap into [0, pixels) of values one step outside it
    far = np.concatenate([q - pixels, q, q[q < pixels - lim] + pixels])
    got = codec.bound(torch.from_numpy(far), 0, torch.tensor(pixels)).numpy()
    np.testing.assert_array_equal(got, spec.bound(far, 0, pixels))
    for x0 in (0, lim - 1, int(q[7])):
        got = codec.periodic_distance(torch.from_numpy(q), torch.tensor(x0),
                                      torch.tensor(pixels)).numpy()
        want = [spec.periodic_distance(int(v), x0, pixels) for v in q]
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() < 1 << 31  # K1 holds it in an int


def test_float_capacity_bounds_certified_widths_at_any_count():
    pixels = np.array([1, 2, 250000, (1 << 31) - 1, 1 << 31, (1 << 32) + 1,
                       (1 << 53) + 1, (1 << 53) + 2, (1 << 62) + 1,
                       (1 << 63) - 1], np.int64)
    lens = np.full(len(pixels), 100, np.int64)
    for periodic in (True, False):
        per = np.full(len(pixels), periodic)
        for i, p in enumerate(pixels):
            # a certified block: pixels below 2^31, in [0, p) if periodic
            widest = min(int(p - 1).bit_length(), 32) if periodic else 32
            got = pipeline._float_capacity(pixels[i:i + 1], per[i:i + 1],
                                           lens[i:i + 1])
            assert got >= (min(widest, 31 if periodic else 32) * 100
                           + 31) // 32
            assert got <= (32 * 100 + 31) // 32


def test_selfcheck_and_validate_hold_the_wide_counts():
    x, low, high, pixels, periodic, certified = selfcheck.wide_float_blocks(
        np.random.default_rng(1), 12, 257)
    assert pixels.min() >= 1 << 31 and periodic.any() and not periodic.all()
    q = np.stack([spec.quantize(x[i], low[i], high[i], int(pixels[i]))
                  for i in range(12)])
    np.testing.assert_array_equal(
        certified, (q >= 0).all(axis=1) & (q < 1 << 31).all(axis=1))
    assert certified.sum() == 10
    selfcheck._check_encode_wide(torch.device("cpu"))
    selfcheck._check_decode_wide(torch.device("cpu"), MODES, seed=2)
    validate._validate_wide_pixels(np.random.default_rng(2),
                                   torch.device("cpu"), 515)


def _write_wide_catalog(tmp_path, n=1000):
    """A catalog whose ``wide`` column has 10^10 pixels (0 to 1e6 at
    1e-4) with values inside 2^31 pixels, and whose ``far`` column has
    the same config with values all over it."""
    rng = np.random.default_rng(8)
    ids = np.arange(n) + (1 << 40)
    mvir = 10.0 ** rng.uniform(10, 14, n)
    xs = rng.uniform(0, 99.9, n)
    wide = rng.uniform(0, 2.0e5, n)
    far = rng.uniform(0, 999999.0, n)
    lines = ["#ID X Mvir Wide Far"]
    for i in range(n):
        lines.append("%d %.5f %.6e %.4f %.3f"
                     % (ids[i], xs[i], mvir[i], wide[i], far[i]))
    hlist = tmp_path / "hlist_1.00000.list"
    hlist.write_text("\n".join(lines) + "\n")
    (tmp_path / "names.txt").write_text(
        "id ID\nx X\nmvir Mvir\nwide Wide\nfar Far\n")
    (tmp_path / "types.txt").write_text(
        "id int\nx q_float position\nmvir q_float log 1e5 1e16 0.001\n"
        "wide q_float linear 0 1e6 1e-4\nfar q_float linear 0 1e6 1e-4\n")
    config = tmp_path / "run.config"
    config.write_text(
        "[minh]\nL = 100\nEpsilon = 0.01\nMp = 1e8\nMinParticles = 10\n"
        "MassName = mvir\nNameIndex = %s\nTypeIndex = %s\n"
        % (tmp_path / "names.txt", tmp_path / "types.txt"))
    return config, hlist


def _convert(convert_file, config, hlist, out, device):
    cfg = jax_text_to_minh.parse_config(str(config))
    idx = jax_text_to_minh.open_index(cfg["NameIndex"])
    types = jax_text_to_minh.parse_types(cfg["TypeIndex"], idx)
    wanted = jax_text_to_minh.parse_vars("all", idx)
    convert_file(cfg, idx, types, wanted, str(hlist), str(out), device,
                 block_size=20000)


@pytest.fixture(scope="module")
def wide_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("wide")
    config, hlist = _write_wide_catalog(d)
    files = {k: d / (k + ".minh") for k in ("port", "port_host", "jax")}
    _convert(text_to_minh.convert_file, config, hlist, files["port"], "cpu")
    _convert(text_to_minh.convert_file, config, hlist, files["port_host"],
             None)
    _convert(jax_text_to_minh.convert_file, config, hlist, files["jax"],
             False)
    return files


def test_minh_file_with_a_wide_column_equals_host_mode_and_the_jax_file(
        wide_file):
    port = wide_file["port"].read_bytes()
    assert port == wide_file["port_host"].read_bytes()
    assert port == wide_file["jax"].read_bytes()
    r = minh.open(str(wide_file["port"]))
    try:
        assert r.length == 1000 and r.blocks > 1
        col = r.columns[r._col("wide")]
        assert spec.float_group_pixels(col.low, col.high, col.dx) > 1 << 33
        assert max(minh_device.block_widths(r, "far")) > 32
        assert max(minh_device.block_widths(r, "wide")) <= 31
    finally:
        r.close()


@pytest.mark.parametrize("mode", MODES)
def test_read_floats_of_the_wide_column_equals_the_host_and_jax_readers(
        wide_file, mode):
    names = ["wide", "far", "x"]
    r = minh.open(str(wide_file["port"]), dither=mode, seed=4)
    try:
        got = minh_device.read_floats(r, names, "cpu")
        want = r.floats(names)
        jax_got = jax_minh_device.read_floats(r, names)
    finally:
        r.close()
    for name in names:
        assert got[name].shape == (1000,)
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      want[name].view(np.int32))
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      np.asarray(jax_got[name]).view(
                                          np.int32))
