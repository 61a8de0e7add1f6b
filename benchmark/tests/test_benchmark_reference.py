"""The benchmark's plain reference against the port's host mode at small
sizes: the codec's arithmetic at every width, whole minh and minp files
byte for byte, and the values their reads give."""

import os

import numpy as np
import pytest

import _paths  # noqa: F401  (the benchmark on sys.path)

from harness import cell
from minnow_torch.cli import convert_snapshot, text_to_minh
from minnow_torch.core import dither, gomath, spec
from minnow_torch.formats import minh, minp
from minnow_torch.utils.name_index import open_index
from reference import codec, container
from reference import minh as rminh
from reference import minp as rminp
from traffic import catalog, snapshot

SPEC = cell.spec()


def small_catalog(rows=3000):
    cfg = cell.config(SPEC, "minh_L250")
    cfg["rows"] = rows
    return cfg


def small_snapshot(n_side=32):
    return dict(cell.config(SPEC, "minp_L250"), n_side=n_side)


@pytest.mark.parametrize("bits", range(65))
def test_pack_rows_every_width(bits):
    rng = np.random.default_rng(bits)
    for n in (1, 7, 63, 64, 65, 200):
        x = rng.integers(0, 2 ** 63, (3, n), dtype=np.uint64) * np.uint64(
            2) + np.uint64(1)
        got = codec.pack_rows(x, bits)
        for r in range(3):
            assert got[r].tobytes() == spec.pack_bits(x[r], bits)


def test_int_rows_and_widths():
    rng = np.random.default_rng(1)
    x = rng.integers(-2 ** 62, 2 ** 62, (4, 100))
    x[1] = 5
    x[2, :50] = np.iinfo(np.int64).min
    x[2, 50:] = np.iinfo(np.int64).max
    mins, bits, deltas = codec.encode_int_rows(x)
    for r in range(4):
        payload, mn, b = spec.encode_int_block(x[r])
        assert (mn, b) == (mins[r], bits[r])
        assert codec.payloads(deltas, bits)[r] == payload


def test_float_rows_against_spec():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 250, (6, 500)).astype(np.float32)
    x[1] = rng.uniform(249.9, 250, 500)  # wraps
    x[2] = np.nextafter(np.float32(250), np.float32(0))  # q may reach P
    x[3, ::2] = 0.0
    x[4] = rng.uniform(100, 100.5, 500)
    p = codec.float_group_pixels(0.0, 250.0, 0.001)
    assert p == spec.float_group_pixels(0.0, 250.0, 0.001)
    for clamp in (False, True):
        mins, bits, deltas, q = codec.encode_float_rows(x, 0.0, 250.0, p,
                                                        clamp)
        pay = codec.payloads(deltas, bits)
        for r in range(6):
            want = spec.encode_float_block(x[r], 0.0, 250.0, p, True, clamp)
            assert (pay[r], mins[r], bits[r]) == want[:3]
            assert np.array_equal(q[r], want[3])


def test_periodic_scan_outside_the_range():
    rng = np.random.default_rng(3)
    for _ in range(20):
        q = rng.integers(-50, 1100, 40)
        assert codec.periodic_min_scan(q, 1000) == spec.periodic_min(q, 1000)


def test_log10_is_gos():
    rng = np.random.default_rng(4)
    x = (10.0 ** rng.uniform(-3, 17, 20000)).astype(np.float32)
    x[:64] = 2.0 ** np.arange(-32, 32)
    want = gomath.log10(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(codec.log10_f32(x).view(np.uint32),
                          want.view(np.uint32))


def test_uniform_dither():
    for seed in (0, 7, 2 ** 40 + 3):
        got = codec.dither_u(seed, [0, 5, 1535], 300)
        for r, b in enumerate((0, 5, 1535)):
            want = dither.dither_u(dither.UNIFORM, seed, b, 300)
            assert np.array_equal(got[r], want)


def test_bfloat16_is_torchs():
    import torch

    rng = np.random.default_rng(5)
    x = (rng.standard_normal(10000) * 10.0 ** rng.uniform(-30, 30, 10000)
         ).astype(np.float32)
    x[:3] = [1.00390625, 1.01171875, -2.5]  # a tie to even, a tie up
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(codec.bfloat16(x).view(np.uint32),
                          want.view(np.uint32))


def _host_minh(cfg, tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    hlist = catalog.write(str(d), cfg, 11)
    pcfg = text_to_minh.parse_config(str(d / "run.config"))
    idx = open_index(pcfg["NameIndex"])
    out = str(tmp_path / "host.minh")
    text_to_minh.convert_file(pcfg, idx,
                              text_to_minh.parse_types(pcfg["TypeIndex"],
                                                       idx),
                              text_to_minh.parse_vars(str(d / "vars.txt"),
                                                      idx), hlist,
                              out)
    return hlist, out


def test_minh_file_and_read(tmp_path):
    cfg = small_catalog()
    hlist, out = _host_minh(cfg, tmp_path)
    cat = rminh.Catalog(hlist, cfg)
    with open(out, "rb") as f:
        assert f.read() == cat.file_bytes()
    r = minh.Reader(out)
    want = cat.decoded(0)
    floats = [n for n, t in cfg["types"].items() if t[0] == "q_float"]
    got = r.floats(floats)
    got.update(r.ints([n for n in want if n not in floats]))
    r.close()
    for n in want:
        assert got[n].dtype == want[n].dtype
        assert np.array_equal(got[n].view(np.uint8), want[n].view(np.uint8))
    assert 0.38 * 3000 < cat.rows < 0.5 * 3000


def test_block_table(tmp_path):
    _, out = _host_minh(small_catalog(500), tmp_path)
    r = minh.Reader(out)
    with open(out, "rb") as f:
        table = container.block_table(f.read())
    assert len(table) == r.f.blocks()
    for b, (gtype, n, bits) in enumerate(table):
        assert gtype == r.f.data_type(b) and n == r.f.data_len(b)
        if bits is not None:
            assert bits == r.f.raw_block(b)[2]
    r.close()


def test_minp_fileset_and_read(tmp_path):
    cfg = small_snapshot()
    x, v = snapshot.make(cfg, 5)
    gadget = tmp_path / "gadget"
    gadget.mkdir()
    snapshot.write_gadget(str(gadget), cfg, x, v, 5)
    out = tmp_path / "out"
    out.mkdir()
    convert_snapshot.to_minp(str(gadget), str(out), 1, cfg["sub_cells"],
                             cfg["dx"], cfg["dv"])
    hd, raws, xr, vr = rminp.rebin(str(gadget))
    assert np.array_equal(xr, x) and np.array_equal(vr, v)
    files = rminp.fileset(xr, vr, hd, raws, 1, cfg["sub_cells"], cfg["dx"],
                          cfg["dv"])
    assert sorted(files) == sorted(os.listdir(out))
    for name, cf in files.items():
        with open(out / name, "rb") as f:
            assert f.read() == cf.file_bytes(), name
        r = minp.Reader(str(out / name))
        assert np.array_equal(r.vectors().view(np.uint32),
                              cf.decoded(0).view(np.uint32))
        r.close()


def test_minp_file_cells(tmp_path):
    """Two file cells a side: the re-binning's cells and the raw headers
    of each file as the host converter writes them."""
    cfg = dict(small_snapshot(), sub_cells=4)
    x, v = snapshot.make(cfg, 6)
    gadget = tmp_path / "gadget"
    gadget.mkdir()
    snapshot.write_gadget(str(gadget), cfg, x, v, 6)
    out = tmp_path / "out"
    out.mkdir()
    convert_snapshot.to_minp(str(gadget), str(out), 2, 4, 0.001, 1.0)
    hd, raws, xr, vr = rminp.rebin(str(gadget))
    files = rminp.fileset(xr, vr, hd, raws, 2, 4, 0.001, 1.0)
    assert len(files) == 16 == len(os.listdir(out))
    for name, cf in files.items():
        with open(out / name, "rb") as f:
            assert f.read() == cf.file_bytes(), name
