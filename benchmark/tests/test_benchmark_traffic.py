"""The traffic generators give the same inputs for the same seed and
other inputs for another; the roofline's bytes on hand-worked shapes; the
closed loop's reservoir keeps a uniform sample."""

import os

import numpy as np
import torch

import _paths  # noqa: F401  (the benchmark on sys.path)

from harness import cell, roofline
from traffic import catalog, closed_loop, snapshot

SPEC = cell.spec()


def _catalog(tmp_path, seed, rows=2000):
    cfg = dict(cell.config(SPEC, "minh_L250"), rows=rows)
    d = tmp_path / ("c%d_%d" % (seed, len(os.listdir(tmp_path))))
    d.mkdir()
    with open(catalog.write(str(d), cfg, seed), "rb") as f:
        return f.read()


def test_catalog_deterministic(tmp_path):
    a, b = _catalog(tmp_path, 3), _catalog(tmp_path, 3)
    assert a == b
    assert a != _catalog(tmp_path, 4)
    big = 2 ** 31 + 12345
    assert _catalog(tmp_path, big) == _catalog(tmp_path, big)


def test_catalog_text_is_printf():
    """Each field as ``printf`` prints the same decimal."""
    units = torch.tensor([0, 5, -5, 123456789, -99999999, 250 * 10 ** 5 - 1])
    for decimals in (0, 2, 3, 5, 6):
        u = units if decimals else units * 7
        got = bytes(catalog.text([catalog.fixed(u, decimals)])).split()
        want = [("%.*f" % (decimals, v / 10 ** decimals)).encode()
                if decimals else b"%d" % v for v in u.tolist()]
        assert got == want
    for d, m, e, neg in ((5, [100000, 999999, 154975], [9, 15, -3],
                          [False, True, False]),
                         (3, [1000, 9999], [12, -1], [True, False])):
        got = bytes(catalog.text([catalog.scientific(
            torch.tensor(m), torch.tensor(e), d, torch.tensor(neg))])).split()
        assert got == [b"%.*e" % (d, (-1) ** n * a * 10.0 ** (b - d))
                       for a, b, n in zip(m, e, neg)]


def test_catalog_values_round_trip():
    """``to_fixed`` and ``to_scientific`` print what ``%f`` and ``%e``
    print, powers of ten and their neighbours included."""
    x = torch.tensor([1e9, 9.99999499e9, 9.9999951e9, 7748750000.0,
                      -1.234567e12, 3.0, 0.000123456], dtype=torch.float64)
    for d in (5, 3):
        m, e, neg = catalog.to_scientific(x, d)
        got = bytes(catalog.text([catalog.scientific(m, e, d, neg)])).split()
        assert got == [b"%.*e" % (d, v) for v in x.tolist()]
    y = torch.tensor([0.5, 249.999994, 1.25, 2.0 / 3.0], dtype=torch.float64)
    got = bytes(catalog.text([catalog.fixed(catalog.to_fixed(y, 5), 5)]))
    assert got.split() == [b"%.5f" % v for v in y.tolist()]


def test_catalog_is_a_consistent_trees_hlist(tmp_path):
    """60 columns, each row one field a column; masses are whole particle
    counts of Mp, from the 20 particles of Rockstar's smallest halo, and
    most fall under the cut."""
    cfg = dict(cell.config(SPEC, "minh_L250"), rows=20000)
    d = tmp_path / "c"
    d.mkdir()
    with open(catalog.write(str(d), cfg, 5), "rb") as f:
        lines = f.read().split(b"\n")
    head = [ln for ln in lines if ln.startswith(b"#")]
    rows = [ln.split(b" ") for ln in lines if ln and not ln.startswith(b"#")]
    assert len(catalog.NAMES) == 60 and b"(0)" in head[0]
    assert len(rows) == 20000 and {len(r) for r in rows} == {60}
    assert sum(len(ln) + 1 for ln in lines if ln and ln[:1] != b"#") > 450 * 20000
    mvir = np.array([float(r[catalog.NAMES.index("mvir")]) for r in rows])
    n = mvir / cfg["Mp"]
    assert n.min() >= 19.99
    cut = np.float32(cfg["Mp"] * cfg["min_particles"])
    below = (mvir.astype(np.float32) <= cut).mean()
    assert 0.5 < below < 0.62
    ids = [int(r[1]) for r in rows]
    assert ids == list(range(cfg["catalog"]["id0"], cfg["catalog"]["id0"]
                             + 20000))
    index = (d / "names.txt").read_text().split("\n")
    assert len([ln for ln in index if ln]) == 60
    assert (d / "vars.txt").read_text().split() == list(cfg["types"])


def test_snapshot_deterministic(tmp_path):
    cfg = dict(cell.config(SPEC, "minp_L250"), n_side=32)
    x1, v1 = snapshot.make(cfg, 9)
    x2, v2 = snapshot.make(cfg, 9)
    assert np.array_equal(x1, x2) and np.array_equal(v1, v2)
    x3, _ = snapshot.make(cfg, 10)
    assert not np.array_equal(x1, x3)
    box = np.float32(cfg["L"])
    assert (x1 >= 0).all() and (x1 < box).all()
    files = []
    for k in range(2):
        d = tmp_path / str(k)
        d.mkdir()
        snapshot.write_gadget(str(d), cfg, x1, v1, 9)
        files.append({n: (d / n).read_bytes() for n in os.listdir(d)})
    assert files[0] == files[1]
    assert len(files[0]) == cfg["snapshot"]["files"]


def test_roofline_bytes():
    # 100 values at 13 bits: 163 packed bytes; 4-byte floats
    assert roofline.decode_bytes([(100, 13, 4)]) == 163 + 400
    assert roofline.encode_bytes([(100, 13, 4), (8, 0, 8)]) == 563 + 64
    assert roofline.packed(32768, 14) == 57344
    assert abs(roofline.bound(3.35e9) - 1e-3) < 1e-15


class _Counting:
    def __init__(self):
        self.dropped = []

    def request(self, i):
        return 1, i

    def drop(self, out):
        self.dropped.append(out)


def test_closed_loop_counts_and_samples():
    wl = _Counting()
    mix = {"callers": 1, "sample": 3}
    records, kept, start, end = closed_loop.run(wl, 0.05, mix, 5)
    assert len(kept) == 3 and len(records) > 3
    kept_ids = {out for _, out in kept}
    assert kept_ids.isdisjoint(wl.dropped)
    assert kept_ids | set(wl.dropped) == set(range(len(records)))
    assert end >= start and all(r["error"] is None for r in records)
    again = closed_loop.run(_Counting(), 0.05, dict(mix, callers=3), 5)
    assert len(again[1]) == 3
