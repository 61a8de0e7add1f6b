"""The port's host formats (``minnow_torch.core`` container,
``minnow_torch.formats.{minh,boundary,minp}``) against the JAX package's:
a file written by one package's host writer is byte-identical to the
other's, and each package reads the other's file to the same arrays in
the ``none``, ``midpoint`` and ``uniform`` dither modes.  Tolerance zero."""

import numpy as np
import pytest

import minnow_tpu
from minnow_tpu.formats import boundary as ref_boundary
from minnow_tpu.formats import minh as ref_minh
from minnow_tpu.formats import minp as ref_minp
from minnow_torch import core
from minnow_torch.formats import boundary, minh, minp

MODES = ["none", "midpoint", "uniform"]
PACKAGES = {"port": (core, minh, boundary, minp),
            "ref": (minnow_tpu, ref_minh, ref_boundary, ref_minp)}


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# -- the container ------------------------------------------------------------


def _write_container(pkg, fname, rng):
    w = pkg.create(fname)
    w.header(b"first header")
    w.int_group(300)
    for _ in range(2):
        w.data(rng.integers(-5, 1 << 40, 300))
    w.header(np.arange(4, dtype=np.int64))
    w.float_group(500, (0.0, 250.0), 0.001)
    w.data(rng.uniform(0, 250, 500).astype(np.float32))
    w.float_group(7, (-10.0, 10.0), 0.25, clamp_q=True)
    w.data(np.append(rng.uniform(-10, 10, 6), 10.0).astype(np.float32))
    w.fixed_size_group(9, 11)  # Float32Group
    w.data(rng.normal(0, 1, 11).astype(np.float32))
    w.close()


@pytest.mark.parametrize("mode", MODES)
def test_container_round_trip_across_packages(tmp_path, mode):
    files = {}
    for name, (pkg, *_) in PACKAGES.items():
        files[name] = str(tmp_path / (name + ".minnow"))
        _write_container(pkg, files[name], np.random.default_rng(1))
    with open(files["port"], "rb") as a, open(files["ref"], "rb") as b:
        assert a.read() == b.read()
    reads = []
    for name, (pkg, *_) in PACKAGES.items():
        # each package reads the file the other one wrote
        other = files["ref" if name == "port" else "port"]
        r = pkg.open(other, dither=mode, seed=4)
        reads.append(([r.header(i) for i in range(r.headers)],
                      [r.data(b) for b in range(r.blocks())]))
        r.close()
    for h0, h1 in zip(reads[0][0], reads[1][0]):
        assert bytes(h0) == bytes(h1)
    assert len(reads[0][1]) == len(reads[1][1]) == 5
    for d0, d1 in zip(*(r[1] for r in reads)):
        same_bits(d0, d1)


# -- minh -------------------------------------------------------------------


def _catalog(rng, n):
    return {"id": np.arange(n) + (1 << 40),
            "pid": np.where(rng.random(n) < 0.8, -1, rng.integers(0, n, n)),
            "x": rng.uniform(0, 100, n).astype(np.float32),
            "y": rng.uniform(0, 100, n).astype(np.float32),
            "z": rng.uniform(0, 100, n).astype(np.float32),
            "mvir": (10.0 ** rng.uniform(9, 14, n)).astype(np.float32),
            "spin": rng.normal(0, 1, n).astype(np.float32)}


def _columns(mod):
    pos = dict(type=mod.Float, low=0.0, high=100.0, dx=0.01)
    return [mod.Column(type=mod.Int64), mod.Column(type=mod.Int),
            mod.Column(**pos), mod.Column(**pos), mod.Column(**pos),
            mod.Column(type=mod.Float, log=1, low=5.0, high=16.0, dx=0.001),
            mod.Column(type=mod.Float32)]


def _write_minh(mod, fname, blocks):
    w = mod.create(fname)
    w.header(list(blocks[0]), "a catalog\nof two blocks", _columns(mod))
    w.geometry(np.float32(100.0), 0, 0)
    for data in blocks:
        w.block(list(data.values()))
    w.close()


def _read_minh(mod, fname, mode):
    r = mod.open(fname, dither=mode, seed=9)
    try:
        floats = r.floats(["x", "y", "z", "mvir", "spin"])
        ints = r.ints(["id", "pid"])
        meta = (r.names, [str(c) for c in r.columns], r.text, r.length,
                r.blocks, list(r.block_lengths), float(r.l))
    finally:
        r.close()
    return {**floats, **ints}, meta


@pytest.mark.parametrize("mode", MODES)
def test_minh_files_and_reads_across_packages(tmp_path, mode):
    rng = np.random.default_rng(2)
    blocks = [_catalog(rng, 700), _catalog(rng, 123)]
    files = {name: str(tmp_path / (name + ".minh")) for name in PACKAGES}
    for name, (_, mod, *_) in PACKAGES.items():
        _write_minh(mod, files[name], blocks)
    with open(files["port"], "rb") as a, open(files["ref"], "rb") as b:
        assert a.read() == b.read()
    got, meta = _read_minh(minh, files["ref"], mode)
    want, ref_meta = _read_minh(ref_minh, files["port"], mode)
    assert meta == ref_meta
    for name in want:
        same_bits(got[name], want[name])
    np.testing.assert_array_equal(
        got["id"], np.concatenate([b["id"] for b in blocks]))


# -- boundary -----------------------------------------------------------------


def _write_boundary(mods, fname, data):
    _, mod, bnd, _ = mods
    w = bnd.create_boundary(fname)
    w.header("boundary layout")
    w.geometry(np.float32(100.0), np.float32(5.0), 2)
    w.coordinates(data["x"], data["y"], data["z"])
    for (name, x), col in zip(data.items(), _columns(mod)):
        w.column(name, col, x)
    w.close()


@pytest.mark.parametrize("mode", MODES)
def test_boundary_files_and_reads_across_packages(tmp_path, mode):
    data = _catalog(np.random.default_rng(3), 400)
    files = {name: str(tmp_path / (name + ".bnd.minh")) for name in PACKAGES}
    for name, mods in PACKAGES.items():
        _write_boundary(mods, files[name], data)
    with open(files["port"], "rb") as a, open(files["ref"], "rb") as b:
        assert a.read() == b.read()
    reads = []
    for name, (_, mod, *_) in PACKAGES.items():
        r = mod.open(files["ref" if name == "port" else "port"], dither=mode,
                     seed=2)
        try:
            assert r.file_type and r.cells == 2 and r.blocks == 8
            cols = {n: (r.floats([n])[n]
                        if c.type in (mod.Float, mod.Float32)
                        else r.ints([n])[n])
                    for n, c in zip(r.names, r.columns)}
            reads.append((cols, list(r.block_lengths)))
        finally:
            r.close()
    assert reads[0][1] == reads[1][1] and sum(reads[0][1]) > 400
    assert list(reads[0][0]) == list(reads[1][0]) \
        == ["boundary"] + list(data)
    for name in reads[0][0]:
        same_bits(reads[0][0][name], reads[1][0][name])


# -- minp -------------------------------------------------------------------


def _write_minp(mod, fname, vec, periodic):
    hd = mod.Header(z=0.5, scale=2 / 3, omega_m=0.3, omega_l=0.7, h100=0.7,
                    l=100.0, n_side=8, n_total=512)
    w = mod.Writer(fname)
    w.header(hd, b"raw header", mod.Cell(0, 1, 2),
             0.01 if periodic else 0.5, periodic)
    w.vectors(vec)
    w.close()


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_minp_files_and_reads_across_packages(tmp_path, mode, periodic):
    rng = np.random.default_rng(4)
    vec = (rng.uniform(0, 100, (512, 3)) if periodic
           else rng.normal(0, 300, (512, 3))).astype(np.float32)
    files = {name: str(tmp_path / (name + ".minp")) for name in PACKAGES}
    for name, (*_, mod) in PACKAGES.items():
        _write_minp(mod, files[name], vec, periodic)
    with open(files["port"], "rb") as a, open(files["ref"], "rb") as b:
        assert a.read() == b.read()
    reads = []
    for name, (*_, mod) in PACKAGES.items():
        r = mod.open(files["ref" if name == "port" else "port"], dither=mode,
                     seed=6)
        try:
            reads.append((r.vectors(), r.header, r.cell, r.raw_header,
                          r.periodic))
        finally:
            r.close()
    same_bits(reads[0][0], reads[1][0])
    assert reads[0][0].shape == (512, 3)
    assert vars(reads[0][1]) == vars(reads[1][1])
    assert vars(reads[0][2]) == vars(reads[1][2])
    assert reads[0][3:] == reads[1][3:]
    step = 0.01 if periodic else 0.5
    assert np.abs(reads[0][0] - vec).max() < 2 * step


@pytest.mark.parametrize("sub_cells", [1, 2, 4])
def test_minp_sub_cell_layout(sub_cells):
    vec = np.arange(8 ** 3 * 3, dtype=np.float32).reshape(-1, 3)
    got = minp.split_sub_cells(vec, sub_cells)
    np.testing.assert_array_equal(got,
                                  ref_minp.split_sub_cells(vec, sub_cells))
    np.testing.assert_array_equal(minp.join_sub_cells(got, sub_cells), vec)
    cell = minp.Cell(3, 2, sub_cells)
    np.testing.assert_array_equal(
        minp.lagrangian_ids(cell, 16),
        ref_minp.lagrangian_ids(ref_minp.Cell(3, 2, sub_cells), 16))
