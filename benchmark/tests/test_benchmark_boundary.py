"""The plain reference of the boundary layout (``reference/boundary.py``)
against the port's boundary writers, on hand-made points: the cells'
point lists and the whole file, byte for byte, from the port's host
``BoundaryWriter`` and from its ``DeviceBoundaryWriter`` on the CPU (the
plain versions of its kernels).  The points sit on the cases the layout
has to get right: 0 and just under the box, a cell's edge, exactly at the
ghost shell's inner limits, a corner halo in 8 cells, coordinates at and
past the box, and empty cells."""

from types import SimpleNamespace

import numpy as np
import pytest

import _paths  # noqa: F401

from minnow_torch.formats import boundary as port
from minnow_torch.formats import minh
from minnow_torch.formats.boundary_device import DeviceBoundaryWriter
from minnow_torch.parallel.pipeline import BlockEncoder

from reference import boundary, container
from reference import minh as ref

L, CELLS, BND = 250.0, 8, 5.0
DX = np.float32(L) / np.float32(CELLS)
SB = np.float32(BND) / DX
TYPES = {"id": ["int64"], "pid": ["int"], "x": ["q_float", "position"],
         "y": ["q_float", "position"], "z": ["q_float", "position"],
         "mvir": ["q_float", "log", "1e5", "1e16", "0.001"],
         "vx": ["q_float", "linear", "-10000", "10000", "0.1"]}


def scaled_to(t):
    """A float32 coordinate whose float32 quotient by the cell's width is
    exactly ``t``."""
    x = np.float32(t * DX)
    for _ in range(64):
        q = x / DX
        if q == t:
            return x
        x = np.nextafter(x, np.float32(np.inf if q < t else -np.inf))
    raise AssertionError("no float32 coordinate gives %r" % t)


ONE = np.float32(1)
EDGES = {
    "zero": np.float32(0),
    "under_box": np.nextafter(np.float32(L), np.float32(0)),
    "cell_edge": np.float32(DX),  # scaled exactly 1: cell 1, lower shell
    "inner_low": scaled_to(ONE + SB),  # cell 1, not in the lower shell
    "inner_high": scaled_to(ONE + ONE - SB),  # cell 1, in the upper shell
    "box": np.float32(L),  # wrapped: cell 0, the lower shell
    # wrapped too; past the shell, so only the upstream quirk puts it in
    # the lower shell
    "past_box": np.float32(L + 10),
}
MID = np.float32(3.5 * DX)  # the middle of cell 3, in no shell


def points():
    """``(x, y, z)`` float32: each edge case on each axis with the other
    two in the middle of a cell, a corner halo, and a few others."""
    rows = []
    for v in EDGES.values():
        rows += [(v, MID, MID), (MID, v, MID), (MID, MID, v)]
    rows += [(0.5, 0.5, 0.5), (MID, MID, MID), (249.9, 100.0, 3.0),
             (40.0, 200.0, 131.0)]
    return np.array(rows, np.float32).T


def catalog():
    """A catalog of the hand-made points: its reference description and
    the values a bulk read gives, in the configuration's column types."""
    x, y, z = points()
    n = len(x)
    rng = np.random.default_rng(3)
    values = {"id": np.arange(n, dtype=np.int64) + 3 * 10 ** 9,
              "pid": np.where(rng.random(n) < 0.5, -1,
                              3 * 10 ** 9 + rng.integers(0, n, n)),
              "x": x, "y": y, "z": z,
              # one mass under the column's low end: clamped
              "mvir": np.float32(10.0 ** rng.uniform(4, 15, n)),
              "vx": np.float32(rng.normal(0, 300, n))}
    values["mvir"][0] = np.float32(1e4)
    names = list(TYPES)
    cat = SimpleNamespace(text="#a hand-made catalog", names=names, box=L,
                          cols=[ref.Column(TYPES[n], L, 0.001)
                                for n in names])
    return cat, values


def port_file(path, cat, values, device):
    w = port.create_boundary(str(path))
    if device is not None:
        w = DeviceBoundaryWriter(w, BlockEncoder(device))
    w.header(cat.text)
    w.geometry(np.float32(L), np.float32(BND), CELLS)
    w.coordinates(values["x"], values["y"], values["z"])
    wr = w.wr if device is not None else w
    for name, col in zip(cat.names, cat.cols):
        rec = np.frombuffer(col.record(), minh.COLUMN_DTYPE)[0]
        w.column(name, minh.Column.from_record(rec), values[name])
    w.close()
    return wr.cell_index


@pytest.mark.parametrize("device", [None, "cpu"])
def test_reference_equals_the_port(tmp_path, device):
    cat, values = catalog()
    lay = boundary.Layout(values["x"], values["y"], values["z"], L, BND,
                          CELLS)
    cell_index = port_file(tmp_path / "port.bnd.minh", cat, values, device)
    assert len(cell_index) == CELLS ** 3 == len(lay.points)
    for got, want in zip(cell_index, lay.points):
        np.testing.assert_array_equal(got, want)
    want = boundary.file_bytes(cat, values, CELLS, BND)
    assert (tmp_path / "port.bnd.minh").read_bytes() == want
    # the file reads back with the port's reader: the flags as laid out
    with minh.open(str(tmp_path / "port.bnd.minh")) as r:
        assert r.names == ["boundary"] + cat.names
        assert r.block_lengths == lay.lengths
        np.testing.assert_array_equal(r.ints(["boundary"])["boundary"],
                                      np.concatenate(lay.flags))


def cells_of(lay, point):
    """``{cell: flag}`` of the cells that hold ``point``."""
    return {g: int(f[list(p).index(point)])
            for g, (p, f) in enumerate(zip(lay.points, lay.flags))
            if point in p}


def test_the_cases_by_hand():
    cat, values = catalog()
    lay = boundary.Layout(values["x"], values["y"], values["z"], L, BND,
                          CELLS)

    def g(i, j, k):
        return i + j * CELLS + k * CELLS ** 2

    # point 3 * e + axis: edge case e on that axis, the others in cell 3
    want = {"zero": {0: 0, 7: 1}, "under_box": {7: 0, 0: 1},
            "cell_edge": {1: 0, 0: 1}, "inner_low": {1: 0},
            "inner_high": {1: 0, 2: 1}, "box": {0: 0, 7: 1},
            "past_box": {0: 0, 7: 1}}
    for e, name in enumerate(EDGES):
        for a in range(3):
            got = cells_of(lay, 3 * e + a)
            at = [3, 3, 3]
            expect = {}
            for c, flag in want[name].items():
                at[a] = c
                expect[g(*at)] = flag
            assert got == expect, (name, a)
    corner = 3 * len(EDGES)
    got = cells_of(lay, corner)
    assert len(got) == 8 and sorted(got.values()) == [0] + [1] * 7
    assert got[g(0, 0, 0)] == 0 and got[g(7, 7, 7)] == 1
    assert cells_of(lay, corner + 1) == {g(3, 3, 3): 0}
    assert 0 in lay.lengths  # empty cells
    for p in lay.points:
        assert (np.diff(p) > 0).all()  # increasing index order
    assert sum(lay.lengths) == sum(len(cells_of(lay, i))
                                   for i in range(len(values["x"])))


def test_the_file_layout(tmp_path):
    cat, values = catalog()
    buf = boundary.file_bytes(cat, values, CELLS, BND)
    blocks = container.block_table(buf)
    # 8 columns of 512 groups: the flags and the id's raw groups first
    assert len(blocks) == 8 * CELLS ** 3
    assert {t for t, _, _ in blocks[:CELLS ** 3]} == {container.INT_GROUP}
    assert {b for _, _, b in blocks[CELLS ** 3:2 * CELLS ** 3]} == {None}


def test_the_reference_refuses_what_it_does_not_model():
    x = np.array([10.0, 20.0], np.float32)
    with pytest.raises(ValueError):
        boundary.Layout(x, x, x, L, BND, 2)
    with pytest.raises(ValueError):
        boundary.Layout(np.array([-40.0], np.float32), x[:1], x[:1], L, BND,
                        CELLS)
