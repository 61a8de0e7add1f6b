"""The boundary layout's cell table on the device route, in its plain
version (``ops/cells.py`` beside ``csrc/cells.cu``), against the JAX
package's host writer (``minnow_tpu/formats/boundary.py``): the rows of
every cell, their flags, and the files ``DeviceBoundaryWriter`` writes
through ``BlockEncoder("cpu")``, byte for byte.  The halos are placed by hand where the arithmetic has
its edges: on cell faces, exactly on the shells' edges, at x = l (the
wrap), beyond l, just below 0, in corners whose eight slots are all
used, and with shells wider than half a cell, where the lower shell
wins.  A halo outside the box raises on the device route, where host
mode misfiles it.  On the CPU no table counts as a launch."""

import numpy as np
import pytest
import torch

from minnow_tpu.formats import boundary as ref_boundary
from minnow_tpu.formats import minh as ref_minh
from minnow_torch.formats import boundary, minh
from minnow_torch.formats.boundary_device import DeviceBoundaryWriter
from minnow_torch.ops import cells
from minnow_torch.parallel.pipeline import BlockEncoder

L = 250.0
CELLS = [1, 2, 4, 5, 8]
# the boundary cell's shells, and shells wider than half of an 8^3 cell
BOUNDARIES = [5.0, 0.6 * L / 8]


def on_shells(cells_, bnd):
    """Coordinates whose quotient by dx is exactly a shell's edge in
    float32, i + sb or (i + 1) - sb, in every cell."""
    dx, _, sb = cells.scalars(L, bnd, cells_)
    out = []
    for i in range(cells_):
        for edge in (np.float32(i) + sb, np.float32(i + 1) - sb):
            c = np.float32(edge * dx)
            out += [v for v in (np.nextafter(c, np.float32(0)), c,
                                np.nextafter(c, np.float32(L)))
                    if np.float32(v / dx) == edge]
    assert len(out) >= cells_  # each cell has an edge that is exact
    return np.array(out, np.float32)


def halos(cells_, bnd=5.0, seed=7, n=400):
    """Uniform halos and hand-placed ones: on every face and corner of
    the cells, within a tenth of a cell of a corner (every slot used where
    the shells reach), exactly on the shells' edges, at l and beyond it,
    and just below 0."""
    rng = np.random.default_rng(seed)
    dx = np.float32(L) / np.float32(cells_)
    corner = rng.integers(0, cells_ + 1, (64, 3)) * dx
    edges = on_shells(cells_, bnd)
    pts = np.concatenate([
        rng.uniform(0, L, (n, 3)),
        corner,
        corner + rng.uniform(-0.1, 0.1, (64, 3)) * dx,
        np.stack([edges, rng.uniform(0, L, len(edges)), edges[::-1]], 1),
        [[L, L, L], [L, 0, 0], [0, 0, 0], [-0.5 * dx, 0.25, L],
         [1.5 * L, 1.99 * L, 0.0], [L / 2, np.nextafter(L, 0), 1e-30]],
    ]).astype(np.float32)
    return pts[:, 0].copy(), pts[:, 1].copy(), pts[:, 2].copy()


def host_table(x, y, z, bnd, cells_, tmp_path, monkeypatch):
    """The JAX package's host ``cell_index`` and flag lists."""
    seen = []
    real = ref_boundary.BoundaryWriter._boundary_column

    def spy(self, flag_lists):
        seen.append([f.copy() for f in flag_lists])
        real(self, flag_lists)

    monkeypatch.setattr(ref_boundary.BoundaryWriter, "_boundary_column",
                        spy)
    w = ref_boundary.create_boundary(str(tmp_path / "host.bnd.minh"))
    w.geometry(L, bnd, cells_)
    w.coordinates(x, y, z)
    w.close()
    return w.cell_index, seen[0]


@pytest.mark.parametrize("bnd", BOUNDARIES)
@pytest.mark.parametrize("cells_", CELLS)
def test_plain_table_equals_host_mode(cells_, bnd, tmp_path, monkeypatch):
    x, y, z = halos(cells_, bnd)
    want_index, want_flags = host_table(x, y, z, bnd, cells_, tmp_path,
                                        monkeypatch)
    before = cells.CELLS_LAUNCHES
    t = cells.build(*(torch.from_numpy(a) for a in (x, y, z)), L, bnd,
                    cells_)
    assert cells.CELLS_LAUNCHES == before  # the plain version launches none
    assert t.perm.dtype == torch.int64 and t.flags.dtype == torch.int8
    assert t.offsets.tolist() == t.host_offsets.tolist()
    splits = t.host_offsets[1:-1]
    got_index = np.split(t.perm.numpy(), splits)
    got_flags = np.split(t.flags.numpy(), splits)
    assert len(got_index) == len(want_index) == cells_ ** 3
    for g, w in zip(got_index, want_index):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_flags, want_flags):
        np.testing.assert_array_equal(g, w)
    # corners whose eight slots are all used, ghosts of one point in one
    # cell at cells = 1
    assert np.bincount(t.perm.numpy()).max() == 8


def test_wide_shells_take_the_lower_shell():
    """A shell wider than half a cell: a halo in the middle of a cell lies
    in both shells of its axis, and the lower one (region -1) wins."""
    dx = np.float32(L) / np.float32(8)
    x = np.array([dx * 2.5], np.float32)
    y = z = np.array([dx * 4.5], np.float32)
    t = cells.build(*(torch.from_numpy(a) for a in (x, y, z)), L, 0.6 * dx,
                    8)
    rows = np.repeat(np.arange(512), np.diff(t.host_offsets))
    # host cell (2, 4, 4); the ghosts one cell lower on each axis
    want = sorted({a + 8 * (b + 8 * c) for a in (2, 1) for b in (4, 3)
                   for c in (4, 3)})
    assert rows.tolist() == want
    assert t.flags.tolist() == [0 if r == 2 + 8 * (4 + 8 * 4) else 1
                                for r in want]


def write_file(path, x, y, z, bnd, cells_, device):
    """A boundary file of the halos with an Int, a log and a linear Float,
    a periodic position, a raw Int64 and a raw Float32 column: by the
    port's ``DeviceBoundaryWriter`` on ``device``, or where that is None
    by the JAX package's host writer."""
    rng = np.random.default_rng(3)
    n = len(x)
    if device is None:
        w, fmt = ref_boundary.create_boundary(str(path)), ref_minh
    else:
        w = DeviceBoundaryWriter(boundary.create_boundary(str(path)),
                                 BlockEncoder(device))
        fmt = minh
    w.header("hand-placed halos")
    w.geometry(L, bnd, cells_)
    w.coordinates(x, y, z)
    cols = [("id", fmt.Column(type=fmt.Int),
             (1 << 53) + 1 + np.arange(n, dtype=np.int64) * 3),
            ("mvir", fmt.Column(type=fmt.Float, log=1, low=9, high=16,
                                dx=0.001),
             np.float32(10.0 ** rng.uniform(9, 15, n))),
            ("vx", fmt.Column(type=fmt.Float, low=-1000, high=1000, dx=0.1),
             rng.uniform(-900, 900, n).astype(np.float32)),
            ("x", fmt.Column(type=fmt.Float, low=0, high=L, dx=0.001), x),
            ("upid", fmt.Column(type=fmt.Int64),
             rng.integers(-(1 << 62), 1 << 62, n)),
            ("weird", fmt.Column(type=fmt.Float32),
             rng.uniform(-1, 1, n).astype(np.float32))]
    for name, col, v in cols:
        w.column(name, col, v)
    w.close()
    return (w.wr if device is not None else w).cell_index


@pytest.mark.parametrize("cells_", CELLS)
def test_device_writer_equals_host_mode(cells_, tmp_path):
    x, y, z = halos(cells_, seed=cells_)
    before = cells.CELLS_LAUNCHES
    got = write_file(tmp_path / "dev.bnd.minh", x, y, z, 5.0, cells_, "cpu")
    assert cells.CELLS_LAUNCHES == before  # nothing launched on the CPU
    want = write_file(tmp_path / "host.bnd.minh", x, y, z, 5.0, cells_, None)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert (tmp_path / "dev.bnd.minh").read_bytes() \
        == (tmp_path / "host.bnd.minh").read_bytes()


def test_gather_index_lays_out_the_cells_with_zeros(tmp_path):
    x, y, z = halos(4)
    t = cells.build(*(torch.from_numpy(a) for a in (x, y, z)), L, 5.0, 4)
    index = cells.gather_index(t, len(x))
    lens = np.diff(t.host_offsets)
    assert index.shape == (64, lens.max())
    col = torch.arange(1, len(x) + 2, dtype=torch.int64)
    col[-1] = 0
    batch = torch.take(col, index).numpy()
    for r, idx in enumerate(np.split(t.perm.numpy(), t.host_offsets[1:-1])):
        np.testing.assert_array_equal(batch[r, :len(idx)], idx + 1)
        assert not batch[r, len(idx):].any()


def test_no_halos_give_empty_cells(tmp_path):
    empty = torch.zeros(0, dtype=torch.float32)
    t = cells.build(empty, empty, empty, L, 5.0, 2)
    assert t.perm.numel() == 0 and t.host_offsets.tolist() == [0] * 9
    assert cells.gather_index(t, 0).shape == (8, 1)


@pytest.mark.parametrize("where", ["below -dx", "at -dx", "at 2 l", "far",
                                   "NaN"])
def test_a_halo_outside_the_box_raises(where, tmp_path):
    x, y, z = halos(8)
    dx = np.float32(L) / np.float32(8)
    y[5] = {"below -dx": -1.01 * dx, "at -dx": -dx, "at 2 l": 2 * L,
            "far": 1e30, "NaN": np.nan}[where]
    with pytest.raises(ValueError, match="outside the box"):
        cells.build(*(torch.from_numpy(a) for a in (x, y, z)), L, 5.0, 8)
    w = DeviceBoundaryWriter(
        boundary.create_boundary(str(tmp_path / "out.bnd.minh")),
        BlockEncoder("cpu"))
    w.geometry(L, 5.0, 8)
    with pytest.raises(ValueError, match="outside the box"):
        w.coordinates(x, y, z)


def test_device_writer_refuses_a_column_of_another_length(tmp_path):
    x, y, z = halos(2)
    w = DeviceBoundaryWriter(
        boundary.create_boundary(str(tmp_path / "out.bnd.minh")),
        BlockEncoder("cpu"))
    w.geometry(L, 5.0, 2)
    w.coordinates(x, y, z)
    with pytest.raises(ValueError, match="a column of"):
        w.column("vx", minh.Column(type=minh.Float, low=-1, high=1, dx=0.1),
                 np.zeros(len(x) - 1, np.float32))


def test_build_refuses_what_it_does_not_take():
    good = torch.zeros(3, dtype=torch.float32)
    with pytest.raises(TypeError):
        cells.build(good.double(), good, good, L, 5.0, 2)
    with pytest.raises(ValueError):
        cells.build(good, good[:2], good, L, 5.0, 2)
    with pytest.raises(ValueError):
        cells.build(good, good, good, L, 5.0, 0)
