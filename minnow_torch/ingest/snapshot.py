"""Snapshot abstraction: uniform access to multi-file N-body snapshots
(ref go/minp/snapshot/snapshot.go, grid.go, mock.go, minp.go).

``Snapshot`` is the interface the converters consume; backends:
LGadget-2 binary files (lgadget2.py), an existing minp fileset
(``MinPSnapshot``), and an in-memory mock for tests (``MockSnapshot`` --
the reference's fake-backend pattern, ref go/minp/snapshot/mock.go).

``Grid`` re-bins any snapshot into Lagrangian-contiguous cubic file-cells
by decoding particle IDs (ref go/minp/snapshot/grid.go) -- here a single
vectorized scatter instead of per-particle loops.  The reference's Grid
has two real bugs (lazy-init never fires; ReadV returns the x grid --
SURVEY App. B #2) which are fixed, not replicated.

The port's own copy of ``minnow_tpu/ingest/snapshot.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

import abc
import os

import numpy as np

from ..formats import minp as minp_fmt
from ..utils import profiling

# rho_critical(z=0) in (Msun/h) / (Mpc/h)^3 (h-free comoving units), the
# standard 3 H0^2 / (8 pi G) constant used by nbody-utils
# (ref go/minp/snapshot/snapshot.go:30-34).
RHO_CRIT_0 = 2.77536627e11


def rho_average(omega_m: float) -> float:
    """Mean comoving matter density in (Msun/h)/(Mpc/h)^3."""
    return omega_m * RHO_CRIT_0


def calc_uniform_mass(hd: minp_fmt.Header) -> None:
    """UniformMp = rho_mean * L^3 / NTotal
    (ref go/minp/snapshot/snapshot.go:30-34)."""
    m_tot = (hd.l ** 3) * rho_average(hd.omega_m)
    hd.uniform_mp = m_tot / hd.n_total


class Snapshot(abc.ABC):
    """(ref go/minp/snapshot/snapshot.go:14-27)"""

    @abc.abstractmethod
    def files(self) -> int: ...

    @abc.abstractmethod
    def header(self) -> minp_fmt.Header: ...

    @abc.abstractmethod
    def raw_header(self, i: int) -> bytes: ...

    @abc.abstractmethod
    def update_header(self, hd: minp_fmt.Header) -> None: ...

    @abc.abstractmethod
    def uniform_mass(self) -> bool: ...

    @abc.abstractmethod
    def read_x(self, i: int) -> np.ndarray: ...

    @abc.abstractmethod
    def read_v(self, i: int) -> np.ndarray: ...

    @abc.abstractmethod
    def read_id(self, i: int) -> np.ndarray: ...

    def read_mp(self, i: int) -> np.ndarray:
        n = len(self.read_id(i))
        return np.full(n, np.float32(self.header().uniform_mp), np.float32)


class MockSnapshot(Snapshot):
    """In-memory fake backend (ref go/minp/snapshot/mock.go)."""

    def __init__(self, hd: minp_fmt.Header, x, v, ids):
        self.hd = hd
        self.x = [np.asarray(a, np.float32) for a in x]
        self.v = [np.asarray(a, np.float32) for a in v]
        self.ids = [np.asarray(a, np.int64) for a in ids]

    def files(self):
        return len(self.x)

    def header(self):
        return self.hd

    def raw_header(self, i):
        return b"\x63"

    def update_header(self, hd):
        self.hd = hd

    def uniform_mass(self):
        return True

    def read_x(self, i):
        return self.x[i]

    def read_v(self, i):
        return self.v[i]

    def read_id(self, i):
        return self.ids[i]


class Grid(Snapshot):
    """Lagrangian re-binning of a snapshot into cells**3 cubic file-cells
    (ref go/minp/snapshot/grid.go:12-103, bugs fixed)."""

    def __init__(self, snap: Snapshot, cells: int):
        if not snap.uniform_mass():
            raise ValueError("snapshot.Grid requires uniform particle mass")
        hd = snap.header()
        if hd.n_side % cells != 0:
            raise ValueError(
                "Snapshot has NSide = %d, but %d cells were requested."
                % (hd.n_side, cells))
        self.snap = snap
        self.cells = cells
        self.hd = hd
        self._x = None
        self._v = None

    def files(self):
        return self.cells ** 3

    def header(self):
        return self.snap.header()

    def raw_header(self, i):
        # grid cells can outnumber the source files; raw headers are
        # per-simulation constants, so clamp to an existing file
        return self.snap.raw_header(min(i, self.snap.files() - 1))

    def update_header(self, hd):
        self.snap.update_header(hd)

    def uniform_mass(self):
        return self.snap.uniform_mass()

    def _cell_index(self, ids):
        """(cell, within-cell) indices of Lagrangian ids
        (ref go/minp/snapshot/grid.go:118-137) -- vectorized."""
        n_all = self.hd.n_side
        n_side = n_all // self.cells  # elements per cell side
        ids = np.asarray(ids, np.int64)
        if ids.min() < 0 or ids.max() >= n_all ** 3:
            raise ValueError("ID out of range for NSide=%d" % n_all)
        idx = ids % n_all
        idy = (ids // n_all) % n_all
        idz = ids // (n_all * n_all)
        ix, iy, iz = idx % n_side, idy % n_side, idz % n_side
        i = ix + iy * n_side + iz * n_side * n_side
        cx, cy, cz = idx // n_side, idy // n_side, idz // n_side
        c = cx + cy * self.cells + cz * self.cells * self.cells
        return c, i

    def _build(self, read):
        n_file = self.hd.n_side // self.cells
        grid = np.zeros((self.cells ** 3, n_file ** 3, 3), np.float32)
        for f in range(self.snap.files()):
            vec = np.asarray(read(f), np.float32)
            ids = np.asarray(self.snap.read_id(f), np.int64)
            with profiling.span("grid.cell_index"):
                c, i = self._cell_index(ids - 1)  # ids are 1-based
            with profiling.span("grid.scatter", vec.nbytes):
                grid[c, i] = vec
        return grid

    def read_x(self, i):
        if self._x is None:
            self._x = self._build(self.snap.read_x)
        return self._x[i]

    def read_v(self, i):
        if self._v is None:
            self._v = self._build(self.snap.read_v)
        return self._v[i]

    def read_id(self, idx):
        n_side = self.hd.n_side
        cell = minp_fmt.Cell(idx, self.cells,
                             1)  # sub_cells unused for ids
        return minp_fmt.lagrangian_ids(cell, int(n_side))


class MinPSnapshot(Snapshot):
    """Read an existing minp fileset through the Snapshot interface
    (ref go/minp/snapshot/minp.go:10-88)."""

    def __init__(self, dirname: str, file_fmt: str):
        self.dir = dirname
        self.file_fmt = file_fmt
        f0 = minp_fmt.open(self._fname("x", 0))
        self.file_cells = f0.file_cells
        self.raw_hd = f0.raw_header
        self.hd = f0.header
        f0.close()

    def _fname(self, v: str, i: int) -> str:
        return os.path.join(self.dir, self.file_fmt % (v, i))

    def files(self):
        return self.file_cells ** 3

    def header(self):
        return self.hd

    def raw_header(self, i):
        return self.raw_hd

    def update_header(self, hd):
        self.hd = hd

    def uniform_mass(self):
        return True

    def _read(self, v, i):
        f = minp_fmt.open(self._fname(v, i))
        out = f.vectors()
        f.close()
        return out

    def read_x(self, i):
        return self._read("x", i)

    def read_v(self, i):
        return self._read("v", i)

    def read_id(self, i):
        f = minp_fmt.open(self._fname("x", i))
        out = f.ids()
        f.close()
        return out


def write_minp(dirname: str, fname_fmt: str, file_cells: int,
               sub_cells: int, dx: float, dv: float,
               snap: Snapshot, encoder=None) -> None:
    """Convert any snapshot to a minp fileset, one file per file-cell
    (ref go/minp/snapshot/minp.go:90-123; the reference writes position
    data into the velocity files -- App. B #2 -- fixed here).

    ``encoder`` (a parallel.BlockEncoder) routes each file's sub-cell
    vector encode through the batched device pipeline; bytes are
    identical to the host writer."""
    grid = Grid(snap, file_cells)
    for kind, read, step, periodic in (("x", grid.read_x, dx, True),
                                       ("v", grid.read_v, dv, False)):
        for i in range(grid.files()):
            cell = minp_fmt.Cell(i, file_cells, sub_cells)
            w = minp_fmt.create(
                os.path.join(dirname, fname_fmt % (kind, i)),
                encoder=encoder)
            w.header(grid.header(), grid.raw_header(i), cell, step,
                     periodic)
            w.vectors(read(i))
            w.close()
