"""minh boundary files: spatial cell layout with ghost duplication
(ref go/minh/boundary.go).

The box is divided into ``cells**3`` cubic cells; each halo belongs to its
host cell (flag 0) and is duplicated into every cell whose boundary region
(width ``boundary``) it falls in (flag 1) -- up to 8 cells for corner
points.  Data groups are column-major: one group per (column, cell), the
first written column being the synthetic ``"boundary"`` int flag column
(ref go/minh/boundary.go:227-246).

The reference assigns points with three nested scalar loops per point
(ref boundary.go:111-152); here the up-to-8 candidate cells of all points
are computed as one (N, 8) vectorized table whose slot order replicates
the reference's (z, y, x) enumeration exactly, and per-cell membership
lists come from one stable argsort -- so files are byte-identical,
including the insertion order of duplicated points.

The port's own copy of ``minnow_tpu/formats/boundary.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core import types as ctypes_
from ..utils import profiling
from . import minh as minh_mod


def region(ix, x, scaled_boundary):
    """-1/0/+1 boundary region of scaled coordinate ``x`` within cell
    ``ix`` (ref go/minh/boundary.go:172-180).  Vectorized."""
    low = ix.astype(np.float32)
    out = np.zeros(ix.shape, dtype=np.int64)
    out[x < low + scaled_boundary] = -1
    out[(x >= low + 1 - scaled_boundary) & (out == 0)] = 1
    return out


def idx_reg(vec, cells, l, scaled_boundary):
    """Cell index and boundary region per axis
    (ref go/minh/boundary.go:155-165).  ``vec`` is coordinate/dx, shape
    (3, N).  Replicates the reference exactly, including subtracting the
    *box length* (not the cell count) from wrapped coordinates."""
    vec = vec.astype(np.float32).copy()
    idx = vec.astype(np.int64)  # Go int() truncation (coords >= 0)
    wrap = idx >= cells
    idx[wrap] -= cells
    vec[wrap] -= np.float32(l)
    reg = np.stack([region(idx[k], vec[k], scaled_boundary)
                    for k in range(3)])
    return idx, reg


# slot order replicating the reference's z/y/x nesting
# (ref boundary.go:124-147): bit 0 = x offset, bit 1 = y, bit 2 = z.
_SLOTS = [(z, y, x) for z in (0, 1) for y in (0, 1) for x in (0, 1)]


def host_cells_table(idx, reg, cells):
    """(N, 8) candidate cell ids (-1 = unused slot) and flags, in the
    reference's enumeration order (slot 0 = host cell, flag 0)."""
    n = idx.shape[1]
    table = np.full((n, 8), -1, dtype=np.int64)
    flags = np.zeros((n, 8), dtype=np.int8)
    for s, (zb, yb, xb) in enumerate(_SLOTS):
        diff = np.stack([xb * reg[0], yb * reg[1], zb * reg[2]])
        valid = np.ones(n, dtype=bool)
        if xb:
            valid &= reg[0] != 0
        if yb:
            valid &= reg[1] != 0
        if zb:
            valid &= reg[2] != 0
        vec = idx + diff
        vec[vec < 0] += cells
        vec[vec >= cells] -= cells
        g = vec[0] + vec[1] * cells + vec[2] * cells * cells
        table[valid, s] = g[valid]
        flags[:, s] = 0 if s == 0 else 1
    return table, flags


class BoundaryWriter:
    """(ref go/minh/boundary.go:10-256)"""

    def __init__(self, fname):
        self.w = minh_mod.Writer(fname,
                                 file_type=minh_mod.BOUNDARY_FILE_TYPE)
        self.names: list[str] = []
        self.cols: list[minh_mod.Column] = []
        self.cell_index: list[np.ndarray] | None = None
        self.block_sizes: list[int] = []
        self.blocks = 0

    def header(self, text: str) -> None:
        self.w.f.header(text.encode() if isinstance(text, str) else text)

    def geometry(self, l: float, boundary: float, cells: int) -> None:
        self.w.geometry(l, boundary, cells)

    def coordinates(self, x, y, z) -> None:
        """Assign every point to its host cell + ghost cells, then write
        the synthetic ``"boundary"`` flag column
        (ref go/minh/boundary.go:39-50).  One span, ``boundary.cells``,
        covers it; its counts are the ``halos``, the ``rows`` written
        (ghosts included) and the ``cells``."""
        with profiling.span("boundary.cells") as sp:
            wr = self.w
            cells = wr.cells
            dx = np.float32(wr.l) / np.float32(cells)
            scaled_boundary = np.float32(wr.boundary) / dx

            coord = np.stack([np.asarray(x, np.float32),
                              np.asarray(y, np.float32),
                              np.asarray(z, np.float32)])
            vec = coord / dx
            idx, reg = idx_reg(vec, cells, wr.l, scaled_boundary)
            table, flags = host_cells_table(idx, reg, cells)

            n = table.shape[0]
            flat_cells = table.reshape(-1)
            flat_flags = flags.reshape(-1)
            flat_points = np.repeat(np.arange(n, dtype=np.int64), 8)
            valid = flat_cells >= 0
            flat_cells = flat_cells[valid]
            flat_flags = flat_flags[valid]
            flat_points = flat_points[valid]

            # stable sort by cell preserves the reference's insertion order
            order = np.argsort(flat_cells, kind="stable")
            cells_sorted = flat_cells[order]
            points_sorted = flat_points[order]
            flags_sorted = flat_flags[order]
            counts = np.bincount(cells_sorted, minlength=cells ** 3)
            splits = np.cumsum(counts)[:-1]
            self.set_cells(np.split(points_sorted, splits),
                           np.split(flags_sorted, splits))
            sp.counts.update(halos=n, rows=len(points_sorted),
                             cells=cells ** 3)

    def set_cells(self, cell_index, flag_lists) -> None:
        """Take the finished cell table -- each cell's row indices and
        their flags (0 host, 1 ghost) -- and write the synthetic
        ``"boundary"`` flag column (ref go/minh/boundary.go:227-246); the
        groups' encode and writes are one span, ``container.write``."""
        self.cell_index = cell_index
        self.cols.append(minh_mod.Column(type=minh_mod.Int))
        self.names.append("boundary")
        with profiling.span("container.write"):
            for flags in flag_lists:
                n = len(flags)
                self.w.f.int_group(n)
                self.w.f.data(flags.astype(np.int64))
                self.block_sizes.append(n)
        self.blocks = len(flag_lists)

    def column(self, name: str, col: minh_mod.Column, x) -> None:
        """Write one data column, gathered per cell
        (ref go/minh/boundary.go:184-225); its groups' gathers, encode and
        writes are one span, ``container.write``."""
        if self.cell_index is None:
            raise RuntimeError("call coordinates() before column()")
        self.cols.append(col)
        self.names.append(name)
        wr = self.w
        with profiling.span("container.write"):
            for idx in self.cell_index:
                n = len(idx)
                if col.type in (minh_mod.Int64, minh_mod.Int):
                    buf = np.asarray(x, np.int64)[idx]
                    if col.type == minh_mod.Int64:
                        wr.f.fixed_size_group(ctypes_.INT64_GROUP, n)
                    else:
                        wr.f.int_group(n)
                    wr.f.data(buf)
                elif col.type in (minh_mod.Float32, minh_mod.Float):
                    buf = np.asarray(x, np.float32)[idx]
                    if col.type == minh_mod.Float32:
                        wr.f.fixed_size_group(ctypes_.FLOAT32_GROUP, n)
                        wr.f.data(buf)
                    else:
                        wr.f.float_group(n, (col.low, col.high), col.dx)
                        buf = minh_mod.process_float_column(buf, col)
                        wr.f.data(buf)
                else:
                    raise ValueError("Can't write column with type flag %d"
                                     % col.type)

    def encoded_column(self, name: str, col: minh_mod.Column, enc) -> None:
        """Write one coded (Int or Float) column whose cells are already
        encoded, one block a cell in cell order (an ``EncodedBlocks``):
        one group a cell, all in one span, ``container.write``."""
        if self.cell_index is None:
            raise RuntimeError("call coordinates() before column()")
        if len(enc.payloads) != len(self.cell_index):
            raise ValueError("%d encoded blocks for %d cells"
                             % (len(enc.payloads), len(self.cell_index)))
        f = self.w.f
        if col.type == minh_mod.Int:
            def start_group(r):
                f.int_group(len(self.cell_index[r]))
        elif col.type == minh_mod.Float:
            def start_group(r):
                f.float_group(len(self.cell_index[r]), (col.low, col.high),
                              col.dx)
        else:
            raise ValueError("Can't write column with type flag %d"
                             % col.type)
        self.cols.append(col)
        self.names.append(name)
        enc.write_to(f, start_group)

    def close(self) -> None:
        """(ref go/minh/boundary.go:249-256)"""
        wr = self.w
        wr.f.header("$".join(self.names).encode())
        wr.f.header(minh_mod.columns_to_bytes(self.cols))
        wr.f.header(struct.pack("<ffq", wr.l, wr.boundary, wr.cells))
        wr.f.header(np.int64(self.blocks))
        wr.f.header(np.asarray(self.block_sizes, dtype="<i8"))
        wr.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def create_boundary(fname, encoder=None):
    """A boundary writer: the host writer or, with ``encoder`` (a
    parallel.BlockEncoder), the device route
    (``boundary_device.DeviceBoundaryWriter``)."""
    wr = BoundaryWriter(fname)
    if encoder is None:
        return wr
    from .boundary_device import DeviceBoundaryWriter

    return DeviceBoundaryWriter(wr, encoder)
