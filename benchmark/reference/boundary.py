"""The plain reference of a catalog's boundary layout (``minh_to_bnd``).

From the values a bulk read of a basic minh file gives (``minh.Catalog(
...).decoded(seed)``), the catalog's column records and the deployment's
``cells`` and ``boundary``, it works out the boundary file that
``minh_to_bnd`` has to write, byte for byte, as upstream
``go/minh/boundary.go`` lays it out:

- the scaling: ``dx = float32(L) / float32(cells)``, the scaled boundary
  ``float32(boundary) / dx``, each coordinate divided by ``dx`` in float32
  (boundary.go:39-50);
- the host index by ``int()`` truncation; an index at or past ``cells``
  is brought back by ``cells``, and its scaled coordinate by ``L``, not
  by ``cells``: the upstream code's own quirk, which the program keeps,
  so that a coordinate at or past ``L`` always lies in the lower region
  (boundary.go:155-165);
- the region on each axis, in float32: -1 below ``low + boundary``, +1 at
  or above ``low + 1 - boundary``, else 0, ``low`` the host index
  (boundary.go:172-180);
- the cells: a point lies in a cell when, on each axis, the cell's index
  is the point's host index, or, where the point's region is not 0, the
  neighbour index on the side its region names (periodic); it is written
  there with the flag 0 in its host cell and 1 in every other, so in 1 to
  8 cells; inside a cell, points come in increasing index order, as the
  upstream loop appends them point by point (boundary.go:111-152);
- the columns, column-major: one group per (column, cell), cells in the
  order ``ix + iy cells + iz cells^2``; the ``boundary`` flag column (Int)
  first (boundary.go:227-246), then each of the catalog's columns in its
  order, raw ``int64`` as they are, ``int`` min-subtracted and packed,
  ``q_float`` log10'd again where it is a log column and clamped again
  below ``high``, then quantized on its periodic window
  (boundary.go:184-225);
- the layout: header 0 ``(0xBAFF1ED, 0, 1)``, the catalog's text, the
  groups, then the names joined by ``$`` (``boundary`` first), one
  256-byte record a column (the flag column's an ``int`` record of zeros),
  ``(L f32, boundary f32, cells i64)``, the block count ``cells^3`` and
  each cell's length (boundary.go:249-256).

This is a way to the cells of its own: each axis is taken alone and a
cell's points are what its three axes' sets share; the program's table of
each point's eight candidate cells is not copied.  Departures from the
upstream code: ``cells`` is at least 3, so that a point's host and
neighbour indices on one axis differ (with fewer cells the upstream code
appends a point to one cell twice); a coordinate under 0 or at or past
``2 L``, for which the upstream code indexes outside its cells, raises.
"""

from __future__ import annotations

import struct

import numpy as np

from . import codec
from .container import Container
from .minh import FLOAT, INT, INT64, MAGIC

BOUNDARY_FILE = 1


def axis(v, cells: int, box: float, scaled_boundary):
    """``(host index, region)`` of each float32 scaled coordinate ``v`` on
    one axis."""
    v = np.asarray(v, np.float32)
    idx = v.astype(np.int64)  # int() truncation
    wrapped = idx >= cells
    idx = np.where(wrapped, idx - cells, idx)
    v = np.where(wrapped, v - np.float32(box), v)
    if (idx < 0).any() or (idx >= cells).any():
        raise ValueError("a coordinate lies under 0 or past twice the box")
    low = idx.astype(np.float32)
    region = np.where(v < low + scaled_boundary, -1,
                      np.where(v >= low + np.float32(1) - scaled_boundary,
                               1, 0))
    return idx, region


class Layout:
    """Which points each cell holds, and their flags: ``points[g]`` and
    ``flags[g]`` for cell ``g = ix + iy cells + iz cells^2``."""

    def __init__(self, x, y, z, box: float, boundary: float, cells: int):
        if cells < 3:
            raise ValueError("the reference takes 3 cells a side or more")
        dx = np.float32(box) / np.float32(cells)
        sb = np.float32(boundary) / dx
        idx, member = [], []
        for v in (x, y, z):
            i, reg = axis(np.asarray(v, np.float32) / dx, cells, box, sb)
            nb = (i + reg) % cells
            idx.append(i)
            member.append([(i == c) | ((reg != 0) & (nb == c))
                           for c in range(cells)])
        self.points, self.flags = [], []
        for k in range(cells):
            for j in range(cells):
                zy = np.flatnonzero(member[2][k] & member[1][j])
                for i in range(cells):
                    p = zy[member[0][i][zy]]
                    host = ((idx[0][p] == i) & (idx[1][p] == j)
                            & (idx[2][p] == k))
                    self.points.append(p)
                    self.flags.append(np.where(host, 0, 1).astype(np.int64))

    @property
    def lengths(self) -> list:
        return [len(p) for p in self.points]


def _int_groups(c: Container, rows) -> None:
    for x in rows:
        mins, bits, deltas = codec.encode_int_rows(x[None, :])
        c.int_group(len(x), [mins[0]], [bits[0]],
                    codec.payloads(deltas, bits))


def _float_groups(c: Container, col, rows) -> None:
    for x in rows:
        if not len(x):
            c.float_group(0, col.low, col.high, col.pixels, [0], [0], [b""])
            continue
        mins, bits, deltas, _ = codec.encode_float_rows(
            x[None, :], col.low, col.high, col.pixels)
        c.float_group(len(x), col.low, col.high, col.pixels, [mins[0]],
                      [bits[0]], codec.payloads(deltas, bits))


def file_bytes(cat, values: dict, cells: int, boundary: float) -> bytes:
    """The boundary file of catalog ``cat`` (a ``minh.Catalog``: its text,
    names, columns and box) whose bulk read gave ``values`` (name ->
    array)."""
    lay = Layout(values["x"], values["y"], values["z"], cat.box, boundary,
                 cells)
    c = Container()
    c.header(struct.pack("<qqq", MAGIC, 0, BOUNDARY_FILE))
    c.header(cat.text.encode())
    _int_groups(c, lay.flags)
    for name, col in zip(cat.names, cat.cols):
        v = values[name]
        if col.type == FLOAT:
            v = col.stored(v)
        rows = [v[p] for p in lay.points]
        if col.type == INT64:
            for x in rows:
                c.fixed_group(x.astype("<i8"))
        elif col.type == INT:
            _int_groups(c, rows)
        else:
            _float_groups(c, col, rows)
    flag_record = struct.pack("<qifff", INT, 0, 0, 0, 0) + b"\0" * 232
    c.header("$".join(["boundary"] + cat.names).encode())
    c.header(flag_record + b"".join(col.record() for col in cat.cols))
    c.header(struct.pack("<ffq", np.float32(cat.box), np.float32(boundary),
                         cells))
    c.header(struct.pack("<q", cells ** 3))
    c.header(np.asarray(lay.lengths, "<i8").tobytes())
    return c.bytes()
