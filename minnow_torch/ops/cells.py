"""The boundary layout's cell table on the device (``csrc/cells.cu``),
beside its plain PyTorch version.

:func:`build` takes the halos' x, y, z and the layout's box length,
boundary and cells, and gives a :class:`Table`: the point of every row
the boundary file writes, in file order (cell by cell, within a cell by
point, then by slot), each row's flag (0 in its host cell, 1 in a ghost
shell) and the cells' offsets.  The arithmetic is host mode's bit for
bit (``formats/boundary.py`` ``idx_reg``, ``host_cells_table`` and the
stable sort by cell; ref go/minh/boundary.go:111-180): ``dx`` and the
scaled boundary are numpy float32 scalars computed on the host, and each
quotient, sum and difference is rounded to float32 once.

On a CUDA device :func:`build` launches the kernel chain or raises; on
the CPU it runs the plain version.  Nothing else chooses between them.

**A divergence by design.**  A halo whose host cell falls outside the
box after the one wrap -- a coordinate outside ``(-dx, 2 l)``, or NaN
-- raises ``ValueError`` on both routes.  Host mode takes it silently:
its truncation and wrap put it in some cell, or none, that is not where
it lies.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ._launch import COUNT_LOCK, expect, on_card, stream_of

__all__ = ["CELLS_LAUNCHES", "Table", "scalars", "build", "Chain",
           "table_plain", "gather_index"]

# tables the kernel chain built on the card (the plain version counts none)
CELLS_LAUNCHES = 0


class Table(NamedTuple):
    """A boundary layout's cell table on one device: ``perm`` (rows,)
    int64, the point of each row in file order; ``flags`` (rows,) int8;
    ``offsets`` (cells^3 + 1,) int64, where each cell's rows start, and
    ``host_offsets``, their numpy copy."""
    perm: torch.Tensor
    flags: torch.Tensor
    offsets: torch.Tensor
    host_offsets: np.ndarray


def scalars(l, boundary, cells: int):
    """``(dx, l, scaled boundary)`` as numpy float32 scalars, as host mode
    computes them."""
    dx = np.float32(l) / np.float32(cells)
    return dx, np.float32(l), np.float32(boundary) / dx


def _outside(cells: int) -> ValueError:
    return ValueError("a halo lies outside the box: at or below -dx, at or "
                      "above 2 l, or NaN (its host cell is not one of %d^3)"
                      % cells)


def build(x, y, z, l, boundary, cells: int) -> Table:
    """The cell table of the halos at ``x``, ``y``, ``z`` ((n,) float32
    tensors on one device) in ``cells^3`` cells of a box of side ``l``
    with ghost shells ``boundary`` wide.  On the card: the count and scan
    launches, one read back of the offsets (and the error word), the place
    launch.  Raises ``ValueError`` for a halo outside the box."""
    expect(x, "x", torch.float32, (None,))
    n = x.shape[0]
    expect(y, "y", torch.float32, (n,))
    expect(z, "z", torch.float32, (n,))
    if cells < 1:
        raise ValueError("cells must be at least 1, got %d" % cells)
    if on_card(x, y, z):
        return _on_card(x, y, z, l, boundary, cells)
    return table_plain(x, y, z, l, boundary, cells)


class Chain:
    """The kernel chain for the halos at ``x``, ``y``, ``z`` on the card:
    its cut (``minnow_cells_layout``: the halos a warp) and its buffers,
    the (cells^3, chunks) matrix, the scan's tile sums and ``head``, the
    cells' offsets and then the error word.
    :func:`build` runs it; ``chip_smoke.py`` times its launches alone."""

    def __init__(self, x, y, z, l, boundary, cells: int):
        self.lib = _build.load()
        n, dev = x.shape[0], x.device
        self.ncells = cells ** 3
        cut = (ctypes.c_longlong * 3)()
        self.lib.minnow_cells_layout(n, cells, cut)
        chunk, chunks, tiles = cut
        self.matrix = torch.empty(self.ncells * chunks, dtype=torch.int64,
                                  device=dev)
        self.sums = torch.empty(tiles, dtype=torch.int64, device=dev)
        self.head = torch.zeros(self.ncells + 2, dtype=torch.int64,
                                device=dev)
        self.args = (x.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                     *(float(v) for v in scalars(l, boundary, cells)),
                     cells, chunk, chunks, self.matrix.data_ptr())
        self.stream = stream_of(x)
        self._keep = (x, y, z)

    def count(self) -> None:
        """The count and scan launches: the offsets into ``head``, and its
        last word set where a halo has no host cell."""
        head = self.head.data_ptr()
        with torch.cuda.device(self.head.device):
            _build.check(self.lib.minnow_cells_count(
                *self.args, self.sums.data_ptr(), head,
                head + 8 * (self.ncells + 1), self.stream), "cells count")

    def place(self, perm, flags) -> None:
        """The place launch, after :meth:`count`: ``perm`` (rows,) int64
        and ``flags`` (rows,) int8 on the card."""
        with torch.cuda.device(self.head.device):
            _build.check(self.lib.minnow_cells_place(
                *self.args, perm.data_ptr(), flags.data_ptr(), self.stream),
                "cells place")


def _on_card(x, y, z, l, boundary, cells: int) -> Table:
    global CELLS_LAUNCHES
    chain = Chain(x, y, z, l, boundary, cells)
    chain.count()
    host = chain.head.cpu().numpy()
    if host[-1]:
        raise _outside(cells)
    rows = int(host[chain.ncells])
    perm = torch.empty(rows, dtype=torch.int64, device=x.device)
    flags = torch.empty(rows, dtype=torch.int8, device=x.device)
    chain.place(perm, flags)
    with COUNT_LOCK:
        CELLS_LAUNCHES += 1
    return Table(perm, flags, chain.head[:-1], host[:-1])


def table_plain(x, y, z, l, boundary, cells: int) -> Table:
    """Plain version of the kernel chain: host mode's (N, 8) slot table
    on tensors, and a stable sort of the used slots by cell."""
    dx, lf, sb = scalars(l, boundary, cells)
    n, dev = x.shape[0], x.device
    idx, reg = [], []
    for coord in (x, y, z):
        # a float64 quotient of two float32 values rounds to the float32
        # quotient exactly
        v = (coord.double() / float(dx)).float()
        t = v.trunc()
        if not bool(((t >= 0) & (t.double() < 2 * cells)).all()):
            raise _outside(cells)
        i = t.long()
        wrap = i >= cells
        i = torch.where(wrap, i - cells, i)
        v = torch.where(wrap, v - float(lf), v)
        low = i.float()
        r = torch.zeros_like(i)
        r[v < low + float(sb)] = -1
        r[(v >= (low + 1) - float(sb)) & (r == 0)] = 1
        idx.append(i)
        reg.append(r)
    table = torch.full((n, 8), -1, dtype=torch.int64, device=dev)
    for s in range(8):
        used = torch.ones(n, dtype=torch.bool, device=dev)
        cell = torch.zeros(n, dtype=torch.int64, device=dev)
        for a in (2, 1, 0):  # z, y, x: cell = x + (y + z cells) cells
            bit = (s >> a) & 1
            c = idx[a] + bit * reg[a]
            c = torch.where(c < 0, c + cells, c)
            c = torch.where(c >= cells, c - cells, c)
            cell = cell * cells + c
            if bit:
                used &= reg[a] != 0
        table[used, s] = cell[used]
    flat = table.reshape(-1)
    slots = torch.nonzero(flat >= 0).reshape(-1)  # point * 8 + slot
    _, order = torch.sort(flat[slots], stable=True)
    slots = slots[order]
    counts = torch.bincount(flat[slots], minlength=cells ** 3)
    offsets = torch.zeros(cells ** 3 + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return Table(slots // 8, (slots % 8 != 0).to(torch.int8), offsets,
                 offsets.cpu().numpy())


def gather_index(table: Table, halos: int):
    """The (cells^3, max(Nmax, 1)) int64 index on the table's device that
    gathers a column of ``halos`` values, with one zero put after them,
    into its padded cell batch: row r holds cell r's points in file order,
    then ``halos`` (the zero) to the row's end."""
    offsets = table.offsets
    lens = offsets[1:] - offsets[:-1]
    width = max(int(np.diff(table.host_offsets).max(initial=0)), 1)
    at = torch.arange(width, dtype=torch.int64, device=offsets.device)
    index = offsets[:-1, None] + at[None, :]
    outside = at[None, :] >= lens[:, None]
    if table.perm.numel():
        index = table.perm[index.clamp_(max=table.perm.numel() - 1)]
    return index.masked_fill_(outside, halos)
