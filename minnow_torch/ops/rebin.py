"""The re-binning of a snapshot by particle ID on the device
(``csrc/rebin.cu``), beside its plain PyTorch version.

:func:`cell_index` is the arithmetic of both routes: the host route's
``ingest.snapshot.Grid._cell_index`` calls it on numpy arrays, the plain
version here on tensors, and the kernel writes it out in CUDA (ref
go/minp/snapshot/grid.go:118-137).

A :class:`Batch` holds file cells ``[first, first + count)`` of a grid
being built on a device, positions and velocities both, and a bit a
place that marks where a particle went.  Each source file goes in by one
:meth:`Batch.add`, which places every particle whose cell lies in the
batch; :meth:`Batch.check` then reads back once what the calls found: an
ID outside ``[1, n_side**3]`` raises the host route's ``ValueError``, and
so does a place reached twice (an ID given twice), where the host route's
last writer would win in an order a device does not keep.

On a CUDA device :meth:`Batch.add` launches the kernel or raises; on the
CPU it runs the plain version.  Nothing else chooses between them.
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import COUNT_LOCK, expect, on_card, stream_of

__all__ = ["REBIN_LAUNCHES", "cell_index", "batch_bytes", "Batch",
           "rebin_plain"]

# calls of Batch.add that placed particles: a launch of csrc/rebin.cu on
# the card, the plain version on the CPU
REBIN_LAUNCHES = 0


def cell_index(ids, n_side: int, cells: int):
    """(file cell, place within it) of 0-based Lagrangian ``ids`` in
    [0, n_side**3), numpy arrays or tensors alike."""
    n = n_side // cells  # places along a cell's side
    idx = ids % n_side
    idy = (ids // n_side) % n_side
    idz = ids // (n_side * n_side)
    i = idx % n + (idy % n) * n + (idz % n) * n * n
    c = idx // n + (idy // n) * cells + (idz // n) * cells * cells
    return c, i


def batch_bytes(n_side: int, cells: int, count: int) -> int:
    """Device bytes of a :class:`Batch` of ``count`` file cells: a float32
    position and velocity a place, and the marks, a bit a place in 32-bit
    words."""
    places = count * (n_side // cells) ** 3
    return 24 * places + 4 * -(-places // 32)


class Batch:
    """File cells ``[first, first + count)`` of a grid of ``cells**3``
    over ``n_side**3`` particles, built on ``device``: ``x`` and ``v``
    are (count, (n_side / cells)**3, 3) float32, zero where no particle
    came; ``marks`` holds a bit a place (int32 words, bit ``p % 32`` of
    word ``p // 32`` for place ``p`` of the batch); ``error`` two int32,
    an ID out of range and a place reached twice."""

    def __init__(self, n_side: int, cells: int, first: int, count: int,
                 device):
        if cells < 1 or n_side % cells:
            raise ValueError("%d cells do not divide NSide = %d"
                             % (cells, n_side))
        if first < 0 or count < 1 or first + count > cells ** 3:
            raise ValueError("cells [%d, %d) are not of the %d"
                             % (first, first + count, cells ** 3))
        self.n_side, self.cells = n_side, cells
        self.first, self.count = first, count
        places = (n_side // cells) ** 3
        self.x, self.v = (torch.zeros((count, places, 3),
                                      dtype=torch.float32, device=device)
                          for _ in range(2))
        self.marks = torch.zeros(-(-count * places // 32),
                                 dtype=torch.int32, device=device)
        self.error = torch.zeros(2, dtype=torch.int32, device=device)

    def add(self, ids, x, v) -> None:
        """Place the particles of ``ids`` (n,) int64, 1-based, with
        positions ``x`` and velocities ``v`` (n, 3) float32, whose cells
        lie in the batch.  One launch on the card."""
        global REBIN_LAUNCHES
        expect(ids, "ids", torch.int64, (None,))
        m = ids.shape[0]
        expect(x, "x", torch.float32, (m, 3))
        expect(v, "v", torch.float32, (m, 3))
        card = on_card(ids, x, v, self.x)
        if m == 0:
            return
        if not card:
            rebin_plain(self, ids, x, v)
        else:
            with torch.cuda.device(ids.device):
                err = _build.load().minnow_rebin(
                    ids.data_ptr(), x.data_ptr(), v.data_ptr(), m,
                    self.n_side, self.cells, self.first,
                    self.first + self.count, self.x.data_ptr(),
                    self.v.data_ptr(), self.marks.data_ptr(),
                    self.error.data_ptr(), stream_of(ids))
            _build.check(err, "rebin")
        with COUNT_LOCK:
            REBIN_LAUNCHES += 1

    def check(self) -> None:
        """Raise for what the calls of :meth:`add` found: an ID out of
        range, or a place reached twice.  One read from the device."""
        out_of_range, twice = self.error.tolist()
        if out_of_range:
            raise ValueError("ID out of range for NSide=%d" % self.n_side)
        if twice:
            raise ValueError("two particles have one ID (NSide=%d)"
                             % self.n_side)


def rebin_plain(batch: Batch, ids, x, v) -> None:
    """Plain version of the kernel: the same places, the vectors copied
    bit for bit, the places' bits set, the error words set for an ID out
    of range and for a place reached twice (in this call or an earlier
    one)."""
    ids = ids - 1  # ids are 1-based
    ok = (ids >= 0) & (ids < batch.n_side ** 3)
    if not bool(ok.all()):
        batch.error[0] = 1
    c, i = cell_index(ids[ok], batch.n_side, batch.cells)
    mine = (c >= batch.first) & (c < batch.first + batch.count)
    place = (c[mine] - batch.first) * batch.x.shape[1] + i[mine]
    for grid, vec in ((batch.x, x), (batch.v, v)):
        words = grid.view(torch.int32).view(-1, 3)
        words[place] = vec.view(torch.int32)[ok][mine]
    word, bit = place // 32, place % 32
    if (bool(((batch.marks[word].long() >> bit) & 1).any())
            or place.unique().numel() != place.numel()):
        batch.error[1] = 1
    else:  # distinct bits not yet set: their sum is their OR
        add = torch.zeros(batch.marks.shape, dtype=torch.int64,
                          device=batch.marks.device)
        add.index_add_(0, word, torch.ones_like(bit) << bit)
        batch.marks |= add.to(torch.int32)
