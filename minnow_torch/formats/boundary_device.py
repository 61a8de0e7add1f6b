"""Device-batched boundary-file writes.

``BoundaryWriter`` (formats/boundary.py) builds the cell table and
encodes one cell-group at a time on host (the reference's per-cell loop,
ref go/minh/boundary.go:184-225).  This wrapper does both on the
encoder's device: ``coordinates`` builds the cell table there
(``ops/cells.py``, the kernel chain of ``csrc/cells.cu`` on a CUDA
device, its plain version on the CPU), and each coded column's padded
(cells, Nmax) batch is gathered there from that table and goes through
the port's ``BlockEncoder`` (parallel/pipeline.py) in one call -- cells
are independent minnow blocks, so the batch with per-cell valid lengths
maps directly onto the block-parallel encoder (kernels K1 and K3 on a
CUDA device).  Output bytes are identical to the host writer
(tests/test_torch_minh_to_bnd.py); a halo outside the box raises where
the host writer misfiles it (``ops/cells.py``).

``boundary.create_boundary(fname, encoder=...)`` returns this writer; it
is kept separate from formats/boundary.py so host-side boundary IO never
imports torch.  It writes the file only through ``BoundaryWriter``'s
public methods: ``set_cells`` takes the device's cell table and
``encoded_column`` a coded column's ``EncodedBlocks``.

The port's own copy of ``minnow_tpu/formats/boundary_device.py``: the
same batching and the same bytes; the encoder is always the caller's
(the reference builds its JAX ``BlockEncoder`` when given none), and the
cell table and the gathers are on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec
from ..ops import cells as cells_op
from ..utils import profiling
from . import minh as minh_mod
from .boundary import BoundaryWriter


class DeviceBoundaryWriter:
    """BoundaryWriter wrapper routing Int/Float columns through the
    device BlockEncoder; same API, byte-identical files."""

    def __init__(self, wr: BoundaryWriter, encoder):
        self.wr = wr
        self.enc = encoder
        self._table = self._index = None

    # -- pass-throughs ------------------------------------------------------

    def header(self, text: str) -> None:
        self.wr.header(text)

    def geometry(self, l: float, boundary: float, cells: int) -> None:
        self.wr.geometry(l, boundary, cells)
        self._geometry = (np.float32(l), np.float32(boundary), int(cells))

    def coordinates(self, x, y, z) -> None:
        """Assign every point to its host cell and ghost cells on the
        encoder's device, then write the synthetic ``"boundary"`` flag
        column (ref go/minh/boundary.go:39-50).  One span,
        ``boundary.cells``, covers the positions' upload, the table
        (``ops/cells.build``), the copy back of its rows and flags, and the
        flag column's host encode and writes; its counts are the ``halos``,
        the ``rows`` written (ghosts included) and the ``cells``.  The
        table's rows and offsets stay on the device for the gathers."""
        cells = self._geometry[2]
        with profiling.span("boundary.cells") as sp:
            pos = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                self.enc.device) for a in (x, y, z)]
            table = cells_op.build(*pos, *self._geometry)
            perm = table.perm.cpu().numpy()
            splits = table.host_offsets[1:-1]
            self.wr.set_cells(np.split(perm, splits),
                              np.split(table.flags.cpu().numpy(), splits))
            sp.counts.update(halos=len(pos[0]), rows=len(perm),
                             cells=cells ** 3)
        self._table, self._halos, self._index = table, len(pos[0]), None

    # -- batched column write ----------------------------------------------

    def _cell_batch(self, x, dtype):
        """A column's (cells, Nmax) batch on the encoder's device and each
        cell's length: the column goes up once, with a zero after it, and
        one gather through the padded index (``ops/cells.gather_index``,
        built at the first column) lays it out, zeros past each cell's
        length.  One span, ``boundary.gather``, whose counts are ``nmax``
        and the ``rows`` gathered."""
        if len(x) != self._halos:
            raise ValueError("a column of %d values for %d halos"
                             % (len(x), self._halos))
        with profiling.span("boundary.gather") as sp:
            if self._index is None:
                self._index = cells_op.gather_index(self._table, self._halos)
            lens = np.diff(self._table.host_offsets)
            host = torch.from_numpy(np.ascontiguousarray(x, dtype))
            col = torch.zeros(len(host) + 1, dtype=host.dtype,
                              device=self.enc.device)
            col[:-1].copy_(host)
            xb = torch.take(col, self._index)
            sp.counts.update(nmax=int(lens.max(initial=0)),
                             rows=int(lens.sum()))
        return xb, lens

    def column(self, name: str, col: minh_mod.Column, x) -> None:
        """Write one data column, all cells encoded in one batched device
        call (ref go/minh/boundary.go:184-225); the groups' writes are one
        span, ``container.write``."""
        if self._table is None:
            raise RuntimeError("call coordinates() before column()")
        if col.type == minh_mod.Int:
            xb, lens = self._cell_batch(x, np.int64)
            enc = self.enc.encode_int_blocks(xb, lens=lens)
        elif col.type == minh_mod.Float:
            buf = minh_mod.process_float_column(
                np.asarray(x, np.float32), col)
            xb, lens = self._cell_batch(buf, np.float32)
            pixels = spec.float_group_pixels(col.low, col.high, col.dx)
            enc = self.enc.encode_float_blocks(
                xb, col.low, col.high, pixels, lens=lens)
        else:
            # raw fixed groups: no encoding, host write is already optimal
            # (the host writer also refuses any other type)
            self.wr.column(name, col, x)
            return
        self.wr.encoded_column(name, col, enc)

    def close(self) -> None:
        self.wr.close()
        self._table = self._index = None  # the device's copies

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
