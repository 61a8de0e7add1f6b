"""Device-batched boundary-file writes.

``BoundaryWriter.column`` (formats/boundary.py) encodes one cell-group
at a time on host (the reference's per-cell loop,
ref go/minh/boundary.go:184-225).  This wrapper batches ALL cells of a
column through the port's ``BlockEncoder`` (parallel/pipeline.py) in one
call -- cells are independent minnow blocks, so the batch (B, Nmax) with
per-cell valid lengths maps directly onto the block-parallel encoder
(kernels K1 and K3 on a CUDA device).  Output bytes are identical to the
host writer (tests/test_torch_minh_to_bnd.py).

Kept separate from formats/boundary.py so host-side boundary IO never
imports torch.

The port's own copy of ``minnow_tpu/formats/boundary_device.py``: the
same batching and the same bytes; the encoder is always the caller's
(the reference builds its JAX ``BlockEncoder`` when given none).
"""

from __future__ import annotations

import numpy as np

from ..core import spec, types as ctypes_
from ..utils import profiling
from . import minh as minh_mod
from .boundary import BoundaryWriter


class DeviceBoundaryWriter:
    """BoundaryWriter wrapper routing Int/Float columns through the
    device BlockEncoder; same API, byte-identical files."""

    def __init__(self, wr: BoundaryWriter, encoder):
        self.wr = wr
        self.enc = encoder

    # -- pass-throughs ------------------------------------------------------

    def header(self, text: str) -> None:
        self.wr.header(text)

    def geometry(self, l: float, boundary: float, cells: int) -> None:
        self.wr.geometry(l, boundary, cells)

    def coordinates(self, x, y, z) -> None:
        self.wr.coordinates(x, y, z)

    # -- batched column write ----------------------------------------------

    def _cell_batch(self, x, dtype):
        """A column's (cells, Nmax) batch and each cell's length: one
        span, ``boundary.gather``, whose counts are ``nmax`` and the
        ``rows`` gathered."""
        with profiling.span("boundary.gather") as sp:
            idxs = self.wr.cell_index
            lens = np.array([len(i) for i in idxs], np.int64)
            nmax = int(lens.max()) if len(lens) else 0
            xb = np.zeros((len(idxs), max(nmax, 1)), dtype)
            xv = np.asarray(x, dtype)
            for r, idx in enumerate(idxs):
                xb[r, :len(idx)] = xv[idx]
            sp.counts.update(nmax=nmax, rows=int(lens.sum()))
        return xb, lens

    def column(self, name: str, col: minh_mod.Column, x) -> None:
        """Write one data column, all cells encoded in one batched device
        call (ref go/minh/boundary.go:184-225); the groups' writes are one
        span, ``container.write``."""
        wr = self.wr
        if wr.cell_index is None:
            raise RuntimeError("call coordinates() before column()")
        if col.type in (minh_mod.Int64, minh_mod.Float32):
            # raw fixed groups: no encoding, host write is already optimal
            wr.column(name, col, x)
            return
        wr.cols.append(col)
        wr.names.append(name)
        f = wr.w.f

        if col.type == minh_mod.Int:
            xb, lens = self._cell_batch(x, np.int64)
            enc = self.enc.encode_int_blocks(xb, lens=lens)
            with profiling.span("container.write"):
                for r, n in enumerate(lens):
                    f.int_group(int(n))
                    f.data_encoded(enc.payloads[r], int(enc.mins[r]),
                                   int(enc.bits[r]))
        elif col.type == minh_mod.Float:
            buf = minh_mod.process_float_column(
                np.asarray(x, np.float32), col)
            xb, lens = self._cell_batch(buf, np.float32)
            pixels = spec.float_group_pixels(col.low, col.high, col.dx)
            enc = self.enc.encode_float_blocks(
                xb, col.low, col.high, pixels, lens=lens)
            with profiling.span("container.write"):
                for r, n in enumerate(lens):
                    f.float_group(int(n), (col.low, col.high), col.dx)
                    f.data_encoded(enc.payloads[r], int(enc.mins[r]),
                                   int(enc.bits[r]))
        else:
            raise ValueError("Can't write column with type flag %d"
                             % col.type)

    def close(self) -> None:
        self.wr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
