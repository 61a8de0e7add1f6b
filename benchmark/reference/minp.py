"""The plain reference of a snapshot's conversion and read-back.

From the LGadget-2 fileset the benchmark wrote, or from vectors already
in Lagrangian order, it works out the minp files that ``convert_snapshot
to_minp`` has to write, byte for byte, and the vectors a bulk read of
them has to give:

- the input: each file's 256-byte header between int32 record marks,
  then positions, velocities (times ``sqrt(a)``) and 64-bit IDs, each a
  record; positions wrapped into ``[0, L)``;
- the re-binning: particle ``id - 1`` is the Lagrangian site ``ix + iy N
  + iz N^2``; a file cell holds the sites of its cube, in row order;
- a file cell's file for positions (periodic, over ``[0, L)``) and for
  velocities (over ``[min, nextafter(max, 2 max)]`` of the file, pixels
  clamped below ``P``): each axis one float group of ``sub_cells^3``
  blocks, a block the ``n^3`` sites of one sub-cell in row order;
- the minp layout: header 0 ``(0xBADF00D, 0, 2)``, the snapshot header
  (7 float64, 2 int64, 1 float64), the source's raw header, the cell
  ``(index, file_cells, sub_cells)``, ``dx`` as float64 and the periodic
  byte, then the three groups.
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np

from . import codec
from .container import Container

MAGIC = 0xBADF00D
RHO_CRIT_0 = 2.77536627e11
_GADGET_HEADER = "<6I6d2d2i6I2i4d2i88s"


def read_gadget(path: str):
    """``(raw header, header fields, positions, velocities, ids)`` of one
    LGadget-2 file."""
    with open(path, "rb") as f:
        buf = f.read()
    raw = buf[4:260]
    h = struct.unpack(_GADGET_HEADER, raw)
    count = int(h[1]) + (int(h[0]) << 32)
    at = 264
    arrays = []
    for dtype, width in (("<f4", 3), ("<f4", 3), ("<i8", 1)):
        at += 4
        a = np.frombuffer(buf, dtype, count * width, at)
        arrays.append(a.reshape(count, width) if width > 1 else a)
        at += a.nbytes + 4
    return raw, h, arrays[0], arrays[1], arrays[2]


def snapshot_header(h) -> dict:
    """The minp header fields of an LGadget-2 header ``h`` (a tuple)."""
    time, redshift = h[12], h[13]
    n_total = int(h[17]) + (int(h[16]) << 32)
    c = float(n_total) ** (1.0 / 3)
    n_side = math.ceil(c) if math.ceil(c) - c < c - math.floor(c) \
        else math.floor(c)
    box, omega_m = h[24], h[25]
    return {"z": redshift, "scale": 1.0 / (1.0 + redshift),
            "omega_m": omega_m, "omega_l": h[26], "h100": h[27], "l": box,
            "n_side": int(n_side), "n_total": n_total, "time": time,
            "uniform_mp": box ** 3 * (omega_m * RHO_CRIT_0) / n_total}


def rebin(directory: str, lower=None):
    """Read an LGadget-2 fileset: ``(header, raw headers, x, v)`` with
    ``x`` and ``v`` (N, 3) float32 in Lagrangian order.  ``lower`` rounds
    both to a lower precision: the control."""
    files = sorted(os.path.join(directory, f) for f in os.listdir(directory))
    raws, x, v = [], None, None
    for path in files:
        raw, h, pos, vel, ids = read_gadget(path)
        hd = snapshot_header(h)
        if x is None:
            n = hd["n_total"]
            x = np.empty((n, 3), np.float32)
            v = np.empty((n, 3), np.float32)
        raws.append(raw)
        box = np.float32(hd["l"])
        pos = np.where(pos < 0, pos + box, pos)
        pos = np.where(pos >= box, pos - box, pos)
        x[ids - 1] = pos
        v[ids - 1] = vel * np.float32(math.sqrt(hd["time"]))
    if lower is not None:
        x, v = lower(x), lower(v)
    return hd, raws, x, v


def cell_sites(n_side: int, file_cells: int, index: int) -> np.ndarray:
    """The Lagrangian sites of file cell ``index``, in row order."""
    nf = n_side // file_cells
    fx = index % file_cells
    fy = index // file_cells % file_cells
    fz = index // (file_cells * file_cells)
    j = np.arange(nf, dtype=np.int64)
    iz, iy, ix = np.meshgrid(j + fz * nf, j + fy * nf, j + fx * nf,
                             indexing="ij")
    return (ix + iy * n_side + iz * n_side * n_side).reshape(-1)


def sub_cell_blocks(vec, sub_cells: int) -> np.ndarray:
    """(nf^3, 3) vectors of a cell in row order -> (s^3, n^3, 3): block
    ``(sz, sy, sx)`` holds its ``n^3`` sites in row order."""
    nf = round(len(vec) ** (1 / 3))
    s = sub_cells
    n = nf // s
    g = vec.reshape(s, n, s, n, s, n, 3).transpose(0, 2, 4, 1, 3, 5, 6)
    return g.reshape(s ** 3, n ** 3, 3)


def join_blocks(blocks, sub_cells: int) -> np.ndarray:
    s = sub_cells
    n = round(blocks.shape[1] ** (1 / 3))
    g = blocks.reshape(s, s, s, n, n, n, 3).transpose(0, 3, 1, 4, 2, 5, 6)
    return g.reshape(-1, 3)


class CellFile:
    """One minp file: a file cell's positions or velocities, encoded."""

    def __init__(self, vec, hd, raw, index, file_cells, sub_cells, step,
                 periodic):
        self.hd, self.raw, self.index = hd, raw, index
        self.file_cells, self.sub_cells = file_cells, sub_cells
        self.step, self.periodic = step, periodic
        vec = np.asarray(vec, np.float32)
        if periodic:
            self.low = np.zeros(3, np.float32)
            self.high = np.full(3, np.float32(hd["l"]), np.float32)
        else:
            self.low = vec.min(axis=0)
            hi = vec.max(axis=0)
            self.high = np.nextafter(hi, 2 * hi).astype(np.float32)
        blocks = sub_cell_blocks(vec, sub_cells)
        self.n = blocks.shape[1]
        self.axes = []
        for k in range(3):
            p = codec.float_group_pixels(self.low[k], self.high[k],
                                         np.float32(step))
            mins, bits, deltas, q = codec.encode_float_rows(
                np.ascontiguousarray(blocks[:, :, k]), self.low[k],
                self.high[k], p, clamp_q=not periodic)
            self.axes.append((p, mins, bits, codec.payloads(deltas, bits),
                              q))

    def file_bytes(self) -> bytes:
        hd = self.hd
        c = Container()
        c.header(struct.pack("<qqq", MAGIC, 0, 2))
        c.header(struct.pack("<dddddddqqd", hd["z"], hd["scale"],
                             hd["omega_m"], hd["omega_l"], hd["h100"],
                             hd["l"], 0.0, hd["n_side"], hd["n_total"],
                             hd["uniform_mp"]))
        c.header(self.raw)
        c.header(struct.pack("<qqq", self.index, self.file_cells,
                             self.sub_cells))
        c.header(struct.pack("<d", self.step))
        c.header(struct.pack("<B", 1 if self.periodic else 0))
        for k, (p, mins, bits, pay, _) in enumerate(self.axes):
            c.float_group(self.n, self.low[k], self.high[k], p, mins, bits,
                          pay)
        return c.bytes()

    def decoded(self, seed: int = 0) -> np.ndarray:
        """The file's vectors as a bulk read gives them, in row order,
        with the ``uniform`` dither keyed on ``seed`` and each block's
        container index (axis ``k``, sub-cell ``c``: ``k s^3 + c``)."""
        s3 = self.sub_cells ** 3
        out = np.empty((s3, self.n, 3), np.float32)
        for k, (p, _, _, _, q) in enumerate(self.axes):
            u = codec.dither_u(seed, np.arange(s3) + k * s3, self.n)
            val = codec.dequantize(codec.wrap(q, 0, p), self.low[k],
                                   self.high[k], p, u)
            if self.periodic:
                box = np.float32(self.hd["l"])
                val = np.where(val < 0, val + box, val)
                val = np.where(val >= box, val - box, val)
            out[:, :, k] = val
        return join_blocks(out, self.sub_cells)


def fileset(x, v, hd, raws, file_cells, sub_cells, dx, dv):
    """Every file of the fileset: ``{name: CellFile}``, named
    ``x_<i>.minp`` and ``v_<i>.minp``."""
    out = {}
    for i in range(file_cells ** 3):
        sites = cell_sites(hd["n_side"], file_cells, i)
        raw = raws[min(i, len(raws) - 1)]
        out["x_%d.minp" % i] = CellFile(x[sites], hd, raw, i, file_cells,
                                        sub_cells, dx, True)
        out["v_%d.minp" % i] = CellFile(v[sites], hd, raw, i, file_cells,
                                        sub_cells, dv, False)
    return out
