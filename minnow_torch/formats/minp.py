"""minp: the particle-snapshot file format (ref go/minp/minp.go).

Header layout (ref go/minp/minp.go:64-84; SURVEY.md App. A.5):

  0: id ``{Magic=0xbadf00d, Version=0, FileType=2}`` (the reference's
     ``basicFileType = iota`` inside that const block evaluates to 2 --
     ref go/minp/minp.go:10-15; replicated for byte parity)
  1: ``Header`` struct (7 float64, 2 int64, 1 float64)
  2: raw original snapshot header bytes
  3: ``Cell{FileIndex, FileCells, SubCells}`` (3 int64)
  4: dx float64
  5: periodic byte

Data: three float groups (x, y, z axes), each with ``subCells**3`` blocks
of ``nSub**3`` values, in k-major block order.  Sub-cell extraction
(ref go/minp/minp.go:246-288, two nested scalar loop nests) is a single
``reshape + transpose`` here -- XLA lowers it to one tiled copy.

The port's own copy of ``minnow_tpu/formats/minp.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

from dataclasses import dataclass
import struct

import numpy as np
import torch

from ..core.writer import Writer as MinnowWriter
from ..core.reader import Reader as MinnowReader
from ..utils import profiling

MAGIC = 0xBADF00D
VERSION = 0
BASIC_FILE_TYPE = 2  # iota quirk, see module docstring

_HEADER_FMT = "<dddddddqqd"
_CELL_FMT = "<qqq"


@dataclass
class Header:
    """Snapshot metadata (ref go/minp/minp.go:24-31)."""

    z: float = 0.0
    scale: float = 0.0
    omega_m: float = 0.0
    omega_l: float = 0.0
    h100: float = 0.0
    l: float = 0.0
    epsilon: float = 0.0
    n_side: int = 0
    n_total: int = 0
    uniform_mp: float = 0.0

    def pack(self) -> bytes:
        return struct.pack(_HEADER_FMT, self.z, self.scale, self.omega_m,
                           self.omega_l, self.h100, self.l, self.epsilon,
                           self.n_side, self.n_total, self.uniform_mp)

    @classmethod
    def unpack(cls, raw: bytes) -> "Header":
        vals = struct.unpack(_HEADER_FMT, raw)
        return cls(*vals)


@dataclass
class Cell:
    """File-cell decomposition info (ref go/minp/minp.go:32-36)."""

    file_index: int = 0
    file_cells: int = 1
    sub_cells: int = 1

    def n_file(self, n_side: int) -> int:
        if n_side < 0 or self.file_cells < 0 or \
                n_side % self.file_cells != 0:
            raise ValueError("NSide = %d not a valid combination with "
                             "FileCells = %d" % (n_side, self.file_cells))
        return n_side // self.file_cells

    def file_coord(self):
        fc = self.file_cells
        return (self.file_index % fc, (self.file_index // fc) % fc,
                self.file_index // (fc * fc))

    def pack(self) -> bytes:
        return struct.pack(_CELL_FMT, self.file_index, self.file_cells,
                           self.sub_cells)

    @classmethod
    def unpack(cls, raw: bytes) -> "Cell":
        return cls(*struct.unpack(_CELL_FMT, raw))


def _sub_cell_side(length: int, sub_cells: int) -> int:
    """nSub, the side of a sub-cell, for ``length`` vectors of a file."""
    n_file = round(length ** (1 / 3))
    while n_file ** 3 < length:
        n_file += 1
    if n_file ** 3 != length:
        raise ValueError("len(vec)=%d is not a cube" % length)
    n = n_file // sub_cells
    if n * sub_cells != n_file:
        raise ValueError("subCells=%d does not divide nFile=%d"
                         % (sub_cells, n_file))
    return n


def split_sub_cells(vec, sub_cells: int):
    """(nFile**3, 3) row-major vectors -> (subCells**3, nSub**3, 3) sub-cell
    blocks, matching the reference's getSubCell element order
    (ref go/minp/minp.go:246-264).  Pure reshape/transpose -- one
    strided copy, not 2*nFile**3 scalar loop iterations."""
    vec = np.asarray(vec)
    s = sub_cells
    n = _sub_cell_side(len(vec), s)
    g = vec.reshape(s, n, s, n, s, n, 3)  # (sz, jz, sy, jy, sx, jx, k)
    g = g.transpose(0, 2, 4, 1, 3, 5, 6)  # (sz, sy, sx, jz, jy, jx, k)
    return g.reshape(s * s * s, n * n * n, 3)


def split_axes(vec, sub_cells: int):
    """The blocks of :func:`split_sub_cells` of a (nFile**3, 3) tensor,
    axis first: (3, subCells**3, nSub**3), contiguous, on the tensor's
    device (one copy there)."""
    s = sub_cells
    n = _sub_cell_side(len(vec), s)
    g = vec.reshape(s, n, s, n, s, n, 3)  # (sz, jz, sy, jy, sx, jx, k)
    g = g.permute(6, 0, 2, 4, 1, 3, 5)  # (k, sz, sy, sx, jz, jy, jx)
    return g.contiguous().view(3, s * s * s, n * n * n)


def join_sub_cells(blocks, sub_cells: int):
    """Inverse of :func:`split_sub_cells`
    (ref go/minp/minp.go:270-288, setSubCell)."""
    blocks = np.asarray(blocks)
    s = sub_cells
    n3 = blocks.shape[1]
    n = round(n3 ** (1 / 3))
    while n ** 3 < n3:
        n += 1
    g = blocks.reshape(s, s, s, n, n, n, 3)
    g = g.transpose(0, 3, 1, 4, 2, 5, 6)  # (sz, jz, sy, jy, sx, jx, k)
    return g.reshape(s * s * s * n3, 3)


def lagrangian_ids(cell: Cell, n_side: int):
    """Lagrangian particle IDs of a file-cell, arithmetic reconstruction
    (ref go/minp/minp.go:210-230)."""
    n_file = cell.n_file(n_side)
    fx, fy, fz = cell.file_coord()
    jz, jy, jx = np.meshgrid(
        np.arange(n_file, dtype=np.int64),
        np.arange(n_file, dtype=np.int64),
        np.arange(n_file, dtype=np.int64), indexing="ij")
    ix = jx + fx * n_file
    iy = jy + fy * n_file
    iz = jz + fz * n_file
    return (ix + iy * n_side + iz * n_side * n_side).reshape(-1)


class Writer:
    """minp writer (ref go/minp/minp.go:55-123).

    With ``encoder`` (a parallel.BlockEncoder), each axis's sub-cell
    blocks are quantized/packed in one batched device call; bytes are
    identical to the host path."""

    def __init__(self, fname, encoder=None):
        self.f = MinnowWriter(fname)
        self.f.header(struct.pack("<qqq", MAGIC, VERSION, BASIC_FILE_TYPE))
        self.hd = None
        self.cell = None
        self.periodic = True
        self.dx = np.float32(0)
        self.encoder = encoder

    def header(self, hd: Header, raw_hd: bytes, cell: Cell, dx: float,
               periodic: bool) -> None:
        self.f.header(hd.pack())
        self.f.header(bytes(raw_hd))
        self.f.header(cell.pack())
        self.f.header(struct.pack("<d", dx))
        self.f.header(struct.pack("<B", 1 if periodic else 0))
        self.hd = hd
        self.cell = cell
        self.periodic = periodic
        self.dx = np.float32(dx)

    def vectors(self, vec) -> None:
        """Write an (N, 3) float32 vector array as 3 k-major float groups of
        sub-cell blocks (ref go/minp/minp.go:86-119).

        With an encoder, ``vec`` may be a float32 tensor on its device:
        the bounds, the sub-cell split and the encode then run there, and
        only the six bounds and the encoded blocks come to the host."""
        on_device = torch.is_tensor(vec)
        if on_device and self.encoder is None:
            raise TypeError("a tensor of vectors needs the writer's encoder")
        if not on_device:
            vec = np.asarray(vec, dtype=np.float32)
        if self.periodic:
            l = np.float32(self.hd.l)
            mins = np.zeros(3, np.float32)
            maxs = np.full(3, l, np.float32)
        else:
            if on_device:
                # exact in any order: one reduction, six floats back
                mins, maxs = (t.cpu().numpy()
                              for t in torch.aminmax(vec, dim=0))
            else:
                mins = vec.min(axis=0)
                maxs = vec.max(axis=0)
            # ref go/minp/minp.go:93-95: nudge each max one ulp toward
            # 2*max (upward for positive bounds)
            maxs = np.nextafter(maxs, 2 * maxs).astype(np.float32)

        n_file = self.cell.n_file(int(self.hd.n_side))
        if n_file ** 3 != len(vec):
            raise ValueError(
                "len(vec) = %d, but NSide = %d and FileCells = %d"
                % (len(vec), self.hd.n_side, self.cell.file_cells))
        s = self.cell.sub_cells
        with profiling.span("minp.split_sub_cells", vec.nbytes):
            if on_device:
                axes = split_axes(vec, s)  # (3, S^3, nSub^3)
            else:
                blocks = split_sub_cells(vec, s)  # (S^3, nSub^3, 3)
                if self.encoder is not None:
                    # each axis's blocks contiguous, as a batch is encoded
                    axes = np.ascontiguousarray(blocks.transpose(2, 0, 1))
        n_sub3 = axes.shape[2] if on_device else blocks.shape[1]
        for k in range(3):
            # clamp_q only for non-periodic data: guards the reference's
            # q == pixels wrap bug (SURVEY.md App. B #9); for periodic data
            # the wrap to pixel 0 is correct (0 == L on the circle).
            self.f.float_group(n_sub3, (mins[k], maxs[k]), self.dx,
                               clamp_q=not self.periodic)
            if self.encoder is not None:
                from ..core import spec as _spec

                pixels = _spec.float_group_pixels(mins[k], maxs[k],
                                                  self.dx)
                enc = self.encoder.encode_float_blocks(
                    axes[k], mins[k], maxs[k], pixels,
                    clamp_q=not self.periodic)
                enc.write_to(self.f)
            else:
                for sc in range(blocks.shape[0]):
                    self.f.data(np.ascontiguousarray(blocks[sc, :, k]))

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def create(fname, encoder=None) -> Writer:
    return Writer(fname, encoder=encoder)


class Reader:
    """minp reader (ref go/minp/minp.go:130-240)."""

    def __init__(self, fname, dither: str = "uniform", seed: int = 0):
        self.f = MinnowReader(fname, dither=dither, seed=seed)
        magic, version, file_type = struct.unpack("<qqq", self.f.header(0))
        if magic != MAGIC:
            raise ValueError("Not a minp file. Magic number is %d, not %d"
                             % (magic, MAGIC))
        if version != VERSION:
            raise ValueError("File version = %d, but code version = %d."
                             % (version, VERSION))
        if file_type != BASIC_FILE_TYPE:
            raise ValueError("File type = %d" % file_type)
        self.header = Header.unpack(self.f.header(1))
        self.raw_header = self.f.header(2)
        self.cell = Cell.unpack(self.f.header(3))
        self.dx = self.f.header(4, "d")
        self.periodic = self.f.header(5)[0] != 0
        self.file_index = self.cell.file_index
        self.file_cells = self.cell.file_cells

    def n_blocks_per_axis(self) -> int:
        """blocks/3 = subCells**3 (what the reference's ``N()`` actually
        returns -- ref go/minp/minp.go:233-235)."""
        return self.f.blocks() // 3

    def n(self) -> int:
        """Particles in the file: subCells**3 * nSub**3."""
        return self.n_blocks_per_axis() * (self.f.data_len(0)
                                           if self.f.blocks() else 0)

    def vectors(self, out=None) -> np.ndarray:
        """Read all vectors back in row-major file order
        (ref go/minp/minp.go:175-207)."""
        s = self.cell.sub_cells
        s3 = s * s * s
        if self.f.blocks() != 3 * s3:
            raise ValueError("Expected %d sub-cell blocks, but got %d"
                             % (3 * s3, self.f.blocks()))
        n_sub3 = self.f.data_len(0)
        l = np.float32(self.header.l)
        blocks = np.empty((s3, n_sub3, 3), dtype=np.float32)
        for sc in range(s3):
            for k in range(3):
                arr = self.f.data(k * s3 + sc)
                if self.periodic:
                    arr = np.where(arr < 0, arr + l, arr)
                    arr = np.where(arr >= l, arr - l, arr)
                blocks[sc, :, k] = arr
        vec = join_sub_cells(blocks, s)
        if out is not None:
            out[...] = vec
            return out
        return vec

    def ids(self, out=None) -> np.ndarray:
        ids = lagrangian_ids(self.cell, int(self.header.n_side))
        if out is not None:
            out[...] = ids
            return out
        return ids

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open(fname, **kw) -> Reader:  # noqa: A001
    return Reader(fname, **kw)
