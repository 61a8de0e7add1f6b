"""minh: the halo-catalog file format (ref go/minh/minh.go).

A minh file is a minnow container with a fixed 7-header layout
(ref go/minh/minh.go:78-93,151-156; SURVEY.md App. A.4):

  0: id ``{Magic=0xbaff1ed, Version=0, FileType}`` (3 int64)
  1: free text bytes
  2: column names joined by "$"
  3: ``[]Column`` -- 256 bytes each
  4: geometry ``{L f32, Boundary f32, Cells i64}``
  5: block count (int64)
  6: per-block lengths ([]int64)

Data groups: one minnow group (with a single block) per (row-block,
column); group index ``c + b*n_cols`` for basic files, ``c*blocks + b``
for boundary files (ref go/minh/minh.go:279-306).

Float columns with ``log != 0`` are log10'd on write and 10**x'd on read;
all Float columns are clamped to ``[low, nextafter(high, -inf)]`` before
quantization (ref go/minh/minh.go:141-149).  log10 uses the Go/fdlibm
algorithm (core/gomath.py) so files are byte-identical to the reference.

The port's own copy of ``minnow_tpu/formats/minh.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import struct

import numpy as np

from ..core import types as ctypes_
from ..core.writer import Writer as MinnowWriter
from ..core.reader import Reader as MinnowReader
from ..core import gomath
from ..utils import profiling

MAGIC = 0xBAFF1ED
VERSION = 0

BASIC_FILE_TYPE = 0
BOUNDARY_FILE_TYPE = 1

# Column type enum re-exported (same values as the minnow group enum,
# ref go/minh/minh.go:25-38).
Int64 = ctypes_.INT64_GROUP
Int32 = ctypes_.INT32_GROUP
Int16 = ctypes_.INT16_GROUP
Int8 = ctypes_.INT8_GROUP
Uint64 = ctypes_.UINT64_GROUP
Uint32 = ctypes_.UINT32_GROUP
Uint16 = ctypes_.UINT16_GROUP
Uint8 = ctypes_.UINT8_GROUP
Float64 = ctypes_.FLOAT64_GROUP
Float32 = ctypes_.FLOAT32_GROUP
Int = ctypes_.INT_GROUP
Float = ctypes_.FLOAT_GROUP

# On-disk 256-byte column record (ref go/minh/minh.go:50-55,79-82).
COLUMN_DTYPE = np.dtype([
    ("type", "<i8"),
    ("log", "<i4"),
    ("low", "<f4"),
    ("high", "<f4"),
    ("dx", "<f4"),
    ("buffer", "V232"),
])
assert COLUMN_DTYPE.itemsize == 256


@dataclass
class Column:
    """Column spec (ref go/minh/minh.go:50-55)."""

    type: int = Int64
    log: int = 0
    low: float = 0.0
    high: float = 0.0
    dx: float = 0.0
    buffer: bytes = field(default=b"", repr=False)

    def to_record(self):
        rec = np.zeros((), dtype=COLUMN_DTYPE)
        rec["type"] = self.type
        rec["log"] = self.log
        rec["low"] = np.float32(self.low)
        rec["high"] = np.float32(self.high)
        rec["dx"] = np.float32(self.dx)
        return rec

    @classmethod
    def from_record(cls, rec) -> "Column":
        return cls(type=int(rec["type"]), log=int(rec["log"]),
                   low=float(rec["low"]), high=float(rec["high"]),
                   dx=float(rec["dx"]),
                   buffer=bytes(rec["buffer"]))

    def __str__(self):
        return "{Type: %s, Log: %s, Range: (%g %g), Dx: %g}" % (
            ctypes_.GROUP_NAMES[self.type], bool(self.log), self.low,
            self.high, self.dx)


def columns_to_bytes(cols) -> bytes:
    arr = np.zeros(len(cols), dtype=COLUMN_DTYPE)
    for i, c in enumerate(cols):
        arr[i] = c.to_record()
    return arr.tobytes()


def process_float_column(x, col: Column) -> np.ndarray:
    """log10 + clamp preprocessing before quantization
    (ref go/minh/minh.go:141-149).  Returns float32."""
    buf = np.asarray(x, np.float32)
    owned = col.log != 0  # may we clamp in place? (never mutate caller data)
    if owned:
        from .. import native

        nat = native.log10_f32(buf)
        buf = nat if nat is not None else gomath.log10(
            buf.astype(np.float64)).astype(np.float32)
    low = np.float32(col.low)
    high_clamp = np.float32(np.nextafter(np.float32(col.high),
                                         np.float32(-np.inf)))
    if owned:
        # in-place twin of the where() pair below: maximum propagates
        # NaN like where(buf < low) keeps it, and no f32 exists
        # strictly between high_clamp and high, so minimum(., clamp)
        # == where(. >= high, clamp)
        np.maximum(buf, low, out=buf)
        np.minimum(buf, high_clamp, out=buf)
        return buf
    buf = np.where(buf < low, low, buf)
    buf = np.where(buf >= np.float32(col.high), high_clamp, buf)
    return buf


class Writer:
    """Basic minh writer (ref go/minh/minh.go:40-156).

    With ``encoder`` (a parallel.BlockEncoder), all Float columns of a
    row-block are quantized and packed in one batched device call, and
    all Int columns in another; bytes are identical to the host path."""

    def __init__(self, fname, file_type: int = BASIC_FILE_TYPE,
                 encode_workers: int = 0, encoder=None):
        self.f = MinnowWriter(fname)
        self.f.header(struct.pack("<qqq", MAGIC, VERSION, file_type))
        # column-encode pool size; 0 -> min(4, cores).  Callers running
        # several writers concurrently (text_to_minh --jobs) pass their
        # per-job thread share: 4 jobs x 4-thread pools thrashed a
        # 4-core host at 547 MB/s where 4 x 1 ran 615 (round-5 sweep)
        self._encode_workers = int(encode_workers)
        self.encoder = encoder
        self.cols: list[Column] = []
        self.names: list[str] = []
        self.blocks = 0
        self.block_sizes: list[int] = []
        self.l = np.float32(0)
        self.boundary = np.float32(0)
        self.cells = 0
        self._pool = None  # lazy per-writer column-encode thread pool

    def header(self, names, text: str, cols) -> None:
        """Write the text/names/columns headers
        (ref go/minh/minh.go:88-93)."""
        self.f.header(text.encode() if isinstance(text, str) else text)
        self.f.header("$".join(names).encode())
        self.f.header(columns_to_bytes(cols))
        self.cols = list(cols)
        self.names = list(names)

    def geometry(self, l: float, boundary: float, cells: int) -> None:
        self.l = np.float32(l)
        self.boundary = np.float32(boundary)
        self.cells = int(cells)

    def block(self, cols) -> None:
        """Write one row-block: one value array per column
        (ref go/minh/minh.go:99-139).  ``cols`` is a sequence matching the
        header's column order."""
        if len(cols) != len(self.cols):
            raise ValueError("Expected %d columns, got %d."
                             % (len(self.cols), len(cols)))
        n = len(np.asarray(cols[0]))
        for i, c in enumerate(cols):
            if len(np.asarray(c)) != n:
                raise ValueError("len(cols[%d]) = %d instead of %d"
                                 % (i, len(np.asarray(c)), n))
        if self.encoder is not None:
            encoded = self._encode_batched(cols)
        else:
            encoded = self._encode_host(cols, n)
        self.encoded_block(n, [encoded.get(i, x) for i, x in enumerate(cols)])

    def _encode_batched(self, cols) -> dict:
        """``(payload, min, bits)`` of every Int and Float column by
        column index: all Float columns in one ``encode_float_blocks``
        call (their per-column quantization configs broadcast with the
        batch), all Int columns in one ``encode_int_blocks`` call -- the
        multi-column analog of the reference's per-column loop."""
        from ..core import spec as _spec

        encoded = {}
        float_ids = [i for i, c in enumerate(self.cols) if c.type == Float]
        int_ids = [i for i, c in enumerate(self.cols) if c.type == Int]
        if float_ids:
            fcols = [self.cols[i] for i in float_ids]
            x = np.stack([process_float_column(cols[i], self.cols[i])
                          for i in float_ids])
            low = np.array([c.low for c in fcols], np.float32)
            high = np.array([c.high for c in fcols], np.float32)
            pixels = np.array([_spec.float_group_pixels(c.low, c.high, c.dx)
                               for c in fcols], np.int64)
            enc = self.encoder.encode_float_blocks(x, low, high, pixels)
            encoded.update((i, enc.block(r)) for r, i in enumerate(float_ids))
        if int_ids:
            x = np.stack([np.asarray(cols[i], np.int64) for i in int_ids])
            enc = self.encoder.encode_int_blocks(x)
            encoded.update((i, enc.block(r)) for r, i in enumerate(int_ids))
        return encoded

    def _encode_host(self, cols, n: int) -> dict:
        """``(payload, min, bits)`` of every Int and Float column by
        column index, by the host codec on worker threads -- the native
        encode/log10 kernels and numpy release the GIL, so columns
        genuinely parallelize on the host cores -- byte-identical to the
        sequential loop: the same per-column encode the groups' write_data
        runs, just hoisted."""
        from ..core import groups as _groups, spec as _spec

        def encode_col(i, x):
            col = self.cols[i]
            if col.type == Int:
                return _spec.encode_int_block(
                    np.asarray(x, np.int64),
                    pack=_groups._native().pack_bits)[:3]
            buf = process_float_column(x, col)
            pixels = _spec.float_group_pixels(col.low, col.high, col.dx)
            payload, mn, bits, _ = _groups._native().encode_float_block(
                buf, np.float32(col.low), np.float32(col.high), pixels,
                periodic=True, clamp_q=False)
            return payload, mn, bits

        enc_ids = [i for i, c in enumerate(self.cols)
                   if c.type in (Int, Float)]
        if len(enc_ids) > 1 and n:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                import os as _os

                self._pool = ThreadPoolExecutor(
                    max_workers=self._encode_workers
                    or min(4, _os.cpu_count() or 1))
            futs = {i: self._pool.submit(encode_col, i, cols[i])
                    for i in enc_ids}
            return {i: f.result() for i, f in futs.items()}
        return {i: encode_col(i, cols[i]) for i in enc_ids}

    def encoded_block(self, n: int, cols) -> None:
        """Write one row-block of ``n`` rows whose Int and Float columns
        are already encoded: ``cols[i]`` is a fixed-width column's values
        or a coded column's ``(payload, min, bits)``, as
        ``EncodedBlocks.block`` gives it (ref go/minh/minh.go:99-139).
        The groups' writes are one span, ``container.write``."""
        if len(cols) != len(self.cols):
            raise ValueError("Expected %d columns, got %d."
                             % (len(self.cols), len(cols)))
        self.block_sizes.append(n)
        self.blocks += 1
        with profiling.span("container.write"):
            for col, x in zip(self.cols, cols):
                if ctypes_.is_fixed(col.type):
                    self.f.fixed_size_group(col.type, n)
                    self.f.data(np.asarray(
                        x, ctypes_.group_dtype(col.type)))
                elif col.type == Int:
                    self.f.int_group(n)
                    self.f.data_encoded(*x)
                elif col.type == Float:
                    self.f.float_group(n, (col.low, col.high), col.dx)
                    self.f.data_encoded(*x)
                else:
                    raise ValueError("bad column type %d" % col.type)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        self.f.header(struct.pack("<ffq", self.l, self.boundary, self.cells))
        self.f.header(np.int64(self.blocks))
        self.f.header(np.asarray(self.block_sizes, dtype="<i8"))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def create(fname, encode_workers: int = 0, encoder=None) -> Writer:
    return Writer(fname, encode_workers=encode_workers, encoder=encoder)


class Reader:
    """minh reader (ref go/minh/minh.go:170-323)."""

    def __init__(self, fname, dither: str = "uniform", seed: int = 0):
        f = MinnowReader(fname, dither=dither, seed=seed)
        self.f = f
        magic, version, file_type = struct.unpack("<qqq", f.header(0))
        if magic != MAGIC:
            raise ValueError(
                "%s is not a minh file. Expected magic number %d, but got "
                "%d." % (fname, MAGIC, magic))
        if version < VERSION:
            raise ValueError(
                "%s written with minh version %d, but reader is version %d."
                % (fname, version, VERSION))
        self.file_type = file_type
        self.text = f.header(1).decode()
        self.names = f.header(2).decode().split("$")
        recs = np.frombuffer(f.header(3), dtype=COLUMN_DTYPE)
        self.columns = [Column.from_record(r) for r in recs]
        l, boundary, cells = struct.unpack("<ffq", f.header(4))
        self.l, self.boundary, self.cells = l, boundary, int(cells)
        self.blocks = int(f.header(5, "q"))
        self.block_lengths = [int(v) for v in f.header(6, np.int64).ravel()]
        self.length = sum(self.block_lengths)

    # -- helpers -----------------------------------------------------------

    def _col(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError("Name %s not in Reader.Names = %s."
                           % (name, self.names))

    def _block_idx(self, c: int, b: int) -> int:
        if self.file_type == BASIC_FILE_TYPE:
            return c + b * len(self.columns)
        return c * self.blocks + b

    # -- whole-file reads (ref go/minh/minh.go:232-265) --------------------

    def ints(self, names):
        out = {name: np.empty(self.length, np.int64) for name in names}
        end = 0
        for b in range(self.blocks):
            start, end = end, end + self.block_lengths[b]
            got = self.int_block(b, names)
            for name in names:
                out[name][start:end] = got[name]
        return out

    def floats(self, names):
        out = {name: np.empty(self.length, np.float32) for name in names}
        end = 0
        for b in range(self.blocks):
            start, end = end, end + self.block_lengths[b]
            got = self.float_block(b, names)
            for name in names:
                out[name][start:end] = got[name]
        return out

    # -- per-block reads (ref go/minh/minh.go:267-323) ---------------------

    def int_block(self, b: int, names):
        out = {}
        for name in names:
            c = self._col(name)
            ctypes_.type_match(np.empty(0, np.int64), self.columns[c].type)
            out[name] = np.asarray(self.f.data(self._block_idx(c, b)),
                                   dtype=np.int64)
        return out

    def float_block(self, b: int, names):
        out = {}
        for name in names:
            c = self._col(name)
            col = self.columns[c]
            ctypes_.type_match(np.empty(0, np.float32), col.type)
            arr = np.asarray(self.f.data(self._block_idx(c, b)),
                             dtype=np.float32)
            if col.log != 0:
                # ref go/minh/minh.go:315-319: 10**x in float64 -> float32
                arr = np.float32(np.power(10.0, arr.astype(np.float64)))
            out[name] = arr
        return out

    # -- boundary-file geometry helpers (ref python/minh.py:166-209) -------

    def is_boundary(self) -> bool:
        return self.cells > 0

    def cell_width(self) -> float:
        if not self.is_boundary():
            return self.l
        return self.l / self.cells

    def cell_origin(self, b: int) -> np.ndarray:
        ix = b % self.cells
        iy = (b // self.cells) % self.cells
        iz = b // (self.cells * self.cells)
        return np.array([ix, iy, iz]) * self.cell_width()

    def block_origin(self, b: int) -> np.ndarray:
        origin = self.cell_origin(b) - self.boundary
        origin[origin < 0] += self.l
        return origin

    def block_width(self) -> float:
        return self.cell_width() + self.boundary * 2

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def normalize_coords(coord, l, origin, width):
    """Shift a 3 x N coordinate array into a cell frame with periodic
    unwrapping, clipping to [0, width] (ref python/minh.py:193-209)."""
    out = [None] * 3
    for k in range(3):
        vec = np.asarray(coord[k]).copy()
        vec -= origin[k]
        vec[vec < -l / 4] += l
        vec[vec > (l / 4 + width)] -= l
        vec[vec < 0] = 0
        vec[vec > width] = width
        out[k] = vec
    return np.array(out)


def open(fname, **kw) -> Reader:  # noqa: A001
    return Reader(fname, **kw)
