"""minnow container reader (ref go/reader.go).

Random access to any header or data block: the 48-byte header locates the
tail, the tail reconstructs every group's per-block metadata and byte
offsets (ref go/reader.go:28-88).

The port's own copy of ``minnow_tpu/core/reader.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

import builtins
import struct

import numpy as np

from . import dither as _dither
from .groups import FloatGroup, group_from_tail
from .types import MAGIC, VERSION, group_dtype, type_match


class Reader:
    """An open minnow file (ref go/reader.go:14-25)."""

    def __init__(self, fname, dither: str = _dither.UNIFORM, seed: int = 0):
        self.f = builtins.open(fname, "rb")
        self.dither = dither
        self.seed = seed

        hd = self.f.read(48)
        magic, version, groups, headers, blocks, tail_start = struct.unpack(
            "<QQQQQq", hd)
        if magic != MAGIC:
            raise ValueError(
                "%s is not a minnow file. Magic number is %x, not %x."
                % (fname, magic, MAGIC))
        if version != VERSION:
            raise ValueError(
                "%s was written with minnow version %d, but this code has "
                "version %d." % (fname, version, VERSION))

        self.groups = int(groups)
        self.headers = int(headers)
        self._blocks = int(blocks)

        self.f.seek(tail_start)
        i8 = np.dtype("<i8")

        def read_i8(n):
            return np.frombuffer(self.f.read(8 * n), dtype=i8)

        self.header_offsets = read_i8(self.headers)
        self.header_sizes = read_i8(self.headers)
        self.group_offsets = read_i8(self.groups)
        self.group_types = read_i8(self.groups)
        group_blocks = read_i8(self.groups)

        self.readers = [group_from_tail(self.f, self.group_types[i])
                        for i in range(self.groups)]

        self.block_index = np.repeat(
            np.arange(self.groups, dtype=np.int64), group_blocks)
        assert self.block_index.shape[0] == self._blocks

    # -- headers ------------------------------------------------------------

    def header_size(self, i: int) -> int:
        return int(self.header_sizes[i])

    def header(self, i: int, out_spec=None):
        """Read the i-th header block (ref go/reader.go:92-101).

        ``out_spec`` may be ``None``/``int`` (raw bytes), ``"s"`` (ascii
        string), a ``struct`` format string (tuple; scalar if length 1), or
        a numpy dtype (array; scalar if length 1).
        """
        self.f.seek(int(self.header_offsets[i]))
        raw = self.f.read(int(self.header_sizes[i]))
        if out_spec is None or isinstance(out_spec, int):
            return raw
        if out_spec == "s":
            return raw.decode()
        if isinstance(out_spec, str):
            vals = struct.unpack("<" + out_spec, raw)
            return vals[0] if len(vals) == 1 else vals
        dt = np.dtype(out_spec).newbyteorder("<")
        arr = np.frombuffer(raw, dtype=dt)
        return arr[0] if arr.shape == (1,) else arr

    # -- data blocks ----------------------------------------------------------

    def blocks(self) -> int:
        return self._blocks

    def data_type(self, b: int) -> int:
        return int(self.group_types[self.block_index[b]])

    def data_len(self, b: int) -> int:
        return self.readers[self.block_index[b]].length(b)

    def _seek_block(self, b: int):
        g = self.readers[self.block_index[b]]
        self.f.seek(int(self.group_offsets[self.block_index[b]])
                    + g.block_offset(b))
        return g

    def data(self, b: int, out=None):
        """Read and decode block ``b`` (ref go/reader.go:114-127)."""
        g = self._seek_block(b)
        if out is not None:
            type_match(out, g.group_type())
        if isinstance(g, FloatGroup):
            u = _dither.dither_u(self.dither, self.seed, b, g.ig.n)
            return g.read_data(self.f, b, out=out, u=u)
        return g.read_data(self.f, b, out=out)

    def raw_block(self, b: int):
        """Packed payload + metadata of an int/float block, for device-side
        batched decode.  Returns ``(payload, min, bits, n, params)`` where
        ``params`` is None for int groups and ``(low, high, pixels,
        periodic)`` for float groups."""
        g = self._seek_block(b)
        if isinstance(g, FloatGroup):
            payload, mn, bits, n = g.read_payload(self.f, b)
            return payload, mn, bits, n, (float(g.low), float(g.high),
                                          g.pixels, g.periodic)
        payload, mn, bits, n = g.read_payload(self.f, b)
        return payload, mn, bits, n, None

    def data_dtype(self, b: int):
        return group_dtype(self.data_type(b))

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open(fname, **kw) -> Reader:  # noqa: A001 - mirrors reference API
    """Open a minnow file (ref go/reader.go:28-88)."""
    return Reader(fname, **kw)
