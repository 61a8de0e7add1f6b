"""minnow container writer (ref go/writer.go).

File layout (all little-endian, see docs/FORMAT.md and SURVEY.md App. A):

* ``[0, 48)``   six int64s ``{Magic, Version, Groups, Headers, Blocks,
  TailStart}`` -- zeros at create, finalized at close
  (ref go/writer.go:25-40,131-140).
* ``[48, TailStart)``  user header blocks and group data blocks interleaved
  in call order; a ``header()`` call ends the current group
  (ref go/writer.go:43-55).
* tail: ``headerOffsets, headerSizes, groupOffsets, groupTypes,
  groupBlocks`` as int64 arrays, then each group's tail record in creation
  order (ref go/writer.go:107-129).

The port's own copy of ``minnow_tpu/core/writer.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

import struct

import numpy as np

from . import groups as _groups
from .types import MAGIC, VERSION, is_fixed, type_match


def _header_bytes(x) -> bytes:
    """Serialize a user header value the way Go's ``binary.Write`` would:
    raw little-endian packed fields, no padding."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, str):
        return x.encode()
    if isinstance(x, bool):
        return struct.pack("<B", int(x))
    if isinstance(x, (int, np.integer)):
        return struct.pack("<q", int(x))
    if isinstance(x, (float, np.floating)):
        if isinstance(x, np.float32):
            return struct.pack("<f", float(x))
        return struct.pack("<d", float(x))
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x).astype(
            x.dtype.newbyteorder("<"), copy=False).tobytes()
    if isinstance(x, (list, tuple)):
        return np.asarray(x, dtype="<i8").tobytes()
    if hasattr(x, "tobytes"):
        return x.tobytes()
    raise TypeError("cannot serialize header of type %r" % type(x))


class Writer:
    """Sequential writer for a new minnow file (ref go/writer.go:10-29)."""

    def __init__(self, fname):
        self.f = open(fname, "w+b")
        self.headers = 0
        self.blocks = 0
        self.writers = []
        self.header_offsets: list[int] = []
        self.header_sizes: list[int] = []
        self.group_blocks: list[int] = []
        self.group_offsets: list[int] = []
        self._curr = None
        self.f.write(b"\0" * 48)

    # -- headers ----------------------------------------------------------

    def header(self, x) -> int:
        """Append a raw header block; ends the current group
        (ref go/writer.go:43-55)."""
        data = _header_bytes(x)
        self.header_offsets.append(self.f.tell())
        self.header_sizes.append(len(data))
        self.f.write(data)
        self.headers += 1
        self._curr = None
        return self.headers - 1

    # -- groups -----------------------------------------------------------

    def fixed_size_group(self, group_type: int, n: int) -> None:
        """Start an uncompressed fixed-dtype group
        (ref go/writer.go:59-61)."""
        if not is_fixed(group_type):
            raise ValueError("not a fixed-size group type: %d" % group_type)
        self._new_group(_groups.FixedSizeGroup(self.blocks, n, group_type))

    def int_group(self, n: int) -> None:
        """Start a minimum-precision int64 group (ref go/writer.go:65-67)."""
        self._new_group(_groups.IntGroup(self.blocks, n))

    def float_group(self, n: int, lim, dx: float,
                    clamp_q: bool = False) -> None:
        """Start a quantized float32 group with limits ``lim=(low, high)``
        and precision ``dx``; data assumed periodic
        (ref go/writer.go:72-75).  ``clamp_q`` guards non-periodic data
        against the reference's q == pixels wrap bug (see
        spec.encode_float_block)."""
        from . import spec

        low, high = lim
        pixels = spec.float_group_pixels(low, high, dx)
        self._new_group(
            _groups.FloatGroup(self.blocks, n, low, high, pixels, True,
                               clamp_q=clamp_q))

    def _new_group(self, g) -> None:
        self._curr = g
        self.writers.append(g)
        self.group_blocks.append(0)
        self.group_offsets.append(self.f.tell())

    # -- data blocks --------------------------------------------------------

    def data(self, x) -> int:
        """Append one data block to the current group
        (ref go/writer.go:90-103)."""
        if self._curr is None:
            raise RuntimeError(
                "Data written to minnow.Writer without assigning Group "
                "first.")
        type_match(x, self._curr.group_type())
        self._curr.write_data(self.f, x)
        self.group_blocks[-1] += 1
        self.blocks += 1
        return self.blocks - 1

    def data_encoded(self, payload: bytes, mn: int, bits: int) -> int:
        """Append a pre-encoded block (int/float groups only): packed
        payload plus its per-block metadata.  This is the device-pipeline
        fast path -- bytes were produced by ops/ on the device."""
        if self._curr is None or not hasattr(self._curr, "write_encoded"):
            raise RuntimeError("current group does not accept encoded blocks")
        self._curr.write_encoded(self.f, payload, mn, bits)
        self.group_blocks[-1] += 1
        self.blocks += 1
        return self.blocks - 1

    # -- finalize -----------------------------------------------------------

    def close(self) -> None:
        """Write tail arrays, per-group tails, then the real header
        (ref go/writer.go:107-141)."""
        tail_start = self.f.tell()
        i8 = np.dtype("<i8")
        for arr in (self.header_offsets, self.header_sizes,
                    self.group_offsets,
                    [g.group_type() for g in self.writers],
                    self.group_blocks):
            self.f.write(np.asarray(arr, dtype=i8).tobytes())
        for g in self.writers:
            g.write_tail(self.f)
        self.f.seek(0)
        self.f.write(struct.pack("<QQQQQq", MAGIC, VERSION,
                                 len(self.writers), self.headers,
                                 self.blocks, tail_start))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def create(fname) -> Writer:
    """Create a new minnow file (ref go/writer.go:32-40)."""
    return Writer(fname)
