"""The three codec group families behind the container (ref go/group.go).

Groups do host-side byte framing only; the arithmetic lives in
``core.spec`` (normative numpy) and ``ops`` (the device).  Each group supports the
streaming host path (``write_data``) and a pre-encoded path
(``write_encoded``) used by the device pipeline, which hands over packed
payload bytes plus per-block metadata without re-encoding on host.

The port's own copy of ``minnow_tpu/core/groups.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

import struct

import numpy as np

from . import spec
from .blockindex import BlockIndex


def _native():
    """The C++ bit kernel (byte-identical to spec, validated in
    tests/test_native.py); spec fallback when no compiler is present."""
    from .. import native

    return native
from .types import (
    FIXED_SIZE_BYTES,
    FIXED_SIZE_DTYPES,
    FLOAT_GROUP,
    INT_GROUP,
)


class FixedSizeGroup(BlockIndex):
    """Raw little-endian arrays of the ten fixed dtypes
    (ref go/group.go:109-163)."""

    def __init__(self, start_block: int, n: int, group_type: int):
        super().__init__(start_block)
        self.n = int(n)
        self.gt = int(group_type)
        self.type_size = FIXED_SIZE_BYTES[self.gt]

    def group_type(self) -> int:
        return self.gt

    def length(self, b: int) -> int:
        return self.n

    def write_data(self, f, x) -> None:
        arr = np.asarray(x, FIXED_SIZE_DTYPES[self.gt])
        if arr.size != self.n:
            raise ValueError("block has %d elements, group expects %d"
                             % (arr.size, self.n))
        f.write(arr.tobytes())
        self.add_block(self.type_size * self.n)

    def write_tail(self, f) -> None:
        f.write(struct.pack("<qqq", self.n, self.start_block, self.blocks()))

    def read_data(self, f, b: int, out=None) -> np.ndarray:
        raw = f.read(self.n * self.type_size)
        arr = np.frombuffer(raw, dtype=FIXED_SIZE_DTYPES[self.gt])
        if out is not None:
            out[...] = arr
            return out
        return arr.copy()

    @classmethod
    def from_tail(cls, f, group_type: int) -> "FixedSizeGroup":
        n, start_block, blocks = struct.unpack("<qqq", f.read(24))
        g = cls(start_block, n, group_type)
        for _ in range(blocks):
            g.add_block(g.type_size * g.n)
        return g


class IntGroup(BlockIndex):
    """Per-block min-subtraction + fixed-width bit packing of int64 data
    (ref go/group.go:172-263).  The per-block ``mins``/``bits`` metadata is
    itself min-subtracted and bit-packed into the group tail
    (ref go/group.go:215-232)."""

    def __init__(self, start_block: int, n: int):
        super().__init__(start_block)
        self.n = int(n)
        self.mins: list[int] = []
        self.bits: list[int] = []

    def group_type(self) -> int:
        return INT_GROUP

    def length(self, b: int) -> int:
        return self.n

    def write_data(self, f, x) -> None:
        x = np.asarray(x, dtype=np.int64)
        if x.size != self.n:
            raise ValueError("block has %d elements, group expects %d"
                             % (x.size, self.n))
        payload, mn, bits = spec.encode_int_block(
            x, pack=_native().pack_bits)
        self.write_encoded(f, payload, mn, bits)

    def write_encoded(self, f, payload: bytes, mn: int, bits: int) -> None:
        """Append a pre-encoded block (device pipeline fast path)."""
        f.write(payload)
        self.mins.append(int(mn))
        self.bits.append(int(bits))
        self.add_block(spec.array_bytes(bits, self.n))

    def write_tail(self, f) -> None:
        def write_meta(vals):
            arr = np.asarray(vals, dtype=np.int64)
            mn = int(arr.min()) if arr.size else 0
            deltas = (arr - np.int64(mn)).view(np.uint64)
            bits = spec.precision_needed(int(deltas.max())) if arr.size else 0
            f.write(struct.pack("<qq", mn, bits))
            f.write(spec.pack_bits(deltas, bits))

        f.write(struct.pack("<qqq", self.n, self.start_block, self.blocks()))
        write_meta(self.mins)
        write_meta(self.bits)

    def read_data(self, f, b: int, out=None) -> np.ndarray:
        i = b - self.start_block
        bits, mn = self.bits[i], self.mins[i]
        payload = f.read(spec.array_bytes(bits, self.n)) if bits else b""
        arr = spec.decode_int_block(payload, mn, bits, self.n,
                                    unpack=_native().unpack_bits)
        if out is not None:
            out[...] = arr
            return out
        return arr

    def read_payload(self, f, b: int):
        """Raw packed payload + metadata for device-side batched decode."""
        i = b - self.start_block
        bits, mn = self.bits[i], self.mins[i]
        payload = f.read(spec.array_bytes(bits, self.n)) if bits else b""
        return payload, mn, bits, self.n

    @classmethod
    def from_tail(cls, f) -> "IntGroup":
        n, start_block, blocks = struct.unpack("<qqq", f.read(24))
        g = cls(start_block, n)

        def read_meta():
            mn, bits = struct.unpack("<qq", f.read(16))
            payload = f.read(spec.array_bytes(bits, blocks)) if bits else b""
            deltas = spec.unpack_bits(payload, bits, blocks)
            return [int(v) for v in (deltas.view(np.int64) + np.int64(mn))]

        g.mins = read_meta()
        g.bits = read_meta()
        for bits in g.bits:
            g.add_block(spec.array_bytes(bits, n))
        return g


class FloatGroup:
    """Bounded-precision quantized float32 storage on top of IntGroup
    (ref go/group.go:269-344)."""

    def __init__(self, start_block: int, n: int, low: float, high: float,
                 pixels: int, periodic: bool, clamp_q: bool = False):
        self.ig = IntGroup(start_block, n)
        self.low = np.float32(low)
        self.high = np.float32(high)
        self.pixels = int(pixels)
        self.periodic = 1 if periodic else 0
        # In-memory-only guard against the reference's q == pixels wrap bug
        # (see spec.encode_float_block); not part of the on-disk format.
        self.clamp_q = clamp_q

    def group_type(self) -> int:
        return FLOAT_GROUP

    def length(self, b: int) -> int:
        return self.ig.n

    @property
    def start_block(self):
        return self.ig.start_block

    def blocks(self) -> int:
        return self.ig.blocks()

    def block_offset(self, b: int) -> int:
        return self.ig.block_offset(b)

    def write_data(self, f, x) -> None:
        x = np.asarray(x, dtype=np.float32)
        if x.size != self.ig.n:
            raise ValueError("block has %d elements, group expects %d"
                             % (x.size, self.ig.n))
        payload, mn, bits, _ = _native().encode_float_block(
            x, self.low, self.high, self.pixels, periodic=self.periodic == 1,
            clamp_q=self.clamp_q)
        self.ig.write_encoded(f, payload, mn, bits)

    def write_encoded(self, f, payload: bytes, mn: int, bits: int) -> None:
        self.ig.write_encoded(f, payload, mn, bits)

    def write_tail(self, f) -> None:
        self.ig.write_tail(f)
        f.write(struct.pack("<ffqB", self.low, self.high, self.pixels,
                            self.periodic))

    def read_data(self, f, b: int, out=None, u=None) -> np.ndarray:
        q = self.ig.read_data(f, b)
        if self.periodic == 1:
            q = spec.bound(q, 0, self.pixels)
        arr = spec.dequantize(q, self.low, self.high, self.pixels, u=u)
        if out is not None:
            out[...] = arr
            return out
        return arr

    def read_payload(self, f, b: int):
        payload, mn, bits, n = self.ig.read_payload(f, b)
        return payload, mn, bits, n

    @classmethod
    def from_tail(cls, f) -> "FloatGroup":
        ig = IntGroup.from_tail(f)
        low, high, pixels, periodic = struct.unpack("<ffqB", f.read(17))
        g = cls(ig.start_block, ig.n, low, high, pixels, periodic != 0)
        g.ig = ig
        return g


def group_from_tail(f, group_type: int):
    """Reconstruct a group from its tail record
    (ref go/group.go:93-103)."""
    gt = int(group_type)
    if 0 <= gt <= 9:
        return FixedSizeGroup.from_tail(f, gt)
    if gt == INT_GROUP:
        return IntGroup.from_tail(f)
    if gt == FLOAT_GROUP:
        return FloatGroup.from_tail(f)
    raise ValueError("Unrecognized group type, %d." % gt)
