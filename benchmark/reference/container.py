"""The minnow container's bytes, written and read back in plain Python.

Layout (all little-endian): six 64-bit words ``{Magic 0xACEDAD, Version
1, Groups, Headers, Blocks, TailStart}``; then header blocks and data
blocks in the order they were added; then the tail: the headers' offsets
and sizes, the groups' offsets, types and block counts (int64 arrays),
and each group's own tail in order.  A fixed-size group's tail is ``(n,
start block, blocks)``; an int group's adds its blocks' minimums and
widths, each min-subtracted and packed; a float group's adds ``(low f32,
high f32, pixels i64, periodic u8)`` to that.
"""

from __future__ import annotations

import struct

import numpy as np

from . import codec

MAGIC = 0xACEDAD
VERSION = 1
FIXED_TYPES = {np.dtype("<i8"): 0, np.dtype("<i4"): 1, np.dtype("<f4"): 9,
               np.dtype("<f8"): 8}
INT_GROUP = 10
FLOAT_GROUP = 11


def _packed_list(vals) -> bytes:
    """A tail list of int64 values: its minimum, its width, and the
    min-subtracted values packed."""
    arr = np.asarray(vals, np.int64).reshape(1, -1)
    mins, bits, deltas = codec.encode_int_rows(arr)
    mn = int(mins[0]) if arr.size else 0
    b = int(bits[0]) if arr.size else 0
    return struct.pack("<qq", mn, b) + codec.pack_rows(deltas, b)[0].tobytes()


class Container:
    """A minnow file built in memory: ``header``, ``fixed_group``,
    ``int_group`` / ``float_group`` with their encoded blocks, then
    ``bytes()``."""

    def __init__(self):
        self.parts = [b"\0" * 48]
        self.at = 48
        self.header_offsets, self.header_sizes = [], []
        self.groups = []  # (offset, type, blocks, tail)
        self.blocks = 0

    def _put(self, data: bytes) -> None:
        self.parts.append(data)
        self.at += len(data)

    def header(self, data: bytes) -> None:
        self.header_offsets.append(self.at)
        self.header_sizes.append(len(data))
        self._put(bytes(data))

    def fixed_group(self, arr) -> None:
        arr = np.ascontiguousarray(arr)
        gtype = FIXED_TYPES[arr.dtype.newbyteorder("<")]
        tail = struct.pack("<qqq", arr.size, self.blocks, 1)
        self.groups.append((self.at, gtype, 1, tail))
        self._put(arr.astype(arr.dtype.newbyteorder("<")).tobytes())
        self.blocks += 1

    def int_group(self, n, mins, bits, payloads, gtype=INT_GROUP,
                  float_tail=b"") -> None:
        """A group of ``len(payloads)`` encoded blocks of ``n`` values."""
        tail = (struct.pack("<qqq", n, self.blocks, len(payloads))
                + _packed_list(mins) + _packed_list(bits) + float_tail)
        self.groups.append((self.at, gtype, len(payloads), tail))
        for p in payloads:
            self._put(p)
        self.blocks += len(payloads)

    def float_group(self, n, low, high, pixels, mins, bits,
                    payloads) -> None:
        self.int_group(n, mins, bits, payloads, FLOAT_GROUP,
                       struct.pack("<ffqB", np.float32(low),
                                   np.float32(high), int(pixels), 1))

    def bytes(self) -> bytes:
        tail_start = self.at
        tail = [np.asarray(a, "<i8").tobytes() for a in (
            self.header_offsets, self.header_sizes,
            [g[0] for g in self.groups], [g[1] for g in self.groups],
            [g[2] for g in self.groups])]
        tail += [g[3] for g in self.groups]
        head = struct.pack("<QQQQQq", MAGIC, VERSION, len(self.groups),
                           len(self.header_offsets), self.blocks,
                           tail_start)
        return head + b"".join(self.parts[1:]) + b"".join(tail)


def _unpacked_list(buf, at, count):
    mn, bits = struct.unpack_from("<qq", buf, at)
    at += 16
    nb = codec.array_bytes(bits, count)
    raw = np.frombuffer(buf, np.uint8, nb, at)
    vals = np.zeros(count, np.int64)
    if bits:
        stream = np.unpackbits(raw, bitorder="little")[:count * bits]
        weights = (np.uint64(1) << np.arange(bits, dtype=np.uint64))
        vals = (stream.reshape(count, bits).astype(np.uint64)
                * weights).sum(axis=1, dtype=np.uint64).view(np.int64)
    return vals + mn, at + nb


def block_table(buf: bytes):
    """Every block of a minnow file, from its tail: a list of ``(group
    type, n, bits)`` in block order, ``bits`` None for a fixed-size
    group's raw block.  The roofline metrics count a kernel's bytes from
    it."""
    groups, headers, _, tail_start = struct.unpack_from("<QQQQQq", buf)[2:]
    at = tail_start + 16 * headers
    types = np.frombuffer(buf, "<i8", groups, at + 8 * groups)
    at += 24 * groups
    out = []
    for gtype in types.tolist():
        n, _, blocks = struct.unpack_from("<qqq", buf, at)
        at += 24
        if gtype in (INT_GROUP, FLOAT_GROUP):
            _, at = _unpacked_list(buf, at, blocks)
            bits, at = _unpacked_list(buf, at, blocks)
            out += [(gtype, n, int(b)) for b in bits]
            if gtype == FLOAT_GROUP:
                at += 17
        else:
            out += [(gtype, n, None)] * blocks
    return out
