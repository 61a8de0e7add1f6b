"""Device-batched minh reads: decode whole Float and Int columns on the
device (counterpart of ``minnow_tpu/formats/minh_device.py``).

The packed payloads are gathered on the host (file IO), grouped into
buckets of equal block length and width, and each bucket is decoded by
one launch of kernel K2 (floats, ``device_common.group_decode``) or K4
(ints, ``device_common.group_decode_ints``).  The result equals
``reader.floats`` / ``reader.ints`` bitwise, floats in every dither mode:
the device runs the host reader's arithmetic (``spec.dequantize``,
``spec.decode_int_block``) and its dither stream, keyed on the same
container block index.
"""

from __future__ import annotations

import numpy as np

from ..core import types as ctypes_
from ..ops import bitpack
from ..utils.device import cuda_device
from . import minh
from .device_common import group_decode, group_decode_ints

__all__ = ["read_floats", "read_ints", "read_column", "block_widths"]


def _raw_blocks(reader, c: int):
    """Container block index and raw block (``raw_block``: payload, min,
    bits, n, config) of each row-block of column ``c``."""
    # the container block index is also the dither key, as the host
    # reader passes it (core/reader.py data(b))
    block_ids = [reader._block_idx(c, b) for b in range(reader.blocks)]
    return block_ids, [reader.f.raw_block(i) for i in block_ids]


def block_widths(reader, name: str) -> list:
    """The distinct widths of column ``name``'s blocks, ascending: the
    widths its device read decodes at."""
    return sorted({r[2] for r in _raw_blocks(reader, reader._col(name))[1]})


def _buckets(reader, c: int):
    """``_raw_blocks`` of column ``c``, and its row-blocks grouped by
    (n, bits) with their (B, W) uint32 word matrix and (B,) minimums."""
    block_ids, raw = _raw_blocks(reader, c)
    groups: dict = {}
    for b, (_, _, bits, n, _) in enumerate(raw):
        groups.setdefault((n, bits), []).append(b)
    out = []
    for (n, bits), ids in groups.items():
        words = np.zeros((len(ids), max(bitpack.words_per_block(bits, n), 1)),
                         dtype=np.uint32)
        mins = np.empty(len(ids), np.int64)
        for row, b in enumerate(ids):
            payload, mins[row] = raw[b][:2]
            if bits:
                words[row] = bitpack.bytes_to_words(payload, bits, n)
        out.append((n, bits, ids, words, mins))
    return block_ids, raw, out


def read_floats(reader, names, device=None, dither: str = None,
                seed: int = None):
    """Read float columns of a ``minh.Reader`` on ``device`` (default: the
    CUDA device, an error without one); returns ``{name: float32 numpy
    array}`` over all blocks, as ``reader.floats``.  ``dither``/``seed``
    default to the reader's own, so the result equals
    ``reader.floats(names)`` bitwise."""
    if device is None:
        device = cuda_device()
    if dither is None:
        dither = reader.f.dither
    if seed is None:
        seed = reader.f.seed
    out = {}
    for name in names:
        c = reader._col(name)
        col = reader.columns[c]
        ctypes_.type_match(np.empty(0, np.float32), col.type)
        block_ids, raw, buckets = _buckets(reader, c)
        parts = [None] * len(raw)
        for n, bits, ids, words, mins in buckets:
            # (low, high, pixels, periodic) of each block
            lows, highs, pixels, periodic = zip(*(raw[b][4] for b in ids))
            dec = group_decode(words, mins, lows, highs, pixels, periodic,
                               bits, n, dither,
                               [block_ids[b] for b in ids], seed, device)
            dec = dec.cpu().numpy()
            for row, b in enumerate(ids):
                parts[b] = dec[row]

        arr = np.concatenate(parts) if parts else np.empty(0, np.float32)
        if col.log != 0:
            # ref go/minh/minh.go:315-319: 10**x in float64 -> float32
            arr = np.float32(np.power(10.0, arr.astype(np.float64)))
        out[name] = arr
    return out


def read_ints(reader, names, device=None):
    """Read ``Int`` (delta-coded) columns of a ``minh.Reader`` on
    ``device`` (default: the CUDA device, an error without one); returns
    ``{name: int64 numpy array}`` over all blocks, bitwise equal to
    ``reader.ints(names)``.  Raw ``Int64`` columns have nothing to decode
    and are refused: read them with ``reader.ints``."""
    if device is None:
        device = cuda_device()
    out = {}
    for name in names:
        c = reader._col(name)
        if reader.columns[c].type != minh.Int:
            raise TypeError("column %s is not an Int column (type %d)"
                            % (name, reader.columns[c].type))
        _, raw, buckets = _buckets(reader, c)
        parts = [None] * len(raw)
        for n, bits, ids, words, mins in buckets:
            dec = group_decode_ints(words, mins, bits, n, device)
            dec = dec.cpu().numpy()
            for row, b in enumerate(ids):
                parts[b] = dec[row]
        out[name] = np.concatenate(parts) if parts else np.empty(0, np.int64)
    return out


def read_column(reader, name, device=None):
    """One column of a ``minh.Reader``, routed by its type as the
    reference's CLIs route it (``minnow_tpu/cli/minh_to_bnd.py:61-73``):
    ``Float`` and ``Int`` columns decode on ``device`` (the host reader
    when it is None); raw fixed-width columns are a host read, with
    nothing to decode."""
    col = reader.columns[reader._col(name)]
    if device is not None and col.type == minh.Float:
        return read_floats(reader, [name], device)[name]
    if device is not None and col.type == minh.Int:
        return read_ints(reader, [name], device)[name]
    if col.type in (minh.Float, minh.Float32, minh.Float64):
        return reader.floats([name])[name]
    return reader.ints([name])[name]
