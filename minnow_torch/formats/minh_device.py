"""Device-batched minh reads: decode whole Float and Int columns on the
device (counterpart of ``minnow_tpu/formats/minh_device.py``).

Each column's blocks come from the container's parsed tail; the bytes of
all the columns a call asks for come from one read of the file span that
holds them, go to the device in one copy, and each column is decoded by
one launch of kernel K2 (floats) or K4 (ints), ragged over its row-blocks
(``device_common.read_columns``), and comes back in one copy.  The
result equals ``reader.floats`` / ``reader.ints`` bitwise, floats in every
dither mode: the device runs the host reader's arithmetic
(``spec.dequantize``, ``spec.decode_int_block``) and its dither stream,
keyed on the same container block index.
"""

from __future__ import annotations

import numpy as np

from ..core import types as ctypes_
from ..utils.device import cuda_device
from . import minh
from .device_common import read_columns, tail_blocks

__all__ = ["read_floats", "read_ints", "read_column", "block_widths"]


def _column_ids(reader, c: int) -> list:
    """The container block index of each row-block of column ``c``: also
    the dither key, as the host reader passes it (core/reader.py
    data(b))."""
    return [reader._block_idx(c, b) for b in range(reader.blocks)]


def block_widths(reader, name: str) -> list:
    """The distinct widths of column ``name``'s blocks, ascending, from
    the container's tail: the widths its device read decodes at."""
    blocks = tail_blocks(reader.f, _column_ids(reader, reader._col(name)))
    return sorted(set(blocks.bits.tolist()))


def read_floats(reader, names, device=None, dither: str = None,
                seed: int = None):
    """Read float columns of a ``minh.Reader`` on ``device`` (default: the
    CUDA device, an error without one); returns ``{name: float32 numpy
    array}`` over all blocks, as ``reader.floats``.  ``dither``/``seed``
    default to the reader's own, so the result equals
    ``reader.floats(names)`` bitwise.  One launch of K2 a column."""
    if device is None:
        device = cuda_device()
    if dither is None:
        dither = reader.f.dither
    if seed is None:
        seed = reader.f.seed
    cols = [reader._col(name) for name in names]
    for c in cols:
        ctypes_.type_match(np.empty(0, np.float32), reader.columns[c].type)
    decoded = read_columns(reader.f, [_column_ids(reader, c) for c in cols],
                           device, dither, seed)
    out = {}
    for name, c, dec in zip(names, cols, decoded):
        arr = dec.cpu().numpy()
        if reader.columns[c].log != 0:
            # ref go/minh/minh.go:315-319: 10**x in float64 -> float32
            arr = np.float32(np.power(10.0, arr.astype(np.float64)))
        out[name] = arr
    return out


def read_ints(reader, names, device=None):
    """Read ``Int`` (delta-coded) columns of a ``minh.Reader`` on
    ``device`` (default: the CUDA device, an error without one); returns
    ``{name: int64 numpy array}`` over all blocks, bitwise equal to
    ``reader.ints(names)``.  Raw ``Int64`` columns have nothing to decode
    and are refused: read them with ``reader.ints``.  One launch of K4 a
    column."""
    if device is None:
        device = cuda_device()
    cols = [reader._col(name) for name in names]
    for name, c in zip(names, cols):
        if reader.columns[c].type != minh.Int:
            raise TypeError("column %s is not an Int column (type %d)"
                            % (name, reader.columns[c].type))
    decoded = read_columns(reader.f, [_column_ids(reader, c) for c in cols],
                           device)
    return {name: dec.cpu().numpy() for name, dec in zip(names, decoded)}


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
