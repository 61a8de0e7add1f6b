"""Bulk block decode on the device, shared by the device readers
(counterpart of ``minnow_tpu/formats/device_common.py``).

The route of a read: the blocks' places, widths, lengths and minimums come
from the container's tail, which the reader has parsed already
(:func:`tail_blocks`; no payload is read for them); the bytes of every
block asked for come from one ``seek`` and one ``read`` of the span of the
file that holds them (:func:`read_span`); the span goes to the device as
it lies, with every column's block table, in one host->device copy
(:func:`stage`); and each column is decoded by one launch of kernel K2
(float) or K4 (int) on a CUDA device (their plain versions on the CPU),
which turn the bytes into words on the card (:func:`decode_columns`).

Unlike the TPU path there is no bucketing by length and width, no padding
to a tile alignment and no eligibility test: every width and length
decodes here, and a column is one launch.  The first use of the decode
kernels on a CUDA device in a process certifies them (``ops.selfcheck``:
``decode``, and ``decode_uniform`` for the ``uniform`` dither); a
divergence raises, and nothing is decoded another way.

:func:`group_decode` and :func:`group_decode_ints` decode (B, W) word
matrices, for callers that hold words rather than a file's bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import FLOAT_GROUP, INT_GROUP
from ..ops import codec, decode, selfcheck

__all__ = ["Blocks", "Staged", "tail_blocks", "read_span", "read_payloads",
           "stage", "stage_columns", "decode_columns", "read_columns",
           "group_decode", "group_decode_ints"]


class Blocks(NamedTuple):
    """One column's blocks on the host, one entry a block (numpy).

    ``start`` is where each payload starts, in bytes (in the file, or in
    whatever buffer the caller holds); ``bits``, ``lens`` and ``mins`` are
    its width, length and minimum; ``config`` is None for int blocks and
    ``(low, high, pixels, periodic)`` for float blocks; ``ids`` are the
    container block indices, on which the ``uniform`` dither is keyed."""

    start: np.ndarray
    bits: np.ndarray
    lens: np.ndarray
    mins: np.ndarray
    config: tuple | None
    ids: np.ndarray

    @property
    def nbytes(self) -> np.ndarray:
        """Each payload's bytes (``spec.array_bytes``)."""
        return (self.bits * self.lens + 7) // 8


def tail_blocks(f, ids) -> Blocks:
    """The :class:`Blocks` of the container blocks ``ids`` of the open
    ``core.reader.Reader`` ``f``, all of int groups or all of float
    groups, from its parsed tail alone: ``start`` is each payload's byte
    offset in the file."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    groups = f.block_index[ids]
    start, bits, lens, mins = (np.empty(len(ids), np.int64)
                               for _ in range(4))
    config = [np.empty(len(ids), t) for t in (np.float32, np.float32,
                                              np.int64, bool)]
    floats = set()
    for g in np.unique(groups):
        gt = int(f.group_types[g])
        if gt not in (INT_GROUP, FLOAT_GROUP):
            raise TypeError("block of group %d (type %d) has nothing to "
                            "decode" % (g, gt))
        grp = f.readers[g]
        floats.add(gt == FLOAT_GROUP)
        ig = grp.ig if gt == FLOAT_GROUP else grp
        sel = groups == g
        local = ids[sel] - ig.start_block
        ends = np.asarray(ig.offsets, np.int64)
        starts = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
        start[sel] = int(f.group_offsets[g]) + starts[local]
        bits[sel] = np.asarray(ig.bits, np.int64)[local]
        mins[sel] = np.asarray(ig.mins, np.int64)[local]
        lens[sel] = ig.n
        if gt == FLOAT_GROUP:
            for a, v in zip(config, (grp.low, grp.high, grp.pixels,
                                     grp.periodic != 0)):
                a[sel] = v
    if len(floats) > 1:
        raise TypeError("blocks of int and of float groups in one column")
    return Blocks(start, bits, lens, mins,
                  tuple(config) if floats == {True} else None, ids)


def read_span(f, columns):
    """The bytes from the first payload of ``columns`` (:class:`Blocks`
    of the open reader ``f``, as :func:`tail_blocks` gives them) to the
    end of the last, by one ``seek`` and one ``read``: ``(span, s0)``,
    a uint8 array and its offset in the file.

    The span is contiguous per column where a column's blocks lie back
    to back: a boundary file's column (one group), a minp file's three
    axes.  In a basic minh file of several row-blocks the columns
    interleave, row-block by row-block (``formats/minh.py``
    ``Writer.block``), so a column's span also holds the other columns'
    bytes between its blocks; it is read once for all the columns a call
    asks for, and the copy to the device carries those bytes along."""
    starts = np.concatenate([c.start for c in columns])
    ends = starts + np.concatenate([c.nbytes for c in columns])
    if not starts.size:
        return np.zeros(0, np.uint8), 0
    s0, s1 = int(starts.min()), int(ends.max())
    f.f.seek(s0)
    data = f.f.read(s1 - s0)
    if len(data) != s1 - s0:
        raise ValueError("file ends %d bytes into a span of %d"
                         % (len(data), s1 - s0))
    return np.frombuffer(data, np.uint8), s0


def read_payloads(f, ids):
    """The payloads of the container blocks ``ids`` of ``f`` (all of int
    or all of float groups) as a list of bytes, from one read of their
    span, and their :class:`Blocks`."""
    blocks = tail_blocks(f, ids)
    span, s0 = read_span(f, [blocks])
    data = span.tobytes()
    return [data[a - s0:a - s0 + m] for a, m in
            zip(blocks.start.tolist(), blocks.nbytes.tolist())], blocks


def stage(device, arrays):
    """Numpy arrays -> tensors of the same dtypes and shapes on
    ``device``, by one host->device copy: the arrays lie back to back in
    one byte buffer, each at an 8-byte boundary, and the tensors are
    views of its copy."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, end = [], 0
    for a in arrays:
        offsets.append(end)
        end += -(-a.nbytes // 8) * 8
    buf = np.zeros(end, np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    on_dev = torch.from_numpy(buf).to(device)
    return [on_dev[o:o + a.nbytes].view(
        torch.from_numpy(a[:0].reshape(-1)).dtype).reshape(a.shape)
        for a, o in zip(arrays, offsets)]


class Staged(NamedTuple):
    """A column's decode arguments on the device: its block table, and
    for a float column its configs and (``uniform``) dither keys."""

    table: decode.BlockTable
    params: codec.BlockParams | None
    k1: torch.Tensor | None
    k2: torch.Tensor | None


def _check_blocks(c: Blocks, size: int) -> None:
    """Raise unless every block of ``c`` lies inside ``size`` bytes."""
    if c.bits.size and (c.bits.min() < 0 or c.bits.max() > 64):
        raise ValueError("widths must lie in [0, 64], got %s"
                         % sorted(set(c.bits.tolist())))
    if c.lens.size and c.lens.min() < 0:
        raise ValueError("negative block length %d" % c.lens.min())
    if c.start.size and (c.start.min() < 0
                         or (c.start + c.nbytes).max() > size):
        raise ValueError("a block lies outside the %d bytes of its span"
                         % size)


def stage_columns(span, columns, device, dither: str = "none",
                  seed: int = 0):
    """Put ``span`` (uint8 numpy, holding each block of ``columns`` at its
    ``start``) and every column's decode arguments on ``device`` by one
    host->device copy: ``(src, [Staged, ...])``, ``src`` the span as
    int32 words.  The span is padded to whole words and 8 bytes more, so
    a kernel's reads of a block's last words never leave it."""
    span = np.asarray(span, np.uint8).reshape(-1)
    for c in columns:
        _check_blocks(c, span.size)
    src = np.zeros(-(-span.size // 4) + 2, np.int32)
    src.view(np.uint8)[:span.size] = span
    cat = [np.concatenate([getattr(c, k) for c in columns]
                          or [np.zeros(0, np.int64)]).astype(np.int64)
           for k in ("start", "bits", "lens", "mins")]
    out_off = np.concatenate([np.cumsum(c.lens) - c.lens for c in columns]
                             or [np.zeros(0, np.int64)]).astype(np.int64)
    arrays = [src, cat[0] * 8, cat[1], cat[2], out_off, cat[3]]
    floats = [c for c in columns if c.config is not None]
    if floats:
        b = cat[0].size

        def config(i, dtype):
            a = np.zeros(b, dtype)
            end = 0
            for c in columns:
                if c.config is not None:
                    a[end:end + c.start.size] = c.config[i]
                end += c.start.size
            return a

        # the rows of int columns get a config no launch reads (1 pixel)
        arrays += codec.block_config(
            config(0, np.float32), config(1, np.float32),
            np.maximum(config(2, np.int64), 1), config(3, bool))
        if dither == "uniform":
            arrays += codec.dither_keys_np(
                np.concatenate([c.ids for c in columns]), seed)
    on_dev = stage(device, arrays)
    staged, end = [], 0
    for c in columns:
        rows = slice(end, end + c.start.size)
        end = rows.stop
        table = decode.BlockTable(*(t[rows] for t in on_dev[1:6]),
                                  int(c.lens.sum()),
                                  int(c.lens.max()) if c.lens.size else 0)
        params = k1 = k2 = None
        if c.config is not None:
            params = codec.BlockParams(*(t[rows] for t in on_dev[6:10]))
            if dither == "uniform":
                k1, k2 = (t[rows] for t in on_dev[10:12])
        staged.append(Staged(table, params, k1, k2))
    return on_dev[0], staged


def decode_columns(span, columns, device, dither: str = "none",
                   seed: int = 0):
    """Decode ``columns`` (:class:`Blocks` into ``span``) on ``device``:
    one host->device copy for all of them, then one launch of K4 (int) or
    K2 (float) a column.  Returns a flat tensor a column on ``device``,
    its blocks back to back in the order given.  The first use on a CUDA
    device certifies the kernels (``selfcheck``)."""
    selfcheck.certify("decode", device)
    if dither == "uniform" and any(c.config is not None for c in columns):
        selfcheck.certify("decode_uniform", device)
    src, staged = stage_columns(span, columns, device, dither, seed)
    out = []
    for c, s in zip(columns, staged):
        if c.config is None:
            out.append(decode.decode_int_ragged(src, s.table))
        else:
            out.append(decode.decode_float_ragged(src, s.table, s.params,
                                                  dither, s.k1, s.k2))
    return out


def read_columns(f, columns, device, dither: str = "none", seed: int = 0):
    """Decode the container blocks of ``f`` listed in ``columns`` (one
    list of block indices a column, each all int or all float blocks) on
    ``device``: one read of the span that holds them, one host->device
    copy, one launch a column.  Returns a flat tensor a column."""
    blocks = [tail_blocks(f, ids) for ids in columns]
    span, s0 = read_span(f, blocks)
    blocks = [b._replace(start=b.start - s0) for b in blocks]
    return decode_columns(span, blocks, device, dither, seed)


def _put_words(words, mins, device):
    words_t = torch.from_numpy(
        np.ascontiguousarray(words, np.uint32).view(np.int32)).to(device)
    mins_t = torch.from_numpy(np.asarray(mins, np.int64)).to(device)
    return words_t, mins_t


def group_decode(words, mins, lows, highs, pixels, periodic, bits: int,
                 n: int, dither: str, block_ids, seed: int, device):
    """(B, W) uint32 words (numpy) -> (B, n) float32 tensor on ``device``.

    ``mins``/``lows``/``highs``/``pixels``/``periodic`` are the blocks'
    (B,) numpy metadata; ``block_ids`` the container block indices the
    ``uniform`` dither is keyed on."""
    selfcheck.certify("decode", device)
    params = codec.block_params(lows, highs, pixels, periodic, device)
    words_t, mins_t = _put_words(words, mins, device)
    k1 = k2 = None
    if dither == "uniform":
        selfcheck.certify("decode_uniform", device)
        k1, k2 = codec.dither_keys(block_ids, seed, device)
    return decode.decode_float_group(words_t, mins_t, params, int(bits),
                                     int(n), dither, k1, k2)


def group_decode_ints(words, mins, bits: int, n: int, device):
    """(B, W) uint32 words (numpy) and their (B,) int64 minimums ->
    (B, n) int64 tensor on ``device``."""
    selfcheck.certify("decode", device)
    words_t, mins_t = _put_words(words, mins, device)
    return decode.decode_int_group(words_t, mins_t, int(bits), int(n))
