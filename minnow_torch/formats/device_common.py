"""Bulk block decode on the device, shared by the device readers
(counterpart of ``minnow_tpu/formats/device_common.py``).

The route of a read: the blocks' places, widths, lengths and minimums come
from the container's tail, which the reader has parsed already
(:func:`tail_blocks`; no payload is read for them); every column's block
table is written into the thread's staging buffer, after the room for the
span of the file that holds the blocks asked for; the span is read into
that room by one ``seek`` and one ``readinto``; the buffer goes to the
device in one host->device copy; and each column is decoded by one launch
of kernel K2 (float) or K4 (int) on a CUDA device (their plain versions on
the CPU), which turn the bytes into words on the card
(:func:`read_columns`).

The staging buffer is reused from call to call, one a thread (pinned host
memory for a CUDA device): it grows to the largest span and tables seen,
with a quarter more, and never shrinks.  Its copy to a CUDA device is
asynchronous, and the next call to stage into it first waits for the
event recorded after that copy.  On the CPU the copy is a new tensor, so
no result is a view of the buffer.

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

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import FLOAT_GROUP, INT_GROUP
from ..ops import codec, decode, selfcheck
from ..utils import profiling

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


@profiling.traced("read.tail")
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


def _extent(columns):
    """``(s0, s1)``: the first payload's byte of ``columns`` and the end
    of the last; ``(0, 0)`` when they hold no block."""
    starts = np.concatenate([c.start for c in columns]
                            or [np.zeros(0, np.int64)])
    if not starts.size:
        return 0, 0
    ends = starts + np.concatenate([c.nbytes for c in columns])
    return int(starts.min()), int(ends.max())


def _read_into(f, s0: int, out) -> None:
    """``out`` (uint8 numpy) filled from byte ``s0`` of the open reader
    ``f``'s file by one ``seek`` and one ``readinto``."""
    with profiling.span("read.span", out.size):
        f.f.seek(s0)
        got = f.f.readinto(memoryview(out))
    if got != out.size:
        raise ValueError("file ends %d bytes into a span of %d"
                         % (got, out.size))


def read_span(f, columns):
    """The bytes from the first payload of ``columns`` (:class:`Blocks`
    of the open reader ``f``, as :func:`tail_blocks` gives them) to the
    end of the last, by one ``seek`` and one ``readinto``: ``(span,
    s0)``, a uint8 array and its offset in the file.  (A bulk read reads
    its span straight into the staging buffer instead.)

    The span is contiguous per column where a column's blocks lie back
    to back: a boundary file's column (one group), a minp file's three
    axes.  In a basic minh file of several row-blocks the columns
    interleave, row-block by row-block (``formats/minh.py``
    ``Writer.block``), so a column's span also holds the other columns'
    bytes between its blocks; it is read once for all the columns a call
    asks for, and the copy to the device carries those bytes along."""
    s0, s1 = _extent(columns)
    span = np.empty(s1 - s0, np.uint8)
    _read_into(f, s0, span)
    return span, s0


def read_payloads(f, ids):
    """The payloads of the container blocks ``ids`` of ``f`` (all of int
    or all of float groups) as a list of bytes, from one read of their
    span, and their :class:`Blocks`."""
    blocks = tail_blocks(f, ids)
    span, s0 = read_span(f, [blocks])
    data = span.tobytes()
    return [data[a - s0:a - s0 + m] for a, m in
            zip(blocks.start.tolist(), blocks.nbytes.tolist())], blocks


_GRAIN = 1 << 20  # a staging buffer's size is a whole number of MiB
_local = threading.local()


class _Staging:
    """One thread's staging buffer for one kind of device: host bytes
    reused from call to call, pinned where they feed a CUDA device, and
    the event that follows the last copy out of them."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.host = torch.empty(0, dtype=torch.uint8)
        self.event = None

    def take(self, nbytes: int):
        """The buffer's first ``nbytes`` as a uint8 numpy array, free to
        write: waits for the last copy out of the buffer, and where the
        buffer is too small replaces it by one a quarter larger than
        asked, so that spans of about one size take turns in it.  Returns
        ``(bytes, allocs)``, ``allocs`` 1 where it allocated, else 0."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        allocs = int(self.host.numel() < nbytes)
        if allocs:
            # free the old buffer before the new one is allocated
            self.host = torch.empty(0, dtype=torch.uint8)
            size = -(-(nbytes + nbytes // 4) // _GRAIN) * _GRAIN
            self.host = torch.empty(size, dtype=torch.uint8,
                                    pin_memory=self.pinned)
        return self.host.numpy()[:nbytes], allocs

    def copy(self, nbytes: int, device) -> torch.Tensor:
        """The buffer's first ``nbytes`` in a new uint8 tensor on
        ``device``, by one copy; on a CUDA device asynchronous, with an
        event after it that the next :meth:`take` waits for."""
        with profiling.span("read.copy", nbytes):
            out = torch.empty(nbytes, dtype=torch.uint8, device=device)
            out.copy_(self.host[:nbytes], non_blocking=self.pinned)
            if self.pinned:
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(out.device))
        return out


def _staging(device) -> _Staging:
    """This thread's staging buffer for ``device``: pinned for a CUDA
    device, pageable for the CPU.  Threads never share one."""
    pinned = torch.device(device).type == "cuda"
    mine = _local.__dict__.setdefault("staging", {})
    if pinned not in mine:
        mine[pinned] = _Staging(pinned)
    return mine[pinned]


def _padded(size: int) -> int:
    """The bytes of a span of ``size`` bytes as kernels read it: whole
    int32 words and 8 bytes more, so that a kernel's reads of a block's
    last words never leave it."""
    return 4 * (-(-size // 4) + 2)


class _Laid(NamedTuple):
    """Arrays laid out in a staging buffer by :func:`_stage`: the buffer,
    its bytes up to ``end``, the padded span's bytes at its front
    (``head``), and the arrays (contiguous) at ``offsets``."""

    staging: _Staging
    host: np.ndarray
    head: int
    arrays: list
    offsets: list
    end: int

    def copy(self, device):
        """The laid-out bytes' copy on ``device`` and the arrays' views of
        it, tensors of their dtypes and shapes."""
        on_dev = self.staging.copy(self.end, device)
        return on_dev, [on_dev[o:o + a.nbytes].view(
            torch.from_numpy(a[:0].reshape(-1)).dtype).reshape(a.shape)
            for a, o in zip(self.arrays, self.offsets)]


def _stage(sp, device, arrays, size=None, span=None) -> _Laid:
    """Lay out in this thread's staging buffer a span of ``size`` bytes
    (none where ``size`` is None), its padding (:func:`_padded`) zeroed,
    then ``arrays`` each at an 8-byte boundary.  The span's bytes are
    copied in from ``span`` where it is given; else the caller reads
    them into ``host[:size]`` before the copy.  ``sp``, the caller's
    span ``read.stage``, counts ``staging_allocs`` (1 where the buffer
    was allocated or grown, else 0) and ``pinned`` (1 where the copy
    leaves from pinned memory)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    head = 0 if size is None else _padded(size)
    offsets, end = [], head
    for a in arrays:
        end = -(-end // 8) * 8
        offsets.append(end)
        end += a.nbytes
    staging = _staging(device)
    host, allocs = staging.take(end)
    if size is not None:
        host[size:head] = 0
        if span is not None:
            host[:size] = span
    for a, o in zip(arrays, offsets):
        host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    sp.counts.update(staging_allocs=allocs, pinned=int(staging.pinned))
    return _Laid(staging, host, head, arrays, offsets, end)


def stage(device, arrays):
    """Numpy arrays -> tensors of the same dtypes and shapes on
    ``device``, by one host->device copy: the arrays lie back to back in
    the staging buffer, each at an 8-byte boundary, and the tensors are
    views of its copy."""
    with profiling.span("read.stage") as sp:
        laid = _stage(sp, device, arrays)
    return laid.copy(device)[1]


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


def _tables(columns, dither: str, seed: int):
    """Every column's decode arguments as host arrays, the columns' rows
    back to back: start bits, widths, lengths, output offsets and
    minimums; where a column is float, every row's config; under the
    ``uniform`` dither, every row's dither keys."""
    cat = [np.concatenate([getattr(c, k) for c in columns]
                          or [np.zeros(0, np.int64)]).astype(np.int64)
           for k in ("start", "bits", "lens", "mins")]
    out_off = np.concatenate([np.cumsum(c.lens) - c.lens for c in columns]
                             or [np.zeros(0, np.int64)]).astype(np.int64)
    arrays = [cat[0] * 8, cat[1], cat[2], out_off, cat[3]]
    if any(c.config is not None for c in columns):
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
    return arrays


def _stage_columns(size: int, columns, device, dither: str, seed: int,
                   span=None) -> _Laid:
    """:func:`_stage` of a span of ``size`` bytes and the tables of
    ``columns``, whose blocks are checked to lie in it, under the span
    ``read.stage``."""
    with profiling.span("read.stage") as sp:
        for c in columns:
            _check_blocks(c, size)
        return _stage(sp, device, _tables(columns, dither, seed), size,
                      span)


def _on_device(laid: _Laid, columns, device, dither: str):
    """One copy of a staged span and its tables to ``device``: ``(src,
    [Staged, ...])``, ``src`` the span as int32 words."""
    on_dev, tabs = laid.copy(device)
    staged, end = [], 0
    for c in columns:
        rows = slice(end, end + c.start.size)
        end = rows.stop
        table = decode.BlockTable(*(t[rows] for t in tabs[:5]),
                                  int(c.lens.sum()),
                                  int(c.lens.max()) if c.lens.size else 0)
        params = k1 = k2 = None
        if c.config is not None:
            params = codec.BlockParams(*(t[rows] for t in tabs[5:9]))
            if dither == "uniform":
                k1, k2 = (t[rows] for t in tabs[9:11])
        staged.append(Staged(table, params, k1, k2))
    return on_dev[:laid.head].view(torch.int32), staged


def stage_columns(span, columns, device, dither: str = "none",
                  seed: int = 0):
    """Put ``span`` (uint8 numpy, holding each block of ``columns`` at its
    ``start``) and every column's decode arguments on ``device`` by one
    host->device copy of the staging buffer: ``(src, [Staged, ...])``,
    ``src`` the span as int32 words, padded to whole words and 8 bytes
    more with zeros, so a kernel's reads of a block's last words never
    leave it."""
    span = np.asarray(span, np.uint8).reshape(-1)
    laid = _stage_columns(span.size, columns, device, dither, seed, span)
    return _on_device(laid, columns, device, dither)


def _certify(columns, device, dither: str) -> None:
    """Certify the decode kernels on ``device`` on their first use there
    (``selfcheck``), before anything is staged: the checks stage their
    own columns."""
    selfcheck.certify("decode", device)
    if dither == "uniform" and any(c.config is not None for c in columns):
        selfcheck.certify("decode_uniform", device)


def _decode(src, staged, columns, dither: str):
    """One launch of K4 (int) or K2 (float) a staged column."""
    out = []
    for c, s in zip(columns, staged):
        if c.config is None:
            out.append(decode.decode_int_ragged(src, s.table))
        else:
            out.append(decode.decode_float_ragged(src, s.table, s.params,
                                                  dither, s.k1, s.k2))
    return out


def decode_columns(span, columns, device, dither: str = "none",
                   seed: int = 0):
    """Decode ``columns`` (:class:`Blocks` into ``span``) on ``device``:
    the span copied once into the staging buffer with every column's
    table, one host->device copy, then one launch of K4 (int) or K2
    (float) a column.  Returns a flat tensor a column on ``device``, its
    blocks back to back in the order given.  The first use on a CUDA
    device certifies the kernels (``selfcheck``)."""
    _certify(columns, device, dither)
    return _decode(*stage_columns(span, columns, device, dither, seed),
                   columns, dither)


def read_columns(f, columns, device, dither: str = "none", seed: int = 0):
    """Decode the container blocks of ``f`` listed in ``columns`` (one
    list of block indices a column, each all int or all float blocks) on
    ``device``: the tables staged, the span that holds the blocks read
    by one ``readinto`` straight into the staging buffer before them,
    one host->device copy, one launch a column.  Returns a flat tensor a
    column.  Its span ``read.columns`` counts the process's minor page
    faults over the call (``minor_faults``)."""
    with profiling.span("read.columns") as sp:
        faults = profiling.minor_faults()
        blocks = [tail_blocks(f, ids) for ids in columns]
        s0, s1 = _extent(blocks)
        blocks = [b._replace(start=b.start - s0) for b in blocks]
        _certify(blocks, device, dither)
        laid = _stage_columns(s1 - s0, blocks, device, dither, seed)
        _read_into(f, s0, laid.host[:s1 - s0])
        out = _decode(*_on_device(laid, blocks, device, dither), blocks,
                      dither)
        sp.counts["minor_faults"] = profiling.minor_faults() - faults
    return out


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
