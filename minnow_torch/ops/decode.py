"""Block decode on the device: kernels K2 (float) and K4 (int), each
beside its plain PyTorch version.

Both kernels are ragged: one launch decodes a table of blocks
(:class:`BlockTable`), each with its own start bit in one byte stream,
width, length, minimum and place in the flat output -- the blocks of a
column as they lie in a file.  :func:`decode_float_ragged` and
:func:`decode_int_ragged` take the table; :func:`decode_float_group` and
:func:`decode_int_group`, which take a (B, W) matrix of word rows at one
width and length, build its table and launch the same kernel.

A wrapper given CUDA tensors launches its kernel (``csrc/decode_float.cu``,
``csrc/unpack_int.cu``) or raises; given CPU tensors it runs the plain
version.  Nothing else chooses between them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, bitpack, codec
from ._launch import COUNT_LOCK, expect, grid_y, on_card, stream_of

__all__ = ["K2_LAUNCHES", "K4_LAUNCHES", "BlockTable", "decode_float_group",
           "decode_float_plain", "decode_float_ragged",
           "decode_float_ragged_plain", "decode_int_group",
           "decode_int_plain", "decode_int_ragged", "decode_int_ragged_plain"]

K2_LAUNCHES = 0
K4_LAUNCHES = 0

# elements each thread decodes, in K2 and in K4 (measured at 4096 x 2^17
# on the H100: PERF.md, Findings)
DECODE_PER_THREAD = 16
UNPACK_PER_THREAD = 16


class BlockTable(NamedTuple):
    """Where the blocks of a ragged decode lie and where they go: (B,)
    int64 tensors on one device, one row a block, and two host ints.

    Block b's element i is the ``bits[b]``-wide field at bit
    ``start_bit[b] + i * bits[b]`` of the source stream plus ``mins[b]``
    (wrapping in int64), for i below ``lens[b]``; it goes to element
    ``out_off[b] + i`` of an output of ``total`` elements.  ``max_len``
    is the longest block's length, which sizes the grid.  Whoever builds
    a table keeps every block inside the stream and the output
    (``formats.device_common`` checks the tables it builds): a kernel has
    no way to check a table it reads on the card."""

    start_bit: torch.Tensor
    bits: torch.Tensor
    lens: torch.Tensor
    out_off: torch.Tensor
    mins: torch.Tensor
    total: int
    max_len: int


def _check_table(src, table: BlockTable):
    """Raise unless ``src`` is a flat int32 stream and ``table`` a table of
    (B,) int64 rows; returns B."""
    expect(src, "src", torch.int32, (None,))
    expect(table.start_bit, "start_bit", torch.int64, (None,))
    b = table.start_bit.shape[0]
    for name in ("bits", "lens", "out_off", "mins"):
        expect(getattr(table, name), name, torch.int64, (b,))
    if table.total < 0 or table.max_len < 0:
        raise ValueError("a table's total and max_len are counts, got %d, "
                         "%d" % (table.total, table.max_len))
    return b


def _ragged_values(src, table: BlockTable):
    """Each element of a ragged table in the plain versions' flat order:
    its block, its index within the block, and its value, the delta plus
    the block's minimum, wrapping in int64 (``spec.decode_int_block``)."""
    dev = table.lens.device
    blk = torch.repeat_interleave(
        torch.arange(table.lens.shape[0], device=dev), table.lens)
    first = torch.cumsum(table.lens, 0) - table.lens
    i = torch.arange(blk.shape[0], device=dev, dtype=torch.int64) - first[blk]
    bits = table.bits[blk]
    q = bitpack.unpack_at(src, table.start_bit[blk] + i * bits, bits) \
        + table.mins[blk]
    return blk, i, q


def decode_int_ragged_plain(src, table: BlockTable):
    """Plain version of K4: each block's elements plus its minimum at
    their places in a flat (total,) int64 output; places no block covers
    hold zeros."""
    blk, i, q = _ragged_values(src, table)
    out = torch.zeros(table.total, dtype=torch.int64, device=src.device)
    out[table.out_off[blk] + i] = q
    return out


def _launch_int(src, table: BlockTable):
    """K4 on checked CUDA tensors: one launch, counted."""
    global K4_LAUNCHES
    b = len(table.lens)
    out = torch.empty(table.total, dtype=torch.int64, device=src.device)
    if b == 0 or table.total == 0 or table.max_len == 0:
        return out
    with torch.cuda.device(src.device):
        err = _build.load().minnow_unpack_int_ragged(
            src.data_ptr(), b, *(t.data_ptr() for t in table[:5]),
            out.data_ptr(), grid_y(table.max_len, UNPACK_PER_THREAD),
            stream_of(src))
    with COUNT_LOCK:
        K4_LAUNCHES += 1
    _build.check(err, "unpack_int")
    return out


def decode_int_ragged(src, table: BlockTable):
    """Decode the int blocks of ``table`` from the stream ``src`` (a flat
    int32 tensor: the bytes of the blocks as they lie in a file, as
    little-endian words) into a flat (total,) int64 tensor (K4 on the
    card, one launch)."""
    _check_table(src, table)
    if not on_card(src, *table[:5]):
        return decode_int_ragged_plain(src, table)
    return _launch_int(src, table)


def decode_float_ragged_plain(src, table: BlockTable,
                              params: codec.BlockParams, dither: str,
                              k1=None, k2=None):
    """Plain version of K2: unpack, add the minimum, bound periodic
    blocks into [0, pixels), dequantize with the dither (counted within
    each block), into a flat (total,) float32 output; places no block
    covers hold zeros."""
    blk, i, q = _ragged_values(src, table)
    q = torch.where(params.periodic[blk], codec.bound(q, 0,
                                                      params.pixels[blk]), q)
    u = None
    if dither == "midpoint":
        u = 0.5
    elif dither == "uniform":
        u = codec.dither_hash_u(i, k1[blk], k2[blk])[:, None]
    vals = codec.dequantize(q[:, None], params.low[blk], params.dx[blk], u)
    out = torch.zeros(table.total, dtype=torch.float32, device=src.device)
    out[table.out_off[blk] + i] = vals[:, 0]
    return out


def _check_float_args(b: int, params, dither: str, k1, k2):
    """Raise unless ``params`` and the keys fit a table of ``b`` blocks;
    returns the tensors to place."""
    if dither not in codec.DITHER_MODES:
        raise ValueError("unknown dither mode %r" % (dither,))
    expect(params.low, "low", torch.float32, (b,))
    expect(params.dx, "dx", torch.float32, (b,))
    expect(params.pixels, "pixels", torch.int64, (b,))
    expect(params.periodic, "periodic", torch.bool, (b,))
    tensors = list(params)
    if dither == "uniform":
        if k1 is None or k2 is None:
            raise ValueError("uniform dither needs the keys k1, k2")
        expect(k1, "k1", torch.int32, (b,))
        expect(k2, "k2", torch.int32, (b,))
        tensors += [k1, k2]
    return tensors


def _launch_float(src, table: BlockTable, params, dither: str, k1, k2):
    """K2 on checked CUDA tensors: one launch, counted."""
    global K2_LAUNCHES
    b = len(table.lens)
    out = torch.empty(table.total, dtype=torch.float32, device=src.device)
    if b == 0 or table.total == 0 or table.max_len == 0:
        return out
    uniform = dither == "uniform"
    with torch.cuda.device(src.device):
        err = _build.load().minnow_decode_float_ragged(
            src.data_ptr(), b, *(t.data_ptr() for t in table[:5]),
            *(t.data_ptr() for t in params), codec.DITHER_MODES[dither],
            k1.data_ptr() if uniform else None,
            k2.data_ptr() if uniform else None, out.data_ptr(),
            grid_y(table.max_len, DECODE_PER_THREAD), stream_of(src))
    with COUNT_LOCK:
        K2_LAUNCHES += 1
    _build.check(err, "decode_float")
    return out


def decode_float_ragged(src, table: BlockTable, params: codec.BlockParams,
                        dither: str, k1=None, k2=None):
    """Decode the float blocks of ``table`` from the stream ``src`` into a
    flat (total,) float32 tensor (K2 on the card, one launch).
    ``params`` holds each block's config, (B,) each; ``dither`` is
    ``none``, ``midpoint`` or ``uniform``, which takes the per-block keys
    ``k1``, ``k2`` (B,) int32 of ``codec.dither_keys`` (the container
    block index of each block) and counts elements within each block."""
    b = _check_table(src, table)
    tensors = _check_float_args(b, params, dither, k1, k2)
    if not on_card(src, *table[:5], *tensors):
        return decode_float_ragged_plain(src, table, params, dither, k1, k2)
    return _launch_float(src, table, params, dither, k1, k2)


# -- (B, W) word matrices at one width and length ---------------------------


def _check_words(words, bits: int, n: int):
    """Raise unless ``words`` (B, W) int32 holds ``n`` elements of width
    ``bits`` (0..64) in each row; returns (B, W)."""
    if not 0 <= bits <= 64:
        raise ValueError("bits must lie in [0, 64], got %d" % bits)
    expect(words, "words", torch.int32, (None, None))
    b, w = words.shape
    if w < bitpack.words_per_block(bits, n):
        raise ValueError("rows of %d words cannot hold %d x %d bits"
                         % (w, n, bits))
    return b, w


def _rows_table(words, mins, bits: int, n: int) -> BlockTable:
    """The table of a (B, W) word matrix: row b starts at bit 32 W b and
    goes to elements [b n, (b + 1) n) of the output."""
    b, w = words.shape
    dev = words.device

    def steps(step):
        if step == 0:
            return torch.zeros(b, device=dev, dtype=torch.int64)
        return torch.arange(0, b * step, step, device=dev, dtype=torch.int64)

    return BlockTable(steps(32 * w), torch.full((b,), bits, device=dev),
                      torch.full((b,), n, device=dev), steps(n), mins, b * n,
                      n)


def decode_int_plain(words, mins, bits: int, n: int):
    """Plain version of :func:`decode_int_group`: unpack each row at width
    ``bits`` and add its block's minimum, wrapping in int64
    (``spec.decode_int_block``)."""
    b, w = words.shape
    dev = words.device
    offsets = torch.arange(b, device=dev, dtype=torch.int64) * w
    widths = torch.full((b,), bits, device=dev, dtype=torch.int64)
    return bitpack.unpack(words.reshape(-1), offsets, widths, n) \
        + mins[:, None]


def decode_int_group(words, mins, bits: int, n: int):
    """Decode ``n`` elements of each row of ``words`` (B, W) int32 -- one
    int block stream per row, all at width ``bits`` (0..64) -- to (B, n)
    int64, each its delta plus the row's ``mins`` (B,) int64 (one launch
    of K4 on the card).  With zero minimums it is the raw unpack of the
    TPU's per-tile ``unpack_pallas`` (``pallas_codec.py:689``) as well as
    of its grouped kernels (``:592``, ``:641``)."""
    b, _ = _check_words(words, bits, n)
    expect(mins, "mins", torch.int64, (b,))
    if not on_card(words, mins):
        return decode_int_plain(words, mins, bits, n)
    return _launch_int(words.reshape(-1),
                       _rows_table(words, mins, bits, n)).view(b, n)


def decode_float_plain(words, mins, params, bits: int, n: int,
                       dither: str, k1=None, k2=None):
    """Plain version of :func:`decode_float_group`: unpack, add the
    minimum, bound periodic blocks into [0, pixels), dequantize with the
    dither."""
    q = decode_int_plain(words, mins, bits, n)
    dev = words.device
    p = params.pixels[:, None]
    q = torch.where(params.periodic[:, None], codec.bound(q, 0, p), q)
    u = None
    if dither == "midpoint":
        u = 0.5
    elif dither == "uniform":
        c = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
        u = codec.dither_hash_u(c, k1[:, None], k2[:, None])
    return codec.dequantize(q, params.low, params.dx, u)


def decode_float_group(words, mins, params: codec.BlockParams, bits: int,
                       n: int, dither: str, k1=None, k2=None):
    """Decode ``n`` elements of each row of ``words`` (B, W) int32 -- one
    block stream per row, all at width ``bits`` (0..64) -- to (B, n)
    float32 (one launch of K2 on the card).  ``mins`` (B,) int64.
    ``dither`` is ``none``, ``midpoint`` or ``uniform``; ``uniform`` takes
    the per-block keys ``k1``, ``k2`` (B,) int32 of ``codec.dither_keys``.
    It stands for the TPU's grouped decode (``pallas_codec.py:526``) and
    its per-tile decode ``decode_float_pallas`` (``:252``) alike."""
    b, _ = _check_words(words, bits, n)
    expect(mins, "mins", torch.int64, (b,))
    tensors = _check_float_args(b, params, dither, k1, k2)
    if not on_card(words, mins, *tensors):
        return decode_float_plain(words, mins, params, bits, n, dither,
                                  k1, k2)
    return _launch_float(words.reshape(-1), _rows_table(words, mins, bits, n),
                         params, dither, k1, k2).view(b, n)
