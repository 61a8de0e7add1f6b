"""Block decode on the device: kernels K2 (float) and K4 (int), each
beside its plain PyTorch version.

A wrapper given CUDA tensors launches its kernel (``csrc/decode_float.cu``,
``csrc/unpack_int.cu``) or raises; given CPU tensors it runs the plain
version.  Nothing else chooses between them.
"""

from __future__ import annotations

import torch

from . import _build, bitpack, codec
from ._launch import COUNT_LOCK, expect, grid_y, on_card, stream_of

__all__ = ["K2_LAUNCHES", "K4_LAUNCHES", "decode_float_group",
           "decode_float_plain", "decode_int_group", "decode_int_plain"]

K2_LAUNCHES = 0
K4_LAUNCHES = 0

# elements each thread decodes, in K2 and in K4 (measured at 4096 x 2^17
# on the H100: PERF.md, Findings)
DECODE_PER_THREAD = 16
UNPACK_PER_THREAD = 16


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


def decode_int_plain(words, mins, bits: int, n: int):
    """Plain version of K4: unpack each row at width ``bits`` and add its
    block's minimum, wrapping in int64 (``spec.decode_int_block``)."""
    b, w = words.shape
    dev = words.device
    offsets = torch.arange(b, device=dev, dtype=torch.int64) * w
    widths = torch.full((b,), bits, device=dev, dtype=torch.int64)
    return bitpack.unpack(words.reshape(-1), offsets, widths, n) \
        + mins[:, None]


def decode_int_group(words, mins, bits: int, n: int):
    """Decode ``n`` elements of each row of ``words`` (B, W) int32 -- one
    int block stream per row, all at width ``bits`` (0..64) -- to (B, n)
    int64, each its delta plus the row's ``mins`` (B,) int64 (K4 on the
    card).  With zero minimums it is the raw unpack of the TPU's per-tile
    ``unpack_pallas`` (``pallas_codec.py:689``) as well as of its grouped
    kernels (``:592``, ``:641``)."""
    global K4_LAUNCHES
    b, w = _check_words(words, bits, n)
    expect(mins, "mins", torch.int64, (b,))
    if not on_card(words, mins):
        return decode_int_plain(words, mins, bits, n)
    out = torch.empty((b, n), dtype=torch.int64, device=words.device)
    if b == 0 or n == 0:
        return out
    with torch.cuda.device(words.device):
        err = _build.load().minnow_unpack_int(
            words.data_ptr(), b, w, n, bits, mins.data_ptr(), out.data_ptr(),
            grid_y(n, UNPACK_PER_THREAD), stream_of(words))
    with COUNT_LOCK:
        K4_LAUNCHES += 1
    _build.check(err, "unpack_int")
    return out


def decode_float_plain(words, mins, params, bits: int, n: int,
                       dither: str, k1=None, k2=None):
    """Plain version of K2: unpack, add the minimum, bound periodic
    blocks into [0, pixels), dequantize with the dither."""
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
    float32 (K2 on the card).  ``mins`` (B,) int64.  ``dither`` is
    ``none``, ``midpoint`` or ``uniform``; ``uniform`` takes the per-block
    keys ``k1``, ``k2`` (B,) int32 of ``codec.dither_keys``.  It stands
    for the TPU's grouped decode (``pallas_codec.py:526``) and its
    per-tile decode ``decode_float_pallas`` (``:252``) alike."""
    global K2_LAUNCHES
    if dither not in codec.DITHER_MODES:
        raise ValueError("unknown dither mode %r" % (dither,))
    b, w = _check_words(words, bits, n)
    expect(mins, "mins", torch.int64, (b,))
    expect(params.low, "low", torch.float32, (b,))
    expect(params.dx, "dx", torch.float32, (b,))
    expect(params.pixels, "pixels", torch.int64, (b,))
    expect(params.periodic, "periodic", torch.bool, (b,))
    tensors = [words, mins, *params]
    if dither == "uniform":
        if k1 is None or k2 is None:
            raise ValueError("uniform dither needs the keys k1, k2")
        expect(k1, "k1", torch.int32, (b,))
        expect(k2, "k2", torch.int32, (b,))
        tensors += [k1, k2]
    if not on_card(*tensors):
        return decode_float_plain(words, mins, params, bits, n, dither,
                                  k1, k2)
    out = torch.empty((b, n), dtype=torch.float32, device=words.device)
    if b == 0 or n == 0:
        return out
    uniform = dither == "uniform"
    with torch.cuda.device(words.device):
        err = _build.load().minnow_decode_float(
            words.data_ptr(), b, w, n, bits, mins.data_ptr(),
            params.low.data_ptr(), params.dx.data_ptr(),
            params.pixels.data_ptr(), params.periodic.data_ptr(),
            codec.DITHER_MODES[dither],
            k1.data_ptr() if uniform else None,
            k2.data_ptr() if uniform else None, out.data_ptr(),
            grid_y(n, DECODE_PER_THREAD), stream_of(words))
    with COUNT_LOCK:
        K2_LAUNCHES += 1
    _build.check(err, "decode_float")
    return out
