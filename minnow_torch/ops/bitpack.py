"""Plain PyTorch bit packing in the minnow stream layout.

Element ``i`` of a width-``b`` stream occupies bits ``[i*b, (i+1)*b)``,
least significant bit first, and the stream is read as little-endian
uint32 words (``minnow_tpu/core/spec.py:87-127``, ref go/bit/bit.go).

Every block of a batch is its own stream, with its own width and valid
length, and the streams lie back to back in one flat word buffer at
``offsets`` (:func:`block_layout`).  This is the layout the encode
kernels write (``csrc/bitstream.cuh``), and these functions are their
plain versions.

PyTorch has no unsigned 32- or 64-bit arithmetic on the CPU, so words
and 64-bit values travel in int64 tensors: a word as its value in
``[0, 2**32)``, a 64-bit value as its two's complement bit pattern.
Packed words leave as int32 tensors holding the uint32 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec

__all__ = [
    "words_per_block",
    "block_layout",
    "pack",
    "unpack",
    "unpack_at",
    "words_to_bytes",
    "bytes_to_words",
]

M32 = 0xFFFFFFFF


def words_per_block(bits, n):
    """uint32 words holding ``n`` elements at width ``bits`` (scalars or
    numpy arrays)."""
    return (bits * n + 31) // 32


def block_layout(bits, lens):
    """Word offsets of back-to-back block streams: ``(offsets, total)``
    for per-block widths ``bits`` and valid lengths ``lens`` (numpy)."""
    nw = words_per_block(np.asarray(bits, np.int64),
                         np.asarray(lens, np.int64))
    offsets = np.zeros(len(nw), np.int64)
    np.cumsum(nw[:-1], out=offsets[1:])
    return offsets, int(nw.sum())


def _limb_masks(bits):
    """Masks of the low and high 32-bit halves of a ``bits``-wide value;
    ``bits`` an int64 tensor, the masks of its shape."""
    one = torch.ones_like(bits)
    lo_mask = (one << bits.clamp(max=32)) - 1
    hi_mask = (one << (bits - 32).clamp(min=0)) - 1
    return lo_mask, hi_mask


def pack(values, bits, lens, offsets, total: int):
    """Pack each row of ``values`` (B, n) int64 at its block's width.

    ``bits``, ``lens`` and ``offsets`` are (B,) int64 tensors; elements
    at or past ``lens[b]`` are not packed.  Returns the (total,) int32
    word buffer of :func:`block_layout`.

    Each element adds its bits to the (up to three) words its bit range
    touches; contributions never overlap, so adding them is OR-ing them.
    """
    b, n = values.shape
    dev = values.device
    i = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
    lo_mask, hi_mask = _limb_masks(bits[:, None])
    keep = i < lens[:, None]
    lo = torch.where(keep, values & lo_mask, 0)
    hi = torch.where(keep, (values >> 32) & M32 & hi_mask, 0)
    p = i * bits[:, None]
    w = offsets[:, None] + (p >> 5)
    s = p & 31
    parts = ((lo << s) & M32,
             ((lo >> (32 - s)) | (hi << s)) & M32,
             hi >> (32 - s))
    out = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    for k, part in enumerate(parts):
        # a nonzero part always lies inside its block's stream; zero
        # parts go to the spare last slot, whose index is always valid
        idx = torch.where(part != 0, w + k, total)
        out.index_add_(0, idx.reshape(-1), part.reshape(-1))
    return out[:total].to(torch.int32)


def unpack_at(words, bit, bits):
    """The elements of width ``bits`` that start at stream bit ``bit`` of
    a flat int32 word buffer ``words``: int64 tensors ``bit`` and
    ``bits`` (0..64) of one shape (or broadcasting) -> int64 of that
    shape (the uint64 bit pattern).  A stream may start at any bit, as
    the blocks of a file do at byte boundaries."""
    dev = words.device
    w64 = torch.cat([words.to(torch.int64) & M32,
                     torch.zeros(2, dtype=torch.int64, device=dev)])
    last = w64.shape[0] - 1
    w = bit >> 5
    s = bit & 31
    a, b, c = (w64[(w + k).clamp(max=last)] for k in range(3))
    lo_mask, hi_mask = _limb_masks(bits)
    lo = ((a >> s) | (b << (32 - s))) & M32 & lo_mask
    hi = ((b >> s) | (c << (32 - s))) & M32 & hi_mask
    return lo | (hi << 32)


def unpack(words, offsets, bits, n: int):
    """Inverse of :func:`pack`: ``n`` elements of each block stream ->
    (B, n) int64 (the uint64 bit pattern).  ``words`` is a flat int32
    word buffer; ``offsets`` and ``bits`` are (B,) int64 tensors."""
    i = torch.arange(n, device=words.device, dtype=torch.int64)[None, :]
    return unpack_at(words, offsets[:, None] * 32 + i * bits[:, None],
                     bits[:, None])


# -- host-side glue (numpy; equal to minnow_tpu/ops/bitpack.py:263-274) ----


def words_to_bytes(words, bits: int, n: int) -> bytes:
    """Words -> the exact reference byte stream of ``n`` elements."""
    raw = np.asarray(words).astype("<u4").tobytes()
    return raw[: spec.array_bytes(bits, n)]


def bytes_to_words(data: bytes, bits: int, n: int) -> np.ndarray:
    """Reference byte stream -> uint32 words, zero-padded to whole
    words."""
    need = words_per_block(bits, n)
    buf = data[: spec.array_bytes(bits, n)]
    buf = buf + b"\0" * (need * 4 - len(buf))
    return np.frombuffer(buf, dtype="<u4").copy()
