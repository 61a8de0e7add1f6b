"""Bulk block decode on the device, shared by the device readers
(counterpart of ``minnow_tpu/formats/device_common.py``).

A bucket of blocks that share a length and a width goes to the device as
one (B, W) word matrix and is decoded by one launch of kernel K2 (float)
or K4 (int) on a CUDA device (their plain versions on the CPU).  Unlike
the TPU path there is no padding to a tile alignment and no eligibility
test: every width and length decodes here.  The first use of the decode
kernels on a CUDA device in a process certifies them (``ops.selfcheck``:
``decode``, and ``decode_uniform`` for the ``uniform`` dither); a
divergence raises, and nothing is decoded another way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import codec, decode, selfcheck

__all__ = ["group_decode", "group_decode_ints"]


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
