"""Device-batched minp reads: decode a whole snapshot file's sub-cell
blocks on the device (counterpart of ``minnow_tpu/formats/minp_device.py``).

The host reader (``minnow_tpu.formats.minp.Reader.vectors``) decodes the
file's ``3 * subCells**3`` blocks one at a time.  Here each axis's blocks
are grouped by width, and each group is decoded by one launch of kernel
K2 (``device_common.group_decode``; its plain version on the CPU), keyed
for the ``uniform`` dither on the container block index as the host
reader keys it.  The periodic wrap into ``[0, L)`` and the sub-cell
reordering run on the device too, so the result equals
``reader.vectors()`` bitwise in every dither mode.  K2 takes every width
0..64, so unlike the TPU path no block falls back to another decode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitpack
from ..utils.device import cuda_device
from .device_common import group_decode

__all__ = ["read_vectors"]


def _join_sub_cells(blocks, s: int):
    """(s^3, n^3, 3) sub-cell blocks -> (s^3 n^3, 3) vectors in file order:
    ``minp.join_sub_cells`` on a tensor."""
    n3 = blocks.shape[1]
    n = round(n3 ** (1 / 3))
    while n ** 3 < n3:
        n += 1
    g = blocks.reshape(s, s, s, n, n, n, 3)
    return g.permute(0, 3, 1, 4, 2, 5, 6).reshape(s * s * s * n3, 3)


def read_vectors(reader, device=None, dither: str = None,
                 seed: int = None):
    """The vectors of a ``minp.Reader``, decoded on ``device`` (default:
    the CUDA device, an error without one): an (N, 3) float32 tensor
    there, in the order ``reader.vectors()`` gives.  ``dither``/``seed``
    default to the reader's own, so the result equals
    ``reader.vectors()`` bitwise."""
    if device is None:
        device = cuda_device()
    if dither is None:
        dither = reader.f.dither
    if seed is None:
        seed = reader.f.seed
    s = reader.cell.sub_cells
    s3 = s * s * s
    if reader.f.blocks() != 3 * s3:
        raise ValueError("Expected %d sub-cell blocks, but got %d"
                         % (3 * s3, reader.f.blocks()))
    n = reader.f.data_len(0)
    out = torch.empty((3, s3, n), dtype=torch.float32, device=device)
    for k in range(3):
        # (payload, min, bits, n, (low, high, pixels, periodic)) per block
        raw = [reader.f.raw_block(k * s3 + sc) for sc in range(s3)]
        buckets: dict = {}
        for sc, r in enumerate(raw):
            buckets.setdefault(r[2], []).append(sc)
        for bits, ids in buckets.items():
            words = np.zeros((len(ids), max(bitpack.words_per_block(bits, n),
                                            1)), np.uint32)
            if bits:
                for row, sc in enumerate(ids):
                    words[row] = bitpack.bytes_to_words(raw[sc][0], bits, n)
            mins = [raw[sc][1] for sc in ids]
            lows, highs, pixels, periodic = zip(*(raw[sc][4] for sc in ids))
            out[k, torch.tensor(ids, device=device)] = group_decode(
                words, mins, lows, highs, pixels, periodic, bits, n, dither,
                [k * s3 + sc for sc in ids], seed, device)
    if reader.periodic:
        l = float(np.float32(reader.header.l))
        out = torch.where(out < 0, out + l, out)
        out = torch.where(out >= l, out - l, out)
    return _join_sub_cells(out.permute(1, 2, 0), s)
