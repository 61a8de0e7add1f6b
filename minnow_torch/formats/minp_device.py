"""Device-batched minp reads: decode a whole snapshot file's sub-cell
blocks on the device (counterpart of ``minnow_tpu/formats/minp_device.py``).

The host reader (``minnow_tpu.formats.minp.Reader.vectors``) decodes the
file's ``3 * subCells**3`` blocks one at a time.  Here the file's data
region -- its three axes' groups, back to back -- is read once, copied to
the device once, and all its blocks are decoded by one launch of kernel
K2 (``device_common.read_columns``; its plain version on the CPU), keyed
for the ``uniform`` dither on the container block index as the host
reader keys it.  The periodic wrap into ``[0, L)`` and the sub-cell
reordering run on the device too, so the result equals
``reader.vectors()`` bitwise in every dither mode.  K2 takes every width
0..64, so unlike the TPU path no block falls back to another decode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import cuda_device
from .device_common import read_columns

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
    out = read_columns(reader.f, [range(3 * s3)], device, dither,
                       seed)[0].view(3, s3, n)
    if reader.periodic:
        l = float(np.float32(reader.header.l))
        out = torch.where(out < 0, out + l, out)
        out = torch.where(out >= l, out - l, out)
    return _join_sub_cells(out.permute(1, 2, 0), s)
