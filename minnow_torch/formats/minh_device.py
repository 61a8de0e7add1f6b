"""Device-batched minh reads: decode whole float columns on the device
(counterpart of ``minnow_tpu/formats/minh_device.py:39-106``).

The packed payloads are gathered on the host (file IO), grouped into
buckets of equal block length and width, and each bucket is decoded by
one launch of kernel K2 (``formats/device_common.group_decode``).  The
result equals ``reader.floats`` bitwise in every dither mode: the device
runs the host reader's arithmetic (``spec.dequantize``) and its dither
stream, keyed on the same container block index.
"""

from __future__ import annotations

import numpy as np

from minnow_tpu.core import types as ctypes_

from ..ops import bitpack
from .device_common import group_decode

__all__ = ["read_floats"]


def read_floats(reader, names, device, dither: str = None,
                seed: int = None):
    """Read float columns of a ``minh.Reader`` on ``device``; returns
    ``{name: float32 numpy array}`` over all blocks, as
    ``reader.floats``.  ``dither``/``seed`` default to the reader's own,
    so the result equals ``reader.floats(names)`` bitwise."""
    if dither is None:
        dither = reader.f.dither
    if seed is None:
        seed = reader.f.seed
    out = {}
    for name in names:
        c = reader._col(name)
        col = reader.columns[c]
        ctypes_.type_match(np.empty(0, np.float32), col.type)
        # container block index of each row-block: the dither key, as the
        # host reader passes it (core/reader.py data(b))
        block_ids = [reader._block_idx(c, b) for b in range(reader.blocks)]
        raw = [reader.f.raw_block(i) for i in block_ids]
        buckets: dict = {}
        for b, (_, _, bits, n, _) in enumerate(raw):
            buckets.setdefault((n, bits), []).append(b)

        parts = [None] * len(raw)
        for (n, bits), ids in buckets.items():
            w = max(bitpack.words_per_block(bits, n), 1)
            words = np.zeros((len(ids), w), dtype=np.uint32)
            mins = np.empty(len(ids), np.int64)
            lows = np.empty(len(ids), np.float32)
            highs = np.empty(len(ids), np.float32)
            pixels = np.empty(len(ids), np.int64)
            periodic = np.empty(len(ids), bool)
            for row, b in enumerate(ids):
                payload, mn, _, _, params = raw[b]
                if bits:
                    words[row] = bitpack.bytes_to_words(payload, bits, n)
                mins[row] = mn
                lows[row], highs[row], pixels[row], periodic[row] = params
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
