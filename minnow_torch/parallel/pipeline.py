"""Batched block encode on one device (counterpart of
``minnow_tpu/parallel/pipeline.py``).

A batch of minnow blocks, one per row, goes to the device, is encoded
there by kernel K1 (float) or K3 (int) at each block's true width, and
comes back as per-block payload bytes plus the tail metadata the
container needs (ref go/group.go:242-255, 312-327).  A float batch is
three launches and then one read: the plan of the batch (minimums, widths,
offsets) comes to the host with the words.  Float blocks the
kernel does not certify (non-finite values, pixels beyond int32, or a
periodic block with pixels outside ``[0, pixels)``) are encoded by the
normative host encoder ``spec.encode_float_block``, as the reference's
pipeline does (``pipeline.py:474-487``); with ``clamp_q`` so are the
valid blocks whose largest pixel reaches ``pixels``, the only pixels
``clamp_q`` changes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import spec
from ..ops import bitpack, codec, encode

__all__ = ["EncodedBlocks", "BlockEncoder"]


@dataclass
class EncodedBlocks:
    """Per-block packed payloads and tail metadata of a batch (the same
    fields as the reference's ``EncodedBlocks``)."""

    payloads: list  # list[bytes], one per block
    mins: np.ndarray  # (B,) int64
    bits: np.ndarray  # (B,) int64
    lens: np.ndarray  # (B,) int64 valid lengths

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(p) for p in self.payloads], dtype=np.int64)

    @property
    def offsets(self) -> np.ndarray:
        """Exclusive prefix sum: byte offset of each block within the
        group's data region (ref go/block_index.go)."""
        sizes = self.sizes
        out = np.zeros_like(sizes)
        np.cumsum(sizes[:-1], out=out[1:])
        return out

    def total_bytes(self) -> int:
        return int(self.sizes.sum())

    def write_to(self, writer) -> None:
        """Append all blocks to the current group of a core Writer through
        its pre-encoded path (``Writer.data_encoded``)."""
        for payload, mn, bits in zip(self.payloads, self.mins, self.bits):
            writer.data_encoded(payload, int(mn), int(bits))


def _payloads(words: np.ndarray, offsets, bits, lens) -> list:
    """Slice each block's bytes out of the flat word buffer."""
    out = []
    for off, width, n in zip(offsets, bits, lens):
        nw = bitpack.words_per_block(int(width), int(n))
        out.append(bitpack.words_to_bytes(words[off:off + nw], int(width),
                                          int(n)))
    return out


def _float_capacity(pixels, periodic, lens) -> int:
    """An upper bound on the words of a float batch, from what the host
    knows before the encode: a block K1 certifies has pixels below 2^31,
    so a width of at most 32, and a periodic one has them in [0, pixels),
    so deltas below ``pixels``."""
    widest = np.where(periodic, np.frexp((pixels - 1).astype(np.float64))[1],
                      32)
    return int(bitpack.words_per_block(np.minimum(widest, 32), lens).sum())


class BlockEncoder:
    """Encodes (B, N) batches of minnow blocks on ``device``: a CUDA
    device runs the kernels, the CPU their plain versions."""

    def __init__(self, device):
        self.device = torch.device(device)

    @staticmethod
    def _as_batch(x, lens, dtype):
        x = np.ascontiguousarray(x, dtype)
        b, n = x.shape
        if lens is None:
            lens = np.full(b, n, dtype=np.int64)
        else:
            lens = np.asarray(lens, dtype=np.int64)
        return x, b, n, lens

    def _put(self, a):
        return torch.from_numpy(a).to(self.device)

    def encode_int_blocks(self, x, lens=None) -> EncodedBlocks:
        """Encode (B, N) int64 blocks (ref go/group.go:242-255)."""
        x, b, n, lens = self._as_batch(x, lens, np.int64)
        words, plan = encode.encode_int_group(self._put(x), self._put(lens))
        payloads = _payloads(words.cpu().numpy(), plan.offsets, plan.bits,
                             lens)
        return EncodedBlocks(payloads, plan.mins, plan.bits, lens)

    def encode_float_blocks(self, x, low, high, pixels, lens=None,
                            periodic=True,
                            clamp_q: bool = False) -> EncodedBlocks:
        """Encode (B, N) float32 blocks (ref go/group.go:312-327).

        ``low``/``high``/``pixels``/``periodic`` may be scalars or (B,)
        arrays (per-block quantisation configs, as the multi-column minh
        layout has).  ``clamp_q`` clamps pixels to ``pixels - 1``
        (``spec.encode_float_block``), as minp's non-periodic groups
        ask."""
        x, b, n, lens = self._as_batch(x, lens, np.float32)
        low = np.broadcast_to(np.asarray(low, np.float32), (b,)).copy()
        high = np.broadcast_to(np.asarray(high, np.float32), (b,)).copy()
        pixels = np.broadcast_to(np.asarray(pixels, np.int64), (b,)).copy()
        periodic = np.broadcast_to(np.asarray(periodic, bool), (b,)).copy()
        params = codec.block_params(low, high, pixels, periodic,
                                    self.device)
        words, plan = encode.encode_float_group(
            self._put(x), params, self._put(lens),
            capacity=_float_capacity(pixels, periodic, lens))
        payloads = _payloads(words.cpu().numpy(), plan.offsets, plan.bits,
                             lens)
        mins, bits = plan.mins.copy(), plan.bits.copy()
        host = ~plan.valid
        if clamp_q:
            # K1 certifies periodic pixels in [0, pixels), which clamp_q
            # leaves alone; a non-periodic block's largest is mins + maxd
            host |= ~periodic & (plan.mins + plan.maxd >= pixels)
        for i in np.nonzero(host)[0]:
            payloads[i], mins[i], bits[i], _ = spec.encode_float_block(
                x[i, :lens[i]], low[i], high[i], int(pixels[i]),
                periodic=bool(periodic[i]), clamp_q=clamp_q)
        return EncodedBlocks(payloads, mins, bits, lens)
