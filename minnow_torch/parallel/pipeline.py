"""Batched block encode and decode on one device or several (counterpart
of ``minnow_tpu/parallel/pipeline.py``).

A batch of minnow blocks, one per row, goes to the device, is encoded
there by kernel K1 (float) or K3 (int) at each block's true width, and
comes back as per-block payload bytes plus the tail metadata the
container needs (ref go/group.go:242-255, 312-327).  A batch, float or
int, is three launches and then one read: the plan of the batch
(minimums, widths, offsets) comes to the host with the words.  Float
blocks the kernel does not certify (non-finite values, pixels beyond
int32, or a periodic block with pixels outside ``[0, pixels)``) are
encoded by the normative host encoder ``spec.encode_float_block``, as the
reference's pipeline does (``pipeline.py:474-487``); with ``clamp_q`` so
are the valid blocks whose largest pixel reaches ``pixels``, the only
pixels ``clamp_q`` changes.  A block goes there for the pixels its data holds,
never for its pixel count: counts are 64-bit, and a column of 2^31
pixels or more is encoded on the device like any other as long as its
pixels fit an int32.  ``HOST_BLOCKS`` counts the blocks sent there.

Minnow blocks are data-parallel (each carries its own min and width), so
with several devices the block axis of a batch is split into contiguous
shares (``mesh.block_shards``), every share is queued on its device in a
stream of its own before the first is read back, and the shares' results
are joined in block order: byte for byte the one-device result.  The
decode methods mirror it: the payloads are joined as they would lie in a
file, and each device's share of the blocks goes to it in one copy and is
decoded by one launch of K4 (int) or K2 (float), ragged over its blocks.

The first CUDA use of a kernel family in a process certifies it
(``ops.selfcheck``); a divergence raises and nothing is encoded.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core import spec
from ..formats.device_common import Blocks, decode_columns
from ..ops import bitpack, codec, encode, selfcheck
from ..ops._launch import COUNT_LOCK
from ..utils import profiling
from ..utils.device import cuda_device
from . import mesh

__all__ = ["EncodedBlocks", "BlockEncoder"]

# float blocks that encode_float_blocks sent to the host encoder (read it
# as pipeline.HOST_BLOCKS)
HOST_BLOCKS = 0


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

    def block(self, r: int) -> tuple:
        """Block ``r`` as ``(payload, min, bits)``: the arguments of a core
        Writer's ``data_encoded``."""
        return self.payloads[r], int(self.mins[r]), int(self.bits[r])

    @profiling.traced("container.write")
    def write_to(self, writer, start_group=None) -> None:
        """Append the blocks to a core Writer through its pre-encoded path
        (``Writer.data_encoded``): all into its current group or, with
        ``start_group``, each into a group of its own, which
        ``start_group(r)`` opens before block ``r`` is written."""
        for r, (payload, mn, bits) in enumerate(zip(self.payloads, self.mins,
                                                    self.bits)):
            if start_group is not None:
                start_group(r)
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
    """Encodes and decodes (B, N) batches of minnow blocks on ``device``:
    one device or a list of them (a device may stand in the list twice),
    by default the CUDA device, which raises without a card.  A CUDA
    device runs the kernels, the CPU their plain versions."""

    def __init__(self, device=None):
        self.devices = mesh.block_mesh(cuda_device() if device is None
                                       else device)
        self.device = self.devices[0]
        several = len(self.devices) > 1
        self._streams = [torch.cuda.Stream(d) if several and d.type == "cuda"
                         else None for d in self.devices]

    def _shares(self, b: int) -> list:
        """``(device, stream, slice)`` of each device's share of ``b``
        blocks, empty shares left out; no blocks at all are one empty
        share of the first device."""
        shares = [t for t in zip(self.devices, self._streams,
                                 mesh.block_shards(b, len(self.devices)))
                  if t[2].stop > t[2].start]
        return shares or [(self.devices[0], self._streams[0], slice(0, 0))]

    @staticmethod
    def _on(stream):
        """The context in which a share's work is queued and read."""
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    def _certify(self, family: str) -> None:
        for dev in self.devices:
            selfcheck.certify(family, dev)

    @staticmethod
    def _as_batch(x, lens, dtype):
        if torch.is_tensor(x):  # stays on its device
            x = x.contiguous()
        else:
            x = np.ascontiguousarray(x, dtype)
        b, n = x.shape
        if lens is None:
            lens = np.full(b, n, dtype=np.int64)
        else:
            lens = np.asarray(lens, dtype=np.int64)
        return x, b, n, lens

    @staticmethod
    def _put(a, device):
        if torch.is_tensor(a):
            return a.to(device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    @profiling.traced("encoder.payloads")
    def _read_payloads(self, shares, encoded, lens) -> list:
        """The payload bytes of every share's ``(words, plan)``, in block
        order."""
        payloads = []
        for (_, stream, s), (words, plan) in zip(shares, encoded):
            with self._on(stream):
                payloads += _payloads(words.cpu().numpy(), plan.offsets,
                                      plan.bits, lens[s])
        return payloads

    # -- encode ------------------------------------------------------------

    @profiling.traced("encoder.encode_int")
    def encode_int_blocks(self, x, lens=None) -> EncodedBlocks:
        """Encode (B, N) int64 blocks (ref go/group.go:242-255)."""
        x, b, n, lens = self._as_batch(x, lens, np.int64)
        self._certify("encode")
        shares = self._shares(b)
        queued = []
        for dev, stream, s in shares:
            with self._on(stream):
                # every block at 64 bits: the bytes of the share's elements
                queued.append(encode.start_int_group(
                    self._put(x[s], dev), self._put(lens[s], dev),
                    capacity=2 * int(lens[s].sum())))
        encoded = []
        for (_, stream, _), pending in zip(shares, queued):
            with self._on(stream):
                encoded.append(encode.finish_int_group(pending))
        payloads = self._read_payloads(shares, encoded, lens)
        plans = [plan for _, plan in encoded]
        return EncodedBlocks(payloads,
                             np.concatenate([p.mins for p in plans]),
                             np.concatenate([p.bits for p in plans]), lens)

    @profiling.traced("encoder.encode_float")
    def encode_float_blocks(self, x, low, high, pixels, lens=None,
                            periodic=True,
                            clamp_q: bool = False) -> EncodedBlocks:
        """Encode (B, N) float32 blocks (ref go/group.go:312-327): a
        numpy array, or a tensor, which is used where it lies (on the
        encoder's device it is not copied).

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
        self._certify("encode")
        shares = self._shares(b)
        queued = []
        for dev, stream, s in shares:
            with self._on(stream):
                params = codec.block_params(low[s], high[s], pixels[s],
                                            periodic[s], dev)
                queued.append(encode.start_float_group(
                    self._put(x[s], dev), params, self._put(lens[s], dev),
                    capacity=_float_capacity(pixels[s], periodic[s],
                                             lens[s])))
        encoded = []
        for (_, stream, _), pending in zip(shares, queued):
            with self._on(stream):
                encoded.append(encode.finish_float_group(pending))
        payloads = self._read_payloads(shares, encoded, lens)
        mins, bits, valid, maxd = (
            np.concatenate([getattr(plan, name) for _, plan in encoded])
            for name in ("mins", "bits", "valid", "maxd"))
        host = ~valid
        if clamp_q:
            # K1 certifies periodic pixels in [0, pixels), which clamp_q
            # leaves alone; a non-periodic block's largest is mins + maxd
            host |= ~periodic & (mins + maxd >= pixels)
        global HOST_BLOCKS
        with COUNT_LOCK:
            HOST_BLOCKS += int(host.sum())
        for i in np.nonzero(host)[0]:
            row = x[i, :lens[i]]
            if torch.is_tensor(row):  # only this block's row comes back
                row = row.cpu().numpy()
            payloads[i], mins[i], bits[i], _ = spec.encode_float_block(
                row, low[i], high[i], int(pixels[i]),
                periodic=bool(periodic[i]), clamp_q=clamp_q)
        return EncodedBlocks(payloads, mins, bits, lens)

    # -- decode ------------------------------------------------------------

    def _decode(self, payloads, bits, lens, mins, config=None, ids=None,
                dither: str = "none", seed: int = 0) -> np.ndarray:
        """The blocks' elements back to back, in block order: the payloads
        joined as they would lie in a file, each device's contiguous share
        of them put on it in one copy and decoded by one launch, queued on
        the share's stream before the first share is read back."""
        b = len(payloads)
        ends = np.cumsum([len(p) for p in payloads], dtype=np.int64)
        starts = np.concatenate([np.zeros(1, np.int64), ends])
        joined = np.frombuffer(b"".join(payloads), np.uint8)
        if ids is None:
            ids = np.arange(b, dtype=np.int64)
        shares = self._shares(b)
        queued = []
        for dev, stream, s in shares:
            a, z = int(starts[s.start]), int(starts[s.stop])
            col = Blocks(starts[s] - a, bits[s], lens[s], mins[s],
                         None if config is None
                         else tuple(c[s] for c in config), ids[s])
            with self._on(stream):
                queued.append(decode_columns(joined[a:z], [col], dev, dither,
                                             seed)[0])
        parts = []
        for (_, stream, _), dec in zip(shares, queued):
            with self._on(stream):
                parts.append(dec.cpu().numpy())
        return np.concatenate(parts)

    def decode_int_blocks(self, payloads, mins, bits, n: int) -> np.ndarray:
        """Decode per-block payloads back to (B, n) int64."""
        b = len(payloads)
        return self._decode(payloads, np.asarray(bits, np.int64),
                            np.full(b, n, np.int64),
                            np.asarray(mins, np.int64)).reshape(b, n)

    def decode_float_blocks(self, payloads, mins, bits, low, high, pixels,
                            n: int, periodic=True, dither: str = "none",
                            seed: int = 0, block_ids=None) -> np.ndarray:
        """Decode per-block payloads back to (B, n) float32
        (ref go/group.go:299-310).  ``block_ids`` are the container block
        indices the ``uniform`` dither is keyed on (default 0..B-1)."""
        b = len(payloads)
        config = (np.broadcast_to(np.asarray(low, np.float32), (b,)),
                  np.broadcast_to(np.asarray(high, np.float32), (b,)),
                  np.broadcast_to(np.asarray(pixels, np.int64), (b,)),
                  np.broadcast_to(np.asarray(periodic, bool), (b,)))
        ids = None if block_ids is None else np.asarray(block_ids, np.int64)
        return self._decode(payloads, np.asarray(bits, np.int64),
                            np.full(b, n, np.int64),
                            np.asarray(mins, np.int64), config, ids, dither,
                            seed).reshape(b, n)
