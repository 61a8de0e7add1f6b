"""The devices a batch is split over, and the split (counterpart of
``minnow_tpu/parallel/mesh.py``).

The unit of parallelism is the independently coded minnow *block*
(ref go/group.go:242-263 -- every block carries its own min/bits
metadata): the block axis of a batch is split into contiguous shares, one
per device of a process and one per process of a job.  The TPU mesh needs
equal shards and pads the batch to a multiple of its size
(``pad_to_multiple``); CUDA devices take unequal shares, so nothing is
padded here and the same split serves the multi-device encoder
(``pipeline.BlockEncoder``) and the owner table of a multi-process job
(``tools.multiprocess_gather_check``).
"""

from __future__ import annotations

import torch

from ..utils.device import cuda_device

__all__ = ["block_mesh", "block_shards"]


def block_mesh(devices=None) -> list:
    """The list of ``torch.device`` a batch is split over: the given
    device or devices, or every visible CUDA device when ``devices`` is
    None (RuntimeError without one)."""
    if devices is None:
        cuda_device()
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("a block mesh needs at least one device")
    return out


def block_shards(b: int, parts: int) -> list:
    """The contiguous split of ``b`` blocks into ``parts`` shares, as
    slices in block order; earlier shares take the remainder, so the
    counts differ by at most one and a share may be empty."""
    if parts < 1:
        raise ValueError("parts must be at least 1, got %d" % parts)
    base, rem = divmod(int(b), parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < rem else 0)
        out.append(slice(start, stop))
        start = stop
    return out
