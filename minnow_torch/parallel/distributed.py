"""Multi-process coordination: ordered gather of encoded blocks to one
file (counterpart of ``minnow_tpu/parallel/distributed.py``, on
``torch.distributed``).

The distributed generalization of the reference's single-process writer
(ref go/writer.go): every process encodes its local share of blocks with
the device pipeline, per-block byte sizes are gathered, writer-order
offsets are the exclusive prefix sum over the *global* block order (the
distributed blockIndex, ref go/block_index.go:16-23), and process 0
writes one byte-exact file.

One process is the degenerate case and shares all code paths except the
collectives.  Block batches are expected to be process-sharded in
process-major global order (``mesh.block_shards``).

An ``EncodedBlocks`` holds host bytes, so the transport is a **gloo**
process group whatever device encoded them; :func:`init_distributed`
starts it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .pipeline import EncodedBlocks

__all__ = ["init_distributed", "gather_blocks", "is_coordinator",
           "barrier"]


# Env vars whose mere presence signals multi-process intent: the
# rendezvous of ``init_method="env://"``, as torchrun sets it.
_INTENT_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")
# Cluster environments (SLURM, Open MPI, PMI): intent only when they
# announce MORE THAN ONE task -- every single-task job inside `salloc`
# sets SLURM_JOB_ID, and a bare job must not turn a correct
# single-process run into a hard failure.
_INTENT_SIZE_ENV = (
    "SLURM_NTASKS", "SLURM_STEP_NUM_TASKS", "OMPI_COMM_WORLD_SIZE",
    "PMI_SIZE",
)


def _multiprocess_intent(environ) -> bool:
    if any(environ.get(v) for v in _INTENT_ENV):
        return True
    for v in _INTENT_SIZE_ENV:
        val = environ.get(v)
        if val:
            try:
                if int(val) > 1:
                    return True
            except ValueError:
                return True  # unparseable size: assume intent
    return False


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(**kw) -> None:
    """Start the gloo process group of a multi-process job.

    ``kw`` goes to ``torch.distributed.init_process_group`` (``init_method``,
    ``world_size``, ``rank``, ``timeout``); without it the environment's
    rendezvous is used (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).

    A genuine failure to start must NOT degrade silently into a wrong
    single-process run: when the caller *intends* several processes
    (explicit kwargs, or the environment of torchrun, SLURM, Open MPI or
    PMI says so), errors propagate.  Only the plain single-process
    convenience call (no kwargs, no such environment) and a second call
    are no-ops.
    """
    if _initialized():
        return
    if not (kw or _multiprocess_intent(os.environ)):
        return  # no multi-process intent anywhere: single process
    try:
        dist.init_process_group(backend="gloo", **kw)
    except Exception as e:  # noqa: BLE001 - every cause refuses the same way
        raise RuntimeError(
            "multi-process initialization failed (rendezvous unreachable "
            "or misconfigured: %s); refusing to continue as a single "
            "process" % e) from e


def _rank_and_size():
    if not _initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_coordinator() -> bool:
    return _rank_and_size()[0] == 0


def barrier() -> None:
    """Cross-process synchronization point (e.g. wait for the
    coordinator's file write before every process opens it for the
    sharded read-back).  Single-process: no-op."""
    if _rank_and_size()[1] > 1:
        dist.barrier()


def _all_gather(a: np.ndarray) -> np.ndarray:
    """``a`` of every process, stacked in rank order (equal shapes)."""
    mine = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return np.stack([t.numpy() for t in out])


def gather_blocks(enc: EncodedBlocks, mode: str = None) -> EncodedBlocks:
    """Gather per-process encoded blocks into the global writer order
    (process-major), for the single coordinator-written file
    (ref writer order contract: go/block_index.go:16-23).

    Two transports, both after one all-gather of every process's block
    count and payload total:

    * ``"gather"`` (coordinator-only, the default above 4 processes):
      every process sends its payload stream + metadata ONCE to process
      0, as one :func:`_pack_shard` blob; per-process traffic is O(local
      bytes) and only the coordinator materializes the global stream.
      Returns the full EncodedBlocks on the coordinator and **None**
      everywhere else.
    * ``"allgather"`` (the default up to 4 processes): every process
      receives every byte, O(P x total bytes) traffic.  For small P and
      for callers that need the result on every process.

    ``mode=None`` picks automatically; pass explicitly to force either.
    One process returns ``enc`` itself.  Handles *unequal* per-process
    block counts and processes with no block; in allgather mode payloads
    travel as ONE concatenated byte stream per process padded to the max
    per-process total (not per-block max), so overhead is bounded by the
    per-process total imbalance.
    """
    rank, size = _rank_and_size()
    if size == 1:
        return enc
    if mode is None:
        mode = "gather" if size > 4 else "allgather"
    if mode not in ("gather", "allgather"):
        raise ValueError("unknown gather mode %r" % mode)

    sizes = enc.sizes
    b_local = len(enc.payloads)
    local_total = int(sizes.sum())
    # (P, 2): per-process block count and payload total
    counts = _all_gather(np.asarray([b_local, local_total], np.int64))
    if mode == "gather":
        return _gather_to_coordinator(enc, counts, rank)

    # collectives want equal, non-empty shapes
    max_b = max(int(counts[:, 0].max()), 1)
    max_total = max(int(counts[:, 1].max()), 1)

    # metadata padded to max_b rows; minimums as int64 bit patterns
    meta = np.zeros((4, max_b), np.int64)
    meta[0, :b_local] = sizes
    meta[1, :b_local] = np.asarray(enc.mins, np.int64)
    meta[2, :b_local] = enc.bits
    meta[3, :b_local] = enc.lens
    all_meta = _all_gather(meta)

    # one ragged byte stream per process, padded to max_total
    stream = np.zeros(max_total, np.uint8)
    if local_total:
        stream[:local_total] = np.frombuffer(
            b"".join(enc.payloads), dtype=np.uint8)
    all_streams = _all_gather(stream)

    payloads: list = []
    mins: list = []
    bits: list = []
    lens: list = []
    for p in range(size):
        bp = int(counts[p, 0])
        p_sizes = all_meta[p, 0, :bp]
        offs = np.concatenate([[0], np.cumsum(p_sizes)])
        for i in range(bp):
            payloads.append(
                all_streams[p, offs[i]:offs[i + 1]].tobytes())
        mins.append(all_meta[p, 1, :bp])
        bits.append(all_meta[p, 2, :bp])
        lens.append(all_meta[p, 3, :bp])
    return EncodedBlocks(payloads,
                         np.concatenate(mins),
                         np.concatenate(bits),
                         np.concatenate(lens))


def _pack_shard(enc: EncodedBlocks) -> bytes:
    """One self-describing byte blob per process: block count, then the
    (4, B) int64 metadata (sizes, mins, bits, lens), then the
    concatenated payload stream."""
    b_local = len(enc.payloads)
    meta = np.empty((4, b_local), np.int64)
    meta[0] = enc.sizes
    meta[1] = enc.mins
    meta[2] = enc.bits
    meta[3] = enc.lens
    return (np.int64(b_local).tobytes() + meta.tobytes()
            + b"".join(enc.payloads))


def _unpack_shard(blob: bytes):
    """Inverse of _pack_shard: (payloads, mins, bits, lens) arrays."""
    b = int(np.frombuffer(blob[:8], np.int64)[0])
    meta = np.frombuffer(blob[8:8 + 32 * b], np.int64).reshape(4, b)
    sizes = meta[0]
    offs = 8 + 32 * b + np.concatenate([[0], np.cumsum(sizes)])
    payloads = [blob[offs[i]:offs[i + 1]] for i in range(b)]
    return payloads, meta[1], meta[2], meta[3]


def _gather_to_coordinator(enc: EncodedBlocks, counts,
                           rank: int) -> EncodedBlocks:
    """Coordinator-only gather (SURVEY section 5.8 single-writer gather):
    process p sends its shard blob to process 0 in one message, whose
    length the coordinator knows from ``counts``; per-process traffic is
    its own bytes, the coordinator's is the global total.  Returns
    EncodedBlocks on the coordinator, None on every other process."""
    if rank != 0:
        blob = np.frombuffer(_pack_shard(enc), dtype=np.uint8)
        dist.send(torch.from_numpy(blob.copy()), dst=0)
        return None

    payloads = list(enc.payloads)
    mins = [np.asarray(enc.mins, np.int64)]
    bits = [np.asarray(enc.bits, np.int64)]
    lens = [np.asarray(enc.lens, np.int64)]
    for q in range(1, len(counts)):
        blob = torch.empty(8 + 32 * int(counts[q, 0]) + int(counts[q, 1]),
                           dtype=torch.uint8)
        dist.recv(blob, src=q)
        pq, mq, bq, lq = _unpack_shard(blob.numpy().tobytes())
        payloads.extend(pq)
        mins.append(mq)
        bits.append(bq)
        lens.append(lq)
    return EncodedBlocks(payloads, np.concatenate(mins),
                         np.concatenate(bits), np.concatenate(lens))
