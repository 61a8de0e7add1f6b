"""Block encode on the device: kernels K1 (float), K5 (float pack from
precomputed pixels) and K3 (int), each beside its plain PyTorch version.

A wrapper given CUDA tensors launches its kernel (``csrc/encode_float.cu``,
``csrc/pack_int.cu``) or raises; given CPU tensors it runs the plain
version.  Nothing else chooses between them.

An encode, float or int, is three launches with nothing for the host
between them: per-block stats (:func:`float_stats`, :func:`int_stats`),
the plan of the batch on the device (:func:`float_plan`,
:func:`int_plan`: each block's minimum, width and word offset, in one
layout for both) and the pack (:func:`pack_float`, or with ``reuse_q`` K5,
:func:`pack_float_q`, from the pixels the stats launch stored; K3 for
ints).  The host reads the plan once, after the pack is queued
(:func:`read_plan`, a :class:`Plan`).  Encoded blocks come back as one flat
int32 word buffer (the uint32 bit patterns) holding each block's stream at
its own width, back to back at ``plan.offsets``
(``bitpack.block_layout``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build, bitpack, codec
from ._launch import COUNT_LOCK, THREADS, expect, on_card, stream_of

__all__ = [
    "K1_LAUNCHES",
    "K3_LAUNCHES",
    "K3_STATS_LAUNCHES",
    "K3_PLAN_LAUNCHES",
    "K5_LAUNCHES",
    "Plan",
    "float_stats",
    "float_stats_plain",
    "float_plan",
    "float_plan_plain",
    "read_plan",
    "plan_float",
    "pack_float",
    "pack_float_plain",
    "pack_float_q",
    "pack_float_q_plain",
    "start_float_group",
    "finish_float_group",
    "encode_float_group",
    "int_stats",
    "int_stats_plain",
    "int_plan",
    "int_plan_plain",
    "plan_int",
    "delta_pack_int",
    "delta_pack_int_plain",
    "start_int_group",
    "finish_int_group",
    "encode_int_group",
    "pack_batch",
    "pack_batch_plain",
]

# kernel launches made by the wrappers (K1 counts each of its three; K3
# its packs, from either entry, beside its stats and plan launches)
K1_LAUNCHES = 0
K3_LAUNCHES = 0
K3_STATS_LAUNCHES = 0
K3_PLAN_LAUNCHES = 0
K5_LAUNCHES = 0

# launch shape (``tools.ab_launch`` sweeps it at 4096 x 2^17 on the
# H100; PERF.md, Findings): elements each thread takes in a run of a
# stats launch (K1's and K3's).  The packs (K1, K5, K3) size their own
# persistent grids: as many CTAs as the card holds
STATS_PER_THREAD = 32

# rows of the device plan (csrc/plan.cuh), K1's and K3's: six rows of B
# int64, then the total number of words and the longest block stream's
PLAN_ROWS = 6


class Plan(NamedTuple):
    """Host plan of a batch's encode, all (B,) numpy.  Blocks that are not
    ``valid`` get width 0 and zero metadata: the caller encodes them with
    ``spec``.  ``m`` is the periodic recentring offset (floats only)."""

    mins: np.ndarray     # int64 block minimum (after recentring)
    maxd: np.ndarray     # int64 largest delta (uint64 bit pattern)
    bits: np.ndarray     # int64 width
    valid: np.ndarray    # bool
    m: np.ndarray        # int64
    offsets: np.ndarray  # int64 word offset of each block's stream
    total: int           # words in the buffer
    max_words: int       # words in the largest block stream


def _plan(mins, maxd, valid, m, lens) -> Plan:
    mins = np.where(valid, mins, 0).astype(np.int64)
    maxd = np.where(valid, maxd, 0).astype(np.int64)
    # spec.precision_needed: the exact bit length of the uint64 delta
    bits = np.array([int(v).bit_length() for v in maxd.view(np.uint64)],
                    np.int64)
    offsets, total = bitpack.block_layout(bits, lens)
    max_words = int(bitpack.words_per_block(bits, lens).max(initial=0))
    return Plan(mins, maxd, bits, np.asarray(valid, bool),
                np.asarray(m, np.int64), offsets, total, max_words)


def _put(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _check_params(b, params, lens):
    expect(params.low, "low", torch.float32, (b,))
    expect(params.dx, "dx", torch.float32, (b,))
    expect(params.pixels, "pixels", torch.int64, (b,))
    expect(params.periodic, "periodic", torch.bool, (b,))
    expect(lens, "lens", torch.int64, (b,))


def _check_float_args(x, params, lens, *more):
    expect(x, "x", torch.float32, (None, None))
    _check_params(x.shape[0], params, lens)
    return on_card(x, *params, lens, *more)


def _check_lens(lens, n):
    if lens.numel() and (int(lens.max()) > n or int(lens.min()) < 0):
        raise ValueError("lens must lie in [0, %d]" % n)


# -- K1: float encode ---------------------------------------------------------


def float_stats_plain(x, params, lens, q_out=None):
    """Plain version of K1's stats launch (``codec.float_block_stats``)."""
    if q_out is not None:
        q, _ = codec.quantize(x, params.low, params.dx)
        live = torch.arange(x.shape[1], device=x.device)[None, :] \
            < lens[:, None]
        q_out.copy_(torch.where(live, q.to(torch.int32), q_out))
    return codec.float_block_stats(x, params, lens)


def _launch_stats(x, params, lens, q_out):
    global K1_LAUNCHES
    b, n = x.shape
    stats = torch.empty((b, 6), dtype=torch.int32, device=x.device)
    if b == 0:
        return stats
    with torch.cuda.device(x.device):
        err = _build.load().minnow_encode_float_stats(
            x.data_ptr(), b, n, THREADS * STATS_PER_THREAD,
            params.low.data_ptr(), params.dx.data_ptr(),
            params.pixels.data_ptr(), params.periodic.data_ptr(),
            lens.data_ptr(), stats.data_ptr(),
            None if q_out is None else q_out.data_ptr(), stream_of(x))
    with COUNT_LOCK:
        K1_LAUNCHES += 1
    _build.check(err, "encode_float_stats")
    return stats


def float_stats(x, params: codec.BlockParams, lens, q_out=None):
    """Per-block stats rows (B, 6) int32 of ``codec.float_block_stats``
    for ``x`` (B, n) float32 over its first ``lens`` elements; K1's first
    launch on the card.  Given ``q_out`` (B, n) int32, it also stores each
    element's pixel there (``codec.quantize``'s q, 0 where not certified),
    in each row's first ``lens`` places only."""
    more = []
    if q_out is not None:
        expect(q_out, "q_out", torch.int32, tuple(x.shape))
        more.append(q_out)
    if not _check_float_args(x, params, lens, *more):
        return float_stats_plain(x, params, lens, q_out)
    _check_lens(lens, x.shape[1])
    return _launch_stats(x, params, lens, q_out)


def plan_float(stats, params: codec.BlockParams, lens) -> Plan:
    """Host plan from the stats rows: recentring offset, minimum and
    width of each block, as ``spec.periodic_min_fast`` and
    ``pallas_encode.py:591-617`` derive them.  The reference that
    :func:`float_plan` is held to; no encode path calls it."""
    host = [t.cpu() for t in (stats, params.pixels, params.periodic, lens)]
    m, mn, maxd, valid = (t.numpy() for t in codec.finish_float_stats(
        *host))
    return _plan(mn, maxd, valid, m, host[3].numpy())


def _plan_rows(mn, maxd, valid, m, lens):
    """The device plan's layout from its (B,) int64 rows: the width of
    each largest delta (``spec.precision_needed`` of the uint64 bit
    pattern ``maxd`` holds) and the exclusive prefix sum of the blocks'
    word counts, then the total and the longest stream."""
    powers = 2 ** torch.arange(63, dtype=torch.int64, device=maxd.device)
    bits = torch.where(maxd < 0, 64,
                       torch.bucketize(maxd, powers, right=True))
    nw = (bits * lens + 31) >> 5
    tail = torch.stack([nw.sum(), nw.max() if nw.numel() else nw.sum()])
    return torch.cat([mn, maxd, bits, valid.to(torch.int64), m,
                      nw.cumsum(0) - nw, tail])


def float_plan_plain(stats, params, lens):
    """Plain version of K1's plan launch: ``codec.finish_float_stats``,
    then the widths and offsets of :func:`_plan_rows`."""
    m, mn, maxd, valid = codec.finish_float_stats(
        stats, params.pixels, params.periodic, lens)
    zero = torch.zeros_like(mn)
    return _plan_rows(torch.where(valid, mn, zero),
                      torch.where(valid, maxd, zero), valid, m, lens)


def _launch_plan(stats, params, lens):
    global K1_LAUNCHES
    b = stats.shape[0]
    plan = torch.empty(PLAN_ROWS * b + 2, dtype=torch.int64,
                       device=stats.device)
    with torch.cuda.device(stats.device):
        err = _build.load().minnow_encode_float_plan(
            stats.data_ptr(), params.pixels.data_ptr(),
            params.periodic.data_ptr(), lens.data_ptr(), b, plan.data_ptr(),
            stream_of(stats))
    with COUNT_LOCK:
        K1_LAUNCHES += 1
    _build.check(err, "encode_float_plan")
    return plan


def float_plan(stats, params: codec.BlockParams, lens):
    """The plan of a float batch from its stats rows, on the stats'
    device: a (6 B + 2,) int64 tensor holding the rows ``mins``, ``maxd``,
    ``bits``, ``valid``, ``m`` and ``offsets`` of :class:`Plan`, then
    ``total`` and ``max_words``.  K1's second launch on the card;
    :func:`read_plan` brings it to the host."""
    expect(stats, "stats", torch.int32, (None, 6))
    b = stats.shape[0]
    _check_params(b, params, lens)
    if not on_card(stats, *params, lens):
        return float_plan_plain(stats, params, lens)
    return _launch_plan(stats, params, lens)


def read_plan(plan) -> Plan:
    """The :class:`Plan` of a device plan tensor: one copy to the host."""
    h = plan.cpu().numpy()
    b = (len(h) - 2) // PLAN_ROWS
    mins, maxd, bits, valid, m, offsets = h[:PLAN_ROWS * b].reshape(
        PLAN_ROWS, b)
    return Plan(mins, maxd, bits, valid.astype(bool), m, offsets,
                int(h[-2]), int(h[-1]))


def _device_plan(plan: Plan, device):
    """A host plan in the device plan's layout, on ``device``."""
    return _put(np.concatenate([plan.mins, plan.maxd, plan.bits, plan.valid,
                                plan.m, plan.offsets,
                                [plan.total, plan.max_words]]),
                np.int64, device)


def pack_float_q_plain(q, params, lens, plan: Plan):
    """Plain version of K5 (and, from the quantized x, of K1's pack)."""
    dev = q.device
    q = q.to(torch.int64)
    p = params.pixels[:, None]
    m = _put(plan.m, np.int64, dev)[:, None]
    q = torch.where(params.periodic[:, None], codec.bound(q, m, p), q)
    return bitpack.pack(q - _put(plan.mins, np.int64, dev)[:, None],
                        _put(plan.bits, np.int64, dev), lens,
                        _put(plan.offsets, np.int64, dev), plan.total)


def pack_float_plain(x, params, lens, plan: Plan):
    """Plain version of K1's pack launch."""
    q, _ = codec.quantize(x, params.low, params.dx)
    return pack_float_q_plain(q, params, lens, plan)


def _launch_pack(src, params, lens, plan, capacity: int):
    """The tile pack of ``src`` -- x (K1) or the stored pixels (K5) -- by
    the device plan ``plan`` into a new buffer of ``capacity`` words.  A
    block whose stream would end past the buffer is left out."""
    global K1_LAUNCHES, K5_LAUNCHES
    b, n = src.shape
    words = torch.empty(capacity, dtype=torch.int32, device=src.device)
    if capacity == 0 or b == 0 or n == 0:
        return words
    lib = _build.load()
    from_x = src.dtype == torch.float32
    kernel = (lib.minnow_encode_float_pack if from_x
              else lib.minnow_encode_float_pack_q)
    with torch.cuda.device(src.device):
        err = kernel(
            src.data_ptr(), b, n, params.low.data_ptr(),
            params.dx.data_ptr(), params.pixels.data_ptr(),
            params.periodic.data_ptr(), plan.data_ptr(), lens.data_ptr(),
            words.data_ptr(), capacity, stream_of(src))
    with COUNT_LOCK:
        if from_x:
            K1_LAUNCHES += 1
        else:
            K5_LAUNCHES += 1
    _build.check(err, "encode_float_pack" if from_x
                 else "encode_float_pack_q")
    return words


def _pack_by_host_plan(src, params, lens, plan: Plan):
    b, n = src.shape
    _check_lens(lens, n)
    if plan.bits.size != b or plan.bits.max(initial=0) > 32:
        raise ValueError("the plan must give B widths in [0, 32]")
    return _launch_pack(src, params, lens, _device_plan(plan, src.device),
                        plan.total)


def pack_float(x, params: codec.BlockParams, lens, plan: Plan):
    """Pack each block's recentred, min-subtracted pixels at its planned
    width (0..32) into the (plan.total,) int32 buffer; K1's third launch
    on the card."""
    if not _check_float_args(x, params, lens):
        return pack_float_plain(x, params, lens, plan)
    return _pack_by_host_plan(x, params, lens, plan)


def pack_float_q(q, params: codec.BlockParams, lens, plan: Plan):
    """What :func:`pack_float` packs, from the pixels ``q`` (B, n) int32
    that :func:`float_stats` stored for this plan's x; K5 on the card."""
    expect(q, "q", torch.int32, (None, None))
    _check_params(q.shape[0], params, lens)
    if not on_card(q, *params, lens):
        return pack_float_q_plain(q, params, lens, plan)
    return _pack_by_host_plan(q, params, lens, plan)


def start_float_group(x, params: codec.BlockParams, lens,
                      reuse_q: bool = False, capacity: int = None):
    """Queue the float encode of :func:`encode_float_group` on ``x``'s
    device and return at once, with what :func:`finish_float_group` needs
    to bring the result to the host.  On the card nothing here waits for
    the device, so a caller with several devices or streams can start
    every share before it reads the first one back."""
    if not _check_float_args(x, params, lens):
        q = torch.empty(x.shape, dtype=torch.int32) if reuse_q else None
        stats = float_stats_plain(x, params, lens, q)
        plan = read_plan(float_plan_plain(stats, params, lens))
        if reuse_q:
            return pack_float_q_plain(q, params, lens, plan), plan, None
        return pack_float_plain(x, params, lens, plan), plan, None
    b, n = x.shape
    _check_lens(lens, n)
    if capacity is None:
        capacity = b * n
    q = None
    if reuse_q:
        q = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    stats = _launch_stats(x, params, lens, q)
    dplan = _launch_plan(stats, params, lens)
    words = _launch_pack(q if reuse_q else x, params, lens, dplan, capacity)
    return words, dplan, capacity


def finish_group(pending):
    """``(words, plan)`` of an encode that :func:`start_float_group` or
    :func:`start_int_group` queued: one read of the device plan.  The
    words are a view of the buffer the start allocated, cut to the plan's
    total."""
    words, plan, capacity = pending
    if capacity is None:  # the plain versions have finished already
        return words, plan
    plan = read_plan(plan)
    if plan.total > capacity:
        raise ValueError("the batch packs to %d words, above the capacity "
                         "of %d" % (plan.total, capacity))
    return words[:plan.total], plan


finish_float_group = finish_int_group = finish_group


def encode_float_group(x, params: codec.BlockParams, lens,
                       reuse_q: bool = False, capacity: int = None):
    """Encode float blocks ``x`` (B, n) float32 over their first ``lens``
    elements: stats launch, plan launch, pack launch, then one read of
    the plan.  Returns ``(words, plan)``; every valid block has its true
    width.

    ``capacity`` is an upper bound on the words of the batch that the
    caller has on the host (the word buffer is allocated before the plan
    is known); without one it is B n, every block at 32 bits.

    With ``reuse_q`` the stats launch also stores each element's pixel
    in an int32 (B, n) buffer and K5 packs from it, where K1's pack
    quantizes x again (``encode_float_pallas_bigblock(reuse_q=True)``,
    ``pallas_encode.py:855``); the words are the same."""
    return finish_float_group(start_float_group(x, params, lens, reuse_q,
                                                capacity))


# -- K3: int encode -----------------------------------------------------------


def _check_int_args(x, lens):
    expect(x, "x", torch.int64, (None, None))
    expect(lens, "lens", torch.int64, (x.shape[0],))
    return on_card(x, lens)


def int_stats_plain(x, lens):
    """Plain version of K3's stats launch: ``codec.int_block_stats`` as
    (B, 2) int64 rows of each block's minimum and maximum."""
    mn, maxd = codec.int_block_stats(x, lens)
    return torch.stack([mn, mn + maxd], dim=1)


def _launch_int_stats(x, lens):
    global K3_STATS_LAUNCHES
    b, n = x.shape
    stats = torch.empty((b, 2), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load().minnow_int_stats(
            x.data_ptr(), b, n, THREADS * STATS_PER_THREAD, lens.data_ptr(),
            stats.data_ptr(), stream_of(x))
    with COUNT_LOCK:
        K3_STATS_LAUNCHES += 1
    _build.check(err, "int_stats")
    return stats


def int_stats(x, lens):
    """(B, 2) int64 rows of the minimum and the maximum of each block of
    ``x`` (B, n) int64 over its first ``lens`` elements, (0, 0) for an
    empty block; K3's first launch on the card."""
    if not _check_int_args(x, lens):
        return int_stats_plain(x, lens)
    _check_lens(lens, x.shape[1])
    if x.shape[0] == 0:
        return torch.empty((0, 2), dtype=torch.int64, device=x.device)
    return _launch_int_stats(x, lens)


def int_plan_plain(stats, lens):
    """Plain version of K3's plan launch: each block's minimum, the
    wrapped ``max - min`` as its largest delta and that delta's width,
    zeros for an empty block, every block valid with ``m`` 0, in the
    device plan's layout (:func:`_plan_rows`)."""
    empty = lens == 0
    zero = torch.zeros_like(lens)
    mn = torch.where(empty, zero, stats[:, 0])
    maxd = torch.where(empty, zero, stats[:, 1] - stats[:, 0])
    return _plan_rows(mn, maxd, torch.ones_like(empty), zero, lens)


def _launch_int_plan(stats, lens):
    global K3_PLAN_LAUNCHES
    b = stats.shape[0]
    plan = torch.empty(PLAN_ROWS * b + 2, dtype=torch.int64,
                       device=stats.device)
    with torch.cuda.device(stats.device):
        err = _build.load().minnow_int_plan(
            stats.data_ptr(), lens.data_ptr(), b, plan.data_ptr(),
            stream_of(stats))
    with COUNT_LOCK:
        K3_PLAN_LAUNCHES += 1
    _build.check(err, "int_plan")
    return plan


def int_plan(stats, lens):
    """The plan of an int batch from its stats rows, on their device, in
    the layout of :func:`float_plan`; K3's second launch on the card."""
    expect(stats, "stats", torch.int64, (None, 2))
    expect(lens, "lens", torch.int64, (stats.shape[0],))
    if not on_card(stats, lens):
        return int_plan_plain(stats, lens)
    return _launch_int_plan(stats, lens)


def plan_int(x, lens) -> Plan:
    """Host plan of an int batch: :func:`int_stats` and :func:`int_plan`
    on ``x``'s device, then one read.  No encode path calls it: it is
    for callers that change a plan before they pack by it
    (:func:`delta_pack_int`)."""
    return read_plan(int_plan(int_stats(x, lens), lens))


def delta_pack_int_plain(x, lens, plan: Plan):
    """Plain version of K3's pack."""
    dev = x.device
    return bitpack.pack(x - _put(plan.mins, np.int64, dev)[:, None],
                        _put(plan.bits, np.int64, dev), lens,
                        _put(plan.offsets, np.int64, dev), plan.total)


def _launch_int_pack(x, lens, plan, capacity: int):
    """K3's pack of ``x`` by the device plan ``plan`` into a new buffer
    of ``capacity`` words.  A block whose stream would end past the
    buffer is left out."""
    global K3_LAUNCHES
    b, n = x.shape
    words = torch.empty(capacity, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load().minnow_pack_int(
            x.data_ptr(), b, n, plan.data_ptr(), lens.data_ptr(),
            words.data_ptr(), capacity, stream_of(x))
    with COUNT_LOCK:
        K3_LAUNCHES += 1
    _build.check(err, "pack_int")
    return words


def _launch_int_encode(x, lens, capacity: int):
    """K3's stats, plan and pack launches on ``x`` (B >= 1, n >= 1),
    queued with nothing for the host between them: ``(words, device
    plan)``."""
    plan = _launch_int_plan(_launch_int_stats(x, lens), lens)
    return _launch_int_pack(x, lens, plan, capacity), plan


def _check_host_plan(plan: Plan, lens, n: int):
    """Raise unless a host plan gives B widths in [0, 64] and every
    block's stream ends inside ``plan.total`` words: the kernel leaves a
    block that would pass the end of its buffer unpacked, and the plain
    version has no room for it."""
    lh = lens.cpu().numpy()
    if lh.size and (lh.max() > n or lh.min() < 0):
        raise ValueError("lens must lie in [0, %d]" % n)
    if plan.bits.size != lh.size or plan.bits.max(initial=0) > 64 \
            or plan.bits.min(initial=0) < 0:
        raise ValueError("the plan must give B widths in [0, 64]")
    nw = bitpack.words_per_block(plan.bits, lh)
    past = np.flatnonzero((nw > 0) & (plan.offsets + nw > plan.total))
    if past.size:
        b = int(past[0])
        raise ValueError("block %d's stream ends at word %d, past the "
                         "plan's total of %d" % (
                             b, int(plan.offsets[b] + nw[b]), plan.total))


def delta_pack_int(x, lens, plan: Plan):
    """Pack ``x - mins`` (B, n) int64, wrapping, at each block's planned
    width (0..64) over its first ``lens`` elements into the (plan.total,)
    int32 buffer, by a plan the caller made on the host (its own minimums
    or one width: :func:`pack_batch`, ``validate``); K3's pack on the
    card, the plan brought there in one copy.  A plan in which a block's
    stream ends past ``plan.total`` raises."""
    on = _check_int_args(x, lens)
    _check_host_plan(plan, lens, x.shape[1])
    if not on:
        return delta_pack_int_plain(x, lens, plan)
    if plan.total == 0:
        return torch.empty(0, dtype=torch.int32, device=x.device)
    return _launch_int_pack(x, lens, _device_plan(plan, x.device),
                            plan.total)


def start_int_group(x, lens, capacity: int = None):
    """Queue the int encode of :func:`encode_int_group` on ``x``'s device
    and return at once, with what :func:`finish_int_group` needs to bring
    the result to the host: on the card K3's stats, plan and pack
    launches, and nothing that waits for the device between them."""
    if not _check_int_args(x, lens):
        plan = read_plan(int_plan_plain(int_stats_plain(x, lens), lens))
        return delta_pack_int_plain(x, lens, plan), plan, None
    b, n = x.shape
    _check_lens(lens, n)
    if capacity is None:
        capacity = 2 * b * n
    if b == 0 or n == 0:  # no block holds an element: nothing to launch
        plan = np.zeros(PLAN_ROWS * b + 2, np.int64)
        plan[3 * b:4 * b] = 1  # the valid row
        return (torch.empty(0, dtype=torch.int32, device=x.device),
                _put(plan, np.int64, x.device), capacity)
    return (*_launch_int_encode(x, lens, capacity), capacity)


def encode_int_group(x, lens, capacity: int = None):
    """Encode int blocks ``x`` (B, n) int64 over their first ``lens``
    elements: stats launch, plan launch, pack launch, then one read of
    the plan.  Returns ``(words, plan)``; every block has its true width.

    ``capacity`` is an upper bound on the words of the batch that the
    caller has on the host (the word buffer is allocated before the plan
    is known); without one it is 2 B n, every block at 64 bits, the bytes
    of ``x``."""
    return finish_int_group(start_int_group(x, lens, capacity))


def _batch_plan(x, bits: int):
    """The plan of :func:`pack_batch`: zero minimums, one width, each
    row's stream ``words_per_block(bits, N)`` long; and the lens."""
    if not 1 <= bits <= 32:
        raise ValueError("pack_batch takes widths 1..32, got %d" % bits)
    expect(x, "x", torch.int64, (None, None))
    b, n = x.shape
    nw = bitpack.words_per_block(bits, n)
    plan = Plan(mins=np.zeros(b, np.int64), maxd=np.zeros(b, np.int64),
                bits=np.full(b, bits, np.int64), valid=np.ones(b, bool),
                m=np.zeros(b, np.int64),
                offsets=np.arange(b, dtype=np.int64) * nw, total=b * nw,
                max_words=nw)
    return plan, torch.full((b,), n, dtype=torch.int64, device=x.device)


def pack_batch_plain(x, bits: int):
    """Plain version of :func:`pack_batch` (``delta_pack_int_plain`` on
    its plan)."""
    plan, lens = _batch_plan(x, bits)
    return delta_pack_int_plain(x, lens, plan).view(len(lens), plan.max_words)


def pack_batch(x, bits: int):
    """Pack each row of ``x`` (B, N) -- uint32 values held in int64 --
    at the one width ``bits`` (1..32), each value masked to its low
    ``bits`` bits: ``pallas_pack.pack_batch_pallas`` (``pallas_pack.py:82``)
    on K3, as a delta pack with zero minimums.  Returns the (B,
    ``words_per_block(bits, N)``) int32 words."""
    plan, lens = _batch_plan(x, bits)
    return delta_pack_int(x, lens, plan).view(len(lens), plan.max_words)
