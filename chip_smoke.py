#!/usr/bin/env python3
"""Smoke run of minnow_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises at its first failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of minnow_torch/csrc, one nvcc for each source,
   all started together, for sm_90a;
3. kernels against their plain PyTorch versions on the card, bitwise
   (tolerance zero: words, metadata, integers and float bit patterns must
   be equal): K1 float encode (its stats, plan and pack launches and the
   whole call) and K5 (the pack from the stats launch's pixels, equal to
   K1's pack too) at widths 1..32, on periodic and non-periodic blocks,
   blocks K1 does not certify beside valid ones, and ragged batches with
   lengths 1, 31, 32, 33, 2049 and 2^17 - 1, the plan launch also against
   the host's ``plan_float``; K2 float decode at widths 0..64 in the
   three dither modes; K3 int encode (its stats, plan and pack launches
   and the whole call) at widths 0..64 with IDs above 2^53, at 1, 18,
   37, 54 and 64 bits on lengths 0, 1, 31, 32, 33, 2049 and 4097, at 1,
   31, 32, 33, 54, 63 and 64 bits on lengths 1 to 8193 around the pack's
   tiles of 4,096, on rows on 16-byte boundaries and rows 8 bytes off
   one, with garbage past each length, and -2^63 beside 2^63 - 1 in one
   block;
   K4 int unpack at widths 0..64 with minimums at -2^63 and 2^63 - 1 and
   deltas of 2^width - 1; K2 and K4 also through their ragged entry on
   one column of widths 0..64 at start bytes 0..3 (mod 4), lengths 1, 31,
   33, 4,099 and 2^17 - 1, minimums -2^63 and 2^63 - 1, pixel counts
   2^31 + 5 and 10^10 (``ragged_sweep``); the TPU's per-tile kernels on
   their counterparts: B9 ``decode_float_group`` in none and midpoint,
   B10 ``decode_int_group`` with zero minimums and B11 ``pack_batch`` at
   widths 1..32 (also against ``spec.pack_bits``).
   Then each kernel at the flagship block shape (4096 blocks x 2^17
   elements, 18 bits; K3 also at 37, 54 and 64 bits, K4 at 54), timed
   (CUDA events, median of 7 after warm-up) beside its plain version;
   K1's three launches, the stats launch storing pixels, K5, and K3's
   three launches (its stats launch beside ``torch.aminmax``, both also
   alone in a CUDA graph) apart.  The path of K5,
   ``encode_float_group(reuse_q=True)``, runs once there with the launch
   counts at zero around it, and its words must equal K1's.
   Last (the sweep is mostly ``core.spec`` on the host, and the card's
   clocks fall while it waits, so the timings come first), K1, K5 and K2
   at pixel counts of 2^31 and more (2^31 + 5 periodic with
   a window over the circle's seam and spread over half of it, 2^31 and
   2^33 non-periodic, 10^10 periodic with the data inside 2^31 pixels and
   beyond), at (12, 200) ragged and at (64, 2^17), and 2^62 + 3 and
   2^63 - 1 at (12, 200): against their plain versions and against
   ``core.spec``, bitwise, ``BlockEncoder`` on the same batches with the
   count of blocks it sent to the host encoder;
4. the first main path: a 1,000,000-row Rockstar-style catalog through
   ``text_to_minh --device``, byte-compared with the file of the same
   converter in host mode, every float column read back on the card
   with ``read_floats`` in the none, midpoint and uniform modes and the
   ``int`` columns with ``read_ints``, bitwise equal to the host reader,
   each read one launch a column.
   K1 to K4 must have been launched by this phase.  Before it, K1 to K4
   are checked against their plain versions, bitwise, and timed at the
   shapes this phase gives them (one block of each column).  Then a
   second, 200,000-row catalog with two columns of 10^10 pixels (0 to
   10^6 at 10^-4: ``wide`` with its values inside 2^31 pixels, ``far``
   all over the range) through ``text_to_minh --device``, byte-compared
   with host mode; both columns read back with ``read_floats`` in the
   three modes, bitwise equal to the host reader; ``inspect_minh
   --device`` prints what host mode prints.  K1 and K2 must have been
   launched on it, and the blocks sent to the host encoder are ``far``'s.
   Before its counts are set to zero the same conversion, reads and
   inspection run once with every call of K1 to K4 held against its plain
   version on the same tensors (``held_to_plain``), bitwise: the shapes
   this catalog gives them, ``far``'s block that K1 does not certify
   among them;
5. the boundary path: a second 1,000,000-row catalog with ``int`` IDs
   above 2^53 through ``text_to_minh --device`` (byte-compared as in 4)
   and ``read_ints``, then ``minh_to_bnd --device`` at 8 cells and
   boundary 5.0, byte-compared with ``minh_to_bnd`` in host mode
   (``uniform`` dither); every column of the boundary file read back on
   the card, bitwise equal to the host reader, one K2 launch a Float
   column and one K4 launch an Int column, and ``inspect_minh --device``
   printing what ``inspect_minh`` prints in host mode.
   K1 to K4 must have been launched by this phase, and the cell table
   (``csrc/cells.cu``) built once.  Before it, K1 to K4
   are checked and timed as in 4 at this phase's shapes: K1 and K3 on
   one column of 512 ragged cells, K2 and K4 on that column whole, as
   the read gives it them; the cell table's kernel chain against its
   plain version at the boundary cell's shape (3.0 M halos, 8^3 cells,
   boundary 5), bitwise, and timed alone beside its bound and the plain
   version (into the kernels line); after its count, the file's x and
   id columns as the read stages them, through the ragged entry, timed
   beside their bound;
6. the snapshot path: an LGadget-2 fileset of 256^3 particles (L 250,
   lattice positions with Gaussian displacements and collapsed clusters;
   Gaussian velocities) through ``convert_snapshot to_minp --device`` at
   2 file cells and 8 sub-cells (16 files of 2^21 particles, 3 x 512
   blocks of 4,096 each), re-binned on the card (one launch of
   ``csrc/rebin.cu`` a source file, 8 in all, the 8 cells one batch;
   the kernel also against its plain version and timed at the snapshot
   cell's shape, into the kernels line), every file byte-compared with
   the host mode's;
   every file read back on the card with
   ``read_vectors`` in ``uniform``, one x and one v file also in ``none``
   and ``midpoint``, bitwise equal to the host reader, one K2 launch a
   file, and the positions and velocities of one file cell within dx and
   dv of the source.  K1 and K2 must have been launched by this phase.
   Before it, K1 and K2 are checked and timed at its shapes (one axis of
   a file: 512 blocks of 4,096, K2 on the whole axis); after its count,
   an axis and the whole of one file as ``read_vectors`` stages them,
   through the ragged entry, timed beside their bound;
7. the multi-process path: ``minnow_torch.tools.multiprocess_gather_check``
   with 4 worker processes on the one card (gloo between them) on a
   catalog of 999,888 rows in 11 ragged row-blocks (``int`` IDs from
   2^53 + 1 wider than 32 bits, x periodic at L 250 and 0.001, a log
   mass), dealt 3/3/3/2, once in ``gather`` and once in ``allgather``:
   each rank encodes its row-blocks with ``BlockEncoder``, rank 0 writes
   one minh file that must be byte-identical to a single-process host
   write, and every rank decodes its row-blocks back with
   ``decode_int_blocks`` / ``decode_float_blocks``, bitwise equal to the
   host reader.  Each rank certifies its kernels, sets its launch counts
   to zero, drives the path and reports the counts, its read-back's
   apart: K1 to K4 must be non-zero on every rank.  A worker that exits
   non-zero or outlives its limit ends the script.  Before the workers,
   K1 to K4 are checked and timed as in 4 at the shapes the first and the
   last rank give them: K1 and K3 on a rank's ragged batch, K2 and K4 on
   one block a call.  Then, in this process with the counts at zero:
   ``BlockEncoder([card, card])`` (a stream per share) on the x and id
   columns of phase 5's 512 ragged cells must equal ``BlockEncoder(card)``
   byte for byte and its decode methods the values, and ``text_to_minh
   --device --jobs=2`` on phase 4's and on phase 5's catalog (each under
   two names, so two jobs share one encoder) must write the files those
   phases wrote.  Then the file-level dry runs,
   ``minnow_torch.tools.dryrun.dryrun`` on ``[card]`` and on ``[card,
   card]``: minh, minp and boundary files through the several-share
   encoder, byte-compared with the host writer's, and sharded decodes in
   the three dither modes; K1 to K4 must have been launched.  Before
   their counts are set to zero both dry runs go once through
   ``held_to_plain``, which holds K1 to K4 against their plain versions
   at every batch shape the steps give them;
8. certification: ``validate.validate_backend`` on the card (quantize,
   dequantize, pack, and every kernel at every width against
   ``core.spec``) and ``selfcheck.kernel_ok`` of the three families, both
   printed; ``verify_minnow.verify(deep=True)`` finds no problem in one
   minh, one boundary and one minp file of the earlier phases and finds
   some in a copy cut short;
9. the ``cuda`` tests: ``pytest tests/test_torch_cuda.py --noconftest``
   in a process of its own, with a time limit; its count of passes is
   printed, and a failure, an error or no test run fails the script.

The three self-check families are certified once right after phase 3's
sweeps, outside every timed region and every counted run.  The runs of
phases 4, 5, 6 and 7 and of K5's path in phase 3 each start the launch
counts at zero and read them at their end, as do the wide-column run of
phase 4 and the dry runs of phase 7; in each of those runs, as in each
worker, K3's stats and plan launches must be as many as its packs.  The
last three lines are the nvidia-smi line, a JSON line with each kernel's
numbers (K3's three launches apart; launches: the sum over those runs,
phase 7's summed over its ranks; ``bound_ms``: the least time the card
could take for the flagship call, from its bytes and operations; K3's
stats launch's ``ms`` and ``library_ms`` are the launch and
``torch.aminmax`` alone in a CUDA graph, its ``call_ms`` and
``library_call_ms`` the two as calls), and
``{"ok": true, "device": ...}``.  Without a CUDA device, or outside a
checkout of the repository, it fails before printing any of them.  Files
go to ``build/chip_smoke/`` in the checkout.

The host side of every comparison is the port's own host mode (the same
CLI without ``--device``, the ``formats`` readers on numpy), which the
CPU tests hold byte for byte to ``minnow_tpu``'s.  The script checks at
the end that no module of jax, jaxlib or minnow_tpu was imported, here
or in any worker of phase 7.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from minnow_torch.cli import convert_snapshot, inspect_minh  # noqa: E402
from minnow_torch.cli import minh_to_bnd, text_to_minh  # noqa: E402
from minnow_torch.cli import verify_minnow  # noqa: E402
from minnow_torch.core import spec  # noqa: E402
from minnow_torch.formats import device_common  # noqa: E402
from minnow_torch.formats import minh, minh_device, minp  # noqa: E402
from minnow_torch.formats import minp_device  # noqa: E402
from minnow_torch.ingest import lgadget2, snapshot  # noqa: E402
from minnow_torch.ops import _build, bitpack, codec, decode  # noqa: E402
from minnow_torch.ops import cells, encode, rebin, selfcheck  # noqa: E402
from minnow_torch.ops import validate  # noqa: E402
from minnow_torch.parallel import pipeline  # noqa: E402
from minnow_torch.parallel.pipeline import BlockEncoder  # noqa: E402
from minnow_torch.tools import dryrun  # noqa: E402
from minnow_torch.tools import multiprocess_gather_check  # noqa: E402
from minnow_torch.utils.device import (card_info, cuda_device,  # noqa: E402
                                       graph_ms, time_ms)
from minnow_torch.utils.profiling import StageTimer  # noqa: E402

WORK = os.path.join(ROOT, "build", "chip_smoke")
FLAGSHIP = (4096, 1 << 17)     # blocks x elements: the JAX bench's shape
CHUNK = 256                    # blocks per plain-version chunk
ROWS = 1_000_000               # catalog rows of the main paths
CELLS, BOUNDARY = 8, 5.0       # minh_to_bnd of phase 5: 512 cells at L 250
# K3 counts its packs; its stats and plan launches count apart
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K3 stats", "K3 plan")
# phase 6: an n_side^3-particle snapshot in a box of side L, converted at
# file_cells 2 and sub_cells 8 with position and velocity steps dx, dv
SNAP_SIDE, SNAP_L, SNAP_FILES = 256, 250.0, 8
FILE_CELLS, SUB_CELLS, SNAP_DX, SNAP_DV = 2, 8, 0.001, 1.0
# phase 7: worker processes on the one card, the rows of their catalog (the
# check's 11 ragged row-blocks scaled by 1,776) and each run's time limit
MP_PROCS, MP_ROWS, MP_LIMIT = 4, 999_888, 300
# phase 3: (blocks, elements) of the batches at pixel counts of 2^31 and
# more; phase 4: the rows of the catalog with the 10^10-pixel columns
WIDE_SHAPES = ((12, 200), (64, 1 << 17))
WIDE_ROWS = 200_000
# phase 9: the time limit of the cuda tests' process
TESTS_LIMIT = 420
# launches of one CUDA graph that times a ragged decode, or K3's three
# launches, alone
GRAPH_LAUNCHES = 20


def log(*args):
    print(*args, flush=True)


def int_err(a, b):
    """Largest |a - b| of two integer tensors (0 when bitwise equal)."""
    if a.shape != b.shape:
        raise AssertionError("shapes differ: %s vs %s"
                             % (tuple(a.shape), tuple(b.shape)))
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def float_err(a, b):
    """Largest |a - b| of two float tensors; raises unless bitwise equal."""
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        raise AssertionError("%d elements differ; max |diff| %g"
                             % (bad, float((a - b).abs().max())))
    return float((a - b).abs().max()) if a.numel() else 0.0


# -- phase 3: kernels against their plain versions --------------------------


def k1_batch(rng, k, n):
    """Eight blocks of width about k (1..30): pixels 2^30 with dx = 1, so
    a pixel is its integer value.  Blocks: non-periodic span of exactly k
    bits, periodic cluster, periodic wrap across the edge, periodic full
    range, a NaN, a pixel beyond the range, a short block, an empty one."""
    p = 1 << 30
    q1 = (1 << k) - (1 << max(k - 24, 0))   # largest float32 below 2^k

    def span(lo, hi):
        return np.floor(rng.uniform(lo, hi, n)).astype(np.float32)

    x = np.empty((8, n), np.float32)
    x[0] = span(0, q1)
    x[0, :2] = (0, q1)
    half = min(q1, 1 << 27)
    x[1] = span(1 << 29, (1 << 29) + half)
    h = max(half // 2, 1)
    x[2] = np.where(rng.random(n) < 0.5, span(p - h, p - 1), span(0, h))
    x[3] = span(0, p - 1)
    x[4] = span(0, q1)
    x[4, n // 3] = np.nan
    x[5] = span(0, q1)
    x[5, 7] = np.float32(p + 4096)
    x[6] = span(0, q1)
    x[7] = span(0, q1)
    periodic = np.array([0, 1, 1, 1, 1, 1, 0, 1], bool)
    lens = np.array([n] * 6 + [n // 3, 0], np.int64)
    return x, np.zeros(8), np.full(8, float(p)), np.full(8, p), periodic, \
        lens


def k1_position_batch(rng, n):
    """The catalog's position config (L 250, epsilon 0.001): uniform,
    clustered and edge-wrapping blocks."""
    x = rng.uniform(0, 249.9, (4, n)).astype(np.float32)
    x[1] = rng.uniform(100, 100.4, n)
    x[2] = np.where(rng.random(n) < 0.5, rng.uniform(249.6, 249.99, n),
                    rng.uniform(0, 0.3, n))
    x[3] = rng.uniform(3.0, 3.001, n)
    return x, np.zeros(4), np.full(4, 250.0), np.full(4, 250000), \
        np.ones(4, bool), np.full(4, n, np.int64)


def edge_batches(rng):
    """Blocks of 2^17 - 1 elements at widths about 1, 7, 18 and 30 with
    ragged lengths around the pack's word and tile edges: 1, 31, 32, 33,
    2049, the whole row and none; block 4 holds a NaN beside valid
    blocks, block 5 a pixel beyond the range."""
    n = (1 << 17) - 1
    lens = np.array([n, 1, 31, 32, n, 33, 2049, 0], np.int64)
    return [k1_batch(rng, k, n)[:5] + (lens,) for k in (1, 7, 18, 30)]


def check_float_encode(dev, rng):
    """K1's three launches and K5 against their plain versions, bitwise,
    on the same batches: the stats rows with and without stored pixels,
    the plan kernel against the host's ``plan_float`` and its plain
    version, K1's pack and K5 against the plain pack and each other, and
    the whole call, ``encode_float_group`` with and without ``reuse_q``,
    at the exact capacity.  Returns the largest error of K1 and of K5."""
    widths, err1, err5 = set(), 0, 0
    n = 3001
    batches = [k1_batch(rng, k, n) for k in range(1, 32)]
    batches += [k1_position_batch(rng, n), wide_batch(rng, n)]
    batches += edge_batches(rng)
    for x, low, high, pixels, periodic, lens in batches:
        params = codec.block_params(low, high, pixels, periodic, dev)
        xt = torch.from_numpy(x).to(dev)
        lt = torch.from_numpy(lens).to(dev)
        q = torch.zeros(x.shape, dtype=torch.int32, device=dev)
        q_plain = q.clone()
        stats = encode.float_stats(xt, params, lt)
        err1 = max(err1, int_err(stats, encode.float_stats_plain(
            xt, params, lt, q_out=q_plain)))
        err5 = max(err5, int_err(stats, encode.float_stats(
            xt, params, lt, q_out=q)), int_err(q, q_plain))
        plan = encode.plan_float(stats, params, lt)
        dplan = encode.float_plan(stats, params, lt)
        if not (plan_eq(encode.read_plan(dplan), plan)
                and torch.equal(dplan, encode.float_plan_plain(stats, params,
                                                               lt))):
            raise AssertionError("K1 plan launch differs from plan_float")
        words = encode.pack_float(xt, params, lt, plan)
        ref_words = encode.pack_float_plain(xt, params, lt, plan)
        err1 = max(err1, int_err(words, ref_words))
        err5 = max(err5, int_err(encode.pack_float_q(q, params, lt, plan),
                                 words),
                   int_err(encode.pack_float_q_plain(q, params, lt, plan),
                           words))
        for reuse_q in (False, True):
            w, p = encode.encode_float_group(xt, params, lt, reuse_q=reuse_q,
                                             capacity=plan.total)
            if not plan_eq(p, plan):
                raise AssertionError("encode_float_group(reuse_q=%s): plan "
                                     "differs" % reuse_q)
            e = int_err(w, words)
            err1, err5 = (err1, max(err5, e)) if reuse_q \
                else (max(err1, e), err5)
        widths.update(int(b) for b in plan.bits[plan.valid])
    missing = set(range(1, 33)) - widths
    if err1 or err5 or missing:
        raise AssertionError("K1/K5 sweep: max err %d, %d, widths not seen "
                             "%s" % (err1, err5, sorted(missing)))
    log("K1 and K5 sweep: widths 1..32 at n=%d and ragged lengths 1, 31, "
        "32, 33, 2049 and 2^17 - 1: stats, stored pixels, the plan launch "
        "(against plan_float), K1's and K5's words and both whole calls "
        "bitwise equal to the plain versions, K5's words to K1's" % n)
    return err1, err5


def plan_eq(a, b):
    """True when two plans hold the same values."""
    return all(np.array_equal(u, v) for u, v in zip(a, b))


def ragged_sweep(rng, long=(1 << 17) - 1):
    """One ragged column of each kind for K2 and K4, over random bytes:
    widths 0..64 in a shuffled order, blocks back to back after gaps of 0
    to 3 bytes so that their start bytes run through 0, 1, 2, 3 (mod 4),
    lengths 1, 31, 33, 4,099 and ``long`` in turn (so a block of length 1
    follows each one of ``long``), minimums -2^63 and 2^63 - 1 among
    random ones.  The float column holds the same blocks at pixel counts
    2^31 + 5 and 10^10 (periodic), 250,000 (periodic) and 200,000 (not)
    in turn.  Returns ``(span, [int Blocks, float Blocks])``."""
    widths = rng.permutation(65)
    b = len(widths)
    lens = np.array([(1, 31, 33, 4099, long)[k % 5] for k in range(b)],
                    np.int64)
    nbytes = (widths * lens + 7) // 8
    start, pos = np.empty(b, np.int64), 0
    for k in range(b):
        start[k] = pos + (k - pos) % 4
        pos = int(start[k] + nbytes[k])
    span = rng.integers(0, 256, pos + 5, dtype=np.uint8)
    mins = rng.integers(-(1 << 62), 1 << 62, b)
    mins[:2] = (-(1 << 63), (1 << 63) - 1)
    ids = np.arange(b, dtype=np.int64) * 7919 + (1 << 33)
    kinds = (((1 << 31) + 5, True), (10 ** 10, True), (250000, True),
             (200000, False))
    low = rng.uniform(-10, 0, b).astype(np.float32)
    config = (low, (low + rng.uniform(100, 300, b)).astype(np.float32),
              np.array([kinds[k % 4][0] for k in range(b)], np.int64),
              np.array([kinds[k % 4][1] for k in range(b)], bool))
    cols = [device_common.Blocks(start, widths.astype(np.int64), lens, mins,
                                 c, ids) for c in (None, config)]
    return span, cols


def check_ragged(dev, rng, kind):
    """K2 (``kind`` "K2", in the three modes) or K4 ("K4") through the
    ragged entry on :func:`ragged_sweep`'s column, staged as a read stages
    a file, against its plain version on the same tensors, bitwise.
    Returns the largest error."""
    span, cols = ragged_sweep(rng)
    err = 0.0
    for mode in codec.DITHER_MODES if kind == "K2" else ("none",):
        src, staged = device_common.stage_columns(span, cols, dev, mode,
                                                  seed=3)
        if kind == "K4":
            t = staged[0].table
            same_ints(decode.decode_int_ragged(src, t),
                      decode.decode_int_ragged_plain(src, t),
                      "K4 ragged sweep")
            continue
        args = (src, *staged[1])
        err = max(err, float_err(decode.decode_float_ragged(
            args[0], args[1], args[2], mode, *args[3:]),
            decode.decode_float_ragged_plain(args[0], args[1], args[2], mode,
                                             *args[3:])))
    return err


def check_k2(dev, rng):
    err = 0.0
    b, n = 3, 1001
    for bits in range(65):
        words = rng.integers(0, 1 << 32, (b, max((bits * n + 31) // 32, 1)),
                             dtype=np.uint64).astype(np.uint32)
        mins = rng.integers(-(1 << 40), 1 << 40, b)
        mins[0] = 0
        pixels = rng.integers(1, 1 << 34, b)
        params = codec.block_params(rng.uniform(-10, 0, b),
                                    rng.uniform(100, 300, b), pixels,
                                    np.array([1, 1, 0], bool), dev)
        wt = torch.from_numpy(words.view(np.int32)).to(dev)
        mt = torch.from_numpy(mins).to(dev)
        k1, k2 = codec.dither_keys(np.array([0, 5, 1 << 33]), 3, dev)
        for mode in codec.DITHER_MODES:
            got = decode.decode_float_group(wt, mt, params, bits, n, mode,
                                            k1, k2)
            ref = decode.decode_float_plain(wt, mt, params, bits, n, mode,
                                            k1, k2)
            err = max(err, float_err(got, ref))
    err = max(err, check_ragged(dev, rng, "K2"))
    log("K2 sweep: widths 0..64 x none/midpoint/uniform at n=%d, and "
        "through the ragged entry one column of widths 0..64 at start bytes "
        "0..3 (mod 4), lengths 1, 31, 33, 4099 and 2^17 - 1, pixel counts "
        "2^31 + 5 and 10^10 among them: bitwise equal to the plain version"
        % n)
    return err


def _k3_ragged(rng, bits, n, lens):
    """Blocks of ``lens`` at n whose live elements span exactly ``bits``
    bits (from 2^53 + 7, or -2^63 at 63 and 64 bits), random words past
    each length."""
    x = rng.integers(-(1 << 63), (1 << 63) - 1, (len(lens), n),
                     dtype=np.int64, endpoint=True)
    lo = -(1 << 63) if bits >= 63 else (1 << 53) + 7
    for i, m in enumerate(lens):
        d = rng.integers(0, (1 << 64) - 1 if bits == 64 else 1 << bits, m,
                         dtype=np.uint64)
        d[:2] = (0, (1 << bits) - 1)[:m]
        x[i, :m] = d.view(np.int64) + np.int64(lo)
    return x, lens


# lengths and widths of the tile cases: whole, ragged and next-to-whole
# tiles of K3's pack (4,096 elements), and the widths on either side of
# the point where a delta needs its high half, and the widest
TILE_LENS = (1, 31, 32, 33, 4095, 4096, 4097, 8191, 8193, 0)
TILE_WIDTHS = (1, 31, 32, 33, 54, 63, 64)


def k3_tile_batches(rng):
    """K3's tile cases as numpy ``(x, lens)``: at each of ``TILE_WIDTHS``
    blocks of ``TILE_LENS``, at n = 8,194 for the odd widths (every row on
    a 16-byte boundary) and 8,193 for the even ones (every other row 8
    bytes off one)."""
    lens = np.array(TILE_LENS, np.int64)
    return [_k3_ragged(rng, bits, 8193 + (bits & 1), lens)
            for bits in TILE_WIDTHS]


def k3_batches(rng):
    """K3's cases as numpy ``(x, lens)``: widths 1..64 at n = 3,001 (IDs
    above 2^53, minimums down to -2^63, every seventh block 11 shorter);
    at 1, 18, 37, 54 and 64 bits, blocks of lengths 0, 1, 31, 32, 33,
    2,049 and 4,097 at n = 4,097; :func:`k3_tile_batches`; the padding of
    every block holds random words, the empty ones' too; and, last, one
    block holding -2^63 and 2^63 - 1 (width 64) beside a constant one
    (width 0)."""
    n = 3001
    rows = []
    for bits in range(1, 65):
        lo = (1 << 53) + 12345 if bits < 62 else -(1 << (bits - 1))
        d = rng.integers(0, (1 << 64) - 1 if bits == 64 else 1 << bits, n,
                         dtype=np.uint64)
        d[0], d[1] = 0, (1 << bits) - 1
        rows.append(d.view(np.int64) + np.int64(lo))
    lens = np.full(64, n, np.int64)
    lens[::7] = n - 11
    out = [(np.stack(rows), lens)]
    lens = np.array([0, 1, 31, 32, 33, 2049, 4097, 0], np.int64)
    out += [_k3_ragged(rng, bits, 4097, lens) for bits in (1, 18, 37, 54, 64)]
    out += k3_tile_batches(rng)
    x = np.full((2, 5), 42, np.int64)
    x[0, 1], x[0, 3] = -(1 << 63), (1 << 63) - 1
    out.append((x, np.array([5, 5], np.int64)))
    return out


def hold_k3(x, lens, what, capacity=None):
    """K3 on ``x`` and ``lens`` (on the card) against its plain versions
    on the same tensors, bitwise: the stats launch's rows, the plan
    launch's device plan (also read back against the call's plan) and the
    whole call's words.  Returns the call's ``(words, plan)``."""
    stats = encode.int_stats(x, lens)
    dplan = encode.int_plan(stats, lens)
    want = encode.int_plan_plain(stats, lens)
    words, plan = encode.encode_int_group(x, lens, capacity)
    err = max(int_err(stats, encode.int_stats_plain(x, lens)),
              int_err(dplan, want),
              int_err(words, encode.delta_pack_int_plain(x, lens, plan)))
    if err or not plan_eq(plan, encode.read_plan(want)):
        raise AssertionError("K3 %s at %s: stats, plan or words differ from "
                             "the plain versions (max err %d)"
                             % (what, tuple(x.shape), err))
    return words, plan


def k3_timed(x, lens, plan):
    """K3 at a path's shape: the call (CUDA events, median of 7), its
    three launches alone (``GRAPH_LAUNCHES`` encodes captured in one CUDA
    graph, a replay over their number), the plain versions' route (median
    of 3) and the bound by the bytes the call must move (x's live elements
    read once, the words written once), in ms."""
    def plain():
        p = encode.read_plan(encode.int_plan_plain(
            encode.int_stats_plain(x, lens), lens))
        return encode.delta_pack_int_plain(x, lens, p)

    live, total = int(lens.sum()), plan.total
    return {"call": time_ms(lambda: encode.encode_int_group(x, lens)),
            "kernels": graph_ms(lambda: encode._launch_int_encode(
                x, lens, total), GRAPH_LAUNCHES),
            "plain": time_ms(plain, reps=3, warmup=1),
            "bound": bound(live * 8 + total * 4, 6 * live)["bound_ms"]}


def float_timed(x, params, lens, plan):
    """K1 and K5 at a path's shape, alone: K1's three launches, and K5's
    pack from the pixels a stats launch stored, each ``GRAPH_LAUNCHES``
    times over in one CUDA graph, a replay over their number; beside the
    bound by the bytes of x's live elements and of the words (ms)."""
    total = plan.total
    q = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    dplan = encode._launch_plan(
        encode._launch_stats(x, params, lens, q), params, lens)

    def k1():
        stats = encode._launch_stats(x, params, lens, None)
        return encode._launch_pack(
            x, params, lens, encode._launch_plan(stats, params, lens), total)

    live = int(lens.sum())
    return {"K1": graph_ms(k1, GRAPH_LAUNCHES),
            "K5": graph_ms(lambda: encode._launch_pack(
                q, params, lens, dplan, total), GRAPH_LAUNCHES),
            "bound": bound(live * 4 + total * 4, 16 * live)["bound_ms"]}


def log_float(what, rows):
    log("K1 and K5 at %s, alone, ms (K1's three launches and K5's pack, "
        "each in a graph of %d; bound by bytes at 3.35 TB/s): %s"
        % (what, GRAPH_LAUNCHES, "; ".join(
            "%s: K1 %.4f, K5 %.4f, bound %.5f"
            % (label, t["K1"], t["K5"], t["bound"]) for label, t in rows)))


def log_k3(what, rows):
    log("K3 at %s, ms (the call: CUDA events, median of 7; its three "
        "launches alone in a graph of %d encodes; the plain versions' route "
        "median of 3; bound by bytes at 3.35 TB/s): %s"
        % (what, GRAPH_LAUNCHES, "; ".join(
            "%s: call %.4f, kernels %.4f, plain %.4f, bound %.5f"
            % (label, t["call"], t["kernels"], t["plain"], t["bound"])
            for label, t in rows)))


def check_k3(dev, rng):
    """K3's three launches and the whole call on :func:`k3_batches`,
    against the plain versions; every width 0..64 must come up."""
    widths = set()
    for x, lens in k3_batches(rng):
        _, plan = hold_k3(torch.from_numpy(x).to(dev),
                          torch.from_numpy(lens).to(dev), "sweep")
        widths.update(int(b) for b in plan.bits)
    if widths != set(range(65)):
        raise AssertionError("K3 sweep: widths not seen %s"
                             % sorted(set(range(65)) - widths))
    log("K3 sweep: widths 0..64 at n=3001 (IDs above 2^53); 1, 18, 37, 54 "
        "and 64 bits on lengths 0, 1, 31, 32, 33, 2049 and 4097; 1, 31, 32, "
        "33, 54, 63 and 64 bits on lengths 1, 31, 32, 33, 4095, 4096, 4097, "
        "8191, 8193 and 0 at n=8193 and 8194; garbage past each length; "
        "-2^63 beside 2^63 - 1: the stats rows, the device plan and the "
        "words bitwise equal to the plain versions")
    return 0


def same_ints(got, want, what):
    """0 when the int64 tensors are bitwise equal; raises otherwise."""
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError("%s: %d elements differ" % (what, bad))
    return 0


def check_k4(dev, rng):
    """Rows exactly ``words_per_block`` long (no padding), so the last
    element of each row ends in its last word.  Row 0 starts with the
    widest delta, 2^bits - 1, on the minimum -2^63; row 1 has the minimum
    2^63 - 1, so the add wraps both ways."""
    b, n = 4, 1001
    for bits in range(65):
        w = max(bitpack.words_per_block(bits, n), 1)
        words = rng.integers(0, 1 << 32, (b, w), dtype=np.uint64) \
            .astype(np.uint32)
        words[0, :-(-bits // 32)] = 0xFFFFFFFF
        mins = np.array([-(1 << 63), (1 << 63) - 1,
                         rng.integers(-(1 << 62), 1 << 62), 0], np.int64)
        wt = torch.from_numpy(words.view(np.int32)).to(dev)
        mt = torch.from_numpy(mins).to(dev)
        got = decode.decode_int_group(wt, mt, bits, n)
        same_ints(got, decode.decode_int_plain(wt, mt, bits, n),
                  "K4 sweep at %d bits" % bits)
        if bits == 64 and int(got[0, 0]) != (1 << 63) - 1:
            raise AssertionError("K4: -2^63 + (2^64 - 1) gave %d"
                                 % int(got[0, 0]))
    check_ragged(dev, rng, "K4")
    log("K4 sweep: widths 0..64 at n=%d, minimums -2^63 and 2^63 - 1, and "
        "through the ragged entry one column of widths 0..64 at start bytes "
        "0..3 (mod 4), lengths 1, 31, 33, 4099 and 2^17 - 1: bitwise equal "
        "to the plain version" % n)
    return 0


def wide_batch(rng, n):
    """Two non-periodic blocks of width 32 (pixels from -2^31 + 128 to
    2^31 - 128 at dx = 1), the second ragged."""
    lo, hi = -(1 << 31) + 128, (1 << 31) - 128
    x = np.floor(rng.uniform(lo, hi, (2, n))).astype(np.float32)
    x[:, :2] = (lo, hi)
    return x, np.zeros(2), np.full(2, float(1 << 30)), np.full(2, 1 << 30), \
        np.zeros(2, bool), np.array([n, n - 7], np.int64)


def top_of_range_blocks(rng, b, n):
    """``b`` float blocks of ``n`` elements at the widest pixel counts,
    2^62 + 3 and 2^63 - 1 periodic and 2^63 - 1 non-periodic in turn,
    their pixels inside [0, 2^31): K1 must certify every one.  Returns
    what ``selfcheck.wide_float_blocks`` returns."""
    kinds = (((1 << 62) + 3, True), ((1 << 63) - 1, True),
             ((1 << 63) - 1, False))
    pixels = np.array([kinds[i % 3][0] for i in range(b)], np.int64)
    periodic = np.array([kinds[i % 3][1] for i in range(b)], bool)
    low, high = np.zeros(b, np.float32), np.full(b, 1.0e6, np.float32)
    dx = np.array([spec.quantize_dx(0.0, 1.0e6, int(p)) for p in pixels],
                  np.float32)
    top = (np.float32((1 << 31) - 1024) * dx).astype(np.float64)
    x = rng.uniform(0.0, 1.0, (b, n)) * top[:, None]
    x[::4] = 0.5 * top[::4, None] + 0.001 * x[::4]  # clusters: few bits
    return x.astype(np.float32), low, high, pixels, periodic, np.ones(b, bool)


def check_wide_batch(dev, rng, b, n, blocks=None):
    """K1, K5 and K2 on ``b`` blocks of ``n`` elements at pixel counts of
    2^31 and more (``blocks``, by default ``selfcheck.wide_float_blocks``'s;
    every fourth block ragged): K1's stats, plan and pack launches, K5 and both whole calls
    against their plain versions and against ``spec``'s bytes, minimums
    and widths on every block that must be certified; ``BlockEncoder`` on
    the batch against ``spec`` on every block, with the blocks it sent to
    the host encoder; K2 through ``decode_float_blocks`` on ``spec``'s
    payloads (the 34-bit ones among them) against the host reader in the
    three modes, and on one width bucket against its plain version.
    Returns the number of blocks sent to the host."""
    x, low, high, pixels, periodic, certified = (
        blocks or selfcheck.wide_float_blocks(rng, b, n))
    lens = np.full(b, n, np.int64)
    lens[3::4] = n - 5
    params = codec.block_params(low, high, pixels, periodic, dev)
    xt, lt = torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)
    q = torch.zeros(x.shape, dtype=torch.int32, device=dev)
    q_plain = q.clone()
    stats = encode.float_stats(xt, params, lt, q_out=q)
    err = max(int_err(stats, encode.float_stats_plain(xt, params, lt,
                                                      q_out=q_plain)),
              int_err(stats, encode.float_stats(xt, params, lt)),
              int_err(q, q_plain))
    plan = encode.plan_float(stats, params, lt)
    dplan = encode.float_plan(stats, params, lt)
    if not (plan_eq(encode.read_plan(dplan), plan) and torch.equal(
            dplan, encode.float_plan_plain(stats, params, lt))):
        raise AssertionError("wide pixel counts: the plan launch differs "
                             "from plan_float")
    if not np.array_equal(plan.valid, certified):
        raise AssertionError("wide pixel counts: K1 certified %s, want %s"
                             % (plan.valid, certified))
    words = encode.pack_float(xt, params, lt, plan)
    err = max(err, int_err(words, encode.pack_float_plain(xt, params, lt,
                                                          plan)),
              int_err(encode.pack_float_q(q, params, lt, plan), words))
    for reuse_q in (False, True):
        w, p = encode.encode_float_group(xt, params, lt, reuse_q=reuse_q)
        if not plan_eq(p, plan):
            raise AssertionError("wide pixel counts: encode_float_group("
                                 "reuse_q=%s): plan differs" % reuse_q)
        err = max(err, int_err(w, words))
    if err:
        raise AssertionError("wide pixel counts at (%d, %d): max err %d "
                             "against the plain versions" % (b, n, err))

    want = [spec.encode_float_block(x[i, :lens[i]], low[i], high[i],
                                    int(pixels[i]), bool(periodic[i]))
            for i in range(b)]
    words_h = words.cpu().numpy()
    for i in np.nonzero(certified)[0]:
        payload, mn, bits, _ = want[i]
        if (selfcheck.payload_of(words_h, plan, i, int(lens[i])),
                int(plan.mins[i]), int(plan.bits[i])) != (payload, mn, bits):
            raise AssertionError("wide pixel counts: K1 differs from spec "
                                 "at %d pixels, block %d" % (pixels[i], i))
    before = pipeline.HOST_BLOCKS
    enc = BlockEncoder(dev).encode_float_blocks(x, low, high, pixels,
                                                lens=lens, periodic=periodic)
    sent = pipeline.HOST_BLOCKS - before
    if sent != int((~certified).sum()):
        raise AssertionError("wide pixel counts: %d blocks went to the host "
                             "encoder, want %d" % (sent, (~certified).sum()))
    for i, (payload, mn, bits, _) in enumerate(want):
        if (enc.payloads[i], int(enc.mins[i]), int(enc.bits[i])) != (
                payload, mn, bits):
            raise AssertionError("wide pixel counts: BlockEncoder differs "
                                 "from spec at block %d" % i)

    # K2 on the full-length blocks (decode_float_blocks takes one length)
    full = np.nonzero(lens == n)[0]
    ids = full + (1 << 33)
    for mode in codec.DITHER_MODES:
        got = BlockEncoder(dev).decode_float_blocks(
            [want[i][0] for i in full], [want[i][1] for i in full],
            [want[i][2] for i in full], low[full], high[full], pixels[full],
            n, periodic=periodic[full], dither=mode, seed=9, block_ids=ids)
        for row, i in enumerate(full):
            payload, mn, bits, _ = want[i]
            ref = selfcheck.spec_decode_float(
                bitpack.bytes_to_words(payload, bits, n), mn, bits, n, low[i],
                high[i], int(pixels[i]), bool(periodic[i]), mode, 9,
                int(ids[row]))
            if not np.array_equal(got[row].view(np.int32),
                                  ref.view(np.int32)):
                raise AssertionError(
                    "wide pixel counts: K2 %s differs from the host reader "
                    "at %d pixels, block %d" % (mode, pixels[i], i))
    # and against its plain version: the widest bucket and the 34-bit one
    widths = np.array([want[i][2] for i in full])
    for width in {int(np.bincount(widths).argmax()), int(widths.max())}:
        idx = full[widths == width]
        col = (torch.from_numpy(np.stack([bitpack.bytes_to_words(
            want[i][0], width, n) for i in idx]).view(np.int32)).to(dev),
            torch.tensor([want[i][1] for i in idx], device=dev),
            codec.block_params(low[idx], high[idx], pixels[idx],
                               periodic[idx], dev), width, n)
        keys = codec.dither_keys(idx, 9, dev)
        for mode in codec.DITHER_MODES:
            float_err(decode.decode_float_group(*col, mode, *keys),
                      decode.decode_float_plain(*col, mode, *keys))
    log("wide pixel counts %s, (%d, %d): K1's launches, K5 and both calls "
        "bitwise equal to the plain versions and to spec (certified %d of "
        "%d, widths %s); BlockEncoder equal to spec on all, %d blocks sent "
        "to the host encoder; K2 in three modes equal to the host reader "
        "and to its plain version (widths %s)"
        % (sorted({int(c) for c in pixels}), b, n, certified.sum(), b,
           sorted({int(w) for w in plan.bits[plan.valid]}), sent,
           sorted({int(w) for w in widths})))
    return sent


def check_wide_pixels(dev, rng):
    """:func:`check_wide_batch` at every shape of ``WIDE_SHAPES``, and at
    the first of them on :func:`top_of_range_blocks`."""
    t0 = time.perf_counter()
    sent = sum(check_wide_batch(dev, rng, b, n) for b, n in WIDE_SHAPES)
    b, n = WIDE_SHAPES[0]
    sent += check_wide_batch(dev, rng, b, n, top_of_range_blocks(rng, b, n))
    log("wide pixel counts: %d blocks sent to the host encoder in all, "
        "%.1f s" % (sent, time.perf_counter() - t0))


def check_tile_entries(dev, rng):
    """The TPU's per-tile kernels on their counterparts, at the JAX
    package's test shapes: B9 on K2 (5 x 4,096, 18 bits, none and
    midpoint), B11 on K3 (``pack_batch``, 8 x 2,048, widths 1..32, values
    beyond each width) against its plain version and ``spec.pack_bits``,
    and B10 on K4 (zero minimums) reading B11's words back.  Each entry
    is timed at 18 bits beside its plain version."""
    t = []
    b, n, bits = 5, 4096, 18
    vals = rng.integers(0, 250000, (b, n), dtype=np.uint64)
    words = np.stack([bitpack.bytes_to_words(spec.pack_bits(v, bits), bits,
                                             n) for v in vals])
    low = rng.uniform(-10, 0, b)
    params = codec.block_params(low, low + rng.uniform(100, 300, b),
                                np.full(b, 250000), np.array([1, 1, 0, 1, 0],
                                                             bool), dev)
    col = (torch.from_numpy(words.view(np.int32)).to(dev),
           torch.from_numpy(rng.integers(-3, 3, b)).to(dev), params, bits, n)
    err = 0.0
    for mode in ("none", "midpoint"):
        err = max(err, float_err(decode.decode_float_group(*col, mode),
                                 decode.decode_float_plain(*col, mode)))
        t += [("B9 %s" % mode,
               time_ms(lambda: decode.decode_float_group(*col, mode))),
              ("plain", time_ms(lambda: decode.decode_float_plain(*col,
                                                                    mode)))]

    b, n = 8, 2048
    x = torch.from_numpy(rng.integers(0, 1 << 32, (b, n))).to(dev)
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    for width in range(1, 33):
        got = encode.pack_batch(x, width)
        host = x.cpu().numpy().astype(np.uint64) & np.uint64(
            (1 << width) - 1)
        if int_err(got, encode.pack_batch_plain(x, width)) or any(
                bitpack.words_to_bytes(got[i].cpu().numpy(), width, n)
                != spec.pack_bits(host[i], width) for i in range(b)):
            raise AssertionError("B11 pack_batch at %d bits differs from "
                                 "its plain version or spec" % width)
        back = decode.decode_int_group(got, zeros, width, n)
        same_ints(back, decode.decode_int_plain(got, zeros, width, n),
                  "B10 at %d bits" % width)
        same_ints(back, torch.from_numpy(host.view(np.int64)).to(dev),
                  "B10 round trip at %d bits" % width)
    words = encode.pack_batch(x, bits)
    t += [("B11 pack_batch", time_ms(lambda: encode.pack_batch(x, bits))),
          ("plain", time_ms(lambda: encode.pack_batch_plain(x, bits))),
          ("B10 decode_int_group",
           time_ms(lambda: decode.decode_int_group(words, zeros, bits, n))),
          ("plain",
           time_ms(lambda: decode.decode_int_plain(words, zeros, bits, n)))]
    log("B9 on K2: decode_float_group (5, 4096) at 18 bits, none and "
        "midpoint, bitwise equal to the plain version (|err| %g); B11 on "
        "K3: pack_batch (8, 2048) at widths 1..32 bitwise equal to its "
        "plain version and to spec.pack_bits; B10 on K4: decode_int_group "
        "with zero minimums gives B11's masked input back at every width"
        % err)
    log("B9/B10/B11 entries at 18 bits, ms (CUDA events, median of 7; each "
        "'plain' is the plain version of the entry before it): %s"
        % ", ".join("%s %.4f" % kv for kv in t))


# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# and float32 outside the tensor cores; integer operations are counted at
# the same rate
PEAK_BYTES, PEAK_OPS = 3.35e12, 67e12


def log_ptxas(build_log):
    """Each kernel's registers and spills as ``ptxas -v`` gave them,
    under the kernel's name (a template kernel's name with its argument's
    mangled code: ``pack_tiles_kernel<i>`` is the int instance)."""
    kernel, spills = "?", ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?_cu_[0-9a-f]{8}(\d+)",
                      line)
        if m:
            kernel = line[m.end():m.end() + int(m.group(1))]
            arg = re.match(r"I(\w)E", line[m.end() + int(m.group(1)):])
            if arg:
                kernel += "<%s>" % arg.group(1)
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            log("  %s: %s; %s" % (kernel, line.split(":", 1)[1].strip(),
                                  spills))


def bound(nbytes, ops, library_ms=None):
    """The least time the card could take for a kernel's work: the bytes
    it must move (each input read once, each output written once) over
    the memory rate, or its arithmetic operations on these inputs over
    the float32 rate, whichever is larger; and ``library_ms``, the time of
    the one PyTorch call that computes the same function, where there is
    one (none quantizes, recentres, min-subtracts and bit-packs at a
    per-block width, or does the inverse)."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms}


def reset_counts():
    encode.K1_LAUNCHES = encode.K3_LAUNCHES = encode.K5_LAUNCHES = 0
    encode.K3_STATS_LAUNCHES = encode.K3_PLAN_LAUNCHES = 0
    decode.K2_LAUNCHES = decode.K4_LAUNCHES = 0


def counts():
    return {"K1": encode.K1_LAUNCHES, "K2": decode.K2_LAUNCHES,
            "K3": encode.K3_LAUNCHES, "K4": decode.K4_LAUNCHES,
            "K5": encode.K5_LAUNCHES, "K3 stats": encode.K3_STATS_LAUNCHES,
            "K3 plan": encode.K3_PLAN_LAUNCHES}


def chunks(b):
    return [slice(i, min(i + CHUNK, b)) for i in range(0, b, CHUNK)]


def chunk_plan(plan, s, row):
    """The plan of blocks ``s`` of a batch whose streams are all ``row``
    words long, as a batch of its own."""
    return plan._replace(mins=plan.mins[s], maxd=plan.maxd[s],
                         bits=plan.bits[s], valid=plan.valid[s], m=plan.m[s],
                         offsets=plan.offsets[s] - plan.offsets[s.start],
                         total=int(row * (s.stop - s.start)))


def k5_flagship(x, params, lens, words, plan, results):
    """At 4096 x 2^17, 18 bits, K1's ``words`` and ``plan`` given: K1's
    stats, plan and pack launches, the stats launch storing pixels, and
    K5, each timed alone (the pack launches with the upload of the host
    plan they are given); then K5's path, ``encode_float_group(reuse_q=True)``,
    once with the launch counts at zero around it (its words must be
    K1's), timed, and beside it the plain versions of K5 and of the whole
    path, which must give K1's words too.  Returns that run's counts."""
    b, n = x.shape
    row = int(plan.offsets[1])
    gb = b * n * 4 / 1e9
    q = torch.empty((b, n), dtype=torch.int32, device=x.device)
    stats = encode.float_stats(x, params, lens)
    if not plan_eq(encode.read_plan(encode.float_plan(stats, params, lens)),
                   encode.plan_float(stats, params, lens)):
        raise AssertionError("K1 flagship: the plan launch differs from "
                             "plan_float")
    t = {"K1 stats": time_ms(lambda: encode.float_stats(x, params, lens)),
         "K1 plan": time_ms(lambda: encode.float_plan(stats, params, lens)),
         "K1 pack": time_ms(lambda: encode.pack_float(x, params, lens,
                                                      plan)),
         "stats storing pixels": time_ms(
             lambda: encode.float_stats(x, params, lens, q_out=q)),
         "K5": time_ms(lambda: encode.pack_float_q(q, params, lens, plan))}
    err = int_err(encode.pack_float_q(q, params, lens, plan), words)

    reset_counts()
    words_q, plan_q = encode.encode_float_group(x, params, lens,
                                                reuse_q=True,
                                                capacity=words.numel())
    path = counts()
    err = max(err, int_err(words_q, words))
    if err or not (np.array_equal(plan_q.bits, plan.bits)
                   and np.array_equal(plan_q.mins, plan.mins)):
        raise AssertionError("K5 flagship: words or plan differ from K1's")
    del words_q
    t["reuse_q call"] = time_ms(
        lambda: encode.encode_float_group(x, params, lens, reuse_q=True,
                                          capacity=words.numel()))
    t["K1 call"] = results["K1"]["ms"]
    t["K1 launches"] = t["K1 stats"] + t["K1 plan"] + t["K1 pack"]

    def plain_k5(check):
        e = 0
        for s in chunks(b):
            p = codec.BlockParams(*(v[s] for v in params))
            w = encode.pack_float_q_plain(q[s], p, lens[s],
                                          chunk_plan(plan, s, row))
            if check:
                e = max(e, int_err(w, words[s.start * row:s.stop * row]))
        return e

    def plain_path(check):
        e = 0
        for s in chunks(b):
            p = codec.BlockParams(*(v[s] for v in params))
            qs = torch.empty((s.stop - s.start, n), dtype=torch.int32,
                             device=x.device)
            st = encode.float_stats_plain(x[s], p, lens[s], q_out=qs)
            w = encode.pack_float_q_plain(qs, p, lens[s],
                                          encode.plan_float(st, p, lens[s]))
            if check:
                e = max(e, int_err(w, words[s.start * row:s.stop * row]))
        return e

    err = max(err, plain_k5(True), plain_path(True))
    if err:
        raise AssertionError("K5 flagship: plain versions differ (%d)" % err)
    t["K5 plain"] = time_ms(lambda: plain_k5(False), reps=3, warmup=1)
    t["reuse_q call plain"] = time_ms(lambda: plain_path(False), reps=3,
                                      warmup=1)
    del q
    torch.cuda.empty_cache()
    results["K5"].update(ms=t["K5"], plain_ms=t["K5 plain"],
                         max_abs_err=max(results["K5"]["max_abs_err"], err),
                         **bound(b * n * 4 + words.numel() * 4, 4 * b * n))
    log("K5 flagship %dx%d 18 bits, ms (CUDA events, median of 7; plain "
        "median of 3): %s; GB/s of f32: K1 call %.1f, reuse_q call %.1f; "
        "K5's words, the reuse_q path's and both plain versions' bitwise "
        "equal to K1's; the reuse_q run launched %s"
        % (b, n, ", ".join("%s %.3f" % kv for kv in t.items()),
           gb / t["K1 call"] * 1e3, gb / t["reuse_q call"] * 1e3, path))
    return path


def flagship(dev, results):
    """Each kernel at 4096 x 2^17, 18 bits: kernel vs plain, bitwise, and
    their times.  The plain versions run in chunks of blocks (their int64
    temporaries would not fit at once).  Returns the launch counts of the
    run of K5's path."""
    b, n = FLAGSHIP
    gb = b * n * 4 / 1e9
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.rand((b, n), generator=gen, device=dev) * 249.9
    params = codec.block_params(np.zeros(b), np.full(b, 250.0),
                                np.full(b, 250000), np.ones(b, bool), dev)
    lens = torch.full((b,), n, dtype=torch.int64, device=dev)

    # the capacity a BlockEncoder has for this batch: 250,000 periodic
    # pixels are at most 18 bits
    capacity = b * bitpack.words_per_block(18, n)

    def enc():
        return encode.encode_float_group(x, params, lens, capacity=capacity)

    words, plan = enc()
    if not (plan.valid.all() and (plan.bits == 18).all()):
        raise AssertionError("K1 flagship: not all blocks valid at 18 bits")
    row = plan.offsets[1]

    def plain_enc(check):
        err = 0
        for s in chunks(b):
            p = codec.BlockParams(*(t[s] for t in params))
            st = encode.float_stats_plain(x[s], p, lens[s])
            pl = encode.plan_float(st, p, lens[s])
            w = encode.pack_float_plain(x[s], p, lens[s], pl)
            if check:
                err = max(err, int_err(w, words[s.start * row:
                                                s.start * row + pl.total]))
        return err

    err1 = plain_enc(True)
    if err1:
        raise AssertionError("K1 flagship: words differ (%d)" % err1)
    ms = time_ms(enc)
    plain_ms = time_ms(lambda: plain_enc(False), reps=3, warmup=1)
    results["K1"].update(ms=ms, plain_ms=plain_ms,
                         max_abs_err=max(results["K1"]["max_abs_err"], err1),
                         **bound(x.numel() * 4 + words.numel() * 4,
                                 16 * b * n))
    log("K1 flagship %dx%d 18 bits: kernel %.3f ms (%.1f GB/s of f32), "
        "plain %.3f ms (%.1f GB/s); words bitwise equal"
        % (b, n, ms, gb / ms * 1e3, plain_ms, gb / plain_ms * 1e3))
    reuse_path = k5_flagship(x, params, lens, words, plan, results)

    w2d = words.view(b, row)
    mins = torch.from_numpy(plan.mins).to(dev)
    k1, k2 = codec.dither_keys(np.arange(b), 0, dev)

    def dec():
        return decode.decode_float_group(w2d, mins, params, 18, n,
                                         "uniform", k1, k2)

    out = dec()
    dmax = float((out - x).abs().max())
    if not dmax < 2 * 0.001:
        raise AssertionError("K2 flagship: |x - x_hat| = %g" % dmax)
    err2 = 0.0
    for s in chunks(b):
        p = codec.BlockParams(*(t[s] for t in params))
        ref = decode.decode_float_plain(w2d[s], mins[s], p, 18, n,
                                        "uniform", k1[s], k2[s])
        err2 = max(err2, float_err(out[s], ref))
    del out
    ms = time_ms(dec)

    def plain_dec():
        for s in chunks(b):
            p = codec.BlockParams(*(t[s] for t in params))
            decode.decode_float_plain(w2d[s], mins[s], p, 18, n, "uniform",
                                      k1[s], k2[s])

    plain_ms = time_ms(plain_dec, reps=3, warmup=1)
    results["K2"].update(ms=ms, plain_ms=plain_ms,
                         max_abs_err=max(results["K2"]["max_abs_err"], err2),
                         **bound(w2d.numel() * 4 + x.numel() * 4, 24 * b * n))
    log("K2 flagship uniform decode: kernel %.3f ms (%.1f GB/s of f32), "
        "plain %.3f ms (%.1f GB/s); bitwise equal, |x - x_hat| <= %g"
        % (ms, gb / ms * 1e3, plain_ms, gb / plain_ms * 1e3, dmax))
    del x, words, w2d
    torch.cuda.empty_cache()

    xi = torch.randint(0, 1 << 18, (b, n), generator=gen, device=dev,
                       dtype=torch.int64) + (1 << 53)
    words, plan = k3_flagship(xi, lens, 18, results)
    # K4 reads K3's words back: a round trip to xi, bitwise
    k4_flagship(xi, words.view(b, int(plan.offsets[1])), plan.mins, 18,
                results)
    del xi, words
    torch.cuda.empty_cache()

    # wider widths at the same shape: every block spans exactly 37, 54 or
    # 64 bits; K4 reads the 54-bit words back
    for bits in (37, 54, 64):
        lo = -(1 << 63) if bits == 64 else -(1 << 62)
        xw = torch.randint(0, 1 << min(bits, 62), (b, n), generator=gen,
                           device=dev, dtype=torch.int64) + lo
        xw[:, 0], xw[:, 1] = lo, lo + (1 << bits) - 1
        words, plan = k3_flagship(xw, lens, bits, results)
        if bits == 54:
            k4_flagship(xw, words.view(b, int(plan.offsets[1])), plan.mins,
                        54, results)
        del xw, words
        torch.cuda.empty_cache()
    return reuse_path


def k3_flagship(x, lens, bits, results):
    """K3 at 4096 x 2^17, every block at ``bits``: its stats, plan and
    pack launches and the whole call, each held against its plain version
    on the same tensors, bitwise (the stats and the pack chunk by chunk:
    their int64 temporaries would not fit at once), and timed, CUDA
    events, median of 7; beside the stats launch ``torch.aminmax`` over
    the rows, the one PyTorch call that computes it where every block is
    whole, as here, both also alone (a CUDA graph of ``GRAPH_LAUNCHES``
    calls, a replay over their number: no host work between).  At 18 bits the
    plain versions are timed too (median of 3) and the numbers go into the
    kernels line: for the stats launch its time alone, beside
    ``torch.aminmax``'s alone, and both as a call (``call_ms``,
    ``library_call_ms``: a call of ``int_stats`` also checks lens, which
    waits for a copy to the host).  Returns the call's ``(words,
    plan)``."""
    b, n = x.shape
    words, plan = encode.encode_int_group(x, lens)
    if not (plan.bits == bits).all():
        raise AssertionError("K3 flagship: widths %s" % set(plan.bits))
    row = int(plan.offsets[1])
    stats = encode.int_stats(x, lens)
    dplan = encode.int_plan(stats, lens)
    err = int_err(dplan, encode.int_plan_plain(stats, lens))
    if err or not plan_eq(encode.read_plan(dplan), plan):
        raise AssertionError("K3 flagship: the plan launch differs from its "
                             "plain version or from the call's plan")

    def plain_stats():
        return torch.cat([encode.int_stats_plain(x[s], lens[s])
                          for s in chunks(b)])

    def plain_pack():
        return torch.cat([encode.delta_pack_int_plain(
            x[s], lens[s], chunk_plan(plan, s, row)) for s in chunks(b)])

    err = max(int_err(stats, plain_stats()), int_err(words, plain_pack()))
    if err:
        raise AssertionError("K3 flagship at %d bits: stats or words differ "
                             "(%d)" % (bits, err))
    total = plan.total
    t = {"stats": time_ms(lambda: encode.int_stats(x, lens)),
         "plan": time_ms(lambda: encode.int_plan(stats, lens)),
         "pack": time_ms(lambda: encode._launch_int_pack(x, lens, dplan,
                                                         total)),
         "call": time_ms(lambda: encode.encode_int_group(x, lens)),
         "torch.aminmax": time_ms(lambda: torch.aminmax(x, dim=1)),
         "stats alone": graph_ms(lambda: encode._launch_int_stats(x, lens),
                                 GRAPH_LAUNCHES),
         "torch.aminmax alone": graph_ms(lambda: torch.aminmax(x, dim=1),
                                         GRAPH_LAUNCHES)}
    if bits == 18:
        t.update({
            "stats plain": time_ms(plain_stats, reps=3, warmup=1),
            "plan plain": time_ms(lambda: encode.int_plan_plain(stats, lens),
                                  reps=3, warmup=1),
            "pack plain": time_ms(plain_pack, reps=3, warmup=1)})
    x_bytes, w_bytes = x.numel() * 8, words.numel() * 4
    # bytes: x and the words, and for each block the lens, stats and plan
    # rows a launch reads or writes
    # the stats launch beside torch.aminmax, both alone: a call of
    # int_stats also checks lens, a copy to the host before the launch
    bounds = {"stats": bound(x_bytes + (1 + 2) * 8 * b, 2 * b * n,
                             t["torch.aminmax alone"]),
              "plan": bound((2 + 1 + encode.PLAN_ROWS) * 8 * b + 16, 8 * b),
              "pack": bound(x_bytes + w_bytes + (1 + 3) * 8 * b, 4 * b * n),
              "call": bound(x_bytes + w_bytes, 6 * b * n)}
    if bits == 18:
        for key, launch, ms in (("K3 stats", "stats", "stats alone"),
                                ("K3 plan", "plan", "plan"),
                                ("K3", "pack", "pack")):
            results[key].update(ms=t[ms], plain_ms=t[launch + " plain"],
                                **bounds[launch])
        results["K3 stats"].update(call_ms=t["stats"],
                                   library_call_ms=t["torch.aminmax"])
    gb8 = b * n * 8 / 1e9
    log("K3 flagship %dx%d at %d bits, ms (CUDA events, median of 7; plain "
        "median of 3; alone: a graph of %d): %s; the pack %.1f %% of its "
        "bound %.3f ms; the stats launch alone %.3f ms (%.1f %% of its "
        "bound %.3f) against torch.aminmax alone %.3f, as a call %.3f "
        "against %.3f; the call %.1f GB/s "
        "of int64, %.1f %% of its bound %.3f ms (x once and the words); "
        "stats, device plan and words bitwise equal to the plain versions"
        % (b, n, bits, GRAPH_LAUNCHES,
           ", ".join("%s %.3f" % kv for kv in t.items()),
           100 * bounds["pack"]["bound_ms"] / t["pack"],
           bounds["pack"]["bound_ms"], t["stats alone"],
           100 * bounds["stats"]["bound_ms"] / t["stats alone"],
           bounds["stats"]["bound_ms"], t["torch.aminmax alone"],
           t["stats"], t["torch.aminmax"],
           gb8 / t["call"] * 1e3, 100 * bounds["call"]["bound_ms"]
           / t["call"], bounds["call"]["bound_ms"]))
    del stats, dplan
    return words, plan


def k4_flagship(x, w2d, mins_np, bits, results):
    """K4 on K3's words of ``x`` (4096 x 2^17): the output must be ``x``
    bitwise, as must the plain version's, chunk by chunk; both timed.
    The 18-bit times go into the kernels line."""
    b, n = x.shape
    mins = torch.from_numpy(mins_np).to(x.device)

    def dec():
        return decode.decode_int_group(w2d, mins, bits, n)

    same_ints(dec(), x, "K4 flagship round trip at %d bits" % bits)
    for s in chunks(b):
        same_ints(decode.decode_int_plain(w2d[s], mins[s], bits, n), x[s],
                  "K4 plain round trip at %d bits" % bits)
    ms = time_ms(dec)

    def plain_dec():
        for s in chunks(b):
            decode.decode_int_plain(w2d[s], mins[s], bits, n)

    plain_ms = time_ms(plain_dec, reps=3, warmup=1)
    moved = (w2d.numel() * 4 + b * n * 8) / 1e9
    if bits == 18:
        results["K4"].update(ms=ms, plain_ms=plain_ms,
                             **bound(moved * 1e9, 4 * b * n))
    gb8 = b * n * 8 / 1e9
    log("K4 flagship int64 unpack at %d bits: kernel %.3f ms (%.1f GB/s of "
        "int64, %.1f GB/s moved; bound %.3f ms), plain %.3f ms (%.1f GB/s); "
        "both equal to the packed values bitwise"
        % (bits, ms, gb8 / ms * 1e3, moved / ms * 1e3,
           bound(moved * 1e9, 4 * b * n)["bound_ms"], plain_ms,
           gb8 / plain_ms * 1e3))


# -- phase 4: the main path -------------------------------------------------


def write_catalog(d, rows, seed=2024, id0=3_000_000_000, id_type="int64"):
    """A Rockstar-style hlist of ``rows`` halos, IDs from ``id0`` typed
    ``id_type``, plus the converter's config, name index and type
    index."""
    rng = np.random.default_rng(seed)
    ids = np.arange(rows, dtype=np.int64) + id0
    pid = np.where(rng.random(rows) < 0.8, -1, ids[rng.integers(0, rows,
                                                                rows)])
    num_prog = rng.integers(0, 6, rows)
    # log masses keep clear of the mass cut (log10 7.75e9 = 9.889), so the
    # parsed float32 and the source agree on which halos pass it
    lm = rng.uniform(9, 15, rows)
    mvir = 10.0 ** np.where(np.abs(lm - 9.889) < 0.01, lm + 0.02, lm)
    rvir = 10.0 ** rng.uniform(0.5, 3.5, rows)
    pos = rng.uniform(0, 250, (3, rows))
    vel = np.clip(rng.normal(0, 300, (3, rows)), -9999, 9999)
    cols = [ids, pid, num_prog, mvir, rvir, *pos, *vel]
    fmt = "%d %d %d %.5e %.4f %.5f %.5f %.5f %.2f %.2f %.2f"
    lines = [fmt % t for t in zip(*(c.tolist() for c in cols))]
    hlist = os.path.join(d, "hlist_1.00000.list")
    with open(hlist, "w") as f:
        f.write("#ID PID Num_prog Mvir Rvir X Y Z VX VY VZ\n")
        f.write("#Synthetic catalog, seed %d\n" % seed)
        f.write("\n".join(lines))
        f.write("\n")
    with open(os.path.join(d, "names.txt"), "w") as f:
        f.write("id ID\npid PID\nnum_prog Num_prog\nmvir Mvir\nrvir Rvir\n"
                "x X\ny Y\nz Z\nvx VX\nvy VY\nvz VZ\n")
    with open(os.path.join(d, "types.txt"), "w") as f:
        f.write("id %s\npid int\nnum_prog int\n" % id_type)
        f.write("mvir q_float log 1e5 1e16 0.001\n"
                "rvir q_float log 1e-2 1e5 0.001\n"
                "x q_float position\ny q_float position\nz q_float position\n"
                "vx q_float linear -10000 10000 0.1\n"
                "vy q_float linear -10000 10000 0.1\n"
                "vz q_float linear -10000 10000 0.1\n")
    config = os.path.join(d, "run.config")
    with open(config, "w") as f:
        f.write("[minh]\nL = 250\nEpsilon = 0.001\nMp = 1.54975e+08\n"
                "MinParticles = 50\nMassName = mvir\n"
                "NameIndex = %s\nTypeIndex = %s\n"
                % (os.path.join(d, "names.txt"),
                   os.path.join(d, "types.txt")))
    source = {"pid": pid, "x": pos[0].astype(np.float32),
              "mvir": mvir.astype(np.float32)}
    return config, hlist, source


# the catalog's float columns: (name, low, high, dx), log columns in log10
COLUMNS = [("mvir", 5.0, 16.0, 0.001), ("rvir", -2.0, 5.0, 0.001),
           ("x", 0.0, 250.0, 0.001), ("y", 0.0, 250.0, 0.001),
           ("z", 0.0, 250.0, 0.001), ("vx", -1e4, 1e4, 0.1),
           ("vy", -1e4, 1e4, 0.1), ("vz", -1e4, 1e4, 0.1)]


def check_main_shapes(dev, n, rng):
    """Each kernel against its plain version at the shapes the main path
    gives it, and timed there: K1 on the 8 float columns of the row-block
    (n rows), K3 on its 2 int columns, K2 on each float column, K4 on
    each int column."""
    b = len(COLUMNS)
    periodic = np.array([c[0] in ("x", "y", "z") for c in COLUMNS])
    low = np.array([c[1] for c in COLUMNS], np.float32)
    high = np.array([c[2] for c in COLUMNS], np.float32)
    pixels = np.array([np.ceil(np.float32(h - lo) / np.float32(c[3]))
                       for c, lo, h in zip(COLUMNS, low, high)], np.int64)
    x = np.stack([rng.uniform(lo, h, n) for lo, h in zip(low, high)])
    params = codec.block_params(low, high, pixels, periodic, dev)
    xt = torch.from_numpy(x.astype(np.float32)).to(dev)
    lens = torch.full((b,), n, dtype=torch.int64, device=dev)
    stats = encode.float_stats(xt, params, lens)
    err = int_err(stats, encode.float_stats_plain(xt, params, lens))
    plan = encode.plan_float(stats, params, lens)
    words = encode.pack_float(xt, params, lens, plan)
    err = max(err, int_err(words, encode.pack_float_plain(xt, params, lens,
                                                          plan)))
    k1, k2 = codec.dither_keys(np.arange(b), 0, dev)
    columns = []  # K2's arguments for each column, as read_floats gives them
    for i in range(b):
        w = words[plan.offsets[i]:plan.offsets[i] + (
            int(plan.bits[i]) * n + 31) // 32].view(1, -1)
        columns.append((w, torch.from_numpy(plan.mins[i:i + 1]).to(dev),
                        codec.BlockParams(*(t[i:i + 1] for t in params)),
                        int(plan.bits[i]), n))
        for mode in codec.DITHER_MODES:
            keys = (k1[i:i + 1], k2[i:i + 1])
            float_err(decode.decode_float_group(*columns[i], mode, *keys),
                      decode.decode_float_plain(*columns[i], mode, *keys))
    ints = np.stack([np.where(rng.random(n) < 0.8, -1,
                              rng.integers(3e9, 4e9, n)),
                     rng.integers(0, 6, n)])
    it = torch.from_numpy(ints).to(dev)
    iwords, iplan = hold_k3(it, lens[:2], "at the main path's shape")
    icolumns = []  # K4's arguments for each int column, as read_ints gives
    for i in range(2):
        nw = bitpack.words_per_block(int(iplan.bits[i]), n)
        icolumns.append((iwords[int(iplan.offsets[i]):
                                int(iplan.offsets[i]) + nw].view(1, -1),
                         torch.from_numpy(iplan.mins[i:i + 1]).to(dev),
                         int(iplan.bits[i]), n))
        got = decode.decode_int_group(*icolumns[i])
        same_ints(got, decode.decode_int_plain(*icolumns[i]),
                  "K4 at the main path's shape")
        same_ints(got, it[i:i + 1], "K4 round trip at the main path's shape")
    if err:
        raise AssertionError("main-path shapes: max err %d" % err)
    log("main-path shapes: K1 (8, %d), K2 (1, %d) x 8 columns x 3 modes, "
        "K3 (2, %d), K4 (1, %d) x 2 columns: bitwise equal to the plain "
        "versions, K4 to K3's input; widths %s, %s"
        % (n, n, n, n, plan.bits.tolist(), iplan.bits.tolist()))

    def decode_all():
        for i, col in enumerate(columns):
            decode.decode_float_group(*col, "uniform", k1[i:i + 1],
                                      k2[i:i + 1])

    t = {"K1 call": time_ms(lambda: encode.encode_float_group(xt, params,
                                                              lens)),
         "K1 stats": time_ms(lambda: encode.float_stats(xt, params, lens)),
         "K1 pack": time_ms(lambda: encode.pack_float(xt, params, lens,
                                                      plan)),
         "K2 uniform, 8 columns": time_ms(decode_all),
         "K4, 2 columns": time_ms(lambda: [decode.decode_int_group(*c)
                                           for c in icolumns]),
         "K4 plain, 2 columns": time_ms(lambda: [decode.decode_int_plain(*c)
                                                 for c in icolumns])}
    log("main-path shapes, ms (CUDA events, median of 7): %s" % ", ".join(
        "%s %.4f" % kv for kv in t.items()))
    log_k3("the main path's shape", [("(2, %d) at widths %s" % (
        n, iplan.bits.tolist()), k3_timed(it, lens[:2], iplan))])
    log_float("the main path's shape", [("(8, %d)" % n, float_timed(
        xt, params, lens, plan))])


def main_path(dev):
    shutil.rmtree(WORK, ignore_errors=True)
    for sub in ("device", "host", "stages", "warm"):
        os.makedirs(os.path.join(WORK, sub))
    # set-up: the host text parser is native code (native/fastbits.cpp)
    # built on first use; build it here, outside the timings
    t0 = time.perf_counter()
    warm = write_catalog(os.path.join(WORK, "warm"), 1000)[:2]
    text_to_minh.main([*warm[:1], "all", warm[1],
                       os.path.join(WORK, "warm")])
    log("set-up: host text parser ready in %.2f s"
        % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    config, hlist, source = write_catalog(WORK, ROWS)
    log("main path: catalog of %d rows (%.1f MB) written in %.2f s"
        % (ROWS, os.path.getsize(hlist) / 1e6, time.perf_counter() - t0))
    keep = source["mvir"] > np.float32(1.54975e8 * 50)
    check_main_shapes(dev, int(keep.sum()), np.random.default_rng(11))

    # the counts start at zero here: the main path must launch every kernel
    reset_counts()
    dev_file, args, host_timer = convert_both(config, hlist, WORK)

    names = ["mvir", "rvir", "x", "y", "z", "vx", "vy", "vz"]
    for mode in ("none", "midpoint", "uniform"):
        r = minh.open(dev_file, dither=mode, seed=7)
        try:
            k2 = decode.K2_LAUNCHES
            t0 = time.perf_counter()
            got = minh_device.read_floats(r, names, dev)
            t_read = time.perf_counter() - t0
            k2 = decode.K2_LAUNCHES - k2
            t0 = time.perf_counter()
            want = r.floats(names)
            t_host_read = time.perf_counter() - t0
            kept = r.length
            pid = r.ints(["pid"])["pid"]
        finally:
            r.close()
        for name in names:
            if got[name].shape != (kept,) or not np.array_equal(
                    got[name].view(np.int32), want[name].view(np.int32)):
                raise AssertionError("read_floats(%s) differs from the host "
                                     "reader in mode %s" % (name, mode))
        if k2 != len(names):
            raise AssertionError("read_floats of %d columns launched K2 %d "
                                 "times" % (len(names), k2))
        log("read_floats %s: %d columns x %d rows on the card in %.3f s "
            "(%d K2 launches, one a column), host reader %.3f s; bitwise "
            "equal" % (mode, len(names), kept, t_read, k2, t_host_read))

    if kept != keep.sum() or not np.array_equal(pid, source["pid"][keep]):
        raise AssertionError("mass cut or pid column wrong")
    dx_err = float(np.abs(got["x"] - source["x"][keep]).max())
    if not (np.isfinite(got["x"]).all() and dx_err < 2 * 0.001):
        raise AssertionError("positions off by %g" % dx_err)
    check_read_ints(dev_file, dev)
    launches = counts()
    log("main path launches: %s; positions within %.6g of the source"
        % (launches, dx_err))
    need(launches, KERNELS[:4], "the main path")

    # stage breakdown of one more device conversion (after the counts)
    dev_timer = StageTimer()
    text_to_minh.convert_file(*args, os.path.join(WORK, "stages", "s.minh"),
                              dev, timer=dev_timer)
    for label, timer in (("device", dev_timer), ("host mode", host_timer)):
        log("stages, %s: %s" % (label, ", ".join(
            "%s %.3f s" % (k, v["seconds"])
            for k, v in timer.report().items())))
    t0 = time.perf_counter()
    wide = wide_column_path(dev, os.path.join(WORK, "wide"), WIDE_ROWS)
    log("wide column: %.1f s" % (time.perf_counter() - t0))
    return {k: launches[k] + wide[k] for k in KERNELS}


def write_wide_catalog(d, rows, seed=2027):
    """A small catalog with two float columns of 10^10 pixels (0 to 10^6
    at 10^-4): ``wide`` holds values inside the first 2^31 pixels, ``far``
    values all over the range, whose pixels pass an int32.  Returns the
    config and the hlist."""
    rng = np.random.default_rng(seed)
    cols = [np.arange(rows, dtype=np.int64) + (1 << 40),
            10.0 ** rng.uniform(10, 15, rows), rng.uniform(0, 250, rows),
            rng.uniform(0, 2.0e5, rows), rng.uniform(0, 999999.0, rows)]
    lines = ["%d %.5e %.5f %.4f %.3f" % t
             for t in zip(*(c.tolist() for c in cols))]
    hlist = os.path.join(d, "hlist_1.00000.list")
    with open(hlist, "w") as f:
        f.write("#ID Mvir X Wide Far\n")
        f.write("\n".join(lines))
        f.write("\n")
    with open(os.path.join(d, "names.txt"), "w") as f:
        f.write("id ID\nmvir Mvir\nx X\nwide Wide\nfar Far\n")
    with open(os.path.join(d, "types.txt"), "w") as f:
        f.write("id int\nmvir q_float log 1e5 1e16 0.001\n"
                "x q_float position\n"
                "wide q_float linear 0 1e6 1e-4\n"
                "far q_float linear 0 1e6 1e-4\n")
    config = os.path.join(d, "run.config")
    with open(config, "w") as f:
        f.write("[minh]\nL = 250\nEpsilon = 0.001\nMp = 1.54975e+08\n"
                "MinParticles = 50\nMassName = mvir\n"
                "NameIndex = %s\nTypeIndex = %s\n"
                % (os.path.join(d, "names.txt"),
                   os.path.join(d, "types.txt")))
    return config, hlist


def read_wide_columns(fname, dev):
    """``wide`` and ``far`` of ``fname`` read on the card one at a time in
    the three modes, bitwise equal to the host reader; every read must
    launch K2.  Returns the number of rows."""
    for mode in ("none", "midpoint", "uniform"):
        r = minh.open(fname, dither=mode, seed=7)
        try:
            for name in ("wide", "far"):
                before = decode.K2_LAUNCHES
                got = minh_device.read_floats(r, [name], dev)[name]
                want = r.floats([name])[name]
                if decode.K2_LAUNCHES <= before:
                    raise AssertionError("read_floats(%s) launched no K2"
                                         % name)
                if got.shape != (r.length,) or not np.array_equal(
                        got.view(np.int32), want.view(np.int32)):
                    raise AssertionError(
                        "read_floats(%s) differs from the host reader in "
                        "mode %s" % (name, mode))
            kept = r.length
        finally:
            r.close()
    return kept


def wide_column_path(dev, work, rows):
    """The wide column through the main path: ``text_to_minh --device`` of
    :func:`write_wide_catalog`'s catalog into ``work``, byte-compared
    with host mode; ``wide`` and ``far`` read back on the card in the
    three modes, bitwise equal to the host reader; ``inspect_minh
    --device`` against host mode.  Before it the same conversion, reads
    and inspection run once under :func:`held_to_plain`: K1 on the four
    float columns of the row-block (``far``'s words, which the encoder
    replaces with the host's, among them), K3 on the IDs, K2 and K4 a
    column a call.  Then the counts start at zero; K1 and K2 must have
    been launched, K2 on each of the two columns, and the blocks sent to
    the host encoder must be ``far``'s.  Returns the launches."""
    for sub in ("device", "host", "held"):
        os.makedirs(os.path.join(work, sub))
    config, hlist = write_wide_catalog(work, rows)
    held = os.path.join(work, "held", "hlist_1.00000.minh")
    with held_to_plain({}) as seen:
        text_to_minh.main([config, "all", hlist, os.path.dirname(held),
                           "--device"])
        read_wide_columns(held, dev)
        printed(inspect_minh.main, [held, "--device"])
    need({k: len(seen.get(k, ())) for k in KERNELS[:4]}, KERNELS[:4],
         "the wide column's path under held_to_plain")
    log_held("wide column's shapes", seen)

    reset_counts()
    sent = pipeline.HOST_BLOCKS
    dev_file, _, _ = convert_both(config, hlist, work)
    sent = pipeline.HOST_BLOCKS - sent
    encoded = counts()
    need(encoded, ("K1",), "the wide column's conversion")

    names = ["wide", "far"]
    r = minh.open(dev_file)
    try:
        col = r.columns[r._col("wide")]
        pixels = spec.float_group_pixels(col.low, col.high, col.dx)
        widths = {n: minh_device.block_widths(r, n) for n in names}
        blocks = r.blocks
    finally:
        r.close()
    if pixels < 1 << 33 or max(widths["wide"]) > 31 or \
            min(widths["far"]) < 33 or sent != blocks:
        raise AssertionError(
            "the wide column: %d pixels, widths %s, %d of %d blocks sent to "
            "the host encoder" % (pixels, widths, sent, blocks))
    kept = read_wide_columns(dev_file, dev)
    out = printed(inspect_minh.main, [dev_file, "--device"])
    if out != printed(inspect_minh.main, [dev_file]):
        raise AssertionError("inspect_minh --device prints otherwise than "
                             "host mode on the wide column's file")
    launches = counts()
    need(launches, ("K1", "K2"), "the wide column's path")
    log("wide column: %d rows, %d pixels a column; --device file "
        "byte-identical to host mode; widths wide %s, far %s; %d block(s) "
        "sent to the host encoder (far's); read_floats of both in three "
        "modes bitwise equal to the host reader; inspect_minh --device "
        "prints host mode's %d lines; launches %s (K1 %d in the conversion)"
        % (kept, pixels, widths["wide"], widths["far"], sent,
           len(out.splitlines()), launches, encoded["K1"]))
    return launches


def same_file(a, b, what):
    """Raise unless files ``a`` and ``b`` hold the same bytes; returns
    their size."""
    with open(a, "rb") as f:
        got = f.read()
    with open(b, "rb") as f:
        want = f.read()
    if got != want:
        diff = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                    min(len(got), len(want)))
        raise AssertionError("%s: the files differ (sizes %d, %d; first "
                             "differing byte %d)"
                             % (what, len(got), len(want), diff))
    return len(got)


def convert_both(config, hlist, work):
    """``text_to_minh --device`` of ``hlist`` into ``work``/device and the
    same converter in host mode (the numpy and native codec) into
    ``work``/host; the two files must be byte-identical.  Returns the
    device file, the converter's arguments and the host run's stage
    timer."""
    t0 = time.perf_counter()
    text_to_minh.main([config, "all", hlist, os.path.join(work, "device"),
                       "--device"])
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    dev_file = os.path.join(work, "device", "hlist_1.00000.minh")

    cfg = text_to_minh.parse_config(config)
    idx = text_to_minh.open_index(cfg["NameIndex"])
    args = (cfg, idx, text_to_minh.parse_types(cfg["TypeIndex"], idx),
            text_to_minh.parse_vars("all", idx), hlist)
    host_file = os.path.join(work, "host", "hlist_1.00000.minh")
    host_timer = StageTimer()
    t0 = time.perf_counter()
    text_to_minh.convert_file(*args, host_file, None, timer=host_timer)
    t_host = time.perf_counter() - t0
    size = same_file(dev_file, host_file, "text_to_minh --device")
    log("text_to_minh --device: %.3f s; host mode: %.3f s; the two files "
        "are byte-identical (%d bytes)" % (t_dev, t_host, size))
    return dev_file, args, host_timer


def check_read_ints(fname, dev):
    """Every ``Int`` column of ``fname`` read on the card with
    ``read_ints``, bitwise equal to the host reader; returns the widths
    K4 decoded."""
    r = minh.open(fname)
    try:
        names = [n for n, c in zip(r.names, r.columns) if c.type == minh.Int]
        k4 = decode.K4_LAUNCHES
        t0 = time.perf_counter()
        got = minh_device.read_ints(r, names, dev)
        t_read = time.perf_counter() - t0
        k4 = decode.K4_LAUNCHES - k4
        t0 = time.perf_counter()
        want = r.ints(names)
        t_host = time.perf_counter() - t0
        widths = {n: minh_device.block_widths(r, n) for n in names}
    finally:
        r.close()
    for n in names:
        if got[n].dtype != np.int64 or not np.array_equal(got[n], want[n]):
            raise AssertionError("read_ints(%s) differs from the host reader"
                                 % n)
    if k4 != len(names):
        raise AssertionError("read_ints of %d columns launched K4 %d times"
                             % (len(names), k4))
    log("read_ints %s: %d rows on the card in %.3f s (%d K4 launches, one "
        "a column), host reader %.3f s; bitwise equal; widths %s"
        % (names, len(want[names[0]]), t_read, k4, t_host, widths))
    return {w for ws in widths.values() for w in ws}


def need(launches, kernels, what):
    """Raise unless each of ``kernels`` was launched, and, where
    ``launches`` counts K3's stats and plan launches, unless every int
    encode was K3's three launches: as many of each as packs (the paths
    pack by no host plan)."""
    missing = [k for k in kernels if launches[k] < 1]
    if missing:
        raise AssertionError("kernels %s never launched: %s"
                             % (what, missing))
    k3 = [launches[k] for k in ("K3 stats", "K3 plan", "K3")
          if k in launches]
    if len(set(k3)) > 1:
        raise AssertionError("%s: K3's stats, plan and pack launches %s "
                             "differ" % (what, k3))


def read_all(fname, device, dither="uniform", seed=3):
    """Every column of ``fname``, routed by type as the CLIs route it."""
    r = minh.open(fname, dither=dither, seed=seed)
    try:
        return {n: minh_device.read_column(r, n, device) for n in r.names}
    finally:
        r.close()


def printed(fn, *args):
    """What ``fn(*args)`` prints to standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@contextlib.contextmanager
def held_to_plain(seen):
    """While it is open, every call the host layers make to a kernel's
    entry also runs the plain version on the same tensors and raises
    unless the two are bitwise equal: ``encode.start_float_group`` (K1:
    its stats rows, its plan and its words), ``encode.start_int_group``
    (K3: the same three), ``decode.decode_float_ragged`` (K2) and
    ``decode.decode_int_ragged`` (K4), the one entry of each decode kernel
    (``decode_*_group`` build a table and call them).  ``seen`` gathers
    each call's shape by kernel.  It holds the kernels at whatever shapes
    a path gives them: a path runs under it once before its counted run,
    so none of these launches is counted."""
    real = (encode.start_float_group, encode.start_int_group,
            decode.decode_float_ragged, decode.decode_int_ragged)

    def start_float_group(x, params, lens, reuse_q=False, capacity=None):
        pending = real[0](x, params, lens, reuse_q, capacity)
        if x.shape[0] == 0:
            return pending
        words, plan = encode.finish_float_group(pending)
        stats = encode.float_stats_plain(x, params, lens)
        err = int_err(encode.float_stats(x, params, lens), stats)
        dplan = encode.float_plan(stats, params, lens)
        if err or not plan_eq(encode.read_plan(dplan), plan) or \
                not torch.equal(dplan, encode.float_plan_plain(stats, params,
                                                               lens)):
            raise AssertionError("K1 at %s: stats (max err %d) or plan "
                                 "differ from the plain versions"
                                 % (tuple(x.shape), err))
        err = int_err(words, encode.pack_float_plain(x, params, lens, plan))
        if err:
            raise AssertionError("K1 at %s: words differ from the plain "
                                 "version's, max err %d"
                                 % (tuple(x.shape), err))
        seen.setdefault("K1", []).append(tuple(x.shape))
        return pending

    def start_int_group(x, lens, capacity=None):
        pending = real[1](x, lens, capacity)
        if 0 in x.shape:
            return pending
        words, plan = encode.finish_int_group(pending)
        stats = encode.int_stats_plain(x, lens)
        err = int_err(encode.int_stats(x, lens), stats)
        dplan = encode.int_plan_plain(stats, lens)
        if err or not plan_eq(plan, encode.read_plan(dplan)):
            raise AssertionError("K3 at %s: stats (max err %d) or plan "
                                 "differ from the plain versions"
                                 % (tuple(x.shape), err))
        err = int_err(words, encode.delta_pack_int_plain(x, lens, plan))
        if err:
            raise AssertionError("K3 at %s: words differ from the plain "
                                 "version's, max err %d"
                                 % (tuple(x.shape), err))
        seen.setdefault("K3", []).append(tuple(x.shape))
        return pending

    def shape(table):
        """(blocks, elements, narrowest bits, widest bits) of a table."""
        bits = table.bits.tolist() or [0]
        return (len(table.lens), table.total, min(bits), max(bits))

    def decode_float_ragged(src, table, params, dither, k1=None, k2=None):
        args = (src, table, params, dither, k1, k2)
        got = real[2](*args)
        float_err(got, decode.decode_float_ragged_plain(*args))
        seen.setdefault("K2", []).append(shape(table))
        return got

    def decode_int_ragged(src, table):
        got = real[3](src, table)
        same_ints(got, decode.decode_int_ragged_plain(src, table),
                  "K4 at %s" % (shape(table),))
        seen.setdefault("K4", []).append(shape(table))
        return got

    encode.start_float_group = start_float_group
    encode.start_int_group = start_int_group
    decode.decode_float_ragged = decode_float_ragged
    decode.decode_int_ragged = decode_int_ragged
    try:
        yield seen
    finally:
        (encode.start_float_group, encode.start_int_group,
         decode.decode_float_ragged, decode.decode_int_ragged) = real


def log_held(what, seen):
    """One line for a path that ran under :func:`held_to_plain`."""
    log("%s, every kernel call held against its plain version on the same "
        "tensors, bitwise equal: %s (K1, K3: (blocks, elements); K2, K4: "
        "(blocks, elements, narrowest and widest bits))"
        % (what, "; ".join("%s %d calls at %s" % (k, len(v), sorted(set(v)))
                           for k, v in sorted(seen.items()))))


def file_column(words, plan, lens, config=None, ids=None):
    """The blocks of an encode as a file holds them: their payload bytes
    back to back (``pipeline._payloads``) and their
    ``device_common.Blocks`` (a float column with ``config``, keyed on
    ``ids``).  Returns ``(span, Blocks)``."""
    lens = np.asarray(lens, np.int64)
    payloads = pipeline._payloads(words.cpu().numpy(), plan.offsets,
                                  plan.bits, lens)
    ends = np.cumsum([len(p) for p in payloads], dtype=np.int64)
    start = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
    ids = np.arange(len(lens), dtype=np.int64) if ids is None else ids
    return np.frombuffer(b"".join(payloads), np.uint8), device_common.Blocks(
        start, plan.bits.astype(np.int64), lens, plan.mins.astype(np.int64),
        config, ids)


def ragged_timed(dev, span, col, what, mode="uniform", want=None,
                 timed=True):
    """A column staged as a read stages it (``stage_columns``), through
    the ragged entry: held against its plain version on the same tensors
    (and against ``want``, a tensor, where given), bitwise, then, where
    ``timed``, both timed (CUDA events, median of 7).  At these shapes a
    call's events hold the host's time to issue it, so the kernel is also
    timed alone: ``GRAPH_LAUNCHES`` launches captured in one CUDA graph,
    a replay's time over their number.  Returns ``(what, ms, kernel ms,
    plain ms, bound)``, the bound from the bytes the launch must move (the
    span, the table, the output) by :func:`bound`."""
    src, (s,) = device_common.stage_columns(span, [col], dev, mode, seed=0)
    if col.config is None:
        def run():
            return decode.decode_int_ragged(src, s.table)

        def plain():
            return decode.decode_int_ragged_plain(src, s.table)

        same_ints(run(), plain(), what)
        out_bytes, ops = 8, 4
    else:
        def run():
            return decode.decode_float_ragged(src, s.table, s.params, mode,
                                              s.k1, s.k2)

        def plain():
            return decode.decode_float_ragged_plain(src, s.table, s.params,
                                                    mode, s.k1, s.k2)

        float_err(run(), plain())
        out_bytes, ops = 4, 24
    if want is not None:
        same_ints(run(), want, what + " round trip")
    if not timed:
        return None
    tensors = [src, *s.table[:5], *(s.params or ()), s.k1, s.k2]
    n = s.table.total
    moved = sum(t.numel() * t.element_size() for t in tensors
                if t is not None) + n * out_bytes
    kernel_ms = graph_ms(run, GRAPH_LAUNCHES)
    return ("%s (%d blocks, %d elements, widths %d..%d, %d bytes in)"
            % (what, len(col.lens), n, col.bits.min(), col.bits.max(),
               src.numel() * 4),
            time_ms(run), kernel_ms, time_ms(plain, reps=3, warmup=1),
            bound(moved, ops * n)["bound_ms"])


def log_ragged(what, rows):
    log("%s through the ragged entry, ms (CUDA events, median of 7: the "
        "call, and the kernel alone in a graph of %d launches; plain median "
        "of 3; bound by bytes at 3.35 TB/s): %s"
        % (what, GRAPH_LAUNCHES, "; ".join(
            "%s: call %.4f, kernel %.4f, plain %.4f, bound %.4f" % r
            for r in rows)))


def check_boundary_shapes(dev, rng):
    """Each kernel against its plain version at the shapes phase 5 gives
    it, and timed there.  K1 and K3 take one column of 512 ragged cells,
    as ``DeviceBoundaryWriter`` batches them: 3,619..4,026 rows, zeros
    beyond each cell's length, one empty cell (K3 on the id, pid and
    num_prog columns and on ids spread over 54 bits).  K2 and K4 take
    that column whole, one launch, as the read gives it to them: the
    writer's payloads
    back to back as the file holds them (a round trip for K4), and K4 also
    a column of random bytes at the int widths of the boundary file (1, 3,
    20 and 54 bits)."""
    b = CELLS ** 3
    lens_np = rng.integers(3619, 4027, b)
    lens_np[b // 2] = 0
    width = int(lens_np.max())
    mask = np.arange(width)[None, :] < lens_np[:, None]
    lens = torch.from_numpy(lens_np).to(dev)
    side = 250.0 / CELLS
    t = []  # (what, ms)
    rows = []  # ragged_timed's
    floats = []  # float_timed's

    def timed(what, fn, **kw):
        t.append((what, time_ms(fn, **kw)))

    # float columns: x (a cell and its ghost zones, wrapping) and vx
    for name, lo, hi, dx in (COLUMNS[2], COLUMNS[5]):
        if name == "x":
            base = (np.arange(b) % CELLS) * side - BOUNDARY
            v = ((base[:, None] + rng.uniform(0, side + 2 * BOUNDARY,
                                              (b, width))) % 250.0)
            v = v.astype(np.float32)
            v[v >= 250] = 0
        else:
            v = rng.uniform(-1000, 1000, (b, width))
        xt = torch.from_numpy(np.where(mask, v, 0).astype(np.float32)).to(dev)
        pixels = np.ceil(np.float32(hi - lo) / np.float32(dx))
        params = codec.block_params(np.full(b, lo), np.full(b, hi),
                                    np.full(b, pixels, np.int64),
                                    np.full(b, name == "x"), dev)
        stats = encode.float_stats(xt, params, lens)
        err = int_err(stats, encode.float_stats_plain(xt, params, lens))
        plan = encode.plan_float(stats, params, lens)
        words = encode.pack_float(xt, params, lens, plan)
        err = max(err, int_err(words, encode.pack_float_plain(
            xt, params, lens, plan)))
        if err:
            raise AssertionError("K1 at 512 ragged cells, %s: max err %d"
                                 % (name, err))
        span, col = file_column(words, plan, lens_np, (
            np.full(b, lo, np.float32), np.full(b, hi, np.float32),
            np.full(b, pixels, np.int64), np.full(b, name == "x")))
        for mode in ("none", "midpoint"):
            ragged_timed(dev, span, col, "K2 " + mode, mode, timed=False)
        rows.append(ragged_timed(dev, span, col, "K2 uniform, %s" % name))

        def plain_enc():
            st = encode.float_stats_plain(xt, params, lens)
            pl = encode.plan_float(st, params, lens)
            encode.pack_float_plain(xt, params, lens, pl)

        timed("K1 call, %s" % name,
              lambda: encode.encode_float_group(xt, params, lens))
        timed("plain", plain_enc, reps=3, warmup=1)
        floats.append((name, float_timed(xt, params, lens, plan)))

    # int columns: id (2^53 + 1 + 20 bits), pid (-1 or an ID), num_prog
    ids = (1 << 53) + 1 + rng.integers(0, ROWS, (b, width))
    pid = np.where(rng.random((b, width)) < 0.8, -1, ids)
    k3 = []  # k3_timed's
    wide = (1 << 53) + 1 + rng.integers(0, 1 << 54, (b, width))
    for name, v in (("id", ids), ("pid", pid),
                    ("num_prog", rng.integers(0, 6, (b, width))),
                    ("id at 54 bits", wide)):
        it = torch.from_numpy(np.where(mask, v, 0)).to(dev)
        iwords, iplan = hold_k3(it, lens, "at 512 ragged cells, " + name)
        if name != "id at 54 bits":
            span, col = file_column(iwords, iplan, lens_np)
            rows.append(ragged_timed(dev, span, col, "K4, %s" % name,
                                     want=it[torch.from_numpy(mask).to(dev)]))
        k3.append(("%s at %s bits" % (name, sorted(set(iplan.bits.tolist()))),
                   k3_timed(it, lens, iplan)))
    widths = np.array([(1, 3, 20, 54)[i % 4] for i in range(b)], np.int64)
    nbytes = (widths * lens_np + 7) // 8
    start = np.concatenate([np.zeros(1, np.int64), np.cumsum(nbytes)[:-1]])
    rows.append(ragged_timed(
        dev, rng.integers(0, 256, int(nbytes.sum()), dtype=np.uint8),
        device_common.Blocks(start, widths, lens_np.astype(np.int64),
                             ids[:, 0].copy(), None, np.arange(b)),
        "K4, random bytes"))
    log("boundary-path shapes: K1 (512, %d) and K3 (512, %d; its stats, "
        "plan and words), cells of %d..%d rows and one empty; K2 (three "
        "modes) and K4 on each column of 512 cells, one launch: bitwise "
        "equal to the plain versions, K4 to K3's input"
        % (width, width, lens_np[lens_np > 0].min(), width))
    log("boundary-path shapes, ms (CUDA events, median of 7; the plain "
        "version of K1 median of 3; each 'plain' is the plain version of "
        "the entry before it): %s" % ", ".join("%s %.4f" % kv for kv in t))
    log_ragged("boundary-path columns", rows)
    log_k3("the boundary path's shapes, (512, %d) ragged" % width, k3)
    log_float("the boundary path's shapes, (512, %d) ragged" % width,
              floats)


def cells_timed(dev, results):
    """The boundary cell table's kernel chain (``ops.cells``,
    ``csrc/cells.cu``) against its plain version on the card at the
    boundary cell's shape: 3.0 M uniform halos in 8^3 cells of a 250 box,
    shells of 5, bitwise (rows, flags, offsets), and timed: the count,
    scan and place launches alone on the table's buffers (CUDA events,
    median of 7), and the plain version (median of 7).  Its bound counts
    what the table needs: x, y, z read once and each row's point index
    and flag written once (the chain reads x, y, z twice, once a pass).
    Goes into the kernels line."""
    n = 3_000_000
    rng = np.random.default_rng(18)
    pos = [torch.from_numpy(rng.uniform(0, 250.0, n).astype(np.float32)).to(
        dev) for _ in range(3)]
    got = cells.build(*pos, 250.0, BOUNDARY, CELLS)
    want = cells.table_plain(*pos, 250.0, BOUNDARY, CELLS)
    for what in ("perm", "flags", "offsets"):
        if not torch.equal(getattr(got, what), getattr(want, what)):
            raise AssertionError("cells kernel and plain version differ: %s"
                                 % what)
    chain = cells.Chain(*pos, 250.0, BOUNDARY, CELLS)
    perm, flags = torch.empty_like(got.perm), torch.empty_like(got.flags)

    def launches():
        chain.count()
        chain.place(perm, flags)

    ms = time_ms(launches)
    if not (torch.equal(perm, got.perm) and torch.equal(flags, got.flags)):
        raise AssertionError("the timed cells launches wrote another table")
    plain_ms = time_ms(lambda: cells.table_plain(*pos, 250.0, BOUNDARY,
                                                 CELLS))
    rows = got.perm.numel()
    moved = 12 * n + 9 * rows
    results["cells"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0,
                            **bound(moved, 0))
    log("cells at the boundary cell's shape (%d halos, %d^3 cells, boundary "
        "%g: %d rows): kernel chain %.4f ms, plain %.4f ms, bound %.4f ms "
        "(%d bytes: x, y, z, a row's index and flag once); bitwise "
        "equal" % (n, CELLS, BOUNDARY, rows, ms, plain_ms,
                   results["cells"]["bound_ms"], moved))
    del got, want, chain, perm, flags, pos


def boundary_path(dev, results):
    """Phase 5: a catalog with ``int`` IDs above 2^53 to minh on the card,
    then to the boundary layout with ``minh_to_bnd --device``, read back
    and inspected on the card; every file and value against the port's
    host mode.  The cell table's entry of the kernels line goes into
    ``results``."""
    work = os.path.join(WORK, "boundary")
    for sub in ("device", "host", "bnd_device", "bnd_host"):
        os.makedirs(os.path.join(work, sub))
    t0 = time.perf_counter()
    config, hlist, _ = write_catalog(work, ROWS, seed=2025,
                                     id0=(1 << 53) + 1, id_type="int")
    log("boundary path: catalog of %d rows, int IDs from 2^53 + 1, written "
        "in %.2f s" % (ROWS, time.perf_counter() - t0))
    check_boundary_shapes(dev, np.random.default_rng(13))
    cells_timed(dev, results)

    # the counts start at zero here: this path must launch every kernel
    reset_counts()
    t_start = time.perf_counter()
    src, _, _ = convert_both(config, hlist, work)
    widths = check_read_ints(src, dev)

    t0 = time.perf_counter()
    tables = cells.CELLS_LAUNCHES
    minh_to_bnd.main([str(CELLS), str(BOUNDARY), src,
                      os.path.join(work, "bnd_device"), "--device"])
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    tables = cells.CELLS_LAUNCHES - tables
    if tables != 1:
        raise AssertionError("minh_to_bnd --device built %d cell tables, "
                             "not one" % tables)
    results["cells"]["launches"] = tables
    bnd = os.path.join(work, "bnd_device", "hlist_1.00000.bnd.minh")
    host_bnd = os.path.join(work, "bnd_host", "hlist_1.00000.bnd.minh")
    t0 = time.perf_counter()
    minh_to_bnd.convert_file(src, host_bnd, CELLS, BOUNDARY, None)
    t_host = time.perf_counter() - t0
    size = same_file(bnd, host_bnd, "minh_to_bnd --device")
    r = minh.open(bnd)
    rows, blocks = r.length, r.blocks
    lens = np.asarray(r.block_lengths)
    r.close()
    log("minh_to_bnd --device (%d cells, boundary %g): %.3f s; host "
        "mode: %.3f s; the two files are byte-identical (%d "
        "bytes, %d rows in %d cells of %d..%d rows)"
        % (CELLS ** 3, BOUNDARY, t_dev, t_host, size, rows, blocks,
           lens.min(), lens.max()))

    before = counts()
    t0 = time.perf_counter()
    got = read_all(bnd, dev)
    t_read = time.perf_counter() - t0
    after = counts()
    t0 = time.perf_counter()
    want = read_all(bnd, None)
    t_host_read = time.perf_counter() - t0
    for n, v in want.items():
        if got[n].dtype != v.dtype or not np.array_equal(
                got[n].view(np.uint8), v.view(np.uint8)):
            raise AssertionError("boundary column %s read on the card "
                                 "differs from the host reader" % n)
    r = minh.open(bnd)
    types = [c.type for c in r.columns]
    r.close()
    k2, k4 = after["K2"] - before["K2"], after["K4"] - before["K4"]
    if (k2, k4) != (types.count(minh.Float), types.count(minh.Int)):
        raise AssertionError("the boundary file read launched K2 %d and K4 "
                             "%d times for %d Float and %d Int columns"
                             % (k2, k4, types.count(minh.Float),
                                types.count(minh.Int)))
    log("boundary file read, %d columns, uniform: %.3f s on the card in %d "
        "K2 and %d K4 launches (one a column: %d Float, %d Int), host reader "
        "%.3f s; bitwise equal"
        % (len(want), t_read, k2, k4, types.count(minh.Float),
           types.count(minh.Int), t_host_read))

    t0 = time.perf_counter()
    out = printed(inspect_minh.main, [bnd, "--device"])
    t_inspect = time.perf_counter() - t0
    host_out = printed(inspect_minh.main, [bnd])
    if out != host_out:
        raise AssertionError("inspect_minh --device prints otherwise than "
                             "inspect_minh in host mode:\n%s\n%s"
                             % (out, host_out))
    log("inspect_minh --device: %.3f s, %d lines equal to the host mode's "
        "output" % (t_inspect, len(out.splitlines())))

    launches = counts()
    log("boundary path launches: %s; K4 widths of the source file %s; "
        "%.3f s in all"
        % (launches, sorted(widths), time.perf_counter() - t_start))
    # after the count: two of its columns as the read stages them, through
    # the ragged entry, against the plain version and timed
    r = minh.open(bnd)
    try:
        rows = []
        for name in ("x", "id"):
            blocks = device_common.tail_blocks(r.f, [
                r._block_idx(r._col(name), b) for b in range(r.blocks)])
            span, s0 = device_common.read_span(r.f, [blocks])
            rows.append(ragged_timed(
                dev, span, blocks._replace(start=blocks.start - s0),
                "K%d, the %s column" % (2 if name == "x" else 4, name)))
    finally:
        r.close()
    log_ragged("boundary file columns", rows)
    need(launches, KERNELS[:4], "the boundary path")
    if not (min(widths) <= 32 < max(widths)):
        raise AssertionError("K4 ran at widths %s: not both <= 32 and > 32"
                             % sorted(widths))
    return launches


# -- phase 6: the snapshot path -----------------------------------------------


def write_snapshot(d, n_side, l, files, seed=2026):
    """An LGadget-2 fileset of ``n_side^3`` particles in ``files`` files,
    in random order.  A particle sits at its Lagrangian lattice site plus
    a Gaussian displacement (sigma 1), except in 5 % of the 16^3-site
    patches (a sub-cell of phase 6), whose particles collapse to a
    Gaussian cluster (sigma 0.5) at the patch's centre; positions wrap
    into [0, l).  Velocities are Gaussian, sigma 300.  Returns the source
    positions and velocities by Lagrangian ID."""
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    side = l / n_side
    lag = np.arange(n)
    site = np.stack([lag % n_side, lag // n_side % n_side,
                     lag // (n_side * n_side)], axis=1)
    pos = (site + 0.5) * side + rng.normal(0, 1.0, (n, 3))
    patch = site // 16
    p_side = n_side // 16
    pid = patch[:, 0] + p_side * (patch[:, 1] + p_side * patch[:, 2])
    cluster = rng.random(p_side ** 3) < 0.05
    inside = cluster[pid]
    centre = (patch[inside] + 0.5) * 16 * side
    pos[inside] = centre + rng.normal(0, 0.5, (int(inside.sum()), 3))
    pos = np.mod(pos, l).astype(np.float32)
    vel = rng.normal(0, 300, (n, 3)).astype(np.float32)
    hd = minp.Header(z=0.0, scale=1.0, omega_m=0.3, omega_l=0.7, h100=0.7,
                     l=l, n_side=n_side, n_total=n)
    snapshot.calc_uniform_mass(hd)
    order = np.array_split(rng.permutation(n), files)
    snap = snapshot.MockSnapshot(hd, [pos[o] for o in order],
                                 [vel[o] for o in order],
                                 [o + 1 for o in order])
    gh = lgadget2.LGadget2Header(time=1.0, box_size=l, omega0=0.3,
                                 omega_lambda=0.7, hubble_param=0.7,
                                 n_part_total=(0, n, 0, 0, 0, 0),
                                 num_files=files)
    lgadget2.write_lgadget2(d, "snap_%03d.dat", snap, gh)
    return pos, vel


def check_snapshot_shapes(dev, gadget):
    """K1 and K2 against their plain versions at the shapes phase 6 gives
    them, and timed there: K1 on one axis of one file (512 sub-cell
    blocks of 4,096, as ``minp.Writer`` batches them), positions and
    velocities; K2 on the whole axis, one launch, in the three modes, as
    ``read_vectors`` gives it the blocks of a file.  The blocks are the
    converter's own (``snapshot.Grid`` of the fileset)."""
    grid = snapshot.Grid(lgadget2.LGadget2Snapshot(gadget), FILE_CELLS)
    t, rows, floats = [], [], []
    for kind, vec, dx, periodic in (("x", grid.read_x(0), SNAP_DX, True),
                                    ("v", grid.read_v(0), SNAP_DV, False)):
        blocks = minp.split_sub_cells(vec, SUB_CELLS)[:, :, 0]
        b, n = blocks.shape
        if periodic:
            lo, hi = np.float32(0), np.float32(SNAP_L)
        else:
            lo, hi = blocks.min(), blocks.max()
            hi = np.nextafter(hi, 2 * hi).astype(np.float32)
        pixels = spec.float_group_pixels(lo, hi, dx)
        # minp.Writer's encoder call keeps the periodic default
        params = codec.block_params(np.full(b, lo), np.full(b, hi),
                                    np.full(b, pixels), np.ones(b, bool),
                                    dev)
        xt = torch.from_numpy(np.ascontiguousarray(blocks)).to(dev)
        lens = torch.full((b,), n, dtype=torch.int64, device=dev)
        stats = encode.float_stats(xt, params, lens)
        err = int_err(stats, encode.float_stats_plain(xt, params, lens))
        plan = encode.plan_float(stats, params, lens)
        words = encode.pack_float(xt, params, lens, plan)
        err = max(err, int_err(words, encode.pack_float_plain(
            xt, params, lens, plan)))
        if err:
            raise AssertionError("K1 at phase 6's shape, %s: max err %d"
                                 % (kind, err))
        widths, per = np.unique(plan.bits[plan.valid], return_counts=True)
        span, col = file_column(words, plan, np.full(b, n), (
            np.full(b, lo, np.float32), np.full(b, hi, np.float32),
            np.full(b, pixels, np.int64), np.ones(b, bool)))
        for mode in ("none", "midpoint"):
            ragged_timed(dev, span, col, "K2 " + mode, mode, timed=False)
        rows.append(ragged_timed(dev, span, col, "K2 uniform, the %s axis"
                                 % kind))

        def plain_enc():
            st = encode.float_stats_plain(xt, params, lens)
            encode.pack_float_plain(xt, params, lens,
                                    encode.plan_float(st, params, lens))

        t += [("K1 call, %s" % kind,
               time_ms(lambda: encode.encode_float_group(xt, params, lens))),
              ("plain", time_ms(plain_enc, reps=3, warmup=1))]
        floats.append(("the %s axis, (%d, %d)" % (kind, b, n),
                       float_timed(xt, params, lens, plan)))
        log("snapshot shapes, %s: K1 (%d, %d), widths %s (blocks %s), K2 "
            "on the whole axis, one launch, in three modes: bitwise equal to "
            "the plain versions" % (kind, b, n, widths.tolist(), per.tolist()))
    log("snapshot shapes, ms (CUDA events, median of 7; the plain version "
        "of K1 median of 3; each 'plain' is the plain version of the entry "
        "before it): %s" % ", ".join("%s %.4f" % kv for kv in t))
    log_ragged("snapshot axes", rows)
    log_float("the snapshot path's shapes", floats)


def rebin_timed(dev, gadget, results):
    """The re-binning kernel against its plain version on the card at the
    snapshot cell's shape: one source file's 2.1 M particles into one
    256^3 file cell (``ops.rebin.Batch``), bitwise, and timed (CUDA
    events, median of 7; the plain version of 3; each call after a clear
    of the batch's marks, 2 MB).  Its bound counts the inputs read once
    (an ID and two vectors, 32 bytes a particle) and each scattered write
    at its 32-byte sector (a position, a velocity and a mark's word).
    Goes into the kernels line."""
    snap = lgadget2.LGadget2Snapshot(gadget)
    ids, x, v = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        snap.read_id(0), snap.read_x(0), snap.read_v(0)))
    m = len(ids)
    kernel, plain = (rebin.Batch(SNAP_SIDE, 1, 0, 1, dev) for _ in range(2))
    kernel.add(ids, x, v)
    rebin.rebin_plain(plain, ids, x, v)
    kernel.check()
    plain.check()
    for what in ("x", "v", "marks", "error"):
        if not torch.equal(getattr(kernel, what), getattr(plain, what)):
            raise AssertionError("rebin kernel and plain version differ: "
                                 "%s" % what)

    def again(batch, fn):  # the marks cleared, so each call does it all
        batch.marks.zero_()
        fn(batch)

    ms = time_ms(lambda: again(kernel, lambda b: b.add(ids, x, v)))
    plain_ms = time_ms(lambda: again(plain, lambda b: rebin.rebin_plain(
        b, ids, x, v)), reps=3, warmup=1)
    moved = m * (8 + 24) + m * 3 * 32
    results["rebin"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0,
                            **bound(moved, 0))
    log("rebin at the snapshot cell's shape (%d particles, one %d^3 cell): "
        "kernel %.4f ms, plain %.4f ms, bound %.4f ms (%d bytes, the "
        "scattered writes at 32-byte sectors); bitwise equal"
        % (m, SNAP_SIDE, ms, plain_ms, results["rebin"]["bound_ms"], moved))
    del kernel, plain


def snapshot_path(dev, results):
    """Phase 6: a 256^3-particle LGadget-2 snapshot to minp with
    ``convert_snapshot --device``, byte-compared with the same converter
    in host mode, and read back on the card with ``read_vectors``, bitwise
    equal to the host reader and within dx, dv of the source.  The
    re-binning kernel's entry of the kernels line goes into
    ``results``."""
    work = os.path.join(WORK, "snapshot")
    gadget, dev_dir, host_dir = (os.path.join(work, d)
                                 for d in ("gadget", "device", "host"))
    for d in (gadget, dev_dir, host_dir):
        os.makedirs(d)
    t0 = time.perf_counter()
    pos, vel = write_snapshot(gadget, SNAP_SIDE, SNAP_L, SNAP_FILES)
    log("snapshot path: %d^3 particles in %d LGadget-2 files written in "
        "%.2f s" % (SNAP_SIDE, SNAP_FILES, time.perf_counter() - t0))
    check_snapshot_shapes(dev, gadget)
    rebin_timed(dev, gadget, results)

    # the counts start at zero here: this path must launch K1 and K2
    reset_counts()
    t_start = time.perf_counter()
    args = [str(a) for a in (FILE_CELLS, SUB_CELLS, SNAP_DX, SNAP_DV)]
    t0 = time.perf_counter()
    rebins = rebin.REBIN_LAUNCHES
    convert_snapshot.main(["to_minp", gadget, dev_dir, *args, "--device"])
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    rebins = rebin.REBIN_LAUNCHES - rebins
    if rebins != SNAP_FILES:
        raise AssertionError("to_minp --device re-binned with %d launches, "
                             "not one a source file (one batch of cells)"
                             % rebins)
    results["rebin"]["launches"] = rebins
    t0 = time.perf_counter()
    convert_snapshot.main(["to_minp", gadget, host_dir, *args])
    t_host = time.perf_counter() - t0
    names = sorted(os.listdir(host_dir))
    if sorted(os.listdir(dev_dir)) != names or len(names) != \
            2 * FILE_CELLS ** 3:
        raise AssertionError("to_minp wrote %s and %s"
                             % (sorted(os.listdir(dev_dir)), names))
    size = sum(same_file(os.path.join(dev_dir, f), os.path.join(host_dir, f),
                         "convert_snapshot --device, %s" % f) for f in names)
    log("convert_snapshot to_minp --device: %.3f s (%d re-binning "
        "launches); host mode: %.3f s; %d files byte-identical (%d bytes)"
        % (t_dev, rebins, t_host, len(names), size))

    reads = []  # (mode, seconds on the card, seconds on the host)
    for f in names:
        modes = ["uniform"]
        if f in ("x_0.minp", "v_0.minp"):
            modes += ["none", "midpoint"]
        for mode in modes:
            r = minp.open(os.path.join(dev_dir, f), dither=mode, seed=5)
            try:
                k2 = decode.K2_LAUNCHES
                t0 = time.perf_counter()
                got = minp_device.read_vectors(r, dev)
                torch.cuda.synchronize()
                t_read = time.perf_counter() - t0
                k2 = decode.K2_LAUNCHES - k2
                t0 = time.perf_counter()
                want = r.vectors()
                t_host_read = time.perf_counter() - t0
            finally:
                r.close()
            got = got.cpu().numpy()
            if got.shape != want.shape or not np.array_equal(
                    got.view(np.int32), want.view(np.int32)):
                raise AssertionError("read_vectors(%s) differs from the host "
                                     "reader in mode %s" % (f, mode))
            if k2 != 1:
                raise AssertionError("read_vectors(%s) launched K2 %d times"
                                     % (f, k2))
            reads.append((mode, t_read, t_host_read))
            if f in ("x_0.minp", "v_0.minp") and mode == "uniform":
                src = (pos if f[0] == "x" else vel)[
                    minp.lagrangian_ids(minp.Cell(0, FILE_CELLS, SUB_CELLS),
                                        SNAP_SIDE)]
                d = np.abs(got - src)
                if f[0] == "x":
                    d = np.minimum(d, SNAP_L - d)
                step = SNAP_DX if f[0] == "x" else SNAP_DV
                if not (np.isfinite(got).all() and d.max() <= 2 * step):
                    raise AssertionError("%s read back %g from the source"
                                         % (f, d.max()))
                log("%s: %d vectors within %.6g of the source (step %g)"
                    % (f, len(got), d.max(), step))
    for mode in ("uniform", "none", "midpoint"):
        ts = [(a, b) for m, a, b in reads if m == mode]
        log("read_vectors %s: %d files on the card in %.3f s (%d K2 "
            "launches, one a file), host reader %.3f s; bitwise equal"
            % (mode, len(ts), sum(a for a, _ in ts), len(ts),
               sum(b for _, b in ts)))
    launches = counts()
    log("snapshot path launches: %s; %.3f s in all"
        % (launches, time.perf_counter() - t_start))
    need(launches, ("K1", "K2"), "the snapshot path")
    # phase 8 verifies one of the files
    os.replace(os.path.join(dev_dir, "x_0.minp"),
               os.path.join(WORK, "x_0.minp"))
    shutil.rmtree(work)
    # after the count: one file as read_vectors stages it, through the
    # ragged entry, against the plain version and timed
    r = minp.open(os.path.join(WORK, "x_0.minp"))
    try:
        s3 = r.f.blocks() // 3
        rows = []
        for what, ids in (("an axis", range(s3)),
                          ("the file", range(3 * s3))):
            blocks = device_common.tail_blocks(r.f, ids)
            span, s0 = device_common.read_span(r.f, [blocks])
            rows.append(ragged_timed(
                dev, span, blocks._replace(start=blocks.start - s0),
                "K2 uniform, %s of x_0.minp" % what))
    finally:
        r.close()
    log_ragged("snapshot file", rows)
    return launches


# -- phase 7: the multi-process path and the multi-device encoder -----------


def check_multiprocess_shapes(dev):
    """K1 to K4 against their plain versions at the shapes phase 7's
    workers give them, and timed there, on the batches of the first rank
    (3 row-blocks) and of the last (2), made as the workers make them
    (``multiprocess_gather_check.rank_batches``): K1 on (6 | 4, 126,096)
    ragged rows that alternate the position and the log-mass config, K3 on
    the (3 | 2, 126,096) ragged ID batch at 37 bits; K2 (in the three
    modes) and K4 on one block a call, (1, n), as the sharded read-back
    decodes them, from the words K1 and K3 wrote; K4 also back to K3's
    input."""
    blocks = multiprocess_gather_check.make_catalog(MP_ROWS)
    counts = multiprocess_gather_check.owner_counts(MP_PROCS)
    t = []
    k3 = []  # k3_timed's

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for rank in (0, MP_PROCS - 1):
        first = sum(counts[:rank])
        ib, ilens, fb, flens, flow, fhigh, fpix = \
            multiprocess_gather_check.rank_batches(
                blocks, range(first, first + counts[rank]))
        # BlockEncoder's call keeps the periodic default
        params = codec.block_params(flow, fhigh, fpix,
                                    np.ones(len(fb), bool), dev)
        xt, lens = put(fb), put(flens)
        stats = encode.float_stats(xt, params, lens)
        err = int_err(stats, encode.float_stats_plain(xt, params, lens))
        plan = encode.plan_float(stats, params, lens)
        words = encode.pack_float(xt, params, lens, plan)
        err = max(err, int_err(words, encode.pack_float_plain(
            xt, params, lens, plan)))
        if err or not plan.valid.all():
            raise AssertionError("K1 at rank %d's shape: max err %d, valid "
                                 "%s" % (rank, err, plan.valid))
        cols = []
        for i, n in enumerate(flens):
            nw = bitpack.words_per_block(int(plan.bits[i]), int(n))
            off = int(plan.offsets[i])
            col = (words[off:off + nw][None].clone(), put(plan.mins[i:i + 1]),
                   codec.BlockParams(*(v[i:i + 1] for v in params)),
                   int(plan.bits[i]), int(n))
            keys = codec.dither_keys(np.zeros(1, np.int64), 0, dev)
            for mode in codec.DITHER_MODES:
                float_err(decode.decode_float_group(*col, mode, *keys),
                          decode.decode_float_plain(*col, mode, *keys))
            cols.append((col, keys))

        it, ilt = put(ib), put(ilens)
        iwords, iplan = hold_k3(it, ilt, "at rank %d's shape" % rank)
        if iplan.bits.min() <= 32:
            raise AssertionError("K3 at rank %d's shape: widths %s"
                                 % (rank, iplan.bits))
        icols = []
        for i, n in enumerate(ilens):
            nw = bitpack.words_per_block(int(iplan.bits[i]), int(n))
            off = int(iplan.offsets[i])
            icol = (iwords[off:off + nw][None].clone(),
                    put(iplan.mins[i:i + 1]), int(iplan.bits[i]), int(n))
            got = decode.decode_int_group(*icol)
            same_ints(got, decode.decode_int_plain(*icol),
                      "K4 on block %d of rank %d" % (i, rank))
            same_ints(got, it[i:i + 1, :int(n)],
                      "K4 round trip of block %d of rank %d" % (i, rank))
            icols.append(icol)

        def plain_enc():
            st = encode.float_stats_plain(xt, params, lens)
            encode.pack_float_plain(xt, params, lens,
                                    encode.plan_float(st, params, lens))

        (col, keys), icol = cols[0], icols[0]
        shape = "(%d, %d)" % tuple(xt.shape)
        t += [("K1 call, %s" % shape,
               time_ms(lambda: encode.encode_float_group(xt, params, lens))),
              ("plain", time_ms(plain_enc, reps=3, warmup=1)),
              ("K2 none, (1, %d) at %d bits" % (col[4], col[3]),
               time_ms(lambda: decode.decode_float_group(*col, "none",
                                                         *keys))),
              ("plain", time_ms(lambda: decode.decode_float_plain(
                  *col, "none", *keys))),
              ("K4, (1, %d) at %d bits" % (icol[3], icol[2]),
               time_ms(lambda: decode.decode_int_group(*icol))),
              ("plain", time_ms(lambda: decode.decode_int_plain(*icol)))]
        log("multi-process shapes, rank %d: K1 %s at widths %s, K3 (%d, %d) "
            "at widths %s, rows of %s; K2 in three modes and K4 on each "
            "block alone: bitwise equal to the plain versions, K4 to K3's "
            "input" % (rank, shape, plan.bits.tolist(), *it.shape,
                       iplan.bits.tolist(), ilens.tolist()))
        k3.append(("rank %d, (%d, %d) at %s bits" % (
            rank, *it.shape, sorted(set(iplan.bits.tolist()))),
            k3_timed(it, ilt, iplan)))
    log("multi-process shapes, ms (CUDA events, median of 7; the plain "
        "version of K1 median of 3; each 'plain' is the plain version of "
        "the entry before it): %s" % ", ".join("%s %.4f" % kv for kv in t))
    log_k3("the multi-process shapes", k3)


def multiprocess_runs():
    """``multiprocess_gather_check`` with ``MP_PROCS`` workers on the card
    in each gather mode.  Returns the launches summed over ranks and
    modes."""
    work = os.path.join(WORK, "multiprocess")
    os.makedirs(work)
    total = dict.fromkeys(KERNELS, 0)
    for mode in ("gather", "allgather"):
        report = multiprocess_gather_check.run(
            MP_PROCS, mode, "cuda", rows=MP_ROWS, timeout=MP_LIMIT,
            work_dir=work)
        if report["counts"] != [3, 3, 3, 2]:
            raise AssertionError("owner counts %s" % report["counts"])
        for r in report["ranks"]:
            need(r["launches"], KERNELS[:4], "rank %d of the %s run"
                 % (r["rank"], mode))
            if not r["device"].startswith("cuda") or min(
                    r["int_widths"]) <= 32:
                raise AssertionError("rank %d ran on %s at int widths %s"
                                     % (r["rank"], r["device"],
                                        r["int_widths"]))
            for k in KERNELS:
                total[k] += r["launches"][k]
        log("multi-process %s: %d processes, %d rows in blocks %s, file of "
            "%d bytes byte-identical to the single-process host write, "
            "read-back bit-exact on every rank; %.1f s for the workers; "
            "payload bytes per rank %s"
            % (mode, MP_PROCS, report["rows"], report["counts"],
               report["file_bytes"], report["seconds"],
               [r["bytes_sent"] for r in report["ranks"]]))
        for r in report["ranks"]:
            log("  rank %d: %s; launches %s, of them the read-back's %s; ID "
                "widths %s"
                % (r["rank"], ", ".join("%s %.3f s" % kv
                                        for kv in r["seconds"].items()),
                   r["launches"], r["read_back_launches"], r["int_widths"]))
    return total


def same_blocks(a, b, what):
    if a.payloads != b.payloads or not all(
            np.array_equal(getattr(a, k), getattr(b, k))
            for k in ("mins", "bits", "lens")):
        raise AssertionError("%s: the encoded blocks differ" % what)


def two_device_encoder(dev):
    """``BlockEncoder([dev, dev])`` against ``BlockEncoder(dev)`` on the x
    and id columns of phase 5's boundary file, cell by cell (512 ragged
    blocks): byte for byte, and both decode methods give the host
    reader's values."""
    bnd = os.path.join(WORK, "boundary", "bnd_device",
                       "hlist_1.00000.bnd.minh")
    # midpoint values sit at their pixels' centres, so they quantize back
    # to the pixels they came from
    r = minh.open(bnd, dither="midpoint")
    try:
        col = r.columns[r._col("x")]
        cells = [(r.float_block(b, ["x"])["x"], r.int_block(b, ["id"])["id"])
                 for b in range(r.blocks)]
    finally:
        r.close()
    lens = np.array([len(x) for x, _ in cells], np.int64)
    width = int(lens.max())
    x = np.zeros((len(cells), width), np.float32)
    ids = np.zeros((len(cells), width), np.int64)
    for i, (xs, id_) in enumerate(cells):
        x[i, :len(xs)], ids[i, :len(xs)] = xs, id_
    pixels = spec.float_group_pixels(col.low, col.high, col.dx)
    one, two = BlockEncoder(dev), BlockEncoder([dev, dev])
    t = {}
    for name, enc in (("one device", one), ("two shares", two)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = enc.encode_float_blocks(x, col.low, col.high, pixels, lens=lens)
        i = enc.encode_int_blocks(ids, lens=lens)
        t[name] = time.perf_counter() - t0
        if enc is one:
            f1, i1 = f, i
    same_blocks(f, f1, "float encode on [card, card]")
    same_blocks(i, i1, "int encode on [card, card]")
    # the decode methods take blocks of one length: the most frequent
    n = int(np.bincount(lens).argmax())
    ids_n = np.nonzero(lens == n)[0]
    dec_i = two.decode_int_blocks([i.payloads[k] for k in ids_n],
                                  i.mins[ids_n], i.bits[ids_n], n)
    dec_f = two.decode_float_blocks([f.payloads[k] for k in ids_n],
                                    f.mins[ids_n], f.bits[ids_n], col.low,
                                    col.high, pixels, n, dither="midpoint")
    if not np.array_equal(dec_i, ids[ids_n, :n]):
        raise AssertionError("decode_int_blocks on [card, card] differs")
    if not np.array_equal(dec_f.view(np.int32), x[ids_n, :n].view(np.int32)):
        raise AssertionError("decode_float_blocks on [card, card] differs")
    log("BlockEncoder([card, card]) on the x and id columns of %d ragged "
        "cells (%d..%d rows): payloads, minimums and widths equal to "
        "BlockEncoder(card)'s (%d + %d bytes); %d cells of %d rows decoded "
        "back bitwise; encode of both columns %s"
        % (len(cells), lens.min(), width, f.total_bytes(), i.total_bytes(),
           len(ids_n), n, ", ".join("%s %.4f s" % kv for kv in t.items())))


def jobs_conversions():
    """``text_to_minh --device --jobs=2`` on phase 4's and on phase 5's
    catalog, each under two names so that two jobs run at once on one
    shared encoder: every file must equal the one its phase wrote."""
    for label, src in (("phase 4", WORK),
                       ("phase 5", os.path.join(WORK, "boundary"))):
        d = os.path.join(WORK, "jobs", label.replace(" ", ""))
        os.makedirs(d)
        for name in ("hlist_0.50000.list", "hlist_1.00000.list"):
            os.symlink(os.path.join(src, "hlist_1.00000.list"),
                       os.path.join(d, name))
        t0 = time.perf_counter()
        out = printed(text_to_minh.main,
                      [os.path.join(src, "run.config"), "all",
                       os.path.join(d, "hlist_*.list"), d, "--device",
                       "--jobs=2"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        want = os.path.join(src, "device", "hlist_1.00000.minh")
        for name in ("hlist_0.50000.minh", "hlist_1.00000.minh"):
            size = same_file(os.path.join(d, name), want,
                             "text_to_minh --device --jobs=2, %s" % label)
        log("text_to_minh --device --jobs=2 on %s's catalog under two "
            "names: %.3f s, both files byte-identical to the phase's (%d "
            "bytes); it printed %d lines"
            % (label, seconds, size, len(out.splitlines())))


def dry_runs(dev):
    """The file-level dry runs on ``[card]`` and on ``[card, card]``:
    once under :func:`held_to_plain`, which holds K1 to K4 at every batch
    shape the steps give them, then with the counts at zero before them.
    Returns the launches."""
    shares = ([dev], [dev, dev])
    with held_to_plain({}) as seen:
        for devices in shares:
            dryrun.dryrun(devices)
    need({k: len(seen.get(k, ())) for k in KERNELS[:4]}, KERNELS[:4],
         "the dry runs under held_to_plain")
    log_held("dry runs' shapes", seen)
    reset_counts()
    for devices in shares:
        t0 = time.perf_counter()
        out = dryrun.dryrun(devices)
        torch.cuda.synchronize()
        log("dryrun on %d share(s): %s; %.2f s"
            % (len(devices), ", ".join(
                "%s (%d bytes)" % (k, len(v)) if isinstance(v, bytes) else k
                for k, v in out.items()), time.perf_counter() - t0))
    launches = counts()
    need(launches, KERNELS[:4], "the dry runs")
    return launches


def multiprocess_path(dev):
    """Phase 7.  Returns its launches: the workers' and this process's."""
    check_multiprocess_shapes(dev)
    total = multiprocess_runs()
    reset_counts()
    two_device_encoder(dev)
    jobs_conversions()
    here = counts()
    need(here, KERNELS[:4], "the two-share encoder and --jobs")
    dry = dry_runs(dev)
    log("phase 7 launches: workers %s, this process %s, the dry runs %s"
        % (total, here, dry))
    return {k: total[k] + here[k] + dry[k] for k in KERNELS}


# -- phase 8: certification ---------------------------------------------------


def certify_families(dev):
    """The one-shot self-check of each kernel family on the card, as the
    first ``BlockEncoder`` or bulk read of a process runs it."""
    for family in selfcheck.FAMILIES:
        t0 = time.perf_counter()
        selfcheck.kernel_ok(family, dev)
        torch.cuda.synchronize()
        log("selfcheck %s: ok in %.3f s" % (family,
                                            time.perf_counter() - t0))


def certification(dev):
    t0 = time.perf_counter()
    report = validate.validate_backend(dev)
    torch.cuda.synchronize()
    log("validate_backend: %s in %.2f s (quantize and dequantize at "
        "200,000 values a config, pack at 8 widths, K1, K2 and K5 at "
        "widths 1..32, K3 and K4 at 0..64, against core.spec, bitwise)"
        % (json.dumps(report), time.perf_counter() - t0))
    log("selfcheck verdicts (cached since phase 3): %s" % json.dumps(
        {f: selfcheck.kernel_ok(f, dev) for f in selfcheck.FAMILIES}))
    files = [os.path.join(WORK, "device", "hlist_1.00000.minh"),
             os.path.join(WORK, "boundary", "bnd_device",
                          "hlist_1.00000.bnd.minh"),
             os.path.join(WORK, "x_0.minp")]
    for f in files:
        t0 = time.perf_counter()
        problems = verify_minnow.verify(f, deep=True)
        if problems:
            raise AssertionError("verify_minnow(%s): %s" % (f, problems))
        log("verify_minnow --deep %s: ok (%d bytes, %.2f s)"
            % (os.path.relpath(f, WORK), os.path.getsize(f),
               time.perf_counter() - t0))
    cut = os.path.join(WORK, "cut.minh")
    with open(files[0], "rb") as f:
        data = f.read()
    with open(cut, "wb") as f:
        f.write(data[:len(data) - 10])
    problems = verify_minnow.verify(cut, deep=True)
    if not problems:
        raise AssertionError("verify_minnow found nothing wrong with a file "
                             "cut short")
    log("verify_minnow --deep of a copy cut short by 10 bytes: %s"
        % problems)


def cuda_tests():
    """Phase 9: the ``cuda`` tests in a process of their own.  Raises
    unless pytest exits 0 with at least one test passed and none failed;
    prints the count and the five slowest tests, returns the count of
    passes."""
    cmd = [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py",
           "--noconftest", "-q", "-p", "no:cacheprovider", "--durations=5"]
    run = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         timeout=TESTS_LIMIT)
    tail = run.stdout.strip().splitlines()[-1:] or [""]
    found = {word: int(n) for n, word in re.findall(
        r"(\d+) (passed|failed|errors?|skipped)", tail[0])}
    passed = found.get("passed", 0)
    bad = sum(v for k, v in found.items() if k != "passed")
    if run.returncode != 0 or passed < 1 or bad:
        raise AssertionError("the cuda tests: exit code %d, %s\n%s"
                             % (run.returncode, found, run.stdout[-4000:]))
    log("cuda tests: %s (%s); the slowest: %s"
        % (tail[0].strip("= "), " ".join(cmd[1:]), "; ".join(
            " ".join(line.split()) for line in run.stdout.splitlines()
            if re.match(r"\d+\.\d+s call", line))))
    return passed


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch %s)" % torch.__version__)
        return 2
    t_start = time.perf_counter()
    dev = cuda_device()
    smi = card_info()
    name = torch.cuda.get_device_name(0)
    log("device: %s (%d visible); nvidia-smi: %s; torch %s, CUDA %s"
        % (name, torch.cuda.device_count(), smi, torch.__version__,
           torch.version.cuda))

    t0 = time.perf_counter()
    _build.load()
    log("build: %.2f s" % (time.perf_counter() - t0))
    log_ptxas(_build.build_log())

    results = {k: {"max_abs_err": 0} for k in KERNELS}
    rng = np.random.default_rng(5)
    results["K1"]["max_abs_err"], results["K5"]["max_abs_err"] = \
        check_float_encode(dev, rng)
    results["K2"]["max_abs_err"] = check_k2(dev, rng)
    results["K3"]["max_abs_err"] = check_k3(dev, rng)
    results["K4"]["max_abs_err"] = check_k4(dev, rng)
    check_tile_entries(dev, rng)
    certify_families(dev)
    reuse_path = flagship(dev, results)
    need(reuse_path, ("K1", "K5"), "the reuse_q path")
    check_wide_pixels(dev, rng)

    t0 = time.perf_counter()
    first = main_path(dev)
    log("phase 4: %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    second = boundary_path(dev, results)
    log("phase 5: %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    third = snapshot_path(dev, results)
    log("phase 6: %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    fourth = multiprocess_path(dev)
    log("phase 7: %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    certification(dev)
    log("phase 8: %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    passed = cuda_tests()
    log("phase 9: %d cuda tests passed, %.1f s"
        % (passed, time.perf_counter() - t0))
    runs = (reuse_path, first, second, third, fourth)
    launches = {k: sum(run[k] for run in runs) for k in KERNELS}

    banned = [m for m in sys.modules
              if m.startswith(("jax", "minnow_tpu"))]
    if banned:
        raise AssertionError("imported: %s" % banned)
    log("total %.1f s; no module of jax, jaxlib or minnow_tpu imported"
        % (time.perf_counter() - t_start))

    sources = {"K1": ("encode_float", "minnow_torch/csrc/encode_float.cu",
                      "minnow_tpu/ops/pallas_encode.py:1045 + :714 + :388"),
               "K2": ("decode_float", "minnow_torch/csrc/decode_float.cu",
                      "minnow_tpu/ops/pallas_codec.py:526 + :252"),
               "K3 stats": ("int_stats", "minnow_torch/csrc/pack_int.cu",
                            "minnow_tpu/ops/pallas_encode.py:949 (its stats "
                            "in XLA, minnow_tpu/ops/codec.py:212)"),
               "K3 plan": ("int_plan", "minnow_torch/csrc/pack_int.cu",
                           "minnow_tpu/ops/pallas_encode.py:949 (its plan on "
                           "the host, minnow_tpu/parallel/pipeline.py:264)"),
               "K3": ("pack_int", "minnow_torch/csrc/pack_int.cu",
                      "minnow_tpu/ops/pallas_encode.py:949 + "
                      "minnow_tpu/ops/pallas_pack.py:82"),
               "K4": ("unpack_int", "minnow_torch/csrc/unpack_int.cu",
                      "minnow_tpu/ops/pallas_codec.py:592 + :641 + :689"),
               "K5": ("encode_float_pack_q",
                      "minnow_torch/csrc/encode_float.cu",
                      "minnow_tpu/ops/pallas_encode.py:809")}
    kernels = [dict(name="%s %s" % (k.split()[0], sources[k][0]),
                    route="cuda", source=sources[k][1],
                    replaces=sources[k][2], launches=launches[k],
                    **results[k]) for k in sources]
    kernels.append(dict(name="cells cells", route="cuda",
                        source="minnow_torch/csrc/cells.cu",
                        replaces="none: the host's boundary cell table "
                        "(minnow_tpu/formats/boundary.py idx_reg, "
                        "host_cells_table and the stable sort)",
                        **results["cells"]))
    kernels.append(dict(name="rebin rebin", route="cuda",
                        source="minnow_torch/csrc/rebin.cu",
                        replaces="none: the host's re-binning by ID "
                        "(minnow_tpu/ingest/snapshot.py Grid._build)",
                        **results["rebin"]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
