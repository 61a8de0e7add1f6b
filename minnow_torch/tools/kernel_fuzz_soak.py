"""Fuzz soak of the codec kernels against the normative host codec
(counterpart of ``tools/r3_kernel_fuzz_soak.py``): many random width,
shape and config draws beyond the test suite's seeds.

    python3 -m minnow_torch.tools.kernel_fuzz_soak [n_seeds]
        [--reps=R] [--device={cuda,cpu}]

It runs on the CUDA device, on the kernels, and fails without one;
``--device=cpu`` soaks the kernels' plain PyTorch versions on the CPU
instead.  Two parts: ``n_seeds`` random draws (default 100) of each case,
then a deterministic EVERY-WIDTH sweep (int pack and unpack 1-64, float
encode and uniform decode 2-24) at fixed shapes with random data, ``R``
reps per width (default 2; 0 leaves the sweep out).  Each draw compares,
bitwise:

* int pack (K3) at a random width, ragged lengths and minimums down to
  -2^50, with ``spec.pack_bits``, and its unpack (K4) with the values;
* the uniform decode (K2) at random widths, configs, block ids and seeds
  with the host reader's decode (``core.dither``);
* the float encode (K1, and K5 through ``reuse_q``) at random pixel
  counts, periodic or not, one draw in two with a value beyond the range,
  with ``spec.encode_float_block``; K1 must not certify that block.

It prints a report and exits non-zero at the first divergence.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from minnow_torch.core import spec
from minnow_torch.ops import bitpack, codec, decode, encode
from minnow_torch.ops.selfcheck import (payload_of, spec_decode_float,
                                        words_of)
from minnow_torch.utils.device import card_info, cuda_device


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _check(ok, *what) -> None:
    if not ok:
        raise AssertionError("diverges: %s" % (what,))


def one_int_pack(rng, device, bits=None):
    fixed = bits is not None
    if not fixed:
        bits = int(rng.integers(1, 65))
    n = 4091 if fixed else int(rng.integers(1, 5000))
    bsz = 2 if fixed else int(rng.integers(1, 4))
    hi_excl = (1 << bits) - 1 if bits == 64 else (1 << bits)
    vals = rng.integers(0, hi_excl, (bsz, n), dtype=np.uint64)
    mins = rng.integers(-(2 ** 50), 2 ** 50, bsz).astype(np.int64)
    x = vals.view(np.int64) + mins[:, None]
    lens = rng.integers(0, n + 1, bsz).astype(np.int64)
    offsets, total = bitpack.block_layout(np.full(bsz, bits), lens)
    plan = encode.Plan(mins=mins, maxd=np.zeros(bsz, np.int64),
                       bits=np.full(bsz, bits, np.int64),
                       valid=np.ones(bsz, bool), m=np.zeros(bsz, np.int64),
                       offsets=offsets, total=total,
                       max_words=int(bitpack.words_per_block(
                           bits, lens).max()))
    words = encode.delta_pack_int(_put(x, device), _put(lens, device),
                                  plan).cpu().numpy()
    for i in range(bsz):
        m = int(lens[i])
        ref = spec.pack_bits(vals[i, :m], bits)
        _check(payload_of(words, plan, i, m) == ref, "int_pack", bits, n, i)
        if m:
            back = decode.decode_int_group(
                _put(bitpack.bytes_to_words(ref, bits, m).view(np.int32)
                     [None], device), _put(mins[i:i + 1], device), bits, m)
            _check(np.array_equal(back[0].cpu().numpy(), x[i, :m]),
                   "int_unpack", bits, n, i)


def one_uniform(rng, device, bits=None):
    fixed = bits is not None
    if not fixed:
        bits = int(rng.integers(2, 25))
    n = 4096 if fixed else int(rng.integers(1, 6000))
    bsz = 2 if fixed else int(rng.integers(1, 4))
    pixels = min((1 << bits) - 1, (1 << 24) - 1)
    vals = rng.integers(0, pixels, (bsz, n), dtype=np.uint64)
    words = words_of(vals, bits)
    mins = rng.integers(-3, 4, bsz).astype(np.int64)
    low = rng.uniform(-1000, 1000, bsz).astype(np.float32)
    high = (low + rng.uniform(0.5, 5000, bsz)).astype(np.float32)
    per = rng.integers(0, 2, bsz).astype(bool)
    ids = rng.integers(0, 1 << 50, bsz).astype(np.int64)
    sd = int(rng.integers(0, 1000))
    params = codec.block_params(low, high, np.full(bsz, pixels), per, device)
    got = decode.decode_float_group(
        _put(words.view(np.int32), device), _put(mins, device), params, bits,
        n, "uniform", *codec.dither_keys(ids, sd, device)).cpu().numpy()
    for i in range(bsz):
        ref = spec_decode_float(words[i], int(mins[i]), bits, n, low[i],
                                high[i], pixels, bool(per[i]), "uniform", sd,
                                int(ids[i]))
        _check(np.array_equal(ref.view(np.uint32), got[i].view(np.uint32)),
               "uniform", bits, n, bsz, sd)


def one_float_encode(rng, device, bits=None):
    """K1 and K5 against ``spec.encode_float_block``: random width, pixel
    count, periodicity and data class."""
    fixed = bits is not None
    if not fixed:
        bits = int(rng.integers(2, 25))
    n = 4096 if fixed else int(rng.integers(1, 6000))
    bsz = 2 if fixed else int(rng.integers(1, 4))
    if fixed:
        pixels = min((1 << bits) - 1, (1 << 24) - 1)
        low, high = 0.0, 1000.0
        periodic = bool(bits % 2)
    else:
        pixels = int(rng.integers(3, min((1 << bits), 1 << 24)))
        low = float(rng.uniform(-1000, 1000))
        high = low + float(rng.uniform(0.5, 5000))
        periodic = bool(rng.integers(0, 2))
    span = np.float32(high) - np.float32(low)
    x = (low + rng.uniform(0, 1, (bsz, n)).astype(np.float32)
         * (span * np.float32(0.999))).astype(np.float32)
    beyond = bool(rng.integers(0, 2))
    if beyond:
        x[0, int(rng.integers(0, n))] = high + 1.0  # beyond the range
    lens = rng.integers(0, n + 1, bsz).astype(np.int64)
    lens[0] = n
    params = codec.block_params(np.full(bsz, low), np.full(bsz, high),
                                np.full(bsz, pixels), np.full(bsz, periodic),
                                device)
    xt, lt = _put(x, device), _put(lens, device)
    words, plan = encode.encode_float_group(xt, params, lt)
    words_q, plan_q = encode.encode_float_group(xt, params, lt, reuse_q=True)
    _check(all(np.array_equal(a, b) for a, b in zip(plan, plan_q))
           and torch.equal(words, words_q), "reuse_q", bits, n, pixels)
    words = words.cpu().numpy()
    if beyond and periodic:
        _check(not plan.valid[0], "certified a pixel beyond the range", bits,
               n, pixels)
    for i in np.nonzero(plan.valid)[0]:
        m = int(lens[i])
        payload, mn, width, _ = spec.encode_float_block(
            x[i, :m], low, high, pixels, periodic=periodic)
        _check((int(plan.mins[i]), int(plan.bits[i])) == (mn, width)
               and payload_of(words, plan, i, m) == payload,
               "float_encode", bits, n, pixels, periodic, int(i))


CASES = (one_int_pack, one_uniform, one_float_encode)


def random_draws(n_seeds: int, dev) -> None:
    """``n_seeds`` random draws of each case."""
    t0 = time.time()
    for seed in range(n_seeds):
        rng = np.random.default_rng(31337 + seed)
        for case in CASES:
            case(rng, dev)
        if (seed + 1) % 10 == 0:
            print("seed %d/%d ok (%.0fs)" % (seed + 1, n_seeds,
                                             time.time() - t0), flush=True)
    print("SOAK OK: %d seeds, %.0fs" % (n_seeds, time.time() - t0),
          flush=True)


def width_sweep(reps: int, dev) -> None:
    """Every-width sweep: int pack and unpack 1-64, uniform decode and
    float encode 2-24; fixed shapes and configs per width, random data per
    rep."""
    t0 = time.time()
    for bits in range(1, 65):
        for rep in range(reps):
            one_int_pack(np.random.default_rng(9173 + 1000 * bits + rep),
                         dev, bits=bits)
    print("int pack and unpack: widths 1..64 ok x%d (%.1fs)"
          % (reps, time.time() - t0), flush=True)
    for bits in range(2, 25):
        for rep in range(reps):
            rng = np.random.default_rng(7411 + 1000 * bits + rep)
            one_uniform(rng, dev, bits=bits)
            one_float_encode(rng, dev, bits=bits)
    print("SWEEP OK: %d widths int, %d widths float, %d reps, %.1fs"
          % (64, 23, reps, time.time() - t0), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_seeds, reps, device = 100, 2, "cuda"
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--device" and val in ("cuda", "cpu"):
            device = val
        elif key == "--reps" and val.isdigit():
            reps = int(val)
        elif a.isdigit():
            n_seeds = int(a)
        else:
            raise SystemExit(__doc__)
    if device == "cuda":
        dev = cuda_device()
        print("on the card, the CUDA kernels: %s; nvidia-smi: %s"
              % (torch.cuda.get_device_name(0), card_info()), flush=True)
    else:
        dev = torch.device("cpu")
        print("on the CPU, the kernels' plain versions", flush=True)
    random_draws(n_seeds, dev)
    if reps:
        width_sweep(reps, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
