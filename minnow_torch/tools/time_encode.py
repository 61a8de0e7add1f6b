"""Times of the float encode (K1, K5), the int encode (K3), the float
decode (K2) and the int unpack (K4) on one CUDA card, for one checkout or
for two in turns.

    python3 minnow_torch/tools/time_encode.py [--reps N] [--root DIR]
    python3 minnow_torch/tools/time_encode.py --compare OTHER_CHECKOUT
                                              [--pairs N] [--reps N]

With ``--compare`` the script runs itself as a subprocess on the other
checkout and on this one in turns, ``--pairs`` times over (3 unless told
otherwise), each run building its own kernels, and prints the two
checkouts' times side by side, then each checkout's median and range: a
before and after inside one run, on one card.  One process to the next the
same build's times move by several per cent, so one pair decides nothing.
Every run also counts the SASS instructions of each function of the
library it built (``cuobjdump -sass`` from beside nvcc, under the
function's mangled name), which do not move with the card.  It uses only
what both generations of ``minnow_torch.ops.encode``
have (``float_stats``, ``plan_float``, ``pack_float``, ``pack_float_q``,
``encode_float_group``, ``encode_int_group``, ``plan_int``,
``delta_pack_int``, ``decode.decode_float_group``,
``decode.decode_int_group``), and K1's plan launch and K3's stats and
plan launches where there are.

Shapes, all CUDA events, median of N after warm-up:

* flagship: 4096 blocks x 2^17 elements, periodic, 250,000 pixels (18
  bits): each launch alone, the whole call, the ``reuse_q`` call, the host
  plan on the host clock, K2's ``uniform`` decode of K1's words, and at
  18, 37, 54 and 64 bits the int encode's call (CUDA events and host
  clock), ``plan_int`` on the host clock, K3's pack by that host plan,
  ``torch.aminmax`` over the same rows (a call, and 10 in a CUDA graph)
  and, where the checkout has them, K3's stats, plan and pack launches
  each alone (the stats launch also 10 in a graph, without the host),
  and K4 on K3's words (checked to give K3's input back);
* text_to_minh: the 8 float columns of one row-block of 853,007 halos
  (two log columns, three periodic positions, three velocities);
* minh_to_bnd: one position column of 512 ragged cells of 3,619..4,026;
* convert_snapshot: one axis of a minp file, 512 blocks of 4,096.

For the last three the whole call only, and beside it the host's wall
time of the call (it ends in a device-to-host copy of the plan).  The int
encode's call and host wall time also at the int shapes of the main
paths: text_to_minh's two int columns of a row-block (2, 853,007),
minh_to_bnd's ID column of 512 ragged cells at 20 bits and the same cells
at 54 bits, and a multi-process rank's ID batch (3, 126,096) at 37 bits;
where the checkout has K3's three launches, also those launches alone,
20 times over in one CUDA graph, a replay over 20, and the call's stages
on the host clock, median of 50: the check of lens, each launch until it
returns, and the plan's read, which waits for the pack.  Each shape also gets
its bound: the bytes of x (its live elements, for ints) and of the
packed words over the H100's 3.35 TB/s of device memory.  The last lines
are the nvidia-smi line and one JSON object.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np


def _batches(rng):
    """name -> (x, low, high, pixels, periodic, lens) as numpy."""
    out = {}
    n = 853_007
    cols = [(5.0, 16.0, 0.001, False), (-2.0, 5.0, 0.001, False)] \
        + [(0.0, 250.0, 0.001, True)] * 3 + [(-1e4, 1e4, 0.1, False)] * 3
    low = np.array([c[0] for c in cols], np.float32)
    high = np.array([c[1] for c in cols], np.float32)
    pixels = np.array([np.ceil(np.float32(h - lo) / np.float32(c[2]))
                       for c, lo, h in zip(cols, low, high)], np.int64)
    x = np.stack([rng.uniform(lo, h, n) for lo, h in zip(low, high)])
    out["text_to_minh (8, 853007)"] = (
        x.astype(np.float32), low, high, pixels,
        np.array([c[3] for c in cols]), np.full(8, n, np.int64))
    lens = rng.integers(3619, 4027, 512)
    lens[0] = 4026
    x = rng.uniform(0, 249.9, (512, 4026)).astype(np.float32)
    x[np.arange(4026)[None, :] >= lens[:, None]] = 0
    out["minh_to_bnd (512, <=4026)"] = (
        x, np.zeros(512), np.full(512, 250.0), np.full(512, 250000),
        np.ones(512, bool), lens)
    out["convert_snapshot (512, 4096)"] = (
        rng.uniform(0, 249.9, (512, 4096)).astype(np.float32),
        np.zeros(512), np.full(512, 250.0), np.full(512, 250000),
        np.ones(512, bool), np.full(512, 4096, np.int64))
    return out


def bound_ms(x, words):
    """The least milliseconds for reading ``x`` and writing ``words`` once
    at 3.35 TB/s."""
    return (x.numel() + words.numel()) * 4 / 3.35e12 * 1e3


def _int_batches(rng):
    """name -> (x, lens) as numpy: the int batches of the main paths."""
    from minnow_torch.tools import multiprocess_gather_check as mp

    out = {}
    n = 853_007
    out["text_to_minh ints (2, 853007)"] = (np.stack([
        np.where(rng.random(n) < 0.8, -1, rng.integers(3e9, 4e9, n)),
        rng.integers(0, 6, n)]), np.full(2, n, np.int64))
    lens = rng.integers(3619, 4027, 512)
    lens[0], lens[256] = 4026, 0
    live = np.arange(4026)[None, :] < lens[:, None]
    for bits in (20, 54):
        x = (1 << 53) + 1 + rng.integers(0, 1 << bits, (512, 4026))
        out["minh_to_bnd ids (512, <=4026) %d bits" % bits] = (
            np.where(live, x, 0), lens)
    blocks = mp.make_catalog(999_888)
    ib, ilens = mp.rank_batches(blocks, range(3))[:2]
    out["rank 0 ids (%d, %d)" % ib.shape] = (ib, ilens)
    return out


def sass_counts(lib_path, nvcc):
    """Mangled function name -> SASS instructions in the library at
    ``lib_path``, by the ``cuobjdump`` beside ``nvcc``; a function whose
    arguments are the same in two checkouts has the same name in both."""
    text = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib_path],
        check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            # a file-local function's name holds a hash of its build
            name = re.sub(r"__N__[0-9a-f]{8}_", "__N__", fn.group(1))
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def measure(reps):
    import torch

    from minnow_torch.ops import _build, codec, decode, encode
    from minnow_torch.utils.device import (card_info, cuda_device, graph_ms,
                                           time_ms)

    dev = cuda_device()
    group = encode.encode_float_group
    has_capacity = "capacity" in inspect.signature(group).parameters

    def call(x, params, lens, capacity, **kw):
        if has_capacity:
            kw["capacity"] = capacity
        return group(x, params, lens, **kw)

    def wall_ms(fn):
        ts = []
        for _ in range(reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts[2:]))

    def call_stages(x, lens, total, reps=50):
        """Host-clock ms of each stage of the int encode's call, median
        of ``reps``: the check of lens (two reads to the host), each of
        the three launches (the call returns when the launch is queued),
        and the plan's read (which waits for the pack)."""
        names = ("check lens", "stats launch", "plan launch",
                 "pack launch", "plan read")
        ts = []
        for _ in range(reps + 2):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            encode._check_lens(lens, x.shape[1])
            t.append(time.perf_counter())
            stats = encode._launch_int_stats(x, lens)
            t.append(time.perf_counter())
            dplan = encode._launch_int_plan(stats, lens)
            t.append(time.perf_counter())
            encode._launch_int_pack(x, lens, dplan, total)
            t.append(time.perf_counter())
            encode.read_plan(dplan)
            t.append(time.perf_counter())
            ts.append(np.diff(t) * 1e3)
        med = np.median(np.array(ts[2:]), axis=0)
        return {"K3 call stage, host clock: " + k: float(v)
                for k, v in zip(names, med)}

    out = {"card": card_info()}
    b, n = 4096, 1 << 17
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.rand((b, n), generator=gen, device=dev) * 249.9
    params = codec.block_params(np.zeros(b), np.full(b, 250.0),
                                np.full(b, 250000), np.ones(b, bool), dev)
    lens = torch.full((b,), n, dtype=torch.int64, device=dev)
    capacity = b * ((18 * n + 31) // 32)
    stats = encode.float_stats(x, params, lens)
    plan = encode.plan_float(stats, params, lens)
    if not (plan.bits == 18).all():
        raise AssertionError("flagship widths %s" % set(plan.bits))
    q = torch.empty((b, n), dtype=torch.int32, device=dev)
    t = {"stats launch": time_ms(
             lambda: encode.float_stats(x, params, lens), reps),
         "pack launch": time_ms(
             lambda: encode.pack_float(x, params, lens, plan), reps),
         "stats launch storing pixels": time_ms(
             lambda: encode.float_stats(x, params, lens, q_out=q), reps),
         "K5": time_ms(
             lambda: encode.pack_float_q(q, params, lens, plan), reps),
         "K1 call": time_ms(lambda: call(x, params, lens, capacity), reps),
         "K1 call, host clock": wall_ms(
             lambda: call(x, params, lens, capacity)),
         "reuse_q call": time_ms(
             lambda: call(x, params, lens, capacity, reuse_q=True), reps),
         "plan_float, host clock": wall_ms(
             lambda: encode.plan_float(stats, params, lens))}
    if hasattr(encode, "float_plan"):
        t["plan launch"] = time_ms(
            lambda: encode.float_plan(stats, params, lens), reps)
    words = call(x, params, lens, capacity)[0]
    t["bound"] = bound_ms(x, words)
    out["flagship words checksum"] = int(words.to(torch.int64).sum())
    del x, q
    w2d = words[:capacity].view(b, capacity // b)
    mins = torch.from_numpy(plan.mins).to(dev)
    k1, k2 = codec.dither_keys(np.arange(b), 0, dev)

    def dec():
        return decode.decode_float_group(w2d, mins, params, 18, n, "uniform",
                                         k1, k2)

    t["K2 uniform decode"] = time_ms(dec, reps)
    out["flagship decode checksum"] = int(
        dec().view(torch.int32).to(torch.int64).sum())
    del words, w2d
    torch.cuda.empty_cache()

    # K3 at 18, 37, 54 and 64 bits, and K4 on its words
    launches = hasattr(encode, "start_int_group")
    for bits, lo in ((18, 1 << 53), (37, -(1 << 62)), (54, -(1 << 62)),
                     (64, -(1 << 63))):
        xi = torch.randint(0, 1 << min(bits, 62), (b, n), generator=gen,
                           device=dev, dtype=torch.int64) + lo
        xi[:, 0], xi[:, 1] = lo, lo + (1 << bits) - 1
        iwords, iplan = encode.encode_int_group(xi, lens)
        if not (iplan.bits == bits).all():
            raise AssertionError("K3 widths %s" % set(iplan.bits))
        at = " at %d bits" % bits
        t["K3 call" + at] = time_ms(
            lambda: encode.encode_int_group(xi, lens), reps)
        t["K3 call, host clock" + at] = wall_ms(
            lambda: encode.encode_int_group(xi, lens))
        t["plan_int, host clock" + at] = wall_ms(
            lambda: encode.plan_int(xi, lens))
        t["K3 pack by the host plan" + at] = time_ms(
            lambda: encode.delta_pack_int(xi, lens, iplan), reps)
        if launches:
            istats = encode.int_stats(xi, lens)
            dplan = encode.int_plan(istats, lens)
            t["K3 stats launch" + at] = time_ms(
                lambda: encode.int_stats(xi, lens), reps)
            t["K3 stats launch alone, graph of 10" + at] = graph_ms(
                lambda: encode._launch_int_stats(xi, lens), 10, reps)
            t["K3 plan launch" + at] = time_ms(
                lambda: encode.int_plan(istats, lens), reps)
            t["K3 pack launch" + at] = time_ms(
                lambda: encode._launch_int_pack(xi, lens, dplan,
                                                iplan.total), reps)
            del istats, dplan
        t["torch.aminmax" + at] = time_ms(
            lambda: torch.aminmax(xi, dim=1), reps)
        t["torch.aminmax alone, graph of 10" + at] = graph_ms(
            lambda: torch.aminmax(xi, dim=1), 10, reps)
        t["K3 bound" + at] = (xi.numel() * 8 + iwords.numel() * 4) \
            / 3.35e12 * 1e3
        out["K3 words checksum" + at] = int(iwords.to(torch.int64).sum())
        i2d = iwords.view(b, -1)
        imins = torch.from_numpy(iplan.mins).to(dev)

        def unpack():
            return decode.decode_int_group(i2d, imins, bits, n)

        if not torch.equal(unpack(), xi):
            raise AssertionError("K4 at %d bits: not K3's input" % bits)
        t["K4 at %d bits" % bits] = time_ms(unpack, reps)
        del xi, iwords, i2d
        torch.cuda.empty_cache()
    out["flagship (4096, 131072)"] = t

    for name, (xn, low, high, pixels, periodic, ln) in _batches(
            np.random.default_rng(3)).items():
        params = codec.block_params(low, high, pixels, periodic, dev)
        xt = torch.from_numpy(xn).to(dev)
        lt = torch.from_numpy(ln).to(dev)
        widest = np.where(periodic, [int(p - 1).bit_length() for p in pixels],
                          32)
        capacity = int(((widest * ln + 31) // 32).sum())
        words, plan = call(xt, params, lt, capacity)
        out[name] = {
            "K1 call": time_ms(lambda: call(xt, params, lt, capacity), reps),
            "K1 call, host clock": wall_ms(
                lambda: call(xt, params, lt, capacity)),
            "bound": bound_ms(xt, words),
            "words checksum": int(words.to(torch.int64).sum()),
            "widths": sorted({int(v) for v in plan.bits})}
    for name, (xn, ln) in _int_batches(np.random.default_rng(4)).items():
        xt = torch.from_numpy(xn).to(dev)
        lt = torch.from_numpy(ln).to(dev)
        words, plan = encode.encode_int_group(xt, lt)
        out[name] = {
            "K3 call": time_ms(lambda: encode.encode_int_group(xt, lt), reps),
            "K3 call, host clock": wall_ms(
                lambda: encode.encode_int_group(xt, lt)),
            "bound": (int(ln.sum()) * 8 + words.numel() * 4) / 3.35e12 * 1e3,
            "words checksum": int(words.to(torch.int64).sum()),
            "widths": sorted({int(v) for v in plan.bits})}
        if launches:
            out[name]["K3 launches, graph of 20"] = graph_ms(
                lambda: encode._launch_int_encode(xt, lt, plan.total),
                reps=reps)
            out[name].update(call_stages(xt, lt, plan.total))
    out["SASS instructions"] = sass_counts(_build.load()._name,
                                           _build._nvcc())
    return out


def compare(other, reps, pairs):
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    runs = []
    for label, root in (("other", other), ("this", here)) * pairs:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--reps", str(reps)], check=True, capture_output=True,
            text=True, timeout=900)
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    print("ms; columns: %s (in the order run)"
          % ", ".join(label for label, _ in runs))
    for shape, first in runs[0][1].items():
        if not isinstance(first, dict):
            if len({json.dumps(r[shape]) for _, r in runs}) != 1:
                raise AssertionError("%s differs between the runs: %s"
                                     % (shape, [r[shape] for _, r in runs]))
            continue
        keys = []
        for _, r in runs:
            keys += [k for k in r[shape] if k not in keys]
        for k in keys:
            vals = [r[shape].get(k) for _, r in runs]
            if isinstance(vals[0] if vals[0] is not None else vals[1], float):
                print("%s | %s | %s" % (shape, k, " | ".join(
                    "-" if v is None else "%.4f" % v for v in vals)))
                for label in ("other", "this"):
                    own = [v for (lb, _), v in zip(runs, vals)
                           if lb == label and v is not None]
                    if own:
                        print("%s | %s | %s: median %.4f (%.4f to %.4f)"
                              % (shape, k, label, statistics.median(own),
                                 min(own), max(own)))
            elif shape == "SASS instructions":
                print("%s | %s | %s" % (shape, k, " | ".join(
                    "-" if v is None else "%d" % v for v in vals)))
            elif len({json.dumps(v) for v in vals}) != 1:
                raise AssertionError("%s, %s differs between the runs: %s"
                                     % (shape, k, vals))
    print(runs[0][1]["card"])
    print(json.dumps({"order": [label for label, _ in runs],
                      "runs": [r for _, r in runs]}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--root", default=None,
                    help="the checkout whose minnow_torch is timed")
    ap.add_argument("--compare", default=None,
                    help="another checkout to time in turns with this one")
    ap.add_argument("--pairs", type=int, default=3,
                    help="with --compare: other, this, that many times")
    args = ap.parse_args(argv)
    if args.compare:
        compare(os.path.abspath(args.compare), args.reps, args.pairs)
        return
    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(root))
    out = measure(args.reps)
    print(out["card"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
