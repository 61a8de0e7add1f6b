"""A/B of the kernels' launch shapes on one CUDA card, and of a
block-major schedule of the float encode.

    python3 -m minnow_torch.tools.ab_launch [--reps N]

At the flagship block shape (4096 blocks x 2^17 elements, 18 bits) each
launch runs at every value of its sweep, in two passes of opposite order
(median of N each, CUDA events), and its output must be bitwise equal to
that at the shipped value.  The constants swept are
``encode.STATS_PER_THREAD`` (elements per thread of a run of K1's and of
K3's stats launch; K3's is timed alone, 10 in a CUDA graph, as
``torch.aminmax`` over the same rows beside it, and both also as a
call), ``decode.DECODE_PER_THREAD`` (K2, uniform and none) and
``decode.UNPACK_PER_THREAD`` (K4, on K3's words at 18 bits and at 54
bits); they are set back afterwards.  A 2 GiB device copy gives the
card's memory rate; K1's plan launch is timed beside the host's
``plan_float``, K3's plan launch alone and ``plan_int`` (K3's stats and
plan launches and one read) on the host clock, and the packs of K1, K5
and K3 (at 18 and at 54 bits), which size their own grids, one
persistent CTA for each the card holds, once.

The block-major schedule asks whether x can be read from device memory
once: the float encode runs chunk by chunk (K1's stats, plan and pack, or
with ``reuse_q`` the stats storing pixels, the plan and K5, on 8 to 64
blocks at a time, so that the pack's read of x or q hits the L2), as one
CUDA graph, which leaves out the host's cost of the many launches; its
time stands beside the whole-batch launches' in the same run.  Each
chunk packs into its own buffer: the words are those of the whole batch,
their offsets are not chained.

The last lines are the nvidia-smi line and one JSON object with every
time in milliseconds.  Compare numbers only within one run.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import codec, decode, encode
from ..utils.device import card_info, cuda_device, graph_ms, time_ms

SHAPE = (4096, 1 << 17)
SWEEPS = {
    "K1 stats": (encode, "STATS_PER_THREAD", [4, 8, 16, 32, 64]),
    "K3 stats": (encode, "STATS_PER_THREAD", [4, 8, 16, 32, 64]),
    "K2 uniform": (decode, "DECODE_PER_THREAD", [1, 2, 4, 8, 16, 32]),
    "K2 none": (decode, "DECODE_PER_THREAD", [1, 2, 4, 8, 16, 32]),
    "K4 18 bits": (decode, "UNPACK_PER_THREAD", [1, 2, 4, 8, 16, 32]),
    "K4 54 bits": (decode, "UNPACK_PER_THREAD", [1, 2, 4, 8, 16, 32]),
}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def sweep(label, fn, reps, timer=time_ms):
    """Times of ``fn`` at each value of ``label``'s sweep, two passes,
    by ``timer(fn, reps)``."""
    module, attr, values = SWEEPS[label]
    shipped = getattr(module, attr)
    want = _bits(fn())
    times = {v: [] for v in values}
    for order in (values, values[::-1]):
        for v in order:
            setattr(module, attr, v)
            if not torch.equal(_bits(fn()), want):
                raise AssertionError("%s at %d differs from %d"
                                     % (label, v, shipped))
            times[v].append(timer(fn, reps))
    setattr(module, attr, shipped)
    print("%s (shipped %d): %s" % (label, shipped, ", ".join(
        "%d: %.3f / %.3f ms" % (v, *t) for v, t in times.items())),
        flush=True)
    return {"shipped": shipped, "ms": times}


def graph_timer(fn, reps):
    """Milliseconds of one ``fn()`` alone: 10 in one CUDA graph."""
    return graph_ms(fn, 10, reps)


def pack_time(out, label, x, lens, reps):
    """K3's pack of ``x`` by its device plan, once."""
    dplan = encode.int_plan(encode.int_stats(x, lens), lens)
    total = encode.read_plan(dplan).total
    out[label] = time_ms(
        lambda: encode._launch_int_pack(x, lens, dplan, total), reps)
    print("%s: %.3f ms" % (label, out[label]), flush=True)


def unpack_sweep(out, label, x, lens, reps):
    """K4's sweep on K3's words of ``x``, after checking the round trip."""
    b, n = x.shape
    words, plan = encode.encode_int_group(x, lens)
    w2d = words.view(b, -1)
    mins = torch.from_numpy(plan.mins).to(x.device)
    bits = int(plan.bits[0])
    if not (plan.bits == bits).all():
        raise AssertionError("%s: widths %s" % (label, set(plan.bits)))

    def dec():
        return decode.decode_int_group(w2d, mins, bits, n)

    if not torch.equal(dec(), x):
        raise AssertionError("%s: the round trip differs" % label)
    out[label] = sweep(label, dec, reps)


def block_major(x, params, lens, want, reps):
    """Times of the float encode chunk by chunk, as one CUDA graph, and of
    the same launches on the whole batch; ``want`` is the (B, row) words
    every chunk's pack must reproduce."""
    b, n = x.shape
    row = want.shape[1]

    def launches(s, reuse_q, q):
        p = codec.BlockParams(*(v[s] for v in params))
        stats = encode._launch_stats(x[s], p, lens[s], q if reuse_q else None)
        plan = encode._launch_plan(stats, p, lens[s])
        return encode._launch_pack(q if reuse_q else x[s], p, lens[s], plan,
                                   (s.stop - s.start) * row)

    out = {}
    for reuse_q in (False, True):
        for chunk in (8, 16, 32, 64, b):
            q = torch.empty((chunk, n), dtype=torch.int32, device=x.device)
            slices = [slice(i, i + chunk) for i in range(0, b, chunk)]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                got = launches(slices[-1], reuse_q, q)
            torch.cuda.current_stream().wait_stream(side)
            if not torch.equal(got, want[slices[-1]].reshape(-1)):
                raise AssertionError("chunk of %d blocks, reuse_q %s: the "
                                     "words differ" % (chunk, reuse_q))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                kept = [launches(s, reuse_q, q) for s in slices]
            ms = time_ms(graph.replay, reps)
            label = "%s, %s" % ("reuse_q" if reuse_q else "K1",
                                "whole batch" if chunk == b
                                else "chunks of %d" % chunk)
            out[label] = ms
            print("block-major %s: %.3f ms (%d launches in the graph)"
                  % (label, ms, 3 * len(slices)), flush=True)
            del graph, kept, q
            torch.cuda.empty_cache()
    return out


def host_ms(fn, reps):
    """Median wall milliseconds of ``fn`` ending in a device sync."""
    out = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out[1:]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    reps = ap.parse_args(argv).reps
    dev = cuda_device()
    b, n = SHAPE
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.rand((b, n), generator=gen, device=dev) * 249.9
    params = codec.block_params(np.zeros(b), np.full(b, 250.0),
                                np.full(b, 250000), np.ones(b, bool), dev)
    lens = torch.full((b,), n, dtype=torch.int64, device=dev)
    out = {"shape": list(SHAPE), "bits": 18}
    out["copy_2GiB_ms"] = time_ms(lambda: x.clone(), reps)
    print("copy of 2 GiB f32 (4.3 GB moved): %.3f ms" % out["copy_2GiB_ms"],
          flush=True)

    stats = encode.float_stats(x, params, lens)
    out["plan_float_ms"] = host_ms(
        lambda: encode.plan_float(stats, params, lens), reps)
    out["float_plan_ms"] = time_ms(
        lambda: encode.float_plan(stats, params, lens), reps)
    plan = encode.plan_float(stats, params, lens)
    out["K1 stats"] = sweep("K1 stats",
                            lambda: encode.float_stats(x, params, lens), reps)
    out["K1 pack"] = time_ms(
        lambda: encode.pack_float(x, params, lens, plan), reps)
    q = torch.empty((b, n), dtype=torch.int32, device=dev)
    encode.float_stats(x, params, lens, q_out=q)
    out["K5"] = time_ms(
        lambda: encode.pack_float_q(q, params, lens, plan), reps)
    print("K1 pack %.3f ms, K5 %.3f ms" % (out["K1 pack"], out["K5"]),
          flush=True)
    del q
    words = encode.pack_float(x, params, lens, plan).view(b, -1)
    out["block_major"] = block_major(x, params, lens, words, reps)
    mins = torch.from_numpy(plan.mins).to(dev)
    k1, k2 = codec.dither_keys(np.arange(b), 0, dev)
    for mode in ("uniform", "none"):
        out["K2 " + mode] = sweep("K2 " + mode, lambda: decode.
                                  decode_float_group(words, mins, params, 18,
                                                     n, mode, k1, k2), reps)
    del x, words
    torch.cuda.empty_cache()

    xi = torch.randint(0, 1 << 18, (b, n), generator=gen, device=dev,
                       dtype=torch.int64) + (1 << 53)
    out["plan_int_ms"] = host_ms(lambda: encode.plan_int(xi, lens), reps)
    # the stats launch alone, without the wrapper's check of lens: a CUDA
    # graph of 10 launches, as torch.aminmax beside it
    out["K3 stats"] = sweep("K3 stats",
                            lambda: encode._launch_int_stats(xi, lens), reps,
                            timer=graph_timer)
    out["torch.aminmax"] = graph_timer(lambda: torch.aminmax(xi, dim=1),
                                       reps)
    out["K3 stats call"] = time_ms(lambda: encode.int_stats(xi, lens), reps)
    out["torch.aminmax call"] = time_ms(lambda: torch.aminmax(xi, dim=1),
                                        reps)
    print("torch.aminmax over the same rows: %.3f ms alone, %.3f ms a call "
          "(CUDA events around it); K3's stats call %.3f ms"
          % (out["torch.aminmax"], out["torch.aminmax call"],
             out["K3 stats call"]), flush=True)
    istats = encode.int_stats(xi, lens)
    out["K3 plan"] = time_ms(lambda: encode.int_plan(istats, lens), reps)
    pack_time(out, "K3 pack 18 bits", xi, lens, reps)
    unpack_sweep(out, "K4 18 bits", xi, lens, reps)
    del xi
    torch.cuda.empty_cache()
    # every block spans exactly 54 bits
    xw = torch.randint(0, 1 << 54, (b, n), generator=gen, device=dev,
                       dtype=torch.int64)
    xw[:, 0], xw[:, 1] = 0, (1 << 54) - 1
    pack_time(out, "K3 pack 54 bits", xw, lens, reps)
    unpack_sweep(out, "K4 54 bits", xw, lens, reps)
    print("plans: plan_float on the host %.3f ms, K1's plan launch %.3f "
          "ms, K3's plan launch %.3f ms, plan_int %.3f ms"
          % (out["plan_float_ms"], out["float_plan_ms"], out["K3 plan"],
             out["plan_int_ms"]))
    smi = card_info()
    out["card"] = smi
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
