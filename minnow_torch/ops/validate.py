"""Numeric-exactness validation on the actual device (counterpart of
``minnow_tpu/ops/validate.py``).

The on-disk format is defined by IEEE float32 arithmetic (``core/spec.py``);
this module proves, at run time on the device it is given, that the device
codec reproduces it bitwise: on a CUDA device the kernels K1 to K5, on the
CPU their plain versions.  Any mismatch raises AssertionError: a failure
of the byte-exactness contract, not a tolerance issue, and nothing is
rerouted because of it.

What the checks guard, on any backend:

* the quantize is one IEEE float32 subtraction and one IEEE float32
  division (no reciprocal, no flush to zero), floored;
* the dequantize rounds ``dx * v`` and ``+ low`` separately: an FMA
  contraction would merge two roundings into one (the config
  (5, 16, 0.001) with q = 6276 is the regression case);
* pack and unpack place every bit where ``spec.pack_bits`` does, at every
  width.

``validate_quantize_fast`` of the reference has no counterpart: there is
no ``fastdiv`` here.  The kernel section covers every width (1..32 float,
0..64 int) with ragged and non-periodic blocks; the reference cut it to
one width per structural class only to bound its remote compiles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec
from ..utils.device import cuda_device
from . import bitpack, codec, decode, encode
from .selfcheck import (check_ragged, payload_of, spec_decode_float,
                        wide_float_blocks, words_of)

__all__ = ["validate_quantize", "validate_dequantize", "validate_pack",
           "validate_kernels", "validate_backend"]


def _rand_f32(rng, n, lo, hi):
    return rng.uniform(lo, hi, n).astype(np.float32)


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _device_quantize(x, low, high, pixels, device) -> np.ndarray:
    """The device's pixel of each element of ``x``: what K1's stats launch
    stores (one non-periodic block, so nothing is range-checked)."""
    params = codec.block_params([low], [high], [pixels], [False], device)
    xt = _put(x[None, :], device)
    lens = torch.tensor([len(x)], dtype=torch.int64, device=device)
    q = torch.zeros(xt.shape, dtype=torch.int32, device=device)
    encode.float_stats(xt, params, lens, q_out=q)
    return q[0].cpu().numpy().astype(np.int64)


def validate_quantize(device, n: int = 200_000, seed: int = 0) -> None:
    """Device quantize == host spec quantize, bit for bit, on random and
    boundary-adversarial inputs."""
    rng = np.random.default_rng(seed)
    for low, high, dx in [(0.0, 250.0, 0.001), (-50.0, 100.0, 1.0),
                          (0.0, 1.0, 1 / 7), (1.0, 5.0, 1e-4),
                          (5.0, 16.0, 0.001)]:
        pixels = spec.float_group_pixels(low, high, dx)
        x = _rand_f32(rng, n, low, high)
        want = spec.quantize(x, low, high, pixels)
        got = _device_quantize(x, low, high, pixels, device)
        bad = np.nonzero(got != want)[0]
        if bad.size:
            raise AssertionError(
                "device quantize diverges from spec: %d/%d mismatches, "
                "first at x=%.9g (want %d got %d) [low=%g high=%g px=%d]"
                % (bad.size, n, x[bad[0]], want[bad[0]], got[bad[0]],
                   low, high, pixels))

    # adversarial: values engineered one ulp around every pixel boundary
    low, high, pixels = np.float32(0), np.float32(1), 4093
    dxq = spec.quantize_dx(low, high, pixels)
    ks = rng.integers(1, pixels, max(n // 4, 1))
    grid = (ks.astype(np.float32) * dxq).astype(np.float32)
    x = np.concatenate([np.nextafter(grid, np.float32(-np.inf)), grid,
                        np.nextafter(grid, np.float32(np.inf))])
    want = spec.quantize(x, low, high, pixels)
    got = _device_quantize(x, low, high, pixels, device)
    if not np.array_equal(got, want):
        bad = np.nonzero(got != want)[0]
        raise AssertionError(
            "device quantize diverges at pixel boundaries: %d mismatches "
            "(e.g. x=%.9g want %d got %d)" % (bad.size, x[bad[0]],
                                              want[bad[0]], got[bad[0]]))


def validate_dequantize(device, n: int = 200_000, seed: int = 1) -> None:
    """Device dequantize (dither=none) == host spec, bit for bit: K2 on
    the packed pixels.  The (5, 16, 0.001) config with q=6276 is the
    FMA-contraction regression case."""
    rng = np.random.default_rng(seed)
    for low, high, dx in [(0.0, 250.0, 0.001), (-50.0, 100.0, 0.25),
                          (5.0, 16.0, 0.001)]:
        pixels = spec.float_group_pixels(low, high, dx)
        q = rng.integers(0, pixels, n)
        q[0] = min(6276, pixels - 1)
        want = spec.dequantize(q, low, high, pixels)
        bits = spec.precision_needed(pixels - 1)
        words = words_of(q.astype(np.uint64)[None, :], bits)
        params = codec.block_params([low], [high], [pixels], [False], device)
        got = decode.decode_float_group(
            _put(words.view(np.int32), device),
            torch.zeros(1, dtype=torch.int64, device=device), params, bits,
            n, "none")[0].cpu().numpy()
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            bad = np.nonzero(got.view(np.int32) != want.view(np.int32))[0]
            raise AssertionError(
                "device dequantize diverges from spec: %d mismatches "
                "(likely FMA contraction; e.g. q=%d want %.9g got %.9g)"
                % (bad.size, q[bad[0]], want[bad[0]], got[bad[0]]))


def validate_pack(device, seed: int = 2) -> None:
    """Device pack bytes == spec pack bytes for a sample of widths (K3
    with zero minimums, each value masked to its width), and the device
    unpack (K4) gives the masked values back."""
    rng = np.random.default_rng(seed)
    n = 4097
    lens = torch.tensor([n], dtype=torch.int64, device=device)
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    for bits in (1, 7, 11, 18, 23, 32, 45, 64):
        x = rng.integers(0, 2**63, n, dtype=np.int64).view(np.uint64)
        want = spec.pack_bits(x, bits)
        nw = bitpack.words_per_block(bits, n)
        plan = encode.Plan(mins=np.zeros(1, np.int64),
                           maxd=np.zeros(1, np.int64),
                           bits=np.array([bits], np.int64),
                           valid=np.ones(1, bool), m=np.zeros(1, np.int64),
                           offsets=np.zeros(1, np.int64), total=nw,
                           max_words=nw)
        words = encode.delta_pack_int(_put(x.view(np.int64)[None, :], device),
                                      lens, plan)
        if bitpack.words_to_bytes(words.cpu().numpy(), bits, n) != want:
            raise AssertionError("device pack diverges at bits=%d" % bits)
        back = decode.decode_int_group(
            _put(bitpack.bytes_to_words(want, bits, n).view(np.int32)[None],
                 device), zero, bits, n)[0].cpu().numpy()
        mask = np.uint64(0xFFFFFFFFFFFFFFFF) if bits >= 64 \
            else np.uint64((1 << bits) - 1)
        if not np.array_equal(back.view(np.uint64), x & mask):
            raise AssertionError("device unpack diverges at bits=%d" % bits)


def _float_blocks(rng, k: int, n: int):
    """Four float blocks whose pixels span exactly ``k`` bits (1..32), at
    dx = 1 so that a pixel is its value: a non-periodic span, a periodic
    cluster (k <= 30), a ragged block and an empty one.  Returns
    ``(x, low, high, pixels, periodic, lens)``."""
    if k > 30:
        # pixels up to 2^31 - 128 (31 bits), from -2^31 + 128 on (32)
        lo, hi = (0, (1 << 31) - 128) if k == 31 \
            else (-(1 << 31) + 128, (1 << 31) - 128)
        x = np.floor(rng.uniform(lo, hi, (4, n))).astype(np.float32)
        x[:, :2] = (lo, hi)
        periodic = np.zeros(4, bool)
    else:
        top = (1 << k) - (1 << max(k - 24, 0))  # largest float32 below 2^k
        x = np.floor(rng.uniform(0, top, (4, n))).astype(np.float32)
        x[:, :2] = (0, top)
        x[1] += np.float32(1 << 29) if k < 29 else np.float32(0)
        periodic = np.array([0, 1, 0, 1], bool)
    p = 1 << 30
    return x, np.zeros(4, np.float32), np.full(4, float(p), np.float32), \
        np.full(4, p, np.int64), periodic, np.array([n, n, n - 7, 0],
                                                    np.int64)


def _payloads(words, plan, lens):
    words = words.cpu().numpy()
    return [payload_of(words, plan, i, int(n)) for i, n in enumerate(lens)]


def _validate_wide_pixels(rng, device, n: int) -> None:
    """K1, K5 and K2 == host spec at pixel counts of 2^31 and more
    (``selfcheck.wide_float_blocks``: periodic and non-periodic, a window
    over the circle's seam, ragged blocks); the block whose pixels pass
    an int32 must come back uncertified, and K2 decodes its 34-bit host
    payload like the others."""
    b = 12
    x, low, high, pixels, periodic, certified = wide_float_blocks(rng, b, n)
    lens = np.full(b, n, np.int64)
    lens[1::2] = n - 5
    params = codec.block_params(low, high, pixels, periodic, device)
    xt, lt = _put(x, device), _put(lens, device)
    words, plan = encode.encode_float_group(xt, params, lt)
    words_q, plan_q = encode.encode_float_group(xt, params, lt, reuse_q=True)
    if not np.array_equal(plan.valid, certified) \
            or not np.array_equal(plan_q.valid, certified):
        raise AssertionError("K1 certified %s at the wide pixel counts, "
                             "want %s" % (plan.valid, certified))
    got = _payloads(words, plan, lens)
    if got != _payloads(words_q, plan_q, lens) \
            or not np.array_equal(plan.mins, plan_q.mins):
        raise AssertionError("K5 (reuse_q) differs from K1 at the wide "
                             "pixel counts")
    ids = np.arange(b) + (1 << 35)
    keys = codec.dither_keys(ids, 7, device)
    for i in range(b):
        m = int(lens[i])
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :m], low[i], high[i], int(pixels[i]),
            periodic=bool(periodic[i]))
        if certified[i] and (got[i], int(plan.mins[i]),
                             int(plan.bits[i])) != (payload, mn, bits):
            raise AssertionError("K1 diverges from spec at %d pixels, "
                                 "block %d" % (pixels[i], i))
        row = bitpack.bytes_to_words(payload, bits, m)
        args = (_put(row.view(np.int32)[None], device),
                _put(np.array([mn], np.int64), device),
                codec.BlockParams(*(v[i:i + 1] for v in params)), bits, m)
        for mode in codec.DITHER_MODES:
            dec = decode.decode_float_group(
                *args, mode, keys[0][i:i + 1], keys[1][i:i + 1])
            want = spec_decode_float(row, mn, bits, m, low[i], high[i],
                                     int(pixels[i]), bool(periodic[i]),
                                     mode, 7, int(ids[i]))
            if not np.array_equal(dec[0].cpu().numpy().view(np.int32),
                                  want.view(np.int32)):
                raise AssertionError("K2 %s decode diverges from spec at "
                                     "%d pixels, block %d"
                                     % (mode, pixels[i], i))


def validate_kernels(device, n: int = 2051, seed: int = 5) -> dict:
    """Every kernel == host spec, byte for byte, on the actual device, at
    every width: K1 and K5 (float encode, widths 1..32; K5 through
    ``reuse_q``), K2 (float decode of K1's own payloads in ``none``,
    ``midpoint`` and ``uniform``), K3 (int delta pack, widths 1..64, IDs
    above 2^53 and minimums down to -2^63) and K4 (int unpack, widths
    0..64; both also through the ragged entry the bulk reads take, on a
    column of mixed widths at odd byte offsets).  Ragged, empty and
    non-periodic blocks ride in every batch; a block with a NaN must come
    back uncertified.  K1, K5 and K2 are
    also held at pixel counts of 2^31 and more.  Returns the widths
    each kernel was held at."""
    rng = np.random.default_rng(seed)
    seen = {"K1": set(), "K2": set(), "K3": set(), "K4": set(), "K5": set()}

    for k in range(1, 33):
        x, low, high, pixels, periodic, lens = _float_blocks(rng, k, n)
        params = codec.block_params(low, high, pixels, periodic, device)
        xt, lt = _put(x, device), _put(lens, device)
        words, plan = encode.encode_float_group(xt, params, lt)
        words_q, plan_q = encode.encode_float_group(xt, params, lt,
                                                    reuse_q=True)
        if not plan.valid.all():
            raise AssertionError("K1 failed to certify in-range blocks at "
                                 "%d bits" % k)
        got = _payloads(words, plan, lens)
        if got != _payloads(words_q, plan_q, lens) \
                or not np.array_equal(plan.mins, plan_q.mins):
            raise AssertionError("K5 (reuse_q) differs from K1 at %d bits"
                                 % k)
        ids = np.arange(4) + (1 << 33) * k
        keys = codec.dither_keys(ids, k, device)
        for i in range(4):
            m = int(lens[i])
            payload, mn, bits, _ = spec.encode_float_block(
                x[i, :m], low[i], high[i], int(pixels[i]),
                periodic=bool(periodic[i]))
            if (int(plan.mins[i]), int(plan.bits[i])) != (mn, bits):
                raise AssertionError(
                    "K1 stats diverge from spec at %d bits, block %d (min "
                    "%d want %d, bits %d want %d)"
                    % (k, i, plan.mins[i], mn, plan.bits[i], bits))
            if got[i] != payload:
                raise AssertionError("K1 payload diverges from spec at %d "
                                     "bits, block %d" % (k, i))
            seen["K1"].add(bits)
            seen["K5"].add(bits)
            if m == 0:
                continue
            row = bitpack.bytes_to_words(payload, bits, m)
            args = (_put(row.view(np.int32)[None], device),
                    _put(np.array([mn], np.int64), device),
                    codec.BlockParams(*(v[i:i + 1] for v in params)), bits,
                    m)
            for mode in codec.DITHER_MODES:
                dec = decode.decode_float_group(
                    *args, mode, keys[0][i:i + 1], keys[1][i:i + 1])
                want = spec_decode_float(row, mn, bits, m, low[i], high[i],
                                         int(pixels[i]), bool(periodic[i]),
                                         mode, k, int(ids[i]))
                if not np.array_equal(dec[0].cpu().numpy().view(np.int32),
                                      want.view(np.int32)):
                    raise AssertionError("K2 %s decode diverges from spec "
                                         "at %d bits, block %d"
                                         % (mode, bits, i))
            seen["K2"].add(bits)

    # a block K1 must not certify, beside valid ones
    x, low, high, pixels, periodic, lens = _float_blocks(rng, 18, n)
    x[0, n // 3] = np.nan
    _, plan = encode.encode_float_group(
        _put(x, device), codec.block_params(low, high, pixels, periodic,
                                            device), _put(lens, device))
    if plan.valid[0] or not plan.valid[1:].all():
        raise AssertionError("K1 certified a block with a NaN, or refused "
                             "its neighbours: %s" % plan.valid)

    _validate_wide_pixels(rng, device, n)

    rows, mins = [], []
    for bits in range(65):
        lo = (1 << 53) + 12345 if bits < 62 else -(1 << 63)
        d = rng.integers(0, (1 << 64) - 1 if bits == 64 else 1 << bits, n,
                         dtype=np.uint64) if bits else np.zeros(n, np.uint64)
        if bits:
            d[0], d[1] = 0, (1 << bits) - 1
        rows.append(d.view(np.int64) + np.int64(lo))
        mins.append(lo)
    xi = np.stack(rows)
    lens = np.full(65, n, np.int64)
    lens[::7] = n - 11
    words, plan = encode.encode_int_group(_put(xi, device),
                                          _put(lens, device))
    got = _payloads(words, plan, lens)
    for bits in range(65):
        m = int(lens[bits])
        payload, mn, width = spec.encode_int_block(xi[bits, :m])
        if (int(plan.mins[bits]), int(plan.bits[bits])) != (mn, width) \
                or width != bits:
            raise AssertionError("K3 plan diverges from spec at %d bits"
                                 % bits)
        if got[bits] != payload:
            raise AssertionError("K3 payload diverges from spec at %d bits"
                                 % bits)
        seen["K3"].add(bits)
        row = np.zeros(max(bitpack.words_per_block(bits, m), 1), np.uint32)
        if bits:
            row[:] = bitpack.bytes_to_words(payload, bits, m)
        dec = decode.decode_int_group(
            _put(row.view(np.int32)[None], device),
            _put(np.array([mn], np.int64), device), bits, m)[0].cpu().numpy()
        if not np.array_equal(dec, spec.decode_int_block(payload, mn, bits,
                                                         m)) \
                or not np.array_equal(dec, xi[bits, :m]):
            raise AssertionError("K4 diverges from spec at %d bits" % bits)
        seen["K4"].add(bits)

    # K2 and K4 through the ragged entry of the bulk reads: a column of
    # mixed widths at odd byte offsets, width-0 blocks among them
    check_ragged(device, tuple(codec.DITHER_MODES), seed, rng)

    want = {"K1": range(1, 33), "K2": range(1, 33), "K3": range(65),
            "K4": range(65), "K5": range(1, 33)}
    for name, widths in want.items():
        missing = sorted(set(widths) - seen[name])
        if missing:
            raise AssertionError("%s was not held at widths %s"
                                 % (name, missing))
    return {name: sorted(v) for name, v in seen.items()}


def validate_backend(device=None) -> dict:
    """Run all exactness checks on ``device`` (default: the CUDA device,
    an error without one).  Returns a small report dict; raises
    AssertionError on any divergence."""
    device = torch.device(cuda_device() if device is None else device)
    validate_quantize(device)
    validate_dequantize(device)
    validate_pack(device)
    widths = validate_kernels(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    report = {"backend": device.type, "device": name, "exact": True}
    report.update({k: True for k in widths})
    return report
