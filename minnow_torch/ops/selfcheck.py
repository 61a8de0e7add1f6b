"""One-shot per-process certification of the kernel families (counterpart
of ``minnow_tpu/ops/selfcheck.py``).

The encoders and bulk readers launch the CUDA kernels without the full
``ops.validate.validate_backend`` run having happened in the process.  A
miscompiling toolchain or a broken card would then corrupt written files
and bulk reads silently.  So the first CUDA use of a kernel family in a
process (``parallel.pipeline.BlockEncoder``, ``formats.device_common``)
runs a small comparison of the kernels with the normative host codec
(``core.spec``) on that device, bitwise, and the verdict is cached.

Unlike the reference, a divergence is never answered by another route:
where the TPU package warns and falls back to XLA, :func:`kernel_ok`
raises :class:`SelfCheckError`, naming the family and the first
divergence, on this call and on every later one.  There is no switch
that skips the check.  On the CPU the wrappers run their plain versions,
which need no certificate, and the callers do not ask for one
(:func:`certify`); :func:`kernel_ok` itself runs on any device.

Families, as in the reference: ``encode`` (K1 at the flagship width, K3
-- its stats, plan and pack launches -- at 41 and 18 bits), ``decode`` (K2 in ``none`` and ``midpoint``, K4 at 18
and 41 bits) and ``decode_uniform`` (K2's counter-hash dither).  K1 and K2
are also held at pixel counts of 2^31 and more (:func:`wide_float_blocks`),
where the circle's arithmetic is 64-bit, and K2 and K4 through the ragged
entry the bulk reads take (:func:`check_ragged`: mixed widths, blocks at
odd byte offsets, width 0).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import dither as dither_mod
from ..core import spec
from ..utils.device import cuda_device
from . import bitpack, codec, decode, encode

__all__ = ["SelfCheckError", "kernel_ok", "certify", "reset",
           "spec_decode_float", "words_of", "payload_of", "FAMILIES",
           "wide_float_blocks", "ragged_columns", "check_ragged"]

# (family, device) -> None when it passed, the divergence when not
_VERDICTS: dict = {}
# serializes first-use checks: concurrent encoders (text_to_minh --device
# --jobs=N worker threads) must not each run the check on a shared miss
_LOCK = threading.Lock()

# device types whose kernels production paths certify before first use
_CERTIFIED_TYPES = ("cuda",)

# the flagship float config: L 250 at 0.001, 250,000 pixels, 18 bits
_LOW, _HIGH, _DX, _BITS = 0.0, 250.0, 0.001, 18
_N, _BLOCKS = 8192, 2
# elements of each block at the wide pixel counts
_WIDE_N = 2048


class SelfCheckError(RuntimeError):
    """A kernel family diverged from the normative codec on its device."""


def reset() -> None:
    """Clear cached verdicts (tests only)."""
    with _LOCK:
        _VERDICTS.clear()


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def words_of(values, bits: int) -> np.ndarray:
    """(B, n) uint64 values -> the (B, W) uint32 words of their streams at
    ``bits``, packed by ``spec.pack_bits``."""
    n = values.shape[1]
    return np.stack([bitpack.bytes_to_words(spec.pack_bits(v, bits), bits, n)
                     for v in values])


def spec_decode_float(words, mn: int, bits: int, n: int, low, high,
                      pixels: int, periodic: bool, mode: str = "none",
                      seed: int = 0, block: int = 0) -> np.ndarray:
    """The host reader's decode of one float block from its uint32 words
    (``core.groups.FloatGroup.read_data`` with ``core.dither``)."""
    q = spec.decode_int_block(bitpack.words_to_bytes(words, bits, n), mn,
                              bits, n)
    if periodic:
        q = spec.bound(q, 0, pixels)
    return spec.dequantize(q, low, high, pixels,
                           u=dither_mod.dither_u(mode, seed, block, n))


def _same(got, want, what: str) -> None:
    """Raise unless the arrays hold the same bits."""
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    if got.shape != want.shape:
        raise AssertionError("%s: shape %s, want %s"
                             % (what, got.shape, want.shape))
    bad = np.nonzero(got.view(np.uint8).reshape(-1)
                     != want.view(np.uint8).reshape(-1))[0]
    if bad.size:
        i = int(bad[0]) // got.itemsize
        raise AssertionError(
            "%s: %d of %d elements differ, first at %d (got %r, want %r)"
            % (what, len(np.unique(bad // got.itemsize)), got.size, i,
               got.reshape(-1)[i], want.reshape(-1)[i]))


def payload_of(words, plan, i: int, n: int) -> bytes:
    """The payload bytes of block ``i`` (``n`` elements) in the flat numpy
    word buffer of an encode, by its plan."""
    off, width = int(plan.offsets[i]), int(plan.bits[i])
    nw = bitpack.words_per_block(width, n)
    return bitpack.words_to_bytes(words[off:off + nw], width, n)


# the kinds of wide_float_blocks: (pixels, periodic, what the data does)
_WIDE_KINDS = (
    ((1 << 31) + 5, True, "straddle"),  # a window over the circle's seam
    (1 << 33, False, "inside"),
    (10 ** 10, True, "inside"),
    ((1 << 31) + 5, True, "inside"),    # too spread for a window: m = 0
    (1 << 31, False, "inside"),
    (10 ** 10, True, "beyond"),         # pixels past int32: not certified
)
_WIDE_LOW, _WIDE_HIGH = 0.0, 1.0e6


def wide_float_blocks(rng, b: int, n: int):
    """``b`` float blocks of ``n >= 2`` elements at pixel counts of 2^31
    and more, block ``i`` of kind ``i % 6``: 2^31 + 5 periodic with the
    data on both sides of the circle's seam (so that the distance from
    element 0 and the recentring offset take the count's 64 bits), 2^33
    non-periodic, 10^10 periodic, 2^31 + 5 periodic spread over half the
    circle and more, 2^31 non-periodic -- all with their pixels inside
    [0, 2^31), which K1 must certify -- and 10^10 periodic with pixels
    beyond 2^31, which it must not.  Returns ``(x, low, high, pixels,
    periodic, certified)``."""
    kinds = [_WIDE_KINDS[i % len(_WIDE_KINDS)] for i in range(b)]
    pixels = np.array([k[0] for k in kinds], np.int64)
    periodic = np.array([k[1] for k in kinds], bool)
    what = np.array([k[2] for k in kinds])
    low = np.full(b, _WIDE_LOW, np.float32)
    high = np.full(b, _WIDE_HIGH, np.float32)
    dx = np.array([spec.quantize_dx(_WIDE_LOW, _WIDE_HIGH, int(p))
                   for p in pixels], np.float32)
    # the values whose pixels lie 1024 below 2^31: room for the rounding
    # of this product and of the quantizer's division
    top = (np.float32((1 << 31) - 1024) * dx).astype(np.float64)
    x = rng.uniform(0.0, 1.0, (b, n)) * top[:, None]
    seam = what == "straddle"
    near = rng.uniform(0.0, 3.0, (b, n))
    x[seam, ::2] = near[seam, ::2]
    x[seam, 1::2] = top[seam, None] - near[seam, 1::2]
    beyond = what == "beyond"
    x[beyond] = rng.uniform(0.0, 0.999 * _WIDE_HIGH, (b, n))[beyond]
    x[beyond, 1] = 0.9 * _WIDE_HIGH
    return x.astype(np.float32), low, high, pixels, periodic, ~beyond


def _check_encode_wide(device) -> None:
    """K1 at pixel counts of 2^31 and more == host spec bytes, minimums
    and widths on the blocks whose pixels fit an int32, and no
    certificate for the block whose pixels do not."""
    rng = np.random.default_rng(14)
    b = len(_WIDE_KINDS)
    x, low, high, pixels, periodic, certified = wide_float_blocks(
        rng, b, _WIDE_N)
    params = codec.block_params(low, high, pixels, periodic, device)
    lens = torch.full((b,), _WIDE_N, dtype=torch.int64, device=device)
    words, plan = encode.encode_float_group(_put(x, device), params, lens)
    words = words.cpu().numpy()
    if not np.array_equal(plan.valid, certified):
        raise AssertionError("K1 certified %s at the wide pixel counts, "
                             "want %s" % (plan.valid, certified))
    for i in np.nonzero(certified)[0]:
        payload, mn, bits, _ = spec.encode_float_block(
            x[i], low[i], high[i], int(pixels[i]), bool(periodic[i]))
        if (int(plan.mins[i]), int(plan.bits[i])) != (mn, bits):
            raise AssertionError(
                "K1 stats diverge from spec at %d pixels, block %d: min %d "
                "bits %d, want %d, %d" % (pixels[i], i, plan.mins[i],
                                          plan.bits[i], mn, bits))
        if payload_of(words, plan, i, _WIDE_N) != payload:
            raise AssertionError("K1 payload bytes diverge from spec at %d "
                                 "pixels, block %d" % (pixels[i], i))


def _check_decode_wide(device, modes, seed: int = 0) -> None:
    """K2 in ``modes`` == the host reader's decode of the host encoder's
    payloads at pixel counts of 2^31 and more (a 34-bit block among them),
    bitwise."""
    rng = np.random.default_rng(15)
    b = len(_WIDE_KINDS)
    x, low, high, pixels, periodic, _ = wide_float_blocks(rng, b, _WIDE_N)
    ids = np.arange(b) + (1 << 33)
    k1, k2 = codec.dither_keys(ids, seed, device)
    for i in range(b):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i], low[i], high[i], int(pixels[i]), bool(periodic[i]))
        row = bitpack.bytes_to_words(payload, bits, _WIDE_N)
        params = codec.block_params(low[i], high[i], pixels[i], periodic[i],
                                    device)
        for mode in modes:
            got = decode.decode_float_group(
                _put(row.view(np.int32)[None], device),
                _put(np.array([mn], np.int64), device), params, bits,
                _WIDE_N, mode, k1[i:i + 1], k2[i:i + 1])[0].cpu().numpy()
            _same(got, spec_decode_float(
                row, mn, bits, _WIDE_N, low[i], high[i], int(pixels[i]),
                bool(periodic[i]), mode, seed, int(ids[i])),
                "K2 %s decode at %d pixels, block %d" % (mode, pixels[i], i))


def _check_encode(device) -> None:
    """K1 at the flagship width and K3 at 41 bits (above 32) and 18 ==
    host spec bytes, minimums and widths."""
    rng = np.random.default_rng(11)
    pixels = spec.float_group_pixels(_LOW, _HIGH, _DX)
    x = rng.uniform(0.0, 249.9, (_BLOCKS, _N)).astype(np.float32)
    params = codec.block_params(np.full(_BLOCKS, _LOW),
                                np.full(_BLOCKS, _HIGH),
                                np.full(_BLOCKS, pixels),
                                np.ones(_BLOCKS, bool), device)
    lens = torch.full((_BLOCKS,), _N, dtype=torch.int64, device=device)
    words, plan = encode.encode_float_group(_put(x, device), params, lens)
    words = words.cpu().numpy()
    if not plan.valid.all():
        raise AssertionError("K1 failed to certify in-range blocks")
    for i in range(_BLOCKS):
        payload, mn, bits, _ = spec.encode_float_block(x[i], _LOW, _HIGH,
                                                       pixels)
        if (int(plan.mins[i]), int(plan.bits[i])) != (mn, bits):
            raise AssertionError(
                "K1 stats diverge from spec at block %d: min %d bits %d, "
                "want %d, %d" % (i, plan.mins[i], plan.bits[i], mn, bits))
        if payload_of(words, plan, i, _N) != payload:
            raise AssertionError("K1 payload bytes diverge from spec at "
                                 "block %d" % i)

    for ibits in (41, 18):
        xi = rng.integers(0, 1 << (ibits - 1), (_BLOCKS, _N),
                          dtype=np.int64)
        xi[:, 0] = 0
        xi[:, 1] = (1 << ibits) - 1  # pin the true width
        words, plan = encode.encode_int_group(_put(xi, device), lens)
        words = words.cpu().numpy()
        for i in range(_BLOCKS):
            payload, mn, bits = spec.encode_int_block(xi[i])
            if (int(plan.mins[i]), int(plan.bits[i])) != (mn, bits) \
                    or bits != ibits:
                raise AssertionError("K3 plan diverges from spec at %d "
                                     "bits, block %d" % (ibits, i))
            if payload_of(words, plan, i, _N) != payload:
                raise AssertionError("K3 payload bytes diverge from spec "
                                     "(bits=%d, block %d)" % (ibits, i))
    _check_encode_wide(device)


def _float_case(rng, device):
    """Two flagship blocks as packed words with their decode arguments."""
    pixels = spec.float_group_pixels(_LOW, _HIGH, _DX)
    vals = rng.integers(0, pixels, (_BLOCKS, _N), dtype=np.uint64)
    words = words_of(vals, _BITS)
    mins = np.zeros(_BLOCKS, np.int64)
    params = codec.block_params(np.full(_BLOCKS, _LOW),
                                np.full(_BLOCKS, _HIGH),
                                np.full(_BLOCKS, pixels),
                                np.ones(_BLOCKS, bool), device)
    return words, mins, pixels, (_put(words.view(np.int32), device),
                                 _put(mins, device), params, _BITS, _N)


def _check_decode(device) -> None:
    """K2 in ``none`` and ``midpoint`` == the host reader's decode, and K4
    at 18 and at 41 bits (the wide unpack) == ``spec.decode_int_block``,
    bitwise."""
    rng = np.random.default_rng(12)
    words, mins, pixels, args = _float_case(rng, device)
    for mode in ("none", "midpoint"):
        got = decode.decode_float_group(*args, mode).cpu().numpy()
        for i in range(_BLOCKS):
            _same(got[i], spec_decode_float(words[i], 0, _BITS, _N, _LOW,
                                            _HIGH, pixels, True, mode),
                  "K2 %s decode, block %d" % (mode, i))
    got = decode.decode_int_group(args[0], args[1], _BITS, _N).cpu().numpy()
    for i in range(_BLOCKS):
        _same(got[i], spec.decode_int_block(
            bitpack.words_to_bytes(words[i], _BITS, _N), 0, _BITS, _N),
            "K4 at %d bits, block %d" % (_BITS, i))
    wbits = 41
    vals = rng.integers(0, 1 << wbits, (_BLOCKS, _N), dtype=np.uint64)
    wwords = words_of(vals, wbits)
    wmins = rng.integers(-100, 100, _BLOCKS).astype(np.int64)
    got = decode.decode_int_group(_put(wwords.view(np.int32), device),
                                  _put(wmins, device), wbits, _N)
    got = got.cpu().numpy()
    for i in range(_BLOCKS):
        _same(got[i], spec.decode_int_block(
            bitpack.words_to_bytes(wwords[i], wbits, _N), int(wmins[i]),
            wbits, _N), "K4 wide unpack at %d bits, block %d" % (wbits, i))
    _check_decode_wide(device, ("none", "midpoint"))
    check_ragged(device, ("none", "midpoint"))


def _check_decode_uniform(device) -> None:
    """K2's in-kernel counter-hash dither (the default read mode) == the
    host reader's ``uniform`` decode, bitwise.  Its own family, as in the
    reference: its 32-bit multiplies are another surface than the
    unpack."""
    rng = np.random.default_rng(13)
    words, mins, pixels, args = _float_case(rng, device)
    ids = np.array([0, (1 << 33) + 5])[:_BLOCKS]
    k1, k2 = codec.dither_keys(ids, 1, device)
    got = decode.decode_float_group(*args, "uniform", k1, k2).cpu().numpy()
    for i in range(_BLOCKS):
        _same(got[i], spec_decode_float(words[i], 0, _BITS, _N, _LOW, _HIGH,
                                        pixels, True, "uniform", 1,
                                        int(ids[i])),
              "K2 uniform decode, block %d" % i)
    _check_decode_wide(device, ("uniform",), seed=1)
    check_ragged(device, ("uniform",), seed=1)


def ragged_columns(rng, n: int = 2049):
    """An int and a float column as a file holds them, for the ragged
    decode: mixed widths (18, 41 and 64 bits among them), blocks of width
    0 (a constant, a block of one element), lengths from 1 to ``n``, the
    payloads back to back at byte boundaries after 3 bytes of other data,
    so the first block starts at an odd byte.  Returns ``(span, columns,
    blocks)``: the uint8 span, the two columns'
    ``formats.device_common.Blocks`` and, a column each, every block's
    ``(payload, min, bits, n, config)`` for the host reader's decode."""
    from ..formats.device_common import Blocks

    ints = []
    for width, m in ((18, n), (0, 300), (41, n - 5), (64, 33), (1, 100),
                     (7, 1)):
        hi = (1 << 64) - 1 if width == 64 else 1 << width
        d = rng.integers(0, hi, m, dtype=np.uint64) if width \
            else np.zeros(m, np.uint64)
        d[:2] = (0, hi - 1) if width and m > 1 else 0
        lo = -(1 << 63) if width == 64 else (1 << 53) + 17
        x = d.view(np.int64) + np.int64(lo)
        payload, mn, bits = spec.encode_int_block(x)
        ints.append((payload, mn, bits, m, None))
    floats = []
    pos = (np.float32(0), np.float32(250), 250000, True)
    vel = (np.float32(-1e4), np.float32(1e4), 200000, False)
    for cfg, lo, hi, m in ((pos, 0.0, 249.9, n), (pos, 3.0, 3.4, 257),
                           (pos, 7.5, 7.5, n - 1), (vel, -9e3, 9e3, 33),
                           (pos, 249.7, 250.3, n), (pos, 1.0, 1.0, 1)):
        x = np.mod(rng.uniform(lo, hi, m), 250.0).astype(np.float32) \
            if cfg[3] else rng.uniform(lo, hi, m).astype(np.float32)
        payload, mn, bits, _ = spec.encode_float_block(x, *cfg)
        floats.append((payload, mn, bits, m, cfg))
    span = bytearray(b"\x5a\xa5\xff")
    columns = []
    for k, blocks in enumerate((ints, floats)):
        start = []
        for payload, *_ in blocks:
            start.append(len(span))
            span += payload
        span += b"\xc3" * (k + 2)
        config = None if blocks[0][4] is None else tuple(
            np.array([b[4][j] for b in blocks], t)
            for j, t in enumerate((np.float32, np.float32, np.int64,
                                   bool)))
        columns.append(Blocks(
            np.array(start, np.int64),
            np.array([b[2] for b in blocks], np.int64),
            np.array([b[3] for b in blocks], np.int64),
            np.array([b[1] for b in blocks], np.int64), config,
            np.arange(len(blocks), dtype=np.int64) + (1 << 33) * (k + 1)))
    return np.frombuffer(bytes(span), np.uint8), columns, (ints, floats)


def check_ragged(device, modes, seed: int = 0, rng=None) -> None:
    """K4 and K2 (in ``modes``) through the ragged entry, on
    :func:`ragged_columns` staged as a read stages a file
    (``device_common.stage_columns``), == the host reader's decode of
    each block, bitwise: the route a bulk read takes, not only the (B, W)
    wrapper."""
    from ..formats.device_common import stage_columns

    span, columns, (ints, floats) = ragged_columns(
        np.random.default_rng(16) if rng is None else rng)
    for mode in modes:
        src, (si, sf) = stage_columns(span, columns, device, mode, seed)
        got = decode.decode_int_ragged(src, si.table).cpu().numpy()
        want = np.concatenate([spec.decode_int_block(p, mn, bits, m)
                               for p, mn, bits, m, _ in ints])
        _same(got, want, "K4 ragged decode (widths %s)"
              % [b[2] for b in ints])
        got = decode.decode_float_ragged(src, sf.table, sf.params, mode,
                                         sf.k1, sf.k2).cpu().numpy()
        parts = []
        for i, (p, mn, bits, m, (low, high, pixels, per)) in \
                enumerate(floats):
            q = spec.decode_int_block(p, mn, bits, m)
            if per:
                q = spec.bound(q, 0, pixels)
            parts.append(spec.dequantize(q, low, high, pixels,
                                         u=dither_mod.dither_u(
                                             mode, seed,
                                             int(columns[1].ids[i]), m)))
        _same(got, np.concatenate(parts), "K2 %s ragged decode (widths %s)"
              % (mode, [b[2] for b in floats]))


_CHECKS = {"encode": _check_encode, "decode": _check_decode,
           "decode_uniform": _check_decode_uniform}
FAMILIES = tuple(_CHECKS)


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def kernel_ok(family: str, device=None) -> bool:
    """True when the kernel ``family`` (``encode``, ``decode`` or
    ``decode_uniform``) passed its one-shot check on ``device`` (default:
    the CUDA device) in this process; :class:`SelfCheckError` when it did
    not, now and on every later call.  It never returns False: there is
    no other route to take."""
    if family not in _CHECKS:
        raise ValueError("unknown kernel family %r" % (family,))
    if device is None:
        device = cuda_device()
    key = (family, _device_key(device))
    if _VERDICTS.get(key, key) is None:  # passed before: no lock to take
        return True
    with _LOCK:
        if key not in _VERDICTS:
            try:
                _CHECKS[family](torch.device(device))
                _VERDICTS[key] = None
            except AssertionError as e:
                _VERDICTS[key] = (
                    "minnow_torch: kernel family %r failed its self-check "
                    "on %s: %s" % (family, key[1], e))
        verdict = _VERDICTS[key]
    if verdict is not None:
        raise SelfCheckError(verdict)
    return True


def certify(family: str, device) -> None:
    """What the encoders and readers call before a family's first use on
    ``device``: :func:`kernel_ok` on a CUDA device, nothing on the CPU."""
    if torch.device(device).type in _CERTIFIED_TYPES:
        kernel_ok(family, device)
