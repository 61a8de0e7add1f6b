"""The minnow codec's arithmetic in plain numpy, batched over blocks.

A frozen copy of what the format defines: the bit stream (element ``i`` of
a width-``b`` block at bits ``[i*b, (i+1)*b)``, LSB first), float32
quantization ``floor(float32(x - low) / float32((high - low) / P))``, the
periodic window and its single-step wrap, min-subtraction, the read's
dequantization ``dx * float32(q + u) + low``, the ``uniform`` dither
stream (threefry-2x32 ``fold_in`` of ``(seed, block)``, then a lowbias32
hash of the element index), and Go's fdlibm ``log10``.  It imports nothing
of the program: the benchmark's comparisons hold the program's files and
values to it.

Everything works on a batch of blocks of one length, ``(B, n)``, so that
a snapshot's 1,536 blocks or a catalog's columns cost a few numpy passes.
"""

from __future__ import annotations

import math

import numpy as np

# -- the bit stream --------------------------------------------------------


def array_bytes(bits: int, n: int) -> int:
    return (bits * n + 7) // 8


def bit_width(max_delta) -> np.ndarray:
    """Bits that hold every value in ``[0, max_delta]`` (uint64 array)."""
    d = np.asarray(max_delta, np.uint64)
    out = np.zeros(d.shape, np.int64)
    for b in range(64):
        out += (d >> np.uint64(b)) > 0
    return out


def pack_rows(v, bits: int) -> np.ndarray:
    """Pack each row of the uint64 array ``v`` (R, n) at ``bits`` wide:
    (R, array_bytes(bits, n)) uint8.  Values are masked to ``bits``.

    ``G = 64 / gcd(bits, 64)`` values fill ``bits`` whole words, so the
    rows are cut into groups of ``G`` and each of the ``G`` places in a
    group is shifted into its word(s) across all groups at once."""
    v = np.asarray(v, np.uint64)
    r, n = v.shape
    nbytes = array_bytes(bits, n)
    if bits == 0 or n == 0:
        return np.zeros((r, 0), np.uint8)
    if bits < 64:
        v = v & np.uint64((1 << bits) - 1)
    g = 64 // math.gcd(bits, 64)
    w = g * bits // 64
    groups = -(-n // g)
    if groups * g != n:
        v = np.concatenate([v, np.zeros((r, groups * g - n), np.uint64)],
                           axis=1)
    v = v.reshape(r, groups, g)
    words = np.zeros((r, groups, w), np.uint64)
    for k in range(g):
        pos = k * bits
        i, o = pos // 64, pos % 64
        words[:, :, i] |= v[:, :, k] << np.uint64(o)
        if o + bits > 64:
            words[:, :, i + 1] |= v[:, :, k] >> np.uint64(64 - o)
    out = words.astype("<u8").reshape(r, groups * w).view(np.uint8)
    return out[:, :nbytes]


def pack_bits(x, bits: int) -> bytes:
    """One block: ``pack_rows`` of a single row, as bytes."""
    x = np.asarray(x).view(np.uint64).reshape(1, -1)
    return pack_rows(x, bits)[0].tobytes()


# -- integer blocks --------------------------------------------------------


def encode_int_rows(x):
    """Min-subtract and size each row of int64 ``x`` (B, n): ``(mins,
    bits, deltas)``, the deltas as uint64 with int64 wrap-around."""
    x = np.asarray(x, np.int64)
    if x.shape[1] == 0:
        b = x.shape[0]
        return (np.zeros(b, np.int64), np.zeros(b, np.int64),
                x.view(np.uint64))
    mins = x.min(axis=1)
    with np.errstate(over="ignore"):
        deltas = (x - mins[:, None]).view(np.uint64)
    bits = bit_width(deltas.max(axis=1))
    return mins, bits, deltas


def payloads(deltas, bits) -> list:
    """Each row's packed bytes, rows of one width packed together."""
    out = [None] * len(bits)
    for b in np.unique(bits):
        rows = np.flatnonzero(bits == b)
        packed = pack_rows(deltas[rows], int(b))
        for j, row in enumerate(rows):
            out[row] = packed[j].tobytes()
    return out


# -- float quantization ----------------------------------------------------


def float_group_pixels(low, high, dx) -> int:
    with np.errstate(all="ignore"):
        q = np.float32(np.float32(high) - np.float32(low)) / np.float32(dx)
    return int(math.ceil(float(q)))


def pixel_width(low, high, pixels) -> np.float32:
    return np.float32(np.float32(np.float32(high) - np.float32(low))
                      / np.float32(pixels))


def quantize(x, low, high, pixels) -> np.ndarray:
    x = np.asarray(x, np.float32)
    dx = pixel_width(low, high, pixels)
    with np.errstate(all="ignore"):
        q32 = np.float32(x - np.float32(low)) / dx
    return np.floor(q32.astype(np.float64)).astype(np.int64)


def _periodic_distance(x, x0, pixels):
    d = x - x0
    if d >= 0:
        if d > pixels - d:
            return d - pixels
    elif d < -(d + pixels):
        return pixels + d
    return d


def periodic_min_scan(x, pixels: int) -> int:
    """The greedy scan over one block, element by element: the definition
    of the periodic window's start, also for values outside ``[0, P)``."""
    x = np.asarray(x, np.int64)
    if x.size == 0:
        return 0
    x0, width, half = int(x[0]), 1, pixels // 2
    for xi in x.tolist():
        x1 = x0 + width - 1
        if x1 >= pixels:
            x1 -= pixels
        d0 = _periodic_distance(xi, x0, pixels)
        d1 = _periodic_distance(xi, x1, pixels)
        if d0 > 0 and d1 < 0:
            continue
        if d1 > -d0:
            width += d1
        else:
            x0 += d0
            if x0 < 0:
                x0 += pixels
            width -= d0
        if width > half:
            return 0
    return x0


def periodic_mins(q, pixels) -> np.ndarray:
    """The periodic window's start of each row of ``q`` (B, n).  A row
    inside ``[0, P)`` takes the one-pass form (the window of all its
    circular distances from its first element, or 0 past half the
    circle); any other row takes the scan."""
    q = np.asarray(q, np.int64)
    pixels = np.broadcast_to(np.asarray(pixels, np.int64), q.shape[:1])
    p = pixels[:, None]
    d = q - q[:, :1]
    y = np.where(d >= 0, np.where(d > p - d, d - p, d),
                 np.where(d < -(d + p), p + d, d))
    lo, hi = y.min(axis=1), y.max(axis=1)
    m = q[:, 0] + lo
    m = np.where(m < 0, m + pixels, m)
    m = np.where(hi - lo + 1 > pixels // 2, 0, m)
    inside = (q.min(axis=1) >= 0) & (q.max(axis=1) < pixels)
    for row in np.flatnonzero(~inside):
        m[row] = periodic_min_scan(q[row], int(pixels[row]))
    return m


def wrap(q, start, pixels) -> np.ndarray:
    """Each row into ``[start, start + P)`` by one step of ``P``."""
    start = np.asarray(start, np.int64).reshape(-1, 1)
    p = np.asarray(pixels, np.int64).reshape(-1, 1)
    q = np.where(q < start, q + p, q)
    return np.where(q >= start + p, q - p, q)


def encode_float_rows(x, low, high, pixels, clamp_q=False):
    """Quantize each row of float32 ``x`` (B, n), recentre it on its
    periodic window (every float group of the format is periodic) and
    min-subtract it: ``(mins, bits, deltas, q)``, ``q`` the recentred
    pixels as stored.  ``low``, ``high``, ``pixels`` are scalars or one
    a row."""
    b = x.shape[0]
    low = np.broadcast_to(np.asarray(low, np.float32), (b,))
    high = np.broadcast_to(np.asarray(high, np.float32), (b,))
    pixels = np.broadcast_to(np.asarray(pixels, np.int64), (b,))
    q = np.empty(x.shape, np.int64)
    for key in set(zip(low.tolist(), high.tolist(), pixels.tolist())):
        rows = np.flatnonzero((low == key[0]) & (high == key[1])
                              & (pixels == key[2]))
        q[rows] = quantize(x[rows], key[0], key[1], key[2])
    if clamp_q:
        q = np.minimum(q, pixels[:, None] - 1)
    q = wrap(q, periodic_mins(q, pixels), pixels)
    mins, bits, deltas = encode_int_rows(q)
    return mins, bits, deltas, q


def dequantize(q, low, high, pixels, u=None) -> np.ndarray:
    """Pixels back to float32, ``u`` in ``[0, 1)`` added in float64."""
    dx = pixel_width(low, high, pixels)
    val = np.asarray(q, np.int64).astype(np.float64)
    if u is not None:
        val = val + np.asarray(u, np.float64)
    return np.float32(dx * val.astype(np.float32) + np.float32(low))


def bfloat16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even),
    back in float32: the precision below the format's float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        u = (u + ((u >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


# -- the uniform dither ----------------------------------------------------


def _threefry2x32(k0, k1, x0, x1):
    k0, k1 = np.uint32(k0), np.uint32(k1)
    x0 = np.asarray(x0, np.uint32).copy()
    x1 = np.asarray(x1, np.uint32).copy()
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 += ks[0]
    x1 += ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in rotations[i % 2]:
                x0 += x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def dither_u(seed: int, blocks, n: int) -> np.ndarray:
    """The ``uniform`` dither of ``n`` elements of each container block
    in ``blocks``: (len(blocks), n) float32 in ``[0, 1)``."""
    seed = int(seed)
    blocks = np.asarray(blocks).astype(np.uint32)
    k1, k2 = _threefry2x32((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
                           np.zeros_like(blocks), blocks)
    c = np.arange(n, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        x = (c + k2[:, None]) ^ k1[:, None]
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x21F0AAAD)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0xD35A2D97)
        x ^= x >> np.uint32(15)
        fb = (x >> np.uint32(9)) | np.uint32(0x3F800000)
    return fb.view(np.float32) - np.float32(1.0)


# -- Go's math.Log10 (fdlibm) ----------------------------------------------

_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_LG = (6.666666666666735130e-01, 3.999999999940941908e-01,
       2.857142874366239149e-01, 2.222219843214978396e-01,
       1.818357216161805012e-01, 1.531383769920937332e-01,
       1.479819860511658591e-01)
_SQRT2 = 1.4142135623730951
_LN2 = 0.6931471805599453
_LN10 = 2.302585092994046
_LOG2E = 1.4426950408889634


def _log(frac):
    """fdlibm's log of ``frac`` in ``[0.5, 1)`` (float64)."""
    f1, ki = np.frexp(frac)
    small = f1 < _SQRT2 / 2
    f1 = np.where(small, f1 * 2, f1)
    k = (ki - small.astype(ki.dtype)).astype(np.float64)
    f = f1 - 1.0
    s = f / (2.0 + f)
    s2 = s * s
    s4 = s2 * s2
    t1 = s2 * (_LG[0] + s4 * (_LG[2] + s4 * (_LG[4] + s4 * _LG[6])))
    t2 = s4 * (_LG[1] + s4 * (_LG[3] + s4 * _LG[5]))
    r = t1 + t2
    hfsq = 0.5 * f * f
    return k * _LN2_HI - ((hfsq - (s * (hfsq + r) + k * _LN2_LO)) - f)


def log10_f32(x) -> np.ndarray:
    """``float32(math.Log10(float64(x)))`` as Go computes it, for positive
    finite float32 ``x``: ``log2(x) * (Ln2 / Ln10)``, ``log2`` exact at
    powers of two."""
    x = np.asarray(x, np.float32).astype(np.float64)
    if (x <= 0).any() or not np.isfinite(x).all():
        raise ValueError("log10 of a value that is not positive and finite")
    frac, exp = np.frexp(x)
    exact = frac == 0.5
    gen = (_log(np.where(exact, 1.0, frac)) * _LOG2E
           + exp.astype(np.float64))
    log2 = np.where(exact, exp.astype(np.float64) - 1.0, gen)
    return (log2 * (_LN2 / _LN10)).astype(np.float32)
