"""Normative host-side (numpy) implementation of the codec semantics.

This module is the *spec twin*: a small, independent, carefully documented
implementation of exactly the arithmetic the on-disk format is defined by.
The kernels and plain versions in ``minnow_torch.ops`` are tested
byte-for-byte against it, and it is tested against hand-computed fixtures
and against ``minnow_tpu/core/spec.py``.

Byte/bit layout (ref go/bit/bit.go): element ``i`` of a width-``b`` packed
array occupies bits ``[i*b, (i+1)*b)`` of the byte stream, LSB-first within
each byte; total size is ``ceil(b*len/8)`` bytes; values are masked to ``b``
bits before packing; ``b == 0`` packs to zero bytes and decodes to zeros.

Quantization (ref go/group.go:312-327): with float32 ``low, high`` and
pixel count ``P``, ``dx = (high-low)/float32(P)`` and
``q_i = floor(float32(x_i - low) / dx)`` -- all arithmetic in float32, the
final floor taken of the float32 quotient (the reference floors in float64,
but every finite float32 >= 2**23 is already an integer, so flooring in
either precision yields the same integer).

Periodic recentering (ref go/group.go:374-420): ``periodic_min`` finds the
start of the minimal circular pixel window covering the data via a greedy
scan; ``bound`` wraps values into ``[min, min+P)`` by a single +-P step.

The port's own copy of ``minnow_tpu/core/spec.py``: the same arithmetic
and the same bytes, on numpy, with no import from that package.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "precision_needed",
    "precision_needed_go",
    "array_bytes",
    "pack_bits",
    "unpack_bits",
    "periodic_distance",
    "periodic_min",
    "periodic_min_fast",
    "bound",
    "quantize_dx",
    "quantize",
    "dequantize",
    "encode_int_block",
    "decode_int_block",
    "encode_float_block",
    "float_group_pixels",
]


def precision_needed(max_value: int) -> int:
    """Number of bits needed to store values in ``[0, max_value]``.

    The reference computes ``ceil(log2(max+1))`` in float64
    (ref go/bit/bit.go:19-21).  For ``max < 2**47`` that float expression
    equals ``max.bit_length()`` exactly; above it the float64 rounding of
    ``log2`` can under-count by one bit, silently corrupting data in the
    reference.  We use the exact integer answer (identical bytes for all
    realistic data, lossless always); see ``precision_needed_go`` for the
    literal reference behavior.
    """
    if max_value < 0:
        raise ValueError("precision_needed expects an unsigned value")
    return int(max_value).bit_length()


def precision_needed_go(max_value: int) -> int:
    """Literal replication of the reference's float64 formula
    (ref go/bit/bit.go:19-21).  Diverges from :func:`precision_needed`
    only for ``max_value`` within 2**-52-relative distance of 2**k,
    k >= ~47."""
    return int(math.ceil(math.log2(float(max_value + 1))))


def array_bytes(bits: int, length: int) -> int:
    """Bytes needed to pack ``length`` elements at ``bits`` width
    (ref go/bit/bit.go:23-25)."""
    return (bits * length + 7) // 8


def _mask(bits: int) -> np.uint64:
    if bits >= 64:
        return np.uint64(0xFFFFFFFFFFFFFFFF)
    return np.uint64((1 << bits) - 1)


def pack_bits(x, bits: int) -> bytes:
    """Pack ``x`` (uint64 array) at fixed width ``bits`` into the minnow bit
    stream layout (ref go/bit/bit.go:84-134).

    Implementation: expand every value to its ``bits`` binary digits
    (LSB first), concatenate, and let numpy's little-endian packbits produce
    the byte stream.  This is deliberately simple and obviously-correct; the
    fast paths live in ops/ (the device) and native/ (C++).
    """
    if bits < 0 or bits > 64:
        raise ValueError("bits must be in [0, 64], got %d" % bits)
    x = np.ascontiguousarray(np.asarray(x).view(np.uint64).ravel())
    n = x.shape[0]
    if bits == 0 or n == 0:
        return b""
    x = x & _mask(bits)
    shifts = np.arange(bits, dtype=np.uint64)
    bitmat = ((x[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
    stream = bitmat.reshape(-1)
    return np.packbits(stream, bitorder="little").tobytes()[: array_bytes(bits, n)]


def unpack_bits(data: bytes, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits` (ref go/bit/bit.go:29-82).  ``bits == 0``
    decodes to zeros without consuming bytes (ref go/bit/bit.go:171-174)."""
    if bits == 0:
        return np.zeros(n, dtype=np.uint64)
    need = array_bytes(bits, n)
    if len(data) < need:
        raise ValueError("need %d bytes for %d x %d-bit values, got %d"
                         % (need, n, bits, len(data)))
    raw = np.frombuffer(data[:need], dtype=np.uint8)
    stream = np.unpackbits(raw, bitorder="little")[: n * bits]
    bitmat = stream.reshape(n, bits).astype(np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    return (bitmat << shifts[None, :]).sum(axis=1, dtype=np.uint64)


# ---------------------------------------------------------------------------
# Periodic window helpers (ref go/group.go:374-420)
# ---------------------------------------------------------------------------


def periodic_distance(x: int, x0: int, pixels: int) -> int:
    """Signed distance from ``x0`` to ``x`` on a circle of ``pixels`` pixels
    (ref go/group.go:412-420).  Exact transcription, including its behavior
    for out-of-range inputs."""
    d = x - x0
    if d >= 0:
        if d > pixels - d:
            return d - pixels
    else:
        if d < -(d + pixels):
            return pixels + d
    return d


def periodic_min(x, pixels: int) -> int:
    """Start of the (greedy) minimal circular window covering ``x``
    (ref go/group.go:384-409).  Returns 0 when the window exceeds half the
    circle.  This is the literal sequential reference algorithm; see
    :func:`periodic_min_fast` for the equivalent one-pass reduction used on
    the device."""
    x = np.asarray(x, dtype=np.int64)
    if x.size == 0:
        return 0
    x0 = int(x[0])
    width = 1
    half = pixels // 2
    for xi in x.tolist():
        x1 = x0 + width - 1
        if x1 >= pixels:
            x1 -= pixels
        d0 = periodic_distance(xi, x0, pixels)
        d1 = periodic_distance(xi, x1, pixels)
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


def periodic_min_fast(x, pixels: int):
    """One-pass reduction equal to :func:`periodic_min` for inputs in
    ``[0, pixels)``.

    Derivation: the greedy window in the reference always equals the minimal
    circular window of the processed prefix, and whenever the greedy choice
    is ambiguous the resulting width necessarily exceeds ``pixels//2`` (both
    candidate extensions do), in which case the true minimal window over all
    points exceeds it too and the answer is 0 either way.  Hence with
    ``y_i = periodic_distance(x_i, x_0)``:

      * ``W = max(y) - min(y) + 1``
      * result = 0 if ``W > pixels//2`` else ``(x_0 + min(y)) mod pixels``

    Returns ``(result, valid)``; ``valid`` is False when some input lies
    outside ``[0, pixels)`` (then the caller must fall back to the exact
    sequential scan, whose out-of-range behavior is quirky but normative).
    """
    x = np.asarray(x, dtype=np.int64)
    if x.size == 0:
        return 0, True
    if x.min() < 0 or x.max() >= pixels:
        return 0, False
    x0 = x[0]
    d = x - x0
    y = np.where(d >= 0,
                 np.where(d > pixels - d, d - pixels, d),
                 np.where(d < -(d + pixels), pixels + d, d))
    lo, hi = int(y.min()), int(y.max())
    if hi - lo + 1 > pixels // 2:
        return 0, True
    m = int(x0) + lo
    if m < 0:
        m += pixels
    return m, True


def bound(x, minimum: int, pixels: int) -> np.ndarray:
    """Wrap values into ``[minimum, minimum+pixels)`` by a single +-pixels
    step (ref go/group.go:374-382).  Returns a new array."""
    x = np.asarray(x, dtype=np.int64).copy()
    x[x < minimum] += pixels
    x[x >= minimum + pixels] -= pixels
    return x


# ---------------------------------------------------------------------------
# Quantization (ref go/group.go:299-334, go/writer.go:72-75)
# ---------------------------------------------------------------------------


def float_group_pixels(low: float, high: float, dx: float) -> int:
    """Pixel count for a float group: ``ceil((high-low)/dx)`` with the
    subtraction and division in float32 (ref go/writer.go:72-75)."""
    low32, high32, dx32 = np.float32(low), np.float32(high), np.float32(dx)
    with np.errstate(all="ignore"):
        q = np.float32(high32 - low32) / dx32
    return int(math.ceil(float(q)))


def quantize_dx(low: float, high: float, pixels: int) -> np.float32:
    """Pixel width ``(high-low)/float32(pixels)`` in float32
    (ref go/group.go:316)."""
    low32, high32 = np.float32(low), np.float32(high)
    return np.float32(np.float32(high32 - low32) / np.float32(pixels))


def quantize(x, low: float, high: float, pixels: int) -> np.ndarray:
    """float32 -> int64 pixel indices (ref go/group.go:312-320).

    ``q = floor(float32(x - low) / dx)`` -- float32 subtraction and float32
    division (IEEE, round-to-nearest-even), floored.
    """
    x = np.asarray(x, dtype=np.float32)
    dx = quantize_dx(low, high, pixels)
    with np.errstate(all="ignore"):
        q32 = np.float32(x - np.float32(low)) / dx
    return np.floor(q32.astype(np.float64)).astype(np.int64)


def dequantize(q, low: float, high: float, pixels: int, u=None) -> np.ndarray:
    """int64 pixels -> float32 values with in-pixel dither
    (ref go/group.go:299-310): ``out = dx*float32(float64(q) + u) + low``
    with ``u`` uniform in [0,1).

    The reference uses Go's global unseeded RNG (irreproducible); this
    framework defines the dither as caller-supplied (deterministic,
    counter-based -- see ops/codec.py) or midpoint-free ``u=0``.
    """
    q = np.asarray(q, dtype=np.int64)
    dx = quantize_dx(low, high, pixels)
    if u is None:
        u = np.zeros(q.shape, dtype=np.float64)
    val64 = q.astype(np.float64) + np.asarray(u, dtype=np.float64)
    return np.float32(dx * val64.astype(np.float32) + np.float32(low))


# ---------------------------------------------------------------------------
# Block codecs (ref go/group.go:242-263, 312-327)
# ---------------------------------------------------------------------------


def encode_int_block(x, pack=None):
    """Min-subtract + bit-pack one int64 block (ref go/group.go:242-255).

    Returns ``(payload_bytes, min, bits)``.  Deltas are computed with int64
    wraparound then reinterpreted as uint64, exactly as Go does.
    ``pack`` swaps the bit packer (e.g. the native C++ kernel, which is
    byte-identical); default is the normative numpy packer.
    """
    x = np.asarray(x, dtype=np.int64)
    if x.size == 0:
        mn = np.int64(0)
    else:
        mn = np.int64(x.min())
    deltas = (x - mn).view(np.uint64)
    bits = precision_needed(int(deltas.max())) if x.size else 0
    return (pack or pack_bits)(deltas, bits), int(mn), bits


def decode_int_block(payload: bytes, mn: int, bits: int, n: int,
                     unpack=None) -> np.ndarray:
    """Inverse of :func:`encode_int_block` (ref go/group.go:257-263)."""
    deltas = (unpack or unpack_bits)(payload, bits, n)
    return (deltas.view(np.int64) + np.int64(mn)).astype(np.int64)


def encode_float_block(x, low: float, high: float, pixels: int,
                       periodic: bool = True, clamp_q: bool = False,
                       pack=None):
    """Quantize + (optional) periodic recentering + int coding of one
    float32 block (ref go/group.go:312-327).

    ``clamp_q`` clamps pixel indices to ``pixels - 1``: float32 division
    can round a value within one ulp of ``high`` up to exactly ``pixels``,
    which the (always-on) periodic recentering then wraps to pixel 0 --
    silently corrupting the block maximum of non-periodic data.  The
    reference has this bug (SURVEY.md App. B #9: its minp nextafter nudge,
    ref go/minp/minp.go:93-95, is narrower than the division rounding
    error); we do not replicate it for non-periodic minp groups.  Default
    False = reference-exact bytes.

    Returns ``(payload_bytes, min, bits, q)`` where ``q`` is the final
    (recentred) pixel array actually packed.
    """
    q = quantize(x, low, high, pixels)
    if clamp_q:
        q = np.minimum(q, pixels - 1)
    if periodic:
        m, valid = periodic_min_fast(q, pixels)
        if not valid:
            m = periodic_min(q, pixels)
        q = bound(q, m, pixels)
    payload, mn, bits = encode_int_block(q, pack=pack)
    return payload, mn, bits, q
