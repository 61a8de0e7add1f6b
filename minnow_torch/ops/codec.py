"""Plain PyTorch codec arithmetic (counterpart of ``minnow_tpu/ops/codec.py``
and ``ops/fastdiv.py``).

The reference semantics are ``core/spec.py`` (the port's copy of
``minnow_tpu/core/spec.py``); every function
here is bitwise equal to its spec counterpart on the inputs it accepts:

* quantize: ``q = floor(f32(f32(x - low) / dx))`` -- one IEEE float32
  subtraction and one IEEE float32 division (PyTorch's float32 division
  is IEEE on the CPU and on the card, so the TPU's limb reciprocal of
  ``ops/fastdiv.py`` has no counterpart here);
* dequantize: ``out = f32(dx * f32(f64(q) + f64(u))) + low``, each
  float32 operation rounded on its own (never fused into an FMA);
* the uniform dither stream (lowbias32 counter hash keyed per block,
  ``core/dither.py``).

Per-block quantisation configs cross from the host layers as numpy arrays
(:func:`block_params`); the dither keys as block ids and a seed
(:func:`dither_keys`).  Every function takes its device explicitly or
works on the device of the tensors it is given.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import dither as dither_mod

__all__ = [
    "BlockParams",
    "block_config",
    "block_params",
    "quantize",
    "periodic_distance",
    "bound",
    "float_block_stats",
    "int_block_stats",
    "dequantize",
    "dither_keys",
    "dither_keys_np",
    "dither_hash_u",
    "DITHER_MODES",
]

M32 = 0xFFFFFFFF
I32_MAX = (1 << 31) - 1
I32_MIN = -(1 << 31)

# dither mode -> the integer the decode kernel takes
DITHER_MODES = {"none": 0, "midpoint": 1, "uniform": 2}


class BlockParams(NamedTuple):
    """Per-block quantisation config on one device, all (B,)."""

    low: torch.Tensor       # float32
    dx: torch.Tensor        # float32, spec.quantize_dx
    pixels: torch.Tensor    # int64
    periodic: torch.Tensor  # bool


def block_config(low, high, pixels, periodic):
    """Per-block configs as numpy arrays ``(low, dx, pixels, periodic)``
    (float32, float32, int64, bool) from what the host functions take.
    ``dx = f32(f32(high - low) / f32(pixels))`` is ``spec.quantize_dx``
    (= ``codec._dx64``).  Pixel counts are int64, at least 1: the kernels
    quantize to int32 and certify a block by the pixels its data holds,
    whatever its count."""
    low = np.atleast_1d(np.asarray(low, np.float32))
    high = np.atleast_1d(np.asarray(high, np.float32))
    pixels = np.atleast_1d(np.asarray(pixels, np.int64))
    periodic = np.atleast_1d(np.asarray(periodic, bool))
    if pixels.size and pixels.min() < 1:
        raise ValueError("pixel counts must be at least 1, got %d"
                         % pixels.min())
    with np.errstate(all="ignore"):
        dx = (high - low).astype(np.float32) / pixels.astype(np.float32)
    return low, dx.astype(np.float32), pixels, periodic


def block_params(low, high, pixels, periodic, device) -> BlockParams:
    """:func:`block_config` on ``device``."""
    return BlockParams(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in block_config(low, high, pixels, periodic)))


def quantize(x, low, dx):
    """float32 (B, n) -> ``(q, ok)``: int64 pixel indices and whether
    each is certified -- finite with ``|q| < 2**31``.  Uncertified
    entries hold 0.  ``low``/``dx`` are (B,) float32."""
    qf = torch.floor((x - low[:, None]) / dx[:, None])
    ok = torch.isfinite(qf) & (qf.abs() < 2.0 ** 31)
    return torch.where(ok, qf, 0).to(torch.int64), ok


def periodic_distance(x, x0, pixels):
    """Signed circular distance from ``x0`` to ``x`` (spec.py:130)."""
    d = x - x0
    return torch.where(d >= 0,
                       torch.where(d > pixels - d, d - pixels, d),
                       torch.where(d < -(d + pixels), pixels + d, d))


def bound(x, minimum, pixels):
    """Wrap into ``[minimum, minimum + pixels)`` by one +-pixels step
    (spec.py:213).  The upper test is ``x - minimum >= pixels``:
    ``minimum + pixels`` would wrap in int64 at the widest counts."""
    x = x + torch.where(x < minimum, pixels, 0)
    return x - torch.where(x - minimum >= pixels, pixels, 0)


# layout of the per-block stats the float encode's first pass returns
Q0, YMIN, YMAX, QMIN, QMAX, VALID = range(6)


def stats_init(b: int, device):
    """The identity of the stats reduction: (B, 6) int32."""
    row = torch.tensor([0, I32_MAX, I32_MIN, I32_MAX, I32_MIN, 1],
                       dtype=torch.int32)
    return row.repeat(b, 1).to(device)


def float_block_stats(x, params: BlockParams, lens):
    """Plain version of the float encode's stats pass: (B, 6) int32 rows
    ``(q0, ymin, ymax, qmin, qmax, valid)`` over the first ``lens[b]``
    elements of each row of ``x`` (B, n) float32.

    ``q0`` is the pixel of element 0, ``y`` the periodic distance of each
    in-range pixel from an in-range ``q0``, and ``valid`` is cleared by an
    uncertified pixel or, in a periodic block, a pixel outside
    ``[0, pixels)``.  Unset slots keep :func:`stats_init`'s values."""
    b, n = x.shape
    if n == 0:
        return stats_init(b, x.device)
    q, ok = quantize(x, params.low, params.dx)
    i = torch.arange(n, device=x.device)[None, :]
    live = i < lens[:, None]
    p = params.pixels[:, None]
    per = params.periodic[:, None]
    in_range = (q >= 0) & (q < p)
    q0, ok0 = q[:, :1], ok[:, :1] & live[:, :1]
    counted = live & ok
    has_y = counted & per & in_range & ok0 & (q0 >= 0) & (q0 < p)
    y = periodic_distance(q, q0, p)
    out = stats_init(b, x.device).to(torch.int64)
    out[:, Q0] = torch.where(ok0[:, 0], q0[:, 0], 0)
    out[:, YMIN] = torch.where(has_y, y, I32_MAX).amin(dim=1)
    out[:, YMAX] = torch.where(has_y, y, I32_MIN).amax(dim=1)
    out[:, QMIN] = torch.where(counted, q, I32_MAX).amin(dim=1)
    out[:, QMAX] = torch.where(counted, q, I32_MIN).amax(dim=1)
    bad = (live & ~ok) | (counted & per & ~in_range)
    out[:, VALID] = (~bad.any(dim=1)).to(torch.int64)
    return out.to(torch.int32)


def finish_float_stats(stats, pixels, periodic, lens):
    """From the stats rows to ``(m, mn, maxd, valid)`` (B,) int64 tensors,
    as ``spec.periodic_min_fast`` and ``pallas_encode.py:591-617``: the
    periodic recentring offset ``m``, the block minimum and the maximum
    delta after recentring.  Empty blocks are valid with all zeros."""
    st = stats.to(torch.int64)
    p = pixels.to(torch.int64)
    x0, ymin, ymax = st[:, Q0], st[:, YMIN], st[:, YMAX]
    w = ymax - ymin + 1
    small = w <= p // 2
    m = x0 + ymin
    m = torch.where(m < 0, m + p, m)
    m = torch.where(small, m, 0)
    shifted = periodic & small
    mn = torch.where(shifted, m, st[:, QMIN])
    mx = torch.where(shifted, m + w - 1, st[:, QMAX])
    empty = lens == 0
    valid = (st[:, VALID] != 0) | empty
    zero = torch.zeros_like(m)
    m = torch.where(periodic & ~empty, m, zero)
    mn = torch.where(empty, zero, mn)
    maxd = torch.where(empty, zero, mx - mn)
    return m, mn, maxd, valid


def int_block_stats(x, lens):
    """Per-block ``(mins, maxd)`` of int64 rows over their first
    ``lens[b]`` elements (``codec.int_block_stats``): ``maxd`` is the
    wrapped ``max - min``, the uint64 bit pattern in int64.  Empty blocks
    give zeros."""
    n = x.shape[1]
    if n == 0:
        return torch.zeros_like(lens), torch.zeros_like(lens)
    live = torch.arange(n, device=x.device)[None, :] < lens[:, None]
    info = torch.iinfo(torch.int64)
    mn = torch.where(live, x, info.max).amin(dim=1)
    mx = torch.where(live, x, info.min).amax(dim=1)
    empty = lens == 0
    mn = torch.where(empty, 0, mn)
    return mn, torch.where(empty, 0, mx - mn)


def dequantize(q, low, dx, u=None):
    """int64 pixels (B, n) -> float32 (spec.dequantize):
    ``dx * f32(f64(q) + f64(u)) + low`` with separate float32 roundings.
    ``u`` is None (no dither), a float, or a (B, n) tensor."""
    v = q.to(torch.float64)
    if u is not None:
        v = v + (u.to(torch.float64) if torch.is_tensor(u) else float(u))
    prod = dx[:, None] * v.to(torch.float32)
    return prod + low[:, None]


def dither_keys_np(block_ids, seed: int):
    """Per-block uniform-dither keys ``(k1, k2)`` as int32 numpy arrays
    holding the uint32 bit patterns: ``core/dither._np_fold_in``, bitwise
    equal to ``codec.dither_keys``."""
    ids = np.asarray(block_ids, np.int64)
    k1, k2 = dither_mod._np_fold_in(int(seed), ids)
    return tuple(np.atleast_1d(np.asarray(k, np.uint32)).view(np.int32)
                 for k in (k1, k2))


def dither_keys(block_ids, seed: int, device):
    """:func:`dither_keys_np` on ``device``."""
    return tuple(torch.from_numpy(k.copy()).to(device)
                 for k in dither_keys_np(block_ids, seed))


def _mul32(x, c: int):
    """``x * c mod 2**32`` for x in [0, 2**32), kept below 2**63."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def dither_hash_u(c, k1, k2):
    """The uniform dither stream (``codec.dither_hash_u``): lowbias32 of
    ``(c + k2) ^ k1`` with the mantissa fill -> float32 in [0, 1).
    ``c`` counts elements (int64 in [0, 2**32)); ``k1``/``k2`` are uint32
    bit patterns in int32 or int64 tensors that broadcast against it."""
    k1 = k1.to(torch.int64) & M32
    k2 = k2.to(torch.int64) & M32
    x = ((c + k2) & M32) ^ k1
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0xD35A2D97)
    x = x ^ (x >> 15)
    fb = ((x >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0
