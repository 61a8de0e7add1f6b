"""Deterministic counter-based read dither.

The reference dequantizes with a uniform in-pixel dither: Go uses the
global unseeded RNG (irreproducible across runs, ref go/group.go:308);
the reference Python reader seeds ``random.seed(b)`` per block
(ref python/minnow.py:175).  This framework defines ONE dither stream,
keyed on ``(seed, block_id, element)`` and identical on every path:

* ``uniform`` (the default) is the counter-hash stream of
  ``ops/codec.dither_hash_u``: per-block keys from a full jax-threefry
  ``fold_in`` of ``(seed, block_id)``, per-element mixing via the
  lowbias32 avalanche hash.  The host reader computes the SAME stream
  in pure numpy below (_np_fold_in/_np_hash_u -- bit-for-bit the jax
  algorithm, so opening a file never initializes an accelerator
  runtime), and the device bulk readers run it inside XLA / the Pallas
  decode kernel.  Host and device reads of the same file agree
  bitwise in every mode.
* ``none`` (u=0) and ``midpoint`` (u=0.5) are used for strict
  cross-checking.
* ``philox`` is the legacy host stream from rounds 1-4 (numpy Philox
  keyed on ``(seed, block)``), kept only for reproducing old reads;
  it never matched the device stream and is not the default anywhere.

All streams are deterministic; the decoded-value contract in all modes
is ``|x - x_hat| <= dx`` (ref go/minnow_test.go:328-334).

The port's own copy of ``minnow_tpu/core/dither.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

import numpy as np

UNIFORM = "uniform"
NONE = "none"
MIDPOINT = "midpoint"
PHILOX = "philox"


def _np_threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds), vectorized pure numpy.  Bit-identical
    to jax's ``threefry_2x32`` primitive (same rotation schedule and key
    injections), verified against ``jax.random.fold_in`` in
    tests/test_ops.py."""
    k0 = np.uint32(k0)
    k1 = np.uint32(k1)
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


def _np_fold_in(seed: int, data):
    """numpy twin of ``jax.random.fold_in(PRNGKey(seed), data)`` for the
    per-block dither keys (= ops/codec.dither_keys).  ``data`` may be an
    array of block ids.  Returns (k1, k2) uint32."""
    seed = int(seed)
    k0 = np.uint32((seed >> 32) & 0xFFFFFFFF)
    k1 = np.uint32(seed & 0xFFFFFFFF)
    # jax's fold_in casts data to uint32 first, so the count pair is
    # (0, uint32(data))
    data = np.asarray(data).astype(np.uint32)
    return _np_threefry2x32(k0, k1, np.zeros_like(data), data)


def _np_hash_u(c, k1, k2):
    """numpy twin of ``ops/codec.dither_hash_u``: lowbias32 avalanche of
    ``(c + k2) ^ k1`` with the mantissa-fill float transform.  uint32 in,
    float32 u in [0, 1) out -- bit-identical to the XLA / Pallas-kernel
    stream."""
    with np.errstate(over="ignore"):
        x = (np.asarray(c, np.uint32) + np.uint32(k2)) ^ np.uint32(k1)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x21F0AAAD)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0xD35A2D97)
        x = x ^ (x >> np.uint32(15))
        fb = (x >> np.uint32(9)) | np.uint32(0x3F800000)
    return fb.view(np.float32) - np.float32(1.0)


def dither_u(mode: str, seed: int, block: int, n: int):
    """Per-element dither offsets u in [0, 1) added to pixel indices before
    scaling (ref go/group.go:308 semantics)."""
    if mode == NONE:
        return None
    if mode == MIDPOINT:
        return np.full(n, 0.5)
    if mode == UNIFORM:
        k1, k2 = _np_fold_in(seed, block)
        return _np_hash_u(np.arange(n, dtype=np.uint32), k1, k2)
    if mode == PHILOX:
        rng = np.random.Generator(
            np.random.Philox(key=(np.uint64(seed) << np.uint64(32))
                             ^ np.uint64(block)))
        return rng.random(n)
    raise ValueError("unknown dither mode %r" % mode)
