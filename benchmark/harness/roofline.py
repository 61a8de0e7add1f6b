"""The least time the card could take for a kernel's work, and the bytes
that work must move (the benchmark's own copy of the port's
``chip_smoke.py`` ``bound``, which it owns from here on).

The bytes are counted from the blocks' shapes: each input byte read once
and each output byte written once, whatever a kernel reads again.  None
of the codec's kernels is bound by its operations at these widths, so
the bound is the bytes over the memory rate.
"""

from __future__ import annotations

# the card's device memory rate (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BYTES = 3.35e12


def bound(nbytes) -> float:
    """Seconds: ``nbytes`` over the memory rate."""
    return nbytes / PEAK_BYTES


def packed(n: int, bits: int) -> int:
    """Bytes of ``n`` values packed ``bits`` wide."""
    return (n * bits + 7) // 8


def decode_bytes(blocks) -> int:
    """A decode's bytes: each block's packed payload read and its values
    written, ``blocks`` as ``(n, bits, value bytes)``."""
    return sum(packed(n, bits) + n * size for n, bits, size in blocks)


def encode_bytes(blocks) -> int:
    """An encode's bytes: each block's values read and its packed payload
    written, ``blocks`` as ``(n, bits, value bytes)``."""
    return sum(n * size + packed(n, bits) for n, bits, size in blocks)
