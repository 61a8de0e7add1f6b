"""ctypes bindings for the native host engine (native/fastbits.cpp).

Builds the shared library on first use if missing (g++; see
native/Makefile).  All entry points have pure-numpy fallbacks in
core/spec.py, so the package works without a compiler -- the native path
is the performance engine for host-side packing and text parsing.

The port's own copy of ``minnow_tpu/native.py``: the same arithmetic and
the same bytes, on numpy, with no import from that package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .core import spec

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libfastbits.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # Always invoke make: its fastbits.cpp dependency makes this a no-op
    # when the .so is fresh and a rebuild when the source moved past a
    # stale build/ left by an older checkout.  Serialized under a file
    # lock: concurrent first-use processes (pytest -n, --jobs fan-outs)
    # would otherwise race g++ writing the .so in place and a sibling
    # could dlopen a half-written file.  Best-effort -- with no
    # compiler we still load whatever .so exists.
    try:
        os.makedirs(os.path.join(_NATIVE_DIR, "build"), exist_ok=True)
        import fcntl
        with open(os.path.join(_NATIVE_DIR, "build", ".lock"),
                  "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
    except Exception:
        pass
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64 = ctypes.c_int64
    lib.mnw_pack.argtypes = [ctypes.c_void_p, i64, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int]
    lib.mnw_unpack.argtypes = [ctypes.c_void_p, i64, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int]
    lib.mnw_periodic_min.argtypes = [ctypes.c_void_p, i64, i64]
    lib.mnw_periodic_min.restype = i64
    lib.mnw_bound.argtypes = [ctypes.c_void_p, i64, i64, i64]
    lib.mnw_quantize.argtypes = [ctypes.c_void_p, i64, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_void_p]
    lib.mnw_delta_stats.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.mnw_parse_columns.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, i64,
        ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_int, ctypes.c_char]
    lib.mnw_parse_columns.restype = i64
    try:  # absent only in a stale pre-round-5 .so with no compiler
        lib.mnw_parse_columns_typed.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, i64,
            ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_char]
        lib.mnw_parse_columns_typed.restype = i64
    except AttributeError:
        pass
    lib.mnw_scan_lines.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_char, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int]
    lib.mnw_scan_lines.restype = i64
    lib.mnw_count_newlines.argtypes = [ctypes.c_char_p, i64,
                                       ctypes.c_int]
    lib.mnw_count_newlines.restype = i64
    lib.mnw_log10_f32.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def pack_bits(x, bits: int, threads: int = 1) -> bytes:
    """Native fixed-width pack; byte-identical to spec.pack_bits."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(x).view(np.uint64).ravel())
    n = x.shape[0]
    if lib is None:
        return spec.pack_bits(x, bits)
    if bits == 0 or n == 0:
        return b""
    nbytes = spec.array_bytes(bits, n)
    out = np.zeros(nbytes + 16, dtype=np.uint8)
    lib.mnw_pack(x.ctypes.data, n, bits, out.ctypes.data,
                 threads or os.cpu_count())  # 0 = all cores
    return out[:nbytes].tobytes()


def unpack_bits(data: bytes, bits: int, n: int,
                threads: int = 1) -> np.ndarray:
    """Native unpack; equals spec.unpack_bits."""
    lib = _load()
    if lib is None:
        return spec.unpack_bits(data, bits, n)
    out = np.empty(n, dtype=np.uint64)
    if bits == 0 or n == 0:
        out[:] = 0
        return out
    need = spec.array_bytes(bits, n)
    buf = np.zeros(need + 16, dtype=np.uint8)
    buf[:need] = np.frombuffer(data[:need], dtype=np.uint8)
    lib.mnw_unpack(buf.ctypes.data, n, bits, out.ctypes.data,
                   threads or os.cpu_count())
    return out


def periodic_min(x, pixels: int) -> int:
    """Native greedy periodic window scan; equals spec.periodic_min."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(x, dtype=np.int64))
    if lib is None:
        return spec.periodic_min(x, pixels)
    return int(lib.mnw_periodic_min(x.ctypes.data, x.shape[0], pixels))


def log10_f32(x):
    """``float32(Go math.Log10(float64(x)))`` -- native fdlibm
    transcription, bit-identical to core/gomath.log10 (the minh
    log-column preprocess, ref go/minh/minh.go:141-149).  Returns None
    without the native lib (caller falls back to gomath)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    out = np.empty(x.shape, np.float32)
    lib.mnw_log10_f32(x.ctypes.data, x.size, out.ctypes.data)
    return out


def encode_float_block(x, low, high, pixels: int, periodic: bool = True,
                       clamp_q: bool = False, threads: int = 1):
    """All-native host float-block encode: quantize -> (periodic
    recenter) -> delta stats -> pack, byte-identical to
    spec.encode_float_block (the composition of mnw_quantize,
    mnw_periodic_min, mnw_bound, mnw_delta_stats, mnw_pack -- each op
    exact IEEE f32 / int64, ref go/group.go:312-327).

    Returns ``(payload, mn, bits, q)`` like the spec function."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    if lib is None:
        return spec.encode_float_block(x, low, high, pixels,
                                       periodic=periodic, clamp_q=clamp_q)
    import ctypes as _ct

    n = x.shape[0]
    q = np.empty(n, np.int64)
    dxq = spec.quantize_dx(low, high, pixels)
    lib.mnw_quantize(x.ctypes.data, n, np.float32(low), dxq, q.ctypes.data)
    if clamp_q:
        np.minimum(q, pixels - 1, out=q)
    if periodic and n:
        m = int(lib.mnw_periodic_min(q.ctypes.data, n, pixels))
        lib.mnw_bound(q.ctypes.data, n, m, pixels)
    deltas = np.empty(n, np.uint64)
    mn = _ct.c_int64()
    maxd = _ct.c_uint64()
    lib.mnw_delta_stats(q.ctypes.data, n, deltas.ctypes.data,
                        _ct.byref(mn), _ct.byref(maxd))
    bits = spec.precision_needed(int(maxd.value)) if n else 0
    payload = pack_bits(deltas, bits, threads=threads)
    return payload, int(mn.value), bits, q


def scan_lines(buf: bytes, comment: bytes = b"#", threads: int = 0):
    """Data-line [start, end) spans of a text-catalog buffer: lines split
    at newlines, truncated at inline comments, empty/whitespace-only lines
    dropped (ref go/text/parse.go:16-78).  Returns ``(starts, ends)``
    int64 arrays, or ``None`` when the native engine is unavailable (the
    caller falls back to the numpy span code)."""
    lib = _load()
    if lib is None:
        return None
    n = len(buf)
    # capacity via the threaded native counter: CPython's bytes.count
    # single-byte loop ran at ~0.7 GB/s here and bottlenecked the stage
    cap = lib.mnw_count_newlines(buf, n, threads or os.cpu_count()) + 1
    starts = np.empty(cap, dtype=np.int64)
    ends = np.empty(cap, dtype=np.int64)
    cnt = lib.mnw_scan_lines(buf, n, comment[:1], starts.ctypes.data,
                             ends.ctypes.data, threads or os.cpu_count())
    return starts[:cnt], ends[:cnt]


def parse_columns(buf: bytes, line_starts, line_ends, col_idx,
                  threads: int = 0, sep: bytes = b" ", kinds=None):
    """Parse the given column indices of every line.  ``kinds`` gives a
    per-column parse mode: 0 (default) -> float64; 1 -> exact int64
    (reference strconv.Atoi semantics, ref go/text/parse.go:118-121 --
    exact above 2^53, rejects float syntax, errors on overflow);
    2 -> float32 (narrowed in the parser, one rounding -- identical to
    a float64 parse followed by ``.astype(np.float32)``, without that
    whole-array pass).
    Returns a list of arrays, or raises ValueError naming the bad line.
    The native equivalent of the reference's threaded parse loops
    (ref go/text/parse.go:80-174)."""
    lib = _load()
    line_starts = np.ascontiguousarray(line_starts, dtype=np.int64)
    line_ends = np.ascontiguousarray(line_ends, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int64)
    n_lines = line_starts.shape[0]
    if kinds is None:
        kinds = [0] * len(col_idx)
    kinds = np.ascontiguousarray(kinds, dtype=np.int64)
    _DT = {0: np.float64, 1: np.int64, 2: np.float32}
    outs = [np.empty(n_lines, dtype=_DT[int(k)]) for k in kinds]
    if lib is None or (kinds.any()
                       and not hasattr(lib, "mnw_parse_columns_typed")):
        return _parse_columns_py(buf, line_starts, line_ends, col_idx,
                                 kinds, outs)
    ptrs = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data for o in outs])
    if kinds.any():
        res = lib.mnw_parse_columns_typed(
            buf, line_starts.ctypes.data, line_ends.ctypes.data, n_lines,
            col_idx.ctypes.data, kinds.ctypes.data, len(col_idx), ptrs,
            threads or os.cpu_count(), sep)
    else:
        res = lib.mnw_parse_columns(
            buf, line_starts.ctypes.data, line_ends.ctypes.data, n_lines,
            col_idx.ctypes.data, len(col_idx), ptrs,
            threads or os.cpu_count(), sep)
    if res != 0:
        raise ValueError("cannot parse requested columns on line %d"
                         % (res - 1))
    return outs


def _parse_columns_py(buf, line_starts, line_ends, col_idx, kinds, outs):
    for li in range(line_starts.shape[0]):
        fields = buf[line_starts[li]:line_ends[li]].split()
        for c, ci in enumerate(col_idx):
            if ci >= len(fields):
                raise ValueError(
                    "cannot parse requested columns on line %d" % li)
            try:
                if kinds[c] == 1:
                    if b"_" in fields[ci]:  # int() allows, Atoi doesn't
                        raise ValueError("underscore")
                    v = int(fields[ci])  # exact; rejects float syntax
                    if not (-(1 << 63) <= v < (1 << 63)):
                        raise ValueError("int64 overflow")
                    outs[c][li] = v
                else:
                    outs[c][li] = float(fields[ci])  # f32 outs narrow
            except ValueError:
                raise ValueError(
                    "cannot parse requested columns on line %d" % li)
    return outs
