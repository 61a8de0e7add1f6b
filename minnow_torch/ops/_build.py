"""Build and bind the CUDA kernels in ``minnow_torch/csrc``.

Each source compiles with its own nvcc, all started together, and the
objects link into one shared library with a plain C interface, loaded
with ctypes -- no PyTorch headers, so a build takes seconds.  The
library is built on first use, under a file lock, into
``build/minnow_torch/`` at the checkout root, named by a hash of the
sources and flags, so a changed source builds anew and a stale library is
never loaded.  A failed build raises with nvcc's output; nothing is
fetched and nothing else is tried.

Each entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` turns a nonzero code
into an exception.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "check", "NVCC_FLAGS", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "minnow_torch"

# -fmad=false: no a*b+c contraction anywhere (spec bitwise equality);
# nvcc's default -ftz=false/-prec-div=true keep IEEE division and
# subnormals (no --use_fast_math)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint
_F32 = ctypes.c_float
_SIGNATURES = {
    # x, B, n, run, low, dx, pixels, periodic, lens, stats, q, stream
    "minnow_encode_float_stats": [_P, _I64, _I64, _I32, _P, _P, _P, _P,
                                  _P, _P, _P, _P],
    # stats, pixels, periodic, lens, B, plan, stream
    "minnow_encode_float_plan": [_P, _P, _P, _P, _I64, _P, _P],
    # x (or q), B, n, low, dx, pixels, periodic, plan, lens, words,
    # capacity, stream
    "minnow_encode_float_pack": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P,
                                 _P, _I64, _P],
    "minnow_encode_float_pack_q": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P,
                                   _P, _I64, _P],
    # src, B, start_bit, bits, len, out_off, mins, low, dx, pixels,
    # periodic, mode, k1, k2, out, grid_y, stream
    "minnow_decode_float_ragged": [_P, _I64, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _I32, _P, _P, _P, _U32, _P],
    # x, B, n, run, lens, stats, stream
    "minnow_int_stats": [_P, _I64, _I64, _I32, _P, _P, _P],
    # stats, lens, B, plan, stream
    "minnow_int_plan": [_P, _P, _I64, _P, _P],
    # x, B, n, plan, lens, words, capacity, stream
    "minnow_pack_int": [_P, _I64, _I64, _P, _P, _P, _I64, _P],
    # src, B, start_bit, bits, len, out_off, mins, out, grid_y, stream
    "minnow_unpack_int_ragged": [_P, _I64, _P, _P, _P, _P, _P, _P, _U32,
                                 _P],
    # ids, x, v, n_particles, n_side, cells, c_lo, c_hi, grid_x, grid_v,
    # marks, error, stream
    "minnow_rebin": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P, _P, _P,
                     _P, _P],
    # n, cells, out
    "minnow_cells_layout": [_I64, _I64, _P],
    # x, y, z, n, dx, l, sb, cells, chunk, chunks, matrix, sums, offsets,
    # error, stream
    "minnow_cells_count": [_P, _P, _P, _I64, _F32, _F32, _F32, _I64, _I64,
                           _I64, _P, _P, _P, _P, _P],
    # x, y, z, n, dx, l, sb, cells, chunk, chunks, matrix, perm, flags,
    # stream
    "minnow_cells_place": [_P, _P, _P, _I64, _F32, _F32, _F32, _I64, _I64,
                           _I64, _P, _P, _P, _P],
}

_lib = None
_lib_lock = threading.Lock()
_log = ""


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME=%s"
                       % home)


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands at once; raise with nvcc's output if one fails.
    Returns their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:  # a timeout leaves no compiler running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                               % (p.returncode, " ".join(cmd), out))
    return "".join(outs)


def _build(lib_path: Path) -> str:
    tmp = lib_path.with_suffix(".tmp%d" % os.getpid())
    nvcc = _nvcc()
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [tmp.with_name("%s.%s.o" % (tmp.name, s.stem)) for s in srcs]
    log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(srcs, objs)])
    log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, lib_path)
    return log


def load():
    """The kernel library, built on first use."""
    global _lib, _log
    with _lib_lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / ("libminnow_torch_%s.so" % _key())
        with open(BUILD_DIR / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.exists():
                _log = _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.minnow_error_string.argtypes = [ctypes.c_int]
        lib.minnow_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_log() -> str:
    """nvcc's output from the build this process ran ('' if the library
    was already built)."""
    return _log


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().minnow_error_string(err).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, err, msg))
