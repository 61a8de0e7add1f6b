"""The comparison that decides ``correct``: bit for bit."""

from __future__ import annotations

import os

import numpy as np


def file_bytes(path):
    if not os.path.exists(path):
        return None
    return np.fromfile(path, np.uint8)


def differing(got, want) -> int:
    """Elements of ``got`` that differ bitwise from ``want``; a missing or
    surplus element counts."""
    want = np.ascontiguousarray(want)
    if got is None:
        return want.size
    got = np.ascontiguousarray(got).reshape(-1)
    want = want.reshape(-1)
    if got.dtype.itemsize != want.dtype.itemsize:
        return max(want.size, got.size)
    view = {1: np.uint8, 4: np.uint32, 8: np.uint64}[want.dtype.itemsize]
    n = min(got.size, want.size)
    same = got[:n].view(view) == want[:n].view(view)
    return int(n - same.sum()) + abs(got.size - want.size)
