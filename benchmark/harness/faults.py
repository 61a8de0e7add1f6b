"""Faults planted in the program's timed path, each of which has to make
``correct`` come out false.  A format's ``faults(kind)`` builds its own
from these: ``VALUES`` break what a read returns, ``FILES`` what a
conversion writes (``None``: nothing written).  Only the benchmark's
tests plant them; a run never does."""

from __future__ import annotations

import os

import numpy as np
import torch


def _altered(x):
    if isinstance(x, torch.Tensor):
        x = x.clone()
        x.view(-1)[x.numel() // 2] += 1
        return x
    x = x.copy()
    x.reshape(-1)[x.size // 2] += 1
    return x


def _half(x):
    return x[: len(x) // 2]


def _unchanged(x):
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) \
        else np.zeros_like(x)


def _flip(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 1]))


def _halve(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


VALUES = {"altered": _altered, "half": _half, "unchanged": _unchanged}
FILES = {"altered": _flip, "half": _halve, "unchanged": None}


def on_result(module, attr, fault):
    """``plant(monkeypatch)``: ``module.attr`` returns ``fault`` of what it
    returned."""
    def plant(monkeypatch):
        real = getattr(module, attr)

        def broken(*args, **kw):
            return fault(real(*args, **kw))
        monkeypatch.setattr(module, attr, broken)
    return plant


def on_output(module, attr, timed_output, fault):
    """``plant(monkeypatch)``: a call of ``module.attr`` for which
    ``timed_output(args)`` names a file (a request's output) writes
    nothing when ``fault`` is None, and otherwise writes it and then
    applies ``fault`` to it; a call for which it gives None (set-up's own
    conversions) stays sound."""
    def plant(monkeypatch):
        real = getattr(module, attr)

        def broken(*args, **kw):
            path = timed_output(args)
            if path is not None and fault is None:
                return None  # nothing written: the output stays as it was
            out = real(*args, **kw)
            if path is not None:
                fault(path)
            return out
        monkeypatch.setattr(module, attr, broken)
    return plant
