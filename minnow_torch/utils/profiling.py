"""Stage profiling: wall-clock + GB/s per pipeline stage, with optional
``torch.profiler`` trace capture.

The reference has only ad-hoc per-file minute prints
(ref scripts/text_to_minh.go:60-65); this provides the per-stage GB/s
reporting required by the project baseline (BASELINE.md).

The port's own copy of ``minnow_tpu/utils/profiling.py``: the same
``StageTimer``; :func:`trace` captures with ``torch.profiler`` where the
reference uses ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import time

__all__ = ["StageTimer", "trace"]


class StageTimer:
    """Accumulates (seconds, bytes) per named stage.

    Usage::

        timer = StageTimer()
        with timer.stage("quantize+pack", nbytes=x.nbytes):
            out = encode(x)
            torch.cuda.synchronize()
        print(timer.report())
    """

    def __init__(self):
        import threading

        self.stages: dict[str, list[float]] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, nbytes)

    def add(self, name: str, seconds: float, nbytes: int = 0) -> None:
        # stages may accumulate from prefetch threads; the read-modify-
        # write below must not interleave
        with self._lock:
            sec, by = self.stages.get(name, (0.0, 0))
            self.stages[name] = [sec + seconds, by + nbytes]

    def report(self) -> dict:
        out = {}
        for name, (sec, by) in self.stages.items():
            entry = {"seconds": round(sec, 6)}
            if by:
                entry["bytes"] = by
                entry["GBps"] = round(by / sec / 1e9, 3) if sec else None
            out[name] = entry
        return out

    def dump(self) -> str:
        return json.dumps(self.report())


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and CUDA activity) around
    a block, written as ``trace.json`` (Chrome trace format) under
    ``log_dir``."""
    import os

    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
