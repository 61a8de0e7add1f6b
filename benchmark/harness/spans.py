"""The benchmark's own spans around its calls into the program.

A span is a name, a start and an end on the host's clock
(``time.perf_counter``), kept in memory.  In a traced run each span is
also a ``torch.profiler.record_function`` range, so the trace can name
what the host was doing while the device sat idle.
"""

from __future__ import annotations

import contextlib
import threading
import time


class Spans:
    def __init__(self):
        self.records = []  # (name, start, end)
        self.traced = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.records.append((name, t0, t1))

    def durations(self, name: str, start: float = float("-inf")) -> list:
        """Seconds of each span ``name`` that began at ``start`` or later."""
        return [t1 - t0 for n, t0, t1 in self.records
                if n == name and t0 >= start]
