"""Spans of the port's calls, and stage times on top of them.

A span is one step of a call: its name (``<module>.<step>``), its start and
end on ``time.perf_counter`` (the clock of the benchmark's own spans), its
thread, the span it ran inside (``parent``), the outermost span of the call
(``root``, which names the request), its bytes and any counts the site adds.
Every span goes into a bounded ring in memory, read by :func:`records`.
While a ``torch.profiler`` profile runs on the span's thread, the span is
also a ``record_function`` range, so it lies in the trace as a
``user_annotation`` on the clock of the kernels and copies; with no
profiler running none is made.

Spans sit at the level of a call, a file or a batch, never inside a loop
over blocks, rows or payloads.  A span opened on a worker thread takes as
its parent the span that submitted the work, when the work was wrapped
by :func:`carry`.

``StageTimer`` sums seconds and bytes by stage key over a caller's
conversions (``text_to_minh.convert_file(timer=)``): a span given a timer
and a key adds its interval to that stage as it closes.

Usage::

    with profiling.span("read.span", nbytes):
        data = f.read(nbytes)
    spans, dropped = profiling.records(since=t0)
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import resource
import sys
import threading
import time

__all__ = ["span", "traced", "carry", "records", "minor_faults", "Ring",
           "StageTimer"]

_local = threading.local()
_ids = itertools.count(1)


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _open_range(name: str):
    """A ``record_function`` range entered for ``name`` when a profiler
    runs, else None (the check costs a fraction of a microsecond; an
    idle range costs tens)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch.profiler.record_function(name)
    rng.__enter__()
    return rng


class span:
    """A context manager that records one step; after it closes it is the
    record that :func:`records` returns.  ``nbytes`` may be set inside
    the block, once the bytes are known; ``counts`` takes the site's
    counters.  With ``timer`` (a :class:`StageTimer`) the interval and
    bytes also add to its stage ``stage``."""

    __slots__ = ("name", "nbytes", "counts", "id", "parent", "root",
                 "thread", "start", "end", "_timer", "_stage", "_range")

    def __init__(self, name: str, nbytes: int = 0, timer=None,
                 stage: str = None):
        self.name, self.nbytes, self.counts = name, nbytes, {}
        self._timer, self._stage = timer, stage

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        self.thread = threading.get_ident()
        stack.append(self)
        self._range = _open_range(self.name)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _stack().pop()
        RING.add(self)
        if self._timer is not None:
            self._timer.add(self._stage, self.end - self.start, self.nbytes)
        return False

    def __repr__(self):
        return "span(%r, id=%s, parent=%s, root=%s)" % (
            self.name, self.id, self.parent, self.root)


def traced(name: str):
    """Decorator: every call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def carry(fn):
    """``fn`` wrapped so that the spans it opens, on whatever thread runs
    it, have as parent the span open here now: the submitter's."""
    stack = _stack()
    if not stack:
        return fn
    up = stack[-1]

    @functools.wraps(fn)
    def call(*args, **kwargs):
        there = _stack()
        there.append(up)
        try:
            return fn(*args, **kwargs)
        finally:
            there.pop()
    return call


class Ring:
    """The last ``size`` closed spans, and the latest start among those
    it dropped to make room."""

    def __init__(self, size: int):
        self.items = collections.deque(maxlen=size)
        self.dropped_start = float("-inf")
        self._lock = threading.Lock()

    def add(self, rec) -> None:
        with self._lock:
            if len(self.items) == self.items.maxlen:
                self.dropped_start = max(self.dropped_start,
                                         self.items[0].start)
            self.items.append(rec)

    def since(self, start: float):
        with self._lock:
            return ([r for r in self.items if r.start >= start],
                    self.dropped_start >= start)


RING = Ring(65536)


def records(since: float = float("-inf")):
    """``(spans, dropped)``: the closed spans that started at ``since`` or
    later, in the order they closed, and whether the ring dropped any
    such span to make room."""
    return RING.since(since)


def minor_faults() -> int:
    """The process's minor page faults so far (``getrusage``)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


class StageTimer:
    """Accumulates (seconds, bytes) per named stage.

    Usage::

        timer = StageTimer()
        with timer.stage("encode+write", "text_to_minh.encode_write",
                         nbytes=x.nbytes):
            out = encode(x)
        print(timer.report())
    """

    def __init__(self):
        self.stages: dict[str, list[float]] = {}
        self._lock = threading.Lock()

    def stage(self, key: str, name: str, nbytes: int = 0) -> span:
        """A :class:`span` ``name`` that also adds to stage ``key``."""
        return span(name, nbytes, self, key)

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
