"""The device's side of a traced run, from ``torch.profiler``'s trace.

The window is the benchmark's ``window`` range.  The device was busy
where a kernel, a copy or a memset ran: the union of those intervals.
An idle gap is a stretch of the window outside that union, named by the
innermost benchmark span that was open on the host at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"


@contextlib.contextmanager
def profile(path: str):
    """Trace host and CUDA activity around a block into ``path``
    (Chrome trace format)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def kernel_name(name: str) -> str:
    """A kernel's function name: the demangled name without its return
    type, anonymous namespace, template arguments and parameters."""
    base = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    base = re.split(r"[(<]", base)[0].strip()
    return base.split(" ")[-1] or name[:80]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """``window_s``, ``busy_s``, ``kernels`` (device seconds by function
    name), ``ops`` (the same for kernels, copies and memsets) and
    ``gaps`` (the ten longest: ``[span name, seconds]``)."""

    def __init__(self, events):
        spans, device = [], []
        w0 = w1 = None
        for e in events:
            if e.get("ph") != "X":
                continue
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            cat = e.get("cat", "")
            if cat == "user_annotation":
                if e["name"] == WINDOW:
                    w0, w1 = t0, t1
                else:
                    spans.append((t0, t1, e["name"]))
            elif cat in DEVICE_CATS:
                device.append((t0, t1, cat, e["name"]))
        if w0 is None:
            raise ValueError("the trace has no '%s' range" % WINDOW)
        self.window_s = (w1 - w0) / 1e6
        self.kernels, self.ops = {}, {}
        inside = []
        for t0, t1, cat, name in device:
            a, b = max(t0, w0), min(t1, w1)
            if b <= a:
                continue
            inside.append((a, b))
            k = kernel_name(name) if cat == "kernel" else name
            self.ops[k] = self.ops.get(k, 0.0) + (t1 - t0) / 1e6
            if cat == "kernel":
                self.kernels[k] = self.kernels.get(k, 0.0) + (t1 - t0) / 1e6
        busy = _union(inside)
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        gaps, at = [], w0
        for a, b in busy + [[w1, w1]]:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        spans.sort(key=lambda s: s[1] - s[0])
        self.gaps = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (a + b) / 2
            name = next((s[2] for s in spans if s[0] <= mid <= s[1]),
                        WINDOW)
            self.gaps.append([name, (b - a) / 1e6])

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def kernel_seconds(self, names) -> float:
        """Summed device seconds of the kernels whose function name (its
        last ``::`` part) is one of ``names``."""
        return sum(s for k, s in self.kernels.items()
                   if k.split("::")[-1] in names)

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": self.gaps}
