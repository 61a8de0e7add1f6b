"""The CUDA device, and what the card reports about itself.

Counterpart of ``minnow_tpu/utils/backend_guard.py``, without its probe
subprocess and host downgrade: a CUDA runtime either answers at once or
the caller gets an error.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

__all__ = ["cuda_device", "card_info", "time_ms", "graph_ms"]


def cuda_device() -> torch.device:
    """The CUDA device, or RuntimeError when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            "(torch %s, built for CUDA %s)"
            % (torch.__version__, torch.version.cuda))
    return torch.device("cuda")


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each, as the tool prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps=7, warmup=2) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream, between
    CUDA events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, count=20, reps=7) -> float:
    """Milliseconds of one ``fn()`` without the host's time to issue it:
    ``count`` calls captured in one CUDA graph, the median replay over
    ``count``.  ``fn`` must launch on the current stream and must not
    wait for the device."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [fn() for _ in range(count)]
    ms = time_ms(graph.replay, reps) / count
    del graph, kept
    return ms
