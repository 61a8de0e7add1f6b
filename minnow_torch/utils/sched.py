"""Host-side task parallelism helpers (ref go/thread/thread.go; a copy
of ``minnow_tpu/utils/sched.py``).

The reference's entire parallel runtime is a goroutine worker pool with
contiguous/strided array splitting.  Here the hot loops run on the CUDA
device (ops/) or in C++ threads (native/); these helpers cover the
remaining host-side fan-out (per-file conversions, per-column IO) with
the same API shape.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

__all__ = ["split", "split_array", "worker_queue",
           "contiguous", "jump", "weighted_contiguous",
           "weighted_bounds"]


def worker_queue(workers: int, jobs: int, work) -> None:
    """Run ``work(worker, job)`` for every job on a pool of workers
    (ref go/thread/thread.go:150-169)."""
    if workers <= 1 or jobs <= 1:
        for j in range(jobs):
            work(0, j)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = [pool.submit(work, j % workers, j) for j in range(jobs)]
        for f in futs:
            f.result()


def split(jobs: int, work) -> None:
    """One worker per job (ref go/thread/thread.go:24-26)."""
    worker_queue(jobs, jobs, lambda w, j: work(j))


def contiguous():
    """Contiguous chunks strategy (ref go/thread/thread.go:47-49)."""
    return "contiguous"


def jump():
    """Strided strategy for load balancing
    (ref go/thread/thread.go:54-56)."""
    return "jump"


def weighted_contiguous(weights):
    """Weighted contiguous strategy (declared but left as a
    'not yet implemented' panic in the reference --
    ref go/thread/thread.go:60-62,133-137; implemented here)."""
    return ("weighted", list(weights))


def weighted_bounds(weights, workers: int):
    """Contiguous chunk boundaries with roughly equal total weight:
    worker w gets jobs [bounds[w], bounds[w+1])."""
    total = float(sum(weights)) or 1.0
    target = total / workers
    bounds = [0]
    acc = 0.0
    for i, wt in enumerate(weights):
        acc += wt
        while len(bounds) < workers and acc >= target * len(bounds):
            bounds.append(i + 1)
    while len(bounds) < workers:
        bounds.append(len(weights))
    bounds.append(len(weights))
    return bounds


def split_array(jobs: int, workers: int, work,
                strategy="contiguous") -> None:
    """Partition ``range(jobs)`` across workers; ``work(worker, start,
    end, step)`` loops ``for i in range(start, end, step)``
    (ref go/thread/thread.go:88-131)."""
    if strategy == "contiguous":
        nstep = jobs // workers
        if jobs % workers != 0:
            nstep += 1

        def job(w):
            lo = w * nstep
            hi = min((w + 1) * nstep, jobs)
            work(w, lo, hi, 1)

        split(workers, job)
    elif strategy == "jump":
        split(workers, lambda w: work(w, w, jobs, workers))
    elif isinstance(strategy, tuple) and strategy[0] == "weighted":
        weights = strategy[1]
        if len(weights) != jobs:
            raise ValueError("need one weight per job")
        bounds = weighted_bounds(weights, workers)
        split(workers,
              lambda w: work(w, bounds[w], bounds[w + 1], 1))
    else:
        raise ValueError("Unknown strategy, %r." % (strategy,))
