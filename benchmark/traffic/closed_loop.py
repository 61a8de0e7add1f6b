"""The closed loop: ``callers`` callers, each sending its next request
only when its last one has ended, for ``seconds``.

A request that starts before the window's end runs to its end, so the
window ends with the last request.  Every request is counted; one that
raises is a failure, with its error kept.  The outputs of ``sample``
requests, drawn uniformly from all of the window's by reservoir sampling
on the run's seed, are kept for the check; every other output is dropped
as soon as its request has ended.
"""

from __future__ import annotations

import threading
import time
import traceback

import numpy as np


def run(workload, seconds: float, mix: dict, seed: int):
    """Drive ``workload.request(i) -> (values, output)``; returns
    ``(records, kept, start, end)``: one record a request (``start``,
    ``end``, ``values``, ``error``), the kept ``[(i, output)]``, and the
    window's bounds on the host's clock."""
    callers = int(mix.get("callers", 1))
    sample = int(mix["sample"])
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    lock = threading.Lock()
    records, kept = [], []
    count = [0]
    start = time.perf_counter()
    deadline = start + seconds

    def keep(i, out):
        """Reservoir step for request ``i``'s output, the last of
        ``records`` (under the lock); returns what to drop."""
        if len(kept) < sample:
            kept.append((i, out))
            return None
        j = int(rng.integers(0, len(records)))
        if j < sample:
            kept[j], out = (i, out), kept[j][1]
        return out

    def caller():
        while True:
            with lock:
                if time.perf_counter() >= deadline:
                    return
                i = count[0]
                count[0] += 1
            t0 = time.perf_counter()
            values, out, error = 0, None, None
            try:
                values, out = workload.request(i)
            except Exception:  # a failed request is counted, not fatal
                error = traceback.format_exc(limit=4)
            t1 = time.perf_counter()
            with lock:
                records.append({"i": i, "start": t0, "end": t1,
                                "values": values, "error": error})
                drop = keep(i, out) if error is None else None
            if drop is not None:
                workload.drop(drop)

    threads = [threading.Thread(target=caller) for _ in range(callers - 1)]
    for t in threads:
        t.start()
    caller()
    for t in threads:
        t.join()
    end = max([start] + [r["end"] for r in records])
    records.sort(key=lambda r: r["i"])
    return records, kept, start, end
