"""The median over the window of the benchmark's span around a request's
``read_*`` calls (the open excluded), in milliseconds."""

import statistics


def read(run):
    times = run.span_seconds("read_call")
    return statistics.median(times) * 1e3 if times else None
