"""The median over the window of the benchmark's span around
``minp.Reader(...)`` / ``minh.Reader(...)``: the headers and the tail, in
milliseconds."""

import statistics


def read(run):
    times = run.span_seconds("open")
    return statistics.median(times) * 1e3 if times else None
