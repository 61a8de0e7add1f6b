"""The minor page faults a request, over the window: the program's counter
``minor_faults`` on its spans ``read.columns`` (the process's faults
from a bulk read's start to its end)."""


def read(run):
    try:
        from minnow_torch.utils.profiling import records
    except ImportError:  # a program without spans
        return None
    spans, dropped = records(run.start)
    faults = [s.counts["minor_faults"] for s in spans
              if s.name == "read.columns" and s.start <= run.end
              and "minor_faults" in s.counts]
    done = run.done()
    if dropped or not faults or not done:
        return None
    return sum(faults) / done
