"""The program's spans of the bulk read's file side a request, in
milliseconds, over the window: ``read.tail`` (the block table from the
parsed tail) and ``read.span`` (the one seek and read)."""

SPANS = ("read.tail", "read.span")


def read(run):
    try:
        from minnow_torch.utils.profiling import records
    except ImportError:  # a program without spans
        return None
    spans, dropped = records(run.start)
    seconds = [s.end - s.start for s in spans
               if s.name in SPANS and s.start <= run.end]
    done = run.done()
    if dropped or not seconds or not done:
        return None
    return sum(seconds) / done * 1e3
