"""The program's spans of the container's writes a conversion, in
milliseconds, over the window: ``container.write`` (a group's or a
row-block's pre-encoded blocks) and ``container.close`` (tail and
header)."""

SPANS = ("container.write", "container.close")


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
