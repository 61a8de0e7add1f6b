"""The program's spans ``lgadget2.read`` (one LGadget-2 file's open, read
and checks, for its positions, velocities or ids) a conversion, in
milliseconds, over the window."""

SPANS = ("lgadget2.read",)


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
