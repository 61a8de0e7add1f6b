"""The program's span ``read.stage`` a request, in milliseconds, over the
window: the padded word buffer, the block tables, the dither keys and
the staging buffer, up to the host->device copy."""

SPANS = ("read.stage",)


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
