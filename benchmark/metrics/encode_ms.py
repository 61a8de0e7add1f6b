"""The program's spans of the batch encode a conversion, in milliseconds,
over the window: ``encoder.encode_float`` and ``encoder.encode_int``,
each a whole batch (the put, the launches, the read back, the payloads
and the host fallback)."""

SPANS = ("encoder.encode_float", "encoder.encode_int")


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
