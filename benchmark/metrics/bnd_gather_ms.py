"""The program's spans of the cell gathers a conversion, in milliseconds,
over the window: ``boundary.gather``, once a coded column (its values
gathered into a padded batch of one row a cell for the encoder)."""

SPANS = ("boundary.gather",)


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
