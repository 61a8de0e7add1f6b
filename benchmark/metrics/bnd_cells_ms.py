"""The program's span of the boundary cell assignment a conversion, in
milliseconds, over the window: ``boundary.cells`` (each halo's host cell
and the cells whose ghost shell holds it, the stable sort and split into
cells, and the flag column's groups)."""

SPANS = ("boundary.cells",)


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
