"""The program's spans of the re-binning by ID a conversion, in
milliseconds, over the window: ``grid.cell_index`` (a file's cell and
within-cell indices), ``grid.scatter`` (its vectors into the grid) and
``minp.split_sub_cells`` (an output file's sub-cell gather)."""

SPANS = ("grid.cell_index", "grid.scatter", "minp.split_sub_cells")


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
