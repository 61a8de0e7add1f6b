"""The program's ``StageTimer`` stages of the text ingest (``read``,
``scan_lines``, ``parse``, ``mass_cut``) a conversion, in milliseconds."""

STAGES = ("read", "scan_lines", "parse", "mass_cut")


def read(run):
    done = run.done()
    if not done or not run.stages:
        return None
    return sum(run.stages.get(s, 0.0) for s in STAGES) / done * 1e3
