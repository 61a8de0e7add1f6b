"""The program's ``StageTimer`` stage ``encode+write`` (the batch encode
on the card and the file writes) a conversion, in milliseconds."""


def read(run):
    done = run.done()
    if not done or "encode+write" not in run.stages:
        return None
    return run.stages["encode+write"] / done * 1e3
