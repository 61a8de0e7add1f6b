"""Values decoded and handed to the caller over the whole window, in
millions a second: every request's values over all the window's time."""


def read(run):
    return run.values() / run.window_s / 1e6
