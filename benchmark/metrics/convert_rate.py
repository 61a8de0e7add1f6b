"""Values written into closed minnow files over the whole window, in
millions a second: every conversion's values over all the window's time."""


def read(run):
    return run.values() / run.window_s / 1e6
