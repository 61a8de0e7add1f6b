"""The share of the traced window in which no kernel, copy or memset ran
on the card, in percent (``torch.profiler``, the union of the device's
intervals), in the read cells."""


def read(run):
    if run.trace is None:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
