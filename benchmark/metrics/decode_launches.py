"""K2 and K4 launches a request, from the program's launch counters."""


def read(run):
    done = run.done()
    if not done:
        return None
    return (run.counters["K2"] + run.counters["K4"]) / done
