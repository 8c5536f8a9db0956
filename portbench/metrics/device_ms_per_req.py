"""The card's busy time in the window (the union of the profiler's
device intervals over all of it) over the requests the fleet completed
in it."""


def read(run):
    busy = run.counts.get("window_busy_s")
    n = run.counts.get("completed")
    return busy / n * 1e3 if busy and n else None
