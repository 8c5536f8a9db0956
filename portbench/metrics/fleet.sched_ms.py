"""Host time of the schedulers a slice: the program's ``sched.slice``
spans in the window, summed, over the window's slices."""


def read(run):
    n = run.counts.get("slices", 0)
    if "sched_s" not in run.counts or not n:
        return None
    return run.counts["sched_s"] / n * 1e3
