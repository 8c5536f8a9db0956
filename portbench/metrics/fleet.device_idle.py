"""Share of the traced stretch in which no kernel, copy or memset ran
on the card (the union of the profiler's device intervals)."""


def read(run):
    tr = run.device_trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
