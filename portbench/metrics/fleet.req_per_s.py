"""Requests the fleet completed in a traced run's window over its
seconds (host clock)."""


def read(run):
    return run.counts["completed"] / run.window_s \
        if run.trace and run.window_s else None
