"""95th percentile, by nearest rank, of every fleet slice of a traced
run's window: from the end of the previous slice to its own end, after
a synchronize (host clock; the traced run also synchronizes at the
edges of every decode and migration)."""
from portbench.counts import nearest_rank


def read(run):
    return nearest_rank(run.units, 95) * 1e3 if run.trace and run.units \
        else None
