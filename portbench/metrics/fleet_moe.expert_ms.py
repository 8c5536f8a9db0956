"""Card time a decode step launched inside the program's ``moe.experts``
spans (the MoE layers' routing, expert and shared-expert work), by
``portbench.attribution``'s join over the traced stretch, over the
decode steps in it."""


def read(run):
    busy = run.counts.get("expert_busy_s")
    n = run.counts.get("traced_decodes")
    return busy / n * 1e3 if busy is not None and n else None
