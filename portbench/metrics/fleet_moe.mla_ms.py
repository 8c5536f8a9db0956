"""Card time a decode step launched inside the program's ``attn.mla``
spans (every layer's latent attention), by ``portbench.attribution``'s
join over the traced stretch, over the decode steps in it."""


def read(run):
    busy = run.counts.get("mla_busy_s")
    n = run.counts.get("traced_decodes")
    return busy / n * 1e3 if busy is not None and n else None
