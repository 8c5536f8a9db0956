"""Drivers: each runs one kind of traffic mix (the mix's ``driver``)
through the system under test and fills a :class:`portbench.bench.Run`.
"""
from __future__ import annotations

import dataclasses
import gc
import time

# the configuration file's keys that set the registry ModelConfig's fields
_FIELDS = {"n_layers": "n_layers", "d_model": "d_model",
           "n_heads": "n_heads", "n_kv_heads": "n_kv_heads",
           "head_dim": "head_dim", "d_ff": "d_ff",
           "vocab_size": "vocab_size", "norm_eps": "norm_eps",
           "tie_embeddings": "tie_embeddings", "scan_layers": "scan_layers"}


def program_config(c: dict):
    """The program's ModelConfig of the configuration file ``c``: the
    registry's entry ``c["registry"]`` with the file's sizes, compute
    dtype and layout."""
    import torch

    from repro_torch.configs import get_config
    fields = {a: c[k] for k, a in _FIELDS.items() if k in c}
    fields["dtype"] = getattr(torch, c["compute_dtype"])
    return dataclasses.replace(get_config(c["registry"]), **fields)


def lut_entries(lut) -> list:
    """A placement LUT's entries as plain tuples: (budget, placement,
    task energy, task time, feasible)."""
    return [(e.t_constraint_ns, dict(e.placement), e.e_task_pj, e.t_task_ns,
             bool(e.feasible)) for e in lut.entries]


def lut_mismatch(have: list, want: list) -> int:
    """Entries that differ by a bit, and entries missing on one side."""
    return abs(len(have) - len(want)) + sum(a != b
                                            for a, b in zip(have, want))


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


class Window:
    """The measured window: opened after set-up, closed by the first
    unit that ends ``seconds`` or more after the opening."""

    def __init__(self, run):
        self.run = run
        self.t0 = self.last = None

    def open(self) -> None:
        # what set-up made is never collected again: a collection in
        # the window walks only what the window makes
        gc.collect()
        gc.freeze()
        sync(self.run.device)
        if self.run.device == "cuda":
            import torch
            torch.cuda.reset_peak_memory_stats()
        self.t0 = self.last = time.perf_counter()
        self.run.setup_s = time.time() - self.run.t_start

    def unit_done(self) -> bool:
        """Close one unit (after a synchronize); True once the window is
        over."""
        sync(self.run.device)
        t = time.perf_counter()
        self.run.units.append(t - self.last)
        self.last = t
        if t - self.t0 >= self.run.seconds:
            self.run.window_s = t - self.t0
            gc.unfreeze()
            return True
        return False
