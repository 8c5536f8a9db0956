"""Plain PyTorch versions of the ``rglru_scan`` kernels: the RG-LRU's
linear recurrence ``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``, and
its backward.

The forward is the sequential loop over time that the port's
``rglru_block`` ran before the kernel existed, value for value: one fp32
multiply and one fp32 add per step, each rounded. The JAX package runs
the same recurrence as ``lax.associative_scan``
(``repro/models/recurrent.py::rglru_block``), which associates the
products in another order, so the two differ by fp32 rounding only. The
CPU tests use these as the kernels' stand-ins and ``chip_smoke.py`` holds
the kernels against them, bit for bit, on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, d) fp32 of the recurrence over axis 1 of ``a``, ``b``
    (B, S, d) fp32."""
    hs = []
    ht = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        ht = a[:, t] * ht + b[:, t]
        hs.append(ht)
    return torch.stack(hs, dim=1)


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(da, db)`` of the recurrence, given its inputs' ``a``, its output
    ``h`` and the output's gradient ``dh`` (all (B, S, d) fp32).

    ``g_t = dh_t + a_{t+1} * g_{t+1}`` from ``g_{S-1} = dh_{S-1}``, run
    backwards in time; then ``da_t = g_t * h_{t-1}`` (``h_{-1} = 0``) and
    ``db_t = g_t``.
    """
    S = h.shape[1]
    gs = [None] * S
    g = dh[:, S - 1].clone()
    gs[S - 1] = g
    for t in range(S - 2, -1, -1):
        g = dh[:, t] + a[:, t + 1] * g
        gs[t] = g
    db = torch.stack(gs, dim=1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return db * h_prev, db
