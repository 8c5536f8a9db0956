"""Training step: microbatched gradient accumulation + optimizer.

The reference's ``lax.scan`` over microbatches is a Python loop over the
same ``reshape`` split here, and ``jax.value_and_grad`` is
:func:`value_and_grad`: ``torch.autograd.grad`` over every param leaf,
with zeros for a leaf the loss does not reach, as JAX gives.

On a mesh (params, optimizer state and batch as DTensors, laid out by
:mod:`repro_torch.parallel.sharding`) the same step runs under
``sharding.on_mesh``; each microbatch is a slice of every
rank's local rows, gradients are accumulated in their parameters'
layouts (a partial sum is reduce-scattered onto its shards as it is
added) and moved onto those layouts before the optimizer updates in
place. The single-device path is unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import Optimizer
from repro_torch.parallel import sharding
from repro_torch.tree import leaves, tree_map

PyTree = Any


def default_optimizer_kind(cfg: ModelConfig) -> str:
    """Arctic-class models need factored moments to fit 16 GB/chip."""
    if cfg.n_experts >= 64:
        return "adafactor"
    return "adamw"


def default_train_memory_plan(cfg: ModelConfig, global_batch: int
                              ) -> Dict[str, Any]:
    """Microbatch count + grad-accumulation dtype per model scale."""
    big = cfg.d_model >= 5120 or cfg.n_experts >= 16
    micro = 16 if big else 8
    while global_batch % micro:
        micro //= 2
    return {"num_microbatches": max(micro, 1),
            "accum_dtype": torch.bfloat16 if big else torch.float32}


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss(params, batch):
        return lm.loss_fn(params, cfg, batch)
    return loss


def value_and_grad(loss_fn: Callable, params: PyTree, batch: PyTree
                   ) -> Tuple[Tuple[torch.Tensor, Dict], PyTree]:
    """((loss, metrics), grads) of ``loss_fn(params, batch)`` with respect
    to every leaf of ``params``; the returned loss and metrics are
    detached. ``params`` itself is left without ``requires_grad``: the
    graph is built on detached aliases of its leaves."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(live, batch)
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)])
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(it), params)


def _microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of one batch leaf.

    One device: rows ``[i*B/n, (i+1)*B/n)``, the reference's ``reshape``
    split. A DTensor: the same slice of each rank's local rows, so no
    microbatch moves data between ranks. With the batch sharded over the
    data axes, microbatch ``i`` then holds different global rows than on
    one device (rank r's slice ``i``, for every r); the step's sum over
    microbatches is the same. Reshaping the global batch instead would
    move the sharded batch dim onto the microbatch index, the layout the
    JAX package's multi-device step trips on (ROADMAP note (a))."""
    if isinstance(x, DTensor):
        local = x.to_local()
        return DTensor.from_local(
            local.reshape((n, local.shape[0] // n) + local.shape[1:])[i],
            x.device_mesh, x.placements, run_check=False)
    return x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    num_microbatches: int = 1,
                    accum_dtype=torch.float32) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. The optimizer updates ``params`` and ``opt_state`` in
    place (:mod:`repro_torch.optim.adamw`). With DTensor params the step
    runs on their mesh and returns the loss as a plain tensor."""
    loss_fn = make_loss_fn(cfg)

    def step(params: PyTree, opt_state: PyTree, batch: PyTree, mesh: bool
             ) -> Tuple[PyTree, PyTree, Dict[str, torch.Tensor]]:
        if num_microbatches == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            n = num_microbatches
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(n):
                mb = tree_map(lambda x: _microbatch(x, n, i), batch)
                (loss_mb, _m), g = value_and_grad(loss_fn, params, mb)
                # in place: the same rounding as ``a + b.astype(a.dtype)``
                for a, b in zip(leaves(gsum), leaves(g)):
                    a.add_(b.to(a.dtype))
                lsum = lsum + loss_mb
                del g
            # a tensor divisor, as in optim.adamw
            nt = torch.tensor(float(n), device=lsum.device)
            grads = tree_map(lambda g: (g.float() / nt).to(accum_dtype),
                             gsum)
            del gsum
            loss = lsum / nt
            metrics = {}
        if mesh:
            grads = sharding.redistribute_like(grads, params)
            if isinstance(loss, DTensor):
                loss = loss.full_tensor()

        new_params, new_opt_state = opt.update(grads, opt_state, params)
        out_metrics = {"loss": loss}
        out_metrics.update({k: v for k, v in metrics.items()
                            if k in ("aux",)})
        return new_params, new_opt_state, out_metrics

    def train_step(params: PyTree, opt_state: PyTree, batch: PyTree
                   ) -> Tuple[PyTree, PyTree, Dict[str, torch.Tensor]]:
        if not sharding.is_distributed(params):
            return step(params, opt_state, batch, mesh=False)
        with sharding.on_mesh():
            return step(params, opt_state, batch, mesh=True)

    return train_step
