"""Collective bytes per device, counted while a step runs: the
counterpart of the JAX package's ``launch/hloparse.py``.

The JAX package parses the compiled HLO text and multiplies each
collective inside a ``while`` body by the loop's trip count, because the
compiled program runs that body many times from one textual copy. Here
the step runs eagerly on DTensors, and DTensor lowers every
redistribution to a functional collective (``torch.ops._c10d_functional``)
each time it happens, so a collective inside the layer or microbatch
loop is seen once per iteration and no trip multiplier is needed.
``hloparse.while_summary`` (the trip count of each ``while`` loop) has
no counterpart: an eager step has no loops to summarise.

:class:`CollectiveCounter` is a dispatch mode. Around a step it sums the
output bytes of each collective as one device sees them (a gathered
block, a reduced block, a scattered piece), under the JAX package's kind
names, into the dict that ``hloparse.collective_bytes`` returns:
``{"all-gather": ..., "all-reduce": ..., ..., "total": ...}``, with a
key only for the kinds that occurred.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed._functional_collectives  # noqa: F401  registers ops
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _kinds() -> Dict[object, str]:
    ops = torch.ops._c10d_functional
    return {
        ops.all_gather_into_tensor: "all-gather",
        ops.all_gather_into_tensor_coalesced: "all-gather",
        ops.all_reduce: "all-reduce",
        ops.all_reduce_coalesced: "all-reduce",
        ops.reduce_scatter_tensor: "reduce-scatter",
        ops.reduce_scatter_tensor_coalesced: "reduce-scatter",
        ops.all_to_all_single: "all-to-all",
    }


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as cc: step()`` then ``cc.bytes()``.

    An op on DTensors is handed back (``NotImplemented``) so that DTensor
    runs it and lowers its redistributions to the collectives this mode
    then sees on the local tensors, as ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        self._kind = _kinds()
        self.by_kind: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = self._kind.get(getattr(func, "_overloadpacket", None))
        if kind is not None:
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + _nbytes(out)
        return out

    def bytes(self) -> Dict[str, float]:
        out = dict(self.by_kind)
        out["total"] = sum(self.by_kind.values())
        return out
