"""Sharding rules: map every param/state/batch tensor to a spec, and a
spec to DTensor placements on a :class:`DeviceMesh`.

Convention (DESIGN.md SS.6), the JAX package's rules unchanged:
  * batch dims            -> ("pod", "data") (whichever divide)
  * matmul "wide" dims    -> "model" (tensor parallelism)
  * matmul "narrow" dims  -> "data"  (FSDP-style parameter sharding)
  * MoE expert dim        -> "model" (expert parallelism)
  * scanned-stack leading dim, biases, norms -> replicated

Rules are divisibility-guarded: a dim that does not divide its axis is
replicated instead, so the same rules serve 16x16, 2x16x16 and tiny test
meshes, and a (1, 1) mesh replicates everything.

A spec is a tuple with one entry per tensor dim, each ``None``, an axis
name or a tuple of axis names, exactly as JAX's ``PartitionSpec`` reads as
a tuple. :func:`to_placements` turns it into one placement per mesh dim;
a tuple of axes on one tensor dim shards that dim over each of them,
the first axis major, which is the block each device gets from JAX's
``NamedSharding`` (pod major). A mesh is anything with ``.shape``: a
mapping of axis names to sizes (as JAX's ``Mesh.shape``), or a torch
``DeviceMesh`` (``.shape`` a tuple, ``.mesh_dim_names`` its names).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.overrides import TorchFunctionMode

from repro_torch.tree import flatten_with_path, tree_map

PyTree = Any
Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a mesh whose ``.shape``
    is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def dp_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        n = math.prod(_axis_size(mesh, a) for a in axis)
    else:
        n = _axis_size(mesh, axis)
    return dim % n == 0 and n > 1


def _entry(ax):
    """A spec entry as ``PartitionSpec`` keeps it: a one-name tuple is
    the name."""
    return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax


def _guard(shape, mesh, *axes) -> Spec:
    """Spec with divisibility fallback to replication per dim."""
    return tuple(_entry(ax) if _fits(dim, mesh, ax) else None
                 for dim, ax in zip(shape, axes))


# ---------------------------------------------------------------------------
# parameter rules (keyed on param path names from repro_torch.models.lm)
# ---------------------------------------------------------------------------

_MODEL_OUT = ("wq", "wk", "wv", "w_gate", "w_up", "w_in_x", "w_in_g",
              "w_a", "w_x", "wz", "wi", "wf", "wo_gate", "lm_head")
_MODEL_IN = ("wo", "w_down", "w_out")


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               mesh, scanned: bool, inference: bool = False) -> Spec:
    """Spec for one parameter identified by its tree path.

    ``inference=True`` drops the FSDP "data" factor (params replicated
    across data ranks): without grads/optimizer the data-sharding only buys
    capacity, and its per-matmul weight all-gathers dominate the decode
    collective term."""
    name = path[-1]
    lead: Spec = (None,) if scanned else ()
    body = shape[1:] if scanned else shape

    def out(*axes) -> Spec:
        if inference:
            axes = tuple(None if a == "data" else a for a in axes)
        return lead + _guard(body, mesh, *axes)

    if len(body) <= 1:
        return out(None)
    if name == "embed":
        # vocab replicated: a vocab-sharded table turns the token gather
        # into a full-table all-gather; d_model-sharded rows keep it local
        return out(None, "model")
    if name == "router":
        return out("data", None)
    if name in ("w_gate", "w_up", "w_down") and len(body) == 3:
        # MoE experts: (E, d, f) / (E, f, d) - expert-parallel + FSDP
        if name == "w_down":
            return out("model", None, "data")
        return out("model", "data", None)
    if name == "conv_w":
        return out(None, "model")
    if name in _MODEL_OUT:
        return out("data", "model")
    if name in _MODEL_IN:
        return out("model", "data")
    return out(*([None] * len(body)))


def _names(path) -> Tuple[str, ...]:
    return tuple(str(p) for p in path)


def _specs_with_path(tree: PyTree, fn) -> PyTree:
    """``fn(names, leaf)`` over the leaves of ``tree``, keyed by path."""
    it = iter([fn(_names(path), leaf)
               for path, leaf in flatten_with_path(tree)])
    return tree_map(lambda _: next(it), tree)


def params_shardings(params: PyTree, mesh, inference: bool = False
                     ) -> PyTree:
    """Spec tree for a (possibly abstract) param tree."""
    return _specs_with_path(params, lambda names, leaf: param_spec(
        names, tuple(leaf.shape), mesh, "scan" in names, inference))


def inference_fits_tp_only(params: PyTree, mesh,
                           budget_bytes: float = 8 * 2 ** 30) -> bool:
    """True if TP-only residency (replicated over data) fits per device."""
    total = sum(math.prod(x.shape) * 2 for _, x in flatten_with_path(params))
    return total / _axis_size(mesh, "model") <= budget_bytes


# ---------------------------------------------------------------------------
# batch / activation / decode-state rules
# ---------------------------------------------------------------------------


def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Shard dim0 (batch) over pod x data when divisible."""
    dp = dp_axes(mesh)
    rest = (None,) * (len(shape) - 1)
    if dp and _fits(shape[0], mesh, dp):
        return (_entry(dp),) + rest
    if "data" in axis_sizes(mesh) and _fits(shape[0], mesh, "data"):
        return ("data",) + rest
    return (None,) * len(shape)


def batch_shardings(batch: PyTree, mesh) -> PyTree:
    return tree_map(lambda x: batch_spec(tuple(x.shape), mesh), batch)


def decode_state_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                      mesh, scanned: bool) -> Spec:
    """KV caches: (B, S, KV, hd) -> (dp, model-on-S, None, None), or hd on
    model when S does not divide; recurrent states: batch + widest dim on
    model."""
    name = path[-1]
    lead: Spec = (None,) if scanned else ()
    body = shape[1:] if scanned else shape
    dp = dp_axes(mesh)
    b_ax = _entry(dp) if _fits(body[0], mesh, dp) else (
        "data" if _fits(body[0], mesh, "data") else None)
    if name in ("k", "v") and len(body) == 4:
        # sequence-sharded KV: decode attention becomes distributed softmax
        # (local logits + small stat/PV reductions); hd-sharding instead
        # gathers the whole cache every layer
        if _fits(body[1], mesh, "model"):
            return lead + (b_ax, "model", None, None)
        return lead + (b_ax, None, None,
                       "model" if _fits(body[3], mesh, "model") else None)
    if name == "C" and len(body) == 4:          # mLSTM (B,H,hd,hd)
        return lead + (b_ax, None,
                       "model" if _fits(body[2], mesh, "model") else None,
                       None)
    if len(body) >= 2:
        last = "model" if _fits(body[-1], mesh, "model") else None
        return lead + (b_ax,) + (None,) * (len(body) - 2) + (last,)
    return lead + (b_ax,)


def decode_state_shardings(state: PyTree, mesh) -> PyTree:
    return _specs_with_path(state, lambda names, leaf: decode_state_spec(
        names, tuple(leaf.shape), mesh, "scan" in names))


def replicated(mesh) -> Spec:
    """The replicated spec (``P()``): every dim whole on every device."""
    return ()


# ---------------------------------------------------------------------------
# optimizer-state rules (mirror parameter shardings)
# ---------------------------------------------------------------------------


def params_shardings_like(opt_state: PyTree, params: PyTree,
                          pshard: PyTree, mesh) -> PyTree:
    """Specs for optimizer state trees.

    adam m/v/master mirror the FSDP param rules (ZeRO-style, even when
    ``pshard`` is TP-only); adafactor vr drops the last dim of the param
    spec, vc drops the second-to-last; scalars are replicated.
    """
    def drop_last(s: Spec) -> Spec:
        return s[:-1] if s else s

    def drop_second_last(s: Spec) -> Spec:
        return s[:-2] + s[-1:] if len(s) >= 2 else ()

    out = {}
    for key, sub in opt_state.items():
        if key in ("m", "v", "master"):
            out[key] = _specs_with_path(sub, lambda names, leaf: param_spec(
                names, tuple(leaf.shape), mesh, "scan" in names))
        elif key == "vr":
            out[key] = tree_map(
                lambda p, s: drop_last(s) if p.ndim >= 2 else s,
                params, pshard)
        elif key == "vc":
            out[key] = tree_map(
                lambda p, s: drop_second_last(s) if p.ndim >= 2
                else replicated(mesh), params, pshard)
        else:
            out[key] = tree_map(lambda _: replicated(mesh), sub)
    return out


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------


def to_placements(spec: Spec, mesh) -> Tuple[Placement, ...]:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` on
    every mesh axis that tensor dim ``d`` names, ``Replicate()`` on the
    rest. A tuple of axes must list them in mesh order, so the first is
    major, as in JAX."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh
                ) -> Tuple[int, ...]:
    """Each device's block shape under ``spec`` (the guards make every
    sharded dim divide its axes)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, spec):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        out.append(dim // math.prod(_axis_size(mesh, a) for a in axes))
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh, as JAX's ``NamedSharding``: what
    ``checkpoint.ckpt.restore(..., shardings=)`` lays a leaf out by."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return to_placements(self.spec, self.mesh)


def named(specs: PyTree, like: PyTree, mesh) -> PyTree:
    """The specs of ``specs`` on ``mesh``, one :class:`NamedSharding` per
    leaf of ``like`` (the tree the specs were made for)."""
    return tree_map(lambda _, s: NamedSharding(mesh, s), like, specs)


def distribute(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """``tree``'s tensors as DTensors on ``mesh``, each laid out by its
    spec (the counterpart of ``jax.device_put(tree, shardings)``)."""
    return tree_map(lambda x, s: distribute_tensor(
        x, mesh, to_placements(s, mesh)), tree, specs)


def redistribute_like(tree: PyTree, like: PyTree) -> PyTree:
    """Each DTensor of ``tree`` moved to the placements of the matching
    leaf of ``like`` (a gradient onto its parameter's layout)."""
    return tree_map(lambda x, ref: x.redistribute(
        ref.device_mesh, ref.placements), tree, like)


def is_distributed(tree: PyTree) -> bool:
    """True if the tree's leaves are DTensors."""
    flat = flatten_with_path(tree)
    return bool(flat) and isinstance(flat[0][1], DTensor)


_VIEWS = frozenset({torch.Tensor.reshape, torch.reshape, torch.Tensor.view})


class _PinViewGrads(TorchFunctionMode):
    """Pins the gradient of every DTensor reshape or view to the layout
    its forward result has (a redistribution to
    its own placements: nothing moves forward; backward moves the
    incoming gradient there before the view's backward runs). DTensor
    otherwise chooses gradient layouts op by op, and the backward of a
    reshape that splits or merges a dim sharded that way yields a strided
    shard, which sharding propagation on fake tensors cannot handle
    (``_local_scalar_dense``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _VIEWS and isinstance(out, DTensor) \
                and out.requires_grad:
            out = out.redistribute(out.device_mesh, out.placements)
        return out


@contextlib.contextmanager
def on_mesh() -> Iterator[None]:
    """The scope of one step on DTensors: plain tensors mix with DTensors
    as replicated DTensors, and view gradients keep their forward layouts
    (:class:`_PinViewGrads`).

    The models build plain tensors inside (RoPE tables, masks,
    ``torch.arange`` positions, fp32 divisors), replicated by
    construction; on DTensor params every op that mixes one with a DTensor
    would otherwise raise ("mixed torch.Tensor and DTensor").
    ``torch.distributed.tensor.experimental.implicit_replication`` sets
    the same flag but is broken in torch 2.13 (it reaches through
    ``DTensor._op_dispatcher``, which is ``None`` there), so this sets
    the flag underneath it and restores the previous value on exit."""
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        with _PinViewGrads():
            yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)
