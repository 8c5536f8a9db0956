"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
world of 256 or 512 ranks.

Proves the distribution config is coherent without the hardware: for
each cell it starts a ``fake`` process group of the production mesh's
size (16x16 single pod / 2x16x16 multi-pod, :mod:`.mesh`), builds the
abstract params, optimizer state and batch (fake tensors,
:mod:`.specs`), lays them out as DTensors by the sharding rules
(:mod:`repro_torch.parallel.sharding`) over meta blocks of this rank's
local shapes, and runs the train, prefill or decode step once under
``FlopCounterMode``, the collectives counter (:mod:`.collectives`) and
:class:`PeakBytes`. Nothing is allocated and no collective moves data:
the fake world gives every collective its output shape. This is the
counterpart of the JAX package's ``jit(...).lower().compile()`` with
``cost_analysis`` / ``memory_analysis``. The step runs eagerly, op by op
through DTensor's dispatch, so a full-depth train cell (8 microbatches)
traces for minutes; ``--layers N`` cuts every config to N blocks.

Each cell's record (JSON, one file per cell) keeps the JAX package's
keys that ``roofline.py`` reads: ``status``, ``microbatches``,
``memory.{argument,output,temp}_size_in_bytes`` (per device: the local
shard bytes of the step's inputs and outputs, and the peak of what the
step allocates beyond its inputs, :class:`PeakBytes`),
``cost.flops`` (the step's FLOPs as ``FlopCounterMode`` counts them on
the global DTensor shapes; ``cost.flops_per_device`` divides by the
world) and ``collectives`` (bytes per device by kind). ``trace_s`` is
the wall time of the traced step.

Usage (the world is fake, so ``--device cpu`` traces the same step):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cuda \\
      --arch internlm2_1_8b --shape train_4k,decode_32k --mesh single,multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import warnings
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve as resolve_device
from repro_torch.launch import specs as sp
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.train.step import (default_optimizer_kind,
                                    default_train_memory_plan,
                                    make_train_step)
from repro_torch.tree import leaves, tree_map

PyTree = Any


def start_fake_world(world_size: int) -> None:
    """(Re)start this process's group as a fake world of ``world_size``
    ranks, this process rank 0: collectives return their output shapes
    and move nothing."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _layout(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """The stand-ins of ``tree`` as DTensors on ``mesh`` by ``specs``, each
    over a meta block of this rank's local shape: the global shape,
    dtype and layout the step sees, and no memory behind them. The
    blocks are plain meta tensors, made outside the fake mode the
    stand-ins come from."""
    with unset_fake_temporarily():
        return tree_map(lambda x, s: DTensor.from_local(
            torch.empty(sh.local_shape(tuple(x.shape), s, mesh),
                        dtype=x.dtype, device="meta"),
            mesh, sh.to_placements(s, mesh), run_check=False,
            shape=x.shape, stride=x.stride()), tree, specs)


def _meta(x: torch.Tensor) -> torch.Tensor:
    with unset_fake_temporarily():
        return torch.empty(x.shape, dtype=x.dtype, device="meta")


class PeakBytes(TorchDispatchMode):
    """The peak bytes of this rank's local storages that a step allocates
    and holds at once, beyond its inputs (``inputs``' storages count 0).

    An op on DTensors is handed back (``NotImplemented``) so that this
    mode sees the local ops DTensor lowers it to. DTensor also runs each
    op on global-shape fake tensors to find its output layout; those run
    under a fake mode and are not this rank's memory, so only ops that
    run with no fake mode active count. ``MemTracker`` draws the same
    line from torch 2.13 on; torch 2.11's counts the global-shape
    tensors too, many times a rank's own, so the dry run counts the
    storages itself."""

    def __init__(self, inputs):
        super().__init__()
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in inputs:
            self._seen[t.untyped_storage()] = True

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                if st in self._seen:
                    continue
                self._seen[st] = True
                n = st.nbytes()
                weakref.finalize(st, self._free, n)
                self.live += n
                self.peak = max(self.peak, self.live)
        return out


def _local_bytes(tree: PyTree) -> int:
    total = 0
    for x in leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.element_size()
    return total


def _local_tensors(tree: PyTree) -> list:
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _substrate_summary(cfg: ModelConfig, name: str, device) -> dict:
    """Serving-substrate coherence check for one arch: the registry entry
    must map the config to a model spec and yield a feasible placement LUT
    at the default slice (the placement analogue of "does it compile"),
    built on ``device``."""
    from repro_torch import api
    try:
        sub = api.substrate(name)
        model = sub.model_spec(cfg)
        t_ns = sub.default_t_slice_ns(model)
        lut = sub.build_lut(model, t_slice_ns=t_ns, device=device)
        feasible = [e for e in lut.entries if e.feasible]
        return {"substrate": name, "model_spec": model.name,
                "n_params": model.n_params,
                "t_slice_ms": round(t_ns / 1e6, 6),
                "lut_entries": len(lut.entries),
                "lut_feasible": len(feasible),
                "min_feasible_t_ms": (round(lut.min_feasible_t_ns / 1e6, 6)
                                      if feasible else None)}
    except Exception as e:
        return {"substrate": name, "error": repr(e)}


def trace_cell(cfg: ModelConfig, seq: int, batch: int, kind: str, mesh,
               device) -> Dict[str, Any]:
    """Build one cell's stand-ins on ``mesh`` and run its step once.
    Returns the record's fields (meta, ``memory``, ``cost``,
    ``collectives``, ``trace_s``). ``cfg`` is the config as lowered
    (``specs.dryrun_config``)."""
    dev = resolve_device(device)
    n_dev = mesh.size()
    with FakeTensorMode():
        params_abs = sp.abstract_params(
            cfg, serve_dtype=None if kind == "train" else torch.bfloat16,
            device=dev)
        inference = (kind != "train"
                     and sh.inference_fits_tp_only(params_abs, mesh))
        rec: Dict[str, Any] = {
            "kind": kind, "seq": seq, "batch": batch,
            "mesh": sh.axis_sizes(mesh), "tp_only_params": inference,
            "n_params": int(sum(x.numel() for x in leaves(params_abs)))}
        if kind == "train":
            # ZeRO-1 mixed precision when the bf16 compute params are
            # cheap to replicate across data ranks (<= 2 GiB/dev); bigger
            # models stay FSDP
            bf16_abs = sp.abstract_params(cfg, serve_dtype=torch.bfloat16,
                                          device=dev)
            zero1 = sh.inference_fits_tp_only(bf16_abs, mesh,
                                              budget_bytes=2 * 2 ** 30)
            if zero1:
                params_abs = bf16_abs
                opt_cfg = OptimizerConfig(kind="adamw_mp")
            else:
                opt_cfg = OptimizerConfig(kind=default_optimizer_kind(cfg))
            pshard = sh.params_shardings(params_abs, mesh, inference=zero1)
            opt = make_optimizer(opt_cfg)
            opt_abs = opt.init(params_abs)
            oshard = sh.params_shardings_like(opt_abs, params_abs, pshard,
                                              mesh)
            batch_abs = sp.train_batch_specs(cfg, seq, batch, device=dev)
            plan = default_train_memory_plan(cfg, batch)
            rec.update(microbatches=plan["num_microbatches"],
                        accum_dtype=str(plan["accum_dtype"]).split(".")[-1],
                        optimizer=opt_cfg.kind, zero1=zero1)
            args = (_layout(params_abs, pshard, mesh),
                    _layout(opt_abs, oshard, mesh),
                    _layout(batch_abs, sh.batch_shardings(batch_abs, mesh),
                            mesh))
            run = make_train_step(cfg, opt, **plan)
        elif kind == "prefill":
            batch_abs = sp.train_batch_specs(cfg, seq, batch, device=dev)
            args = (_layout(params_abs, sh.params_shardings(
                        params_abs, mesh, inference=inference), mesh),
                    _layout(batch_abs, sh.batch_shardings(batch_abs, mesh),
                            mesh))

            def run(p, b):
                # serving prefill: sample from the last position only
                # (the (B, S, vocab) logits are never built)
                with torch.no_grad(), sh.on_mesh():
                    h, _ = lm.forward_hidden(
                        p, cfg, b["tokens"],
                        prefix_embeds=b.get("prefix_embeds"),
                        enc_frames=b.get("enc_frames"))
                    head = (p["embed"].T if cfg.tie_embeddings
                            else p["lm_head"]).to(cfg.dtype)
                    return h[:, -1, :] @ head
        else:
            state_abs = sp.abstract_decode_state(cfg, batch, seq,
                                                 device=dev)
            tok_abs, pos_abs = sp.decode_token_specs(batch, device=dev)
            args = (_layout(params_abs, sh.params_shardings(
                        params_abs, mesh, inference=inference), mesh),
                    _layout(state_abs, sh.decode_state_shardings(
                        state_abs, mesh), mesh),
                    _meta(tok_abs), _meta(pos_abs))

            def run(p, s, t, pos):
                with torch.no_grad(), sh.on_mesh():
                    return lm.decode_step(p, cfg, s, t, pos)

    t0 = time.perf_counter()
    with PeakBytes(_local_tensors(args)) as pb, CollectiveCounter() as cc, \
            FlopCounterMode(display=False) as fc:
        out = run(*args)
    rec["trace_s"] = time.perf_counter() - t0
    rec["memory"] = {"argument_size_in_bytes": _local_bytes(args),
                      "output_size_in_bytes": _local_bytes(out),
                      "temp_size_in_bytes": pb.peak}
    flops = float(fc.get_total_flops())
    rec["cost"] = {"flops": flops, "flops_per_device": flops / n_dev}
    rec["collectives"] = cc.bytes()
    return rec


def lower_cell(arch: str, shape: str, mesh, device,
               layers: Optional[int] = None) -> Dict[str, Any]:
    """One registry cell on ``mesh``: the full config as lowered (cut to
    ``layers`` blocks if given), or a ``skipped`` record where the cell
    does not apply."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = sp.dryrun_config(cfg, mesh)
    seq, batch, kind = sp.SHAPES[shape]
    ok, why = sp.cell_is_applicable(cfg, shape)
    if not ok:
        return {"skipped": why}
    rec = trace_cell(cfg, seq, batch, kind, mesh, device)
    rec["n_layers"] = cfg.n_layers
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: Path,
             force: bool = False, substrate: str = "tpu-pool,gpu-pool",
             device: str = "cuda", layers: Optional[int] = None) -> dict:
    tag = f"{arch}__{shape}__{mesh_kind}"
    out_file = out_dir / f"{tag}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    multi = mesh_kind == "multi"
    start_fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device=device)
    t0 = time.time()
    rec: Dict[str, Any] = {"cell": tag, "arch": arch, "shape": shape}
    try:
        meta = lower_cell(arch, shape, mesh, device, layers)
        rec.update(meta)
        if substrate and substrate != "none" and meta.get("kind") == "decode":
            summaries = [_substrate_summary(get_config(arch), s, device)
                         for s in substrate.split(",") if s]
            # single-substrate key kept for older result readers
            rec["substrate"] = summaries[0]
            rec["substrates"] = summaries
        if "skipped" in meta:
            rec["status"] = "skipped"
        else:
            rec["status"] = "ok"
            rec["compile_s"] = round(time.time() - t0, 1)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--substrate", default="tpu-pool,gpu-pool",
                    help="comma-separated serving substrates to sanity-"
                         "check per decode cell ('none' to skip): each "
                         "must map the arch config to a model spec and "
                         "yield a feasible placement LUT")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every config to this many blocks (a train "
                         "cell traces minutes per full-depth model)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    # DTensor warns at every multi-axis reduction and CPU all-to-all
    warnings.filterwarnings("ignore", module="torch.distributed")

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(sp.SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    out_dir = Path(args.out)

    n_ok = n_skip = n_err = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mesh_kind in meshes:
                    rec = run_cell(arch, shape, mesh_kind, out_dir,
                                   force=args.force,
                                   substrate=args.substrate,
                                   device=args.device, layers=args.layers)
                    status = rec.get("status")
                    n_ok += status == "ok"
                    n_skip += status == "skipped"
                    n_err += status == "error"
                    line = f"{rec['cell']:55s} {status}"
                    if status == "ok":
                        mem = rec.get("memory", {})
                        per_dev = (mem.get("argument_size_in_bytes", 0)
                                   + mem.get("temp_size_in_bytes", 0))
                        line += (f" trace={rec.get('trace_s'):.1f}s"
                                 f" mem/dev={per_dev/2**30:.2f}GiB"
                                 f" flops={rec.get('cost', {}).get('flops')}")
                    elif status == "error":
                        line += f"  {rec.get('error', '')[:120]}"
                    print(line, flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"\nok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
