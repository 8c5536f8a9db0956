"""Fault-tolerant checkpointing: atomic, async, readable by both packages.

  * atomic   - write to ``<dir>.tmp`` then rename; a crash mid-write never
               corrupts the latest checkpoint.
  * async    - ``AsyncCheckpointer`` copies the tensors to host memory at
               once and writes on a worker thread; the train loop never
               blocks on IO.
  * portable - the JAX package's layout: ``step_%08d/arrays.npz`` with one
               full host array per leaf under its ``"a__b__c"`` key path
               (sorted-key order, :mod:`repro_torch.tree`) and
               ``meta.json``. A checkpoint of either package restores in
               the other; bf16 leaves are written as float32 (exact;
               numpy has no bf16) and cast back to the template's dtype.
  * elastic  - a DTensor leaf is gathered whole (every rank takes part,
               global rank 0 writes), and ``restore(..., shardings=)``
               lays each leaf out anew on any mesh, so a job can restart
               on another topology.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import flatten_with_path, leaves, structure, tree_map

PyTree = Any

_SEP = "__"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _host(leaf) -> np.ndarray:
    """A host numpy copy of one leaf: never a view of ``leaf``'s memory,
    which an in-place optimizer step may rewrite while the copy waits to
    be written."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()         # a collective: every rank calls
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {_key(path): (_host(leaf) if isinstance(leaf, torch.Tensor)
                         else np.asarray(leaf))
            for path, leaf in flatten_with_path(tree)}


def _writer() -> bool:
    """Global rank 0 writes; a process outside any group is rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(tree: PyTree, directory: str | os.PathLike, step: int) -> Path:
    """Synchronous atomic save. Returns the final checkpoint path. With
    DTensor leaves every rank of their mesh calls it; the file is
    complete on every rank's return."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    flat = _flatten(tree)
    if _writer():
        directory.mkdir(parents=True, exist_ok=True)
        tmp = directory / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "meta.json").write_text(json.dumps({
            "step": step, "treedef": f"PyTreeDef({structure(tree)})",
            "keys": sorted(flat.keys())}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic on POSIX
    if any(isinstance(x, DTensor) for x in leaves(tree)):
        dist.barrier()
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _at(tree: PyTree, path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _restore_leaf(arr: np.ndarray, leaf, shard):
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        if shard is not None:
            return distribute_tensor(t, shard.mesh, shard.placements)
        return t
    if hasattr(leaf, "dtype"):
        return np.asarray(arr.astype(leaf.dtype))
    return arr


def restore(template: PyTree, directory: str | os.PathLike,
            step: Optional[int] = None,
            shardings: Optional[PyTree] = None) -> PyTree:
    """Restore into the structure of ``template``: each tensor leaf comes
    back with its template leaf's dtype and device, each numpy leaf as a
    numpy array of its template's dtype. ``shardings`` (a tree like
    ``template`` of :class:`~repro_torch.parallel.sharding.NamedSharding`,
    e.g. ``sharding.named(specs, template, mesh)``) lays each tensor leaf
    out as a DTensor on its mesh instead (elastic re-shard on a new
    mesh); every rank of that mesh calls it."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step:08d}"
    with np.load(path / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    it = iter([_restore_leaf(arrays[_key(p)], leaf,
                             None if shardings is None
                             else _at(shardings, p))
               for p, leaf in flatten_with_path(template)])
    return tree_map(lambda _: next(it), template)


class AsyncCheckpointer:
    """Snapshot-to-host immediately, write on a background thread."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            tree_host, step = item
            try:
                save(tree_host, self.directory, step)
                self._gc()
            except Exception as e:      # pragma: no cover
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def save_async(self, tree: PyTree, step: int) -> None:
        host = tree_map(_host, tree)        # device->host copy now
        self._q.put((host, step))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=30)
