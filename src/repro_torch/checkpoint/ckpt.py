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

from repro_torch.tree import flatten_with_path, structure, tree_map

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
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {_key(path): (_host(leaf) if isinstance(leaf, torch.Tensor)
                         else np.asarray(leaf))
            for path, leaf in flatten_with_path(tree)}


def save(tree: PyTree, directory: str | os.PathLike, step: int) -> Path:
    """Synchronous atomic save. Returns the final checkpoint path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = _flatten(tree)
    np.savez(tmp / "arrays.npz", **flat)
    (tmp / "meta.json").write_text(json.dumps({
        "step": step, "treedef": f"PyTreeDef({structure(tree)})",
        "keys": sorted(flat.keys())}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic on POSIX
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return np.asarray(arr.astype(leaf.dtype))
    return arr


def restore(template: PyTree, directory: str | os.PathLike,
            step: Optional[int] = None) -> PyTree:
    """Restore into the structure of ``template``: each tensor leaf comes
    back with its template leaf's dtype and device, each numpy leaf as a
    numpy array of its template's dtype."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step:08d}"
    with np.load(path / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    it = iter([_restore_leaf(arrays[_key(p)], leaf)
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
