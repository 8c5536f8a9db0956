"""Public op: re-tier M same-shaped fp32 matrices in one CUDA launch.

:func:`quant_split` wraps the ``quant_split`` CUDA kernel
(``repro_torch/csrc/quant_split.cu``): it cuts the columns of every
matrix of a :class:`MatrixTable` into tiers in split order and writes
each tier once in its format, int8 (per-column symmetric, as
``quant.int8.quantize_per_channel``) or bf16, stacked over the matrices.
It takes CUDA tensors only and never falls back: the plain version is
``models.hetero_linear.split_weight`` of each matrix, which the serve
engine runs on the CPU, and entry ``[i]`` of each output equals
``split_weight(ws[i], counts, formats)``'s bit for bit. Its launch count
is ``quant_split.launches`` (one per call).

:func:`split_plan` chooses the launch geometry here, where the CPU tests
can check it: each tier's column offset and the matrices' 32-column
strips, each a cluster of ``CLUSTER`` blocks that share its rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build

CLUSTER = 8                              # blocks a unit
COLS = 32                                # columns a strip, one a lane
WARPS = 8
MAX_TIERS = 8
MAX_SMEM = 232448                        # bytes a block can have (H100)
STATIC_SMEM = (WARPS + 2) * COLS * 4
# rows one block stages (COLS fp32 each) beside its static shared memory
MAX_ROWS = (MAX_SMEM - STATIC_SMEM) // (COLS * 4)
MAX_M = 65535                            # grid.y

_INTS = ctypes.POINTER(ctypes.c_int)
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [_INTS] * 3
             + [_PTRS] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _ints(xs) -> ctypes.Array:
    """A C int array of ``xs`` for the entry point."""
    xs = list(xs)
    return (ctypes.c_int * len(xs))(*xs)


class MatrixTable(NamedTuple):
    """M same-shaped, contiguous fp32 (d_in, d_out) matrices on one
    device and, on CUDA, the device table of their base pointers the
    kernel reads (``ptrs``, int64; None on the CPU). ``vec``: every
    matrix is 16-byte aligned and ``d_out % 4 == 0``, so the kernel
    loads 16 bytes a thread. The table holds the matrices, so their
    memory outlives it; build it with :func:`matrix_table`."""
    ws: Tuple[torch.Tensor, ...]
    ptrs: Optional[torch.Tensor]
    vec: bool


def matrix_table(ws: Sequence[torch.Tensor]) -> MatrixTable:
    """The :class:`MatrixTable` of ``ws`` (one host-to-device copy on
    CUDA). Raises on what the kernel does not take."""
    ws = tuple(ws)
    if not ws:
        raise ValueError("matrix_table needs at least one matrix")
    ref = ws[0]
    for w in ws:
        if w.dtype != torch.float32:
            raise TypeError(f"quant_split takes float32 matrices, got "
                            f"{w.dtype}")
        if w.ndim != 2 or w.shape != ref.shape:
            raise ValueError(f"quant_split takes (d_in, d_out) matrices of "
                             f"one shape, got {tuple(w.shape)} beside "
                             f"{tuple(ref.shape)}")
        if w.device != ref.device:
            raise ValueError(f"quant_split: matrices on {ref.device} and "
                             f"{w.device}")
        if not w.is_contiguous():
            raise ValueError("quant_split takes contiguous matrices")
    if len(ws) > MAX_M:
        raise ValueError(f"quant_split takes at most {MAX_M} matrices a "
                         f"call, got {len(ws)}")
    ptrs = None
    if ref.device.type == "cuda":
        ptrs = torch.tensor([w.data_ptr() for w in ws], dtype=torch.int64,
                            device=ref.device)
    vec = ref.shape[1] % 4 == 0 and all(w.data_ptr() % 16 == 0 for w in ws)
    return MatrixTable(ws, ptrs, vec)


class TierSlot(NamedTuple):
    """One tier of a split: columns ``[off, off + n)`` of each matrix,
    int8 or bf16."""
    name: str
    int8: bool
    off: int
    n: int


class SplitPlan(NamedTuple):
    """Launch geometry of one ``quant_split`` call on (d_in, d_out)
    matrices, grid ``(CLUSTER x strips, M)``: strip g holds columns
    ``[32 g, 32 g + 32)`` of one matrix, its block rank k staging rows
    ``[k rows, k rows + rows)`` in ``smem`` bytes of dynamic shared
    memory, each lane one column in the tier that holds it. ``tiers`` in
    split order, contiguous from column 0 to ``d_out``."""
    tiers: Tuple[TierSlot, ...]
    strips: int
    rows: int
    smem: int


@functools.lru_cache(maxsize=256)
def split_plan(d_in: int, d_out: int,
               tiers: Tuple[Tuple[str, bool, int], ...]) -> SplitPlan:
    """The plan of a split of (d_in, d_out) matrices into ``tiers``,
    ``(name, int8, columns)`` in split order. Raises on what the kernel
    cannot hold."""
    if d_in < 1 or d_out < 1:
        raise ValueError(f"split_plan takes d_in, d_out >= 1, got "
                         f"{(d_in, d_out)}")
    if not 1 <= len(tiers) <= MAX_TIERS:
        raise ValueError(f"quant_split takes 1 to {MAX_TIERS} tiers, got "
                         f"{len(tiers)}")
    slots, off = [], 0
    for name, int8, n in tiers:
        if n < 0:
            raise ValueError(f"tier {name} has {n} columns")
        slots.append(TierSlot(name, bool(int8), off, n))
        off += n
    if off != d_out:
        raise ValueError(f"tier counts {dict((t[0], t[2]) for t in tiers)} "
                         f"do not sum to the {d_out} columns of w")
    rows = -(-d_in // CLUSTER)
    if rows > MAX_ROWS:
        raise ValueError(f"quant_split stages at most {MAX_ROWS} rows a "
                         f"block, {CLUSTER * MAX_ROWS} a matrix; got "
                         f"d_in={d_in}")
    return SplitPlan(tuple(slots), -(-d_out // COLS), rows,
                     rows * COLS * 4)


def quant_split(table: MatrixTable, counts: Mapping[str, int],
                formats: Mapping[str, str]) -> Dict[str, dict]:
    """Split every matrix of ``table`` into tiers, in ``counts``' order.

    Args:
      table: the M (d_in, d_out) fp32 matrices (:func:`matrix_table`).
      counts: columns per tier, summing to d_out, in split order.
      formats: tier -> ``"int8"`` or ``"bf16"`` (anything but int8 is
        bf16, as in ``split_weight``).

    Returns ``{tier: {"q": (M, d_in, n) int8, "scale": (M, n) fp32} |
    {"w": (M, d_in, n) bf16} | {"empty": True}}`` in split order.
    """
    ws = table.ws
    dev = ws[0].device
    if dev.type != "cuda":
        raise ValueError(f"quant_split runs on cuda tensors, not {dev}; "
                         f"the plain version is split_weight of each "
                         f"matrix")
    if obs.enabled():
        obs.counter("kernels.quant_split.dispatch", backend=dev.type)
    (d_in, d_out), M = ws[0].shape, len(ws)
    plan = split_plan(d_in, d_out, tuple(
        (name, formats[name] == "int8", n) for name, n in counts.items()))
    out: Dict[str, dict] = {}
    for t in plan.tiers:
        if t.n == 0:
            out[t.name] = {"empty": True}
        elif t.int8:
            out[t.name] = {
                "q": torch.empty((M, d_in, t.n), dtype=torch.int8,
                                 device=dev),
                "scale": torch.empty((M, t.n), dtype=torch.float32,
                                     device=dev)}
        else:
            out[t.name] = {"w": torch.empty((M, d_in, t.n),
                                            dtype=torch.bfloat16,
                                            device=dev)}
    k = len(plan.tiers)
    segs = [out[t.name] for t in plan.tiers]
    fn = build.entry("quant_split", "quant_split_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(
            table.ptrs.data_ptr(), M, d_in, d_out, k,
            _ints(t.off for t in plan.tiers), _ints(t.n for t in plan.tiers),
            _ints(int(t.int8) for t in plan.tiers),
            (ctypes.c_void_p * k)(*(
                None if s.get("empty") else
                (s["q"] if "q" in s else s["w"]).data_ptr() for s in segs)),
            (ctypes.c_void_p * k)(*(s["scale"].data_ptr() if "scale" in s
                                    else None for s in segs)),
            plan.rows, int(table.vec),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "quant_split")
    quant_split.launches += 1
    return out


quant_split.launches = 0
