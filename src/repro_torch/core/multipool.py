"""``repro_torch.core.multipool`` - K-cluster placement combine
(DESIGN.md SS.7).

Algorithm 2 of the paper combines exactly two clusters by scanning
``k_hp + k_lp = K``. :func:`combine_many` generalizes it to any cluster
count ``C`` as a min-plus (tropical) convolution fold over the
per-cluster energy tables ``E_c[r, k]`` (min energy of placing ``k``
weight groups in cluster ``c`` at row ``r`` - a time-tick row on the DP
path, a t-grid row on the closed-form path):

    (A (+) E)[r, k] = min_i A[r, i] + E[r, k - i]

Each fold keeps its argmin-``i`` trace, so the optimal per-cluster
split is recovered by backtracing from ``k = K`` through the stored
prefix counts. The final fold is evaluated only at ``k = K`` (the full
weight count), which for ``C == 2`` degenerates to exactly the pairwise
Algorithm-2 scan - the same float additions in the same order and the
same first-minimum ``argmin`` - keeping every pre-existing 1- and
2-cluster LUT byte-identical through the refactor (asserted by the
golden-digest regression suite in tests/test_multipool.py).

Complexity: one full fold is O(R * K^2) time / O(R * K) memory, and a
C-cluster combine is ``C - 2`` full folds plus the O(R * K) final
combine - linear in the cluster count, quadratic in the group count
like Algorithm 2 itself. The fold is row-local (row ``r`` of the output
depends only on row ``r`` of the inputs), so callers may slice tables
to the consulted rows *before* combining without changing any byte of
the result - `build_lut(method="dp")` exploits this to fold only the
grid's tick rows instead of all ``T + 1``.

Dtype note: inputs are combined in their own dtype (float32 DP tables,
float64 closed-form tables) - no up-cast, so the K=2 degenerate case
reproduces the historic pairwise arithmetic bit-for-bit.

Two implementations of the same fold live here:

  * the numpy pair (:func:`minplus_fold` / :func:`combine_many`) - the
    host path, the float64 closed-form combiner;
  * the torch twin (:func:`minplus_fold_torch` /
    :func:`combine_rows_torch`) - the plain version of the
    ``minplus_combine`` CUDA kernel behind the fused LUT pipeline
    (:mod:`repro_torch.kernels.lut_pipeline`), batched over leading
    dims and runnable on any device. Candidate generation order,
    strict-< updates and first-minimum argmin are identical to the numpy
    pair (and to the kernel), so all three produce the same float bits
    and the same integer splits on the same float32 tables (asserted by
    tests/test_torch_multipool.py).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

INF = float("inf")


def minplus_fold(a: np.ndarray, e: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One min-plus convolution step with its argmin trace.

    Args:
      a: (R, K+1) prefix table - min energy of placing ``i`` groups in
         the clusters folded so far.
      e: (R, K+1) next cluster's table.

    Returns:
      out: (R, K+1) folded table ``out[r, k] = min_i a[r, i] + e[r, k-i]``.
      arg: (R, K+1) int64 argmin prefix count ``i`` (ties -> smallest
           ``i``, matching ``np.argmin``'s first-minimum rule).
    """
    if a.shape != e.shape:
        raise ValueError(f"table shapes differ: {a.shape} vs {e.shape}")
    R, K1 = a.shape
    out = np.full((R, K1), INF, dtype=a.dtype)
    arg = np.zeros((R, K1), dtype=np.int64)
    for i in range(K1):
        cand = a[:, i:i + 1] + e[:, :K1 - i]
        tail = out[:, i:]
        take = cand < tail                 # strict: first minimum wins
        tail[take] = cand[take]
        arg[:, i:][take] = i
    return out, arg


def combine_many(tables: Sequence[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Min-plus fold of ``C`` per-cluster tables with split backtrace.

    Args:
      tables: ``C`` arrays, each (R, K+1); ``tables[c][r, k]`` is the
        min energy of placing exactly ``k`` weight groups in cluster
        ``c`` at row ``r`` (+inf where infeasible).

    Returns:
      min_e:  (R,) minimum total energy of placing all ``K`` groups.
      splits: (R, C) int64 per-cluster group counts at the optimum,
        summing to ``K`` on every feasible row; all ``-1`` on
        infeasible rows.
    """
    tables = [np.asarray(t) for t in tables]
    if not tables:
        raise ValueError("combine_many needs at least one cluster table")
    if tables[0].ndim != 2:
        raise ValueError(f"cluster 0: table must be 2-D (R, K+1), got "
                         f"shape {tables[0].shape}")
    R, K1 = tables[0].shape
    for c, t in enumerate(tables[1:], start=1):
        if t.shape != (R, K1):
            raise ValueError(
                f"cluster {c}: table shape {t.shape} disagrees with the "
                f"fold accumulator {(R, K1)} (cluster 0 sets the shared "
                f"(R, K+1) shape; the fold is row-aligned, so every "
                f"cluster must be sliced to the same rows)")
    C = len(tables)
    K = K1 - 1
    rows = np.arange(R)

    if C == 1:
        min_e = tables[0][:, K]
        splits = np.where(np.isfinite(min_e)[:, None], K,
                          -1).astype(np.int64)
        return min_e, splits

    # fold all but the last cluster into full-k prefix tables
    args: List[np.ndarray] = []
    F = tables[0]
    for c in range(1, C - 1):
        F, A = minplus_fold(F, tables[c])
        args.append(A)

    # final combine, evaluated only at k = K; for C == 2 this IS the
    # pairwise Algorithm-2 scan (same additions, same first-min argmin)
    cand = F + tables[C - 1][:, ::-1]      # cand[r, i] = F[r,i] + E[r,K-i]
    i_opt = np.argmin(cand, axis=1)
    min_e = cand[rows, i_opt]
    feasible = np.isfinite(min_e)

    splits = np.full((R, C), -1, dtype=np.int64)
    splits[feasible, C - 1] = K - i_opt[feasible]
    k = np.where(feasible, i_opt, 0)       # groups left in clusters 0..C-2
    for c in range(C - 2, 0, -1):
        i_prev = args[c - 1][rows, k]
        splits[feasible, c] = (k - i_prev)[feasible]
        k = np.where(feasible, i_prev, 0)
    splits[feasible, 0] = k[feasible]
    return min_e, splits


# ---------------------------------------------------------------------------
# torch twin of the fold - the plain version of the minplus_combine
# kernel (repro_torch.kernels.lut_pipeline), batched over leading dims
# ---------------------------------------------------------------------------


def minplus_fold_torch(a: torch.Tensor, e: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch :func:`minplus_fold` over ``(..., R, K+1)`` tables.

    Iterates the prefix count ``i`` ascending with a strict ``<`` update
    exactly like the numpy loop, so on equal inputs the returned values
    are bit-identical and the argmin trace picks the same (first)
    minimum. Returns ``(out, arg)`` with ``arg`` int32.
    """
    if a.shape != e.shape:
        raise ValueError(f"table shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(e.shape)}")
    K1 = a.shape[-1]
    out = torch.full_like(a, INF)
    arg = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for i in range(K1):
        cand = a[..., i:i + 1] + e[..., :K1 - i]
        tail = out[..., i:]
        take = cand < tail                 # strict: first minimum wins
        out[..., i:] = torch.where(take, cand, tail)
        arg[..., i:] = torch.where(take, i, arg[..., i:])
    return out, arg


def combine_rows_torch(tables: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch :func:`combine_many` over stacked tables ``(..., C, R, K+1)``.

    Same fold order, final-combine candidates and first-minimum argmin
    as the numpy fold, so the returned ``min_e`` bits and integer
    ``splits`` match :func:`combine_many` exactly on equal float32
    inputs. Returns ``min_e (..., R)`` and ``splits (..., R, C)`` int32,
    ``-1`` on infeasible rows.
    """
    C, R, K1 = tables.shape[-3:]
    K = K1 - 1
    if C == 1:
        min_e = tables[..., 0, :, K]
        splits = torch.where(torch.isfinite(min_e), K, -1)
        return min_e, splits.to(torch.int32).unsqueeze(-1)

    args = []
    F = tables[..., 0, :, :]
    for c in range(1, C - 1):
        F, A = minplus_fold_torch(F, tables[..., c, :, :])
        args.append(A)

    # cand[r, i] = F[r, i] + E[r, K - i]; first minimum along i
    cand = F + tables[..., C - 1, :, :].flip(-1)
    min_e = cand.amin(-1)
    idx = torch.arange(K1, device=cand.device)
    i_opt = torch.where(cand == min_e.unsqueeze(-1), idx, K1).amin(-1)
    feasible = torch.isfinite(min_e)

    cols = [None] * C
    cols[C - 1] = K - i_opt
    k = i_opt
    for c in range(C - 2, 0, -1):
        i_prev = args[c - 1].gather(-1, k.unsqueeze(-1)).squeeze(-1)
        cols[c] = k - i_prev
        k = i_prev.long()
    cols[0] = k
    splits = torch.stack(cols, dim=-1)
    splits = torch.where(feasible.unsqueeze(-1), splits, -1)
    return min_e, splits.to(torch.int32)
