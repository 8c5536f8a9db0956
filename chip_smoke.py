#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an
H100; the kernels are built for sm_90a). Phases:

  1. print the card's name and power limit; build the six CUDA sources
     from ``src/repro_torch/csrc`` (nvcc, one process per source, in
     parallel), printing ``-Xptxas -v`` and the build times;
  2. hold the placement kernels bitwise (``torch.equal``) against their
     plain PyTorch versions on the same inputs, at the main path's
     shapes: the gpu-pool DVFS clock grid of internlm2_1_8b (V=6, C=2,
     n=2, T=14376, K=256, R=33), the cxl-tier-3 grid (C=3), an edge C=1
     build, a synthetic C=5 build with inert padding, and
     ``knapsack_dp`` at gpu-pool's T=14376, K=256, t=[18, 18]; then
     ``minplus_combine`` alone on tie-heavy and infeasible rows
     (``lut_pipeline.ref.tie_heavy_rows``) at those grids' shapes, C=1,
     K=0, K=1100 and K=2047 at C=5 (80 KB of shared memory), and its
     ``ValueError`` for rows beyond one block's shared memory;
  3. drive the placement path with its launch counts set to 0: all 18
     golden LUT digests built with ``device="cuda"``, the per-point
     ``batched=False`` anchor against the fused build, then
     ``api.scheduler(..., solver="dp", dvfs=True, device="cuda")`` on
     gpu-pool and cxl-tier-3 through the six load scenarios (10 slices
     each), held equal to the same run with ``device="cpu"``; the counts
     are read right after and every kernel must have launched;
  4. time each placement kernel and its plain version with CUDA events
     at the gpu-pool grid, the cxl-tier-3 grid and the synthetic C=5
     shape, beside the bound (bytes written once over 3.35 TB/s, or
     operations over 67 TFLOP/s fp32, the larger), and split one
     ``build_lut_grid`` into kernel, D2H copy and host finalize;
     torch.profiler adds each op's device-only time (the sum of every
     CUDA kernel the op launches, all named with the op's name; for
     ``minplus_combine`` the mean over 20 launches) and the device's
     idle share over one ``build_lut_grid``;
  5. drive the serving path with ``pim_matmul.launches`` set to 0:
     internlm2_1_8b at full width (``scan_layers=False``, random weights
     from a seeded ``torch.Generator`` on the card) through
     ``api.engine("gpu-pool", ..., device="cuda")``, 10 slices of
     ``case6_random`` with ``tiered_forward`` on a (16, 2048) input after
     each; every retier must tier 48 matrices, each int8 segment must
     dequantize to within one step of its columns, and ``tiered_forward``
     must equal the same segments composed on the CPU (int8 tiers
     bitwise); then ``DecodeEngine`` serves 6 requests, and a 2-layer
     fp32 model at the same widths holds one ``decode_step`` on cuda to
     the same step on the CPU;
  6. hold ``pim_mac`` bitwise against its plain version at the tier
     widths phase 5 produced (M=16, K=2048), at M=1, 32 and 256 with
     N=8192, at worst-case magnitudes, with scalar scales, in fp32 and
     bf16; time it L2-cold beside its bound (bytes over 3.35 TB/s or
     operations over 1,979 TOP/s int8) and its plain version, by CUDA
     events and by torch.profiler's device-only time, and at M=32 (the
     smallest M ``torch._int_mm`` takes) beside ``torch._int_mm`` plus
     the same epilogue, timed the same two ways; split one
     ``run_slice`` into scheduler step, retier, decode and
     ``tiered_forward``, and time one full-width ``decode_step``;
  7. the other model families (every architecture of the registry now
     runs in the port): each family's smoke model in fp32 (TF32 off),
     params from ``init_lm`` on a CPU generator copied to the card,
     held to the CPU within 1e-4 - ``forward`` with prefix embeddings or
     encoder frames, ``prefill`` and three ``decode_step``s, one with
     per-row positions - for arctic_480b, llama4_scout_17b_a16e,
     recurrentgemma_2b, xlstm_1_3b, seamless_m4t_medium and pixtral_12b,
     and a recurrentgemma decode that wraps its 16-slot ring buffer;
  8. the families at full width, one model at a time (freed before the
     next), each line naming its cut: recurrentgemma_2b whole,
     xlstm_1_3b whole (48 layers, d_ff=0, scanned), seamless_m4t_medium
     whole (``encode`` of 32 frames per row), pixtral_12b 8 of 40 layers
     with 256 prefix embeds, llama4_scout_17b_a16e 4 of 48 layers with
     all 16 experts (arctic_480b does not fit one card and runs at smoke
     width only). Each prints its parameter count and bytes, one B=4
     ``decode_step`` by CUDA events and its device busy time and idle
     share by torch.profiler; recurrentgemma and xlstm hold prefill +
     decode of 8 tokens to ``forward`` in bf16, llama4 holds one MoE
     layer on the card to the CPU in fp32 at a decode batch and at a
     prefill batch that drops tokens over capacity;
  9. serve recurrentgemma_2b at full width (``scan_layers=False``)
     through ``api.engine("gpu-pool", ...)`` as in phase 5 with
     ``pim_matmul.launches`` set to 0: 52 matrices per migration, int8
     tiers bitwise to the CPU, ``pim_mac`` at K=2560; ``DecodeEngine``
     with 6 requests of 8 tokens; ``pim_mac`` against its plain version
     at the tier widths and timed L2-cold at the widest int8 tier;
  10. the serving fleet at full width with every launch count set to 0
     just before bring-up: ``api.fleet("gpu-pool-mixed", ...,
     n_engines=4, decode=True, solver="dp", dvfs=True, device="cuda")``,
     four internlm2_1_8b workers (two engine shapes) sharing one set of
     random weights, whose bring-up builds every LUT and DVFS clock grid
     on ``dp_stages`` and ``minplus_combine``, over an mmpp trace with
     obs tracing on; bring-up timed on the host clock with the
     stage-tensor copies to the host split out, each slice ending in a
     synchronize (p50/p99), and the spans of ``worker.step``,
     ``engine.migration``, ``engine.decode`` and ``compiler.lut_build``;
     every migration tiers 48 matrices; each worker's ``SliceReport``
     sequence and the ``FleetSummary`` equal the same fleet with
     ``decode=False`` on the card and on the CPU, and ``pc.stats()``
     equals the CPU's but for the device; each worker's int8 tiers run
     ``pim_mac`` in ``tiered_forward`` bitwise to the CPU. Then the
     hierarchical fleet (4 cells x 4 engines, autoscaled to 8 per cell,
     dp, a flash crowd) and the DAG fleet on cxl-tier-3 (4 cells x 2
     engines, C=3) on the card against the CPU: the same assignments,
     scale events (new workers paying 0 LUT builds), summaries and
     ``DagResult``;
  11. training (slice D) with every launch count set to 0 just before
     it: loss and gradients of every family that trains (dense, MoE,
     RG-LRU, xLSTM, VLM with prefix embeddings, encoder-decoder with
     encoder frames) at smoke size in fp32 (TF32 off) on the card
     against the CPU, the loss within 1e-5 (xlstm 5e-4) and each
     gradient leaf within 1e-4 of its largest entry (xlstm 1e-3); three
     ``Trainer`` steps on the dense smoke model against the CPU, with and
     without int8 gradient compression; a resume (checkpoint at step 2, a
     fresh Trainer's steps 3-4 equal to the uninterrupted run's); then
     internlm2_1_8b at full width and depth as ``launch/train.py --full``
     builds it (bf16 compute, fp32 params, scanned, remat; AdamW), 4
     Trainer steps at S=1024, B=8: parameter and state bytes, peak
     memory, each step's host-clock and CUDA-event time, tokens/s, the
     model-FLOP share of the dense bf16 peak, and a fifth step under
     torch.profiler (device busy time, idle share); one ``make_train_step``
     step with 8 microbatches on the same params and batch within 2e-2 of
     the first loss; a 2-layer fp32 model at full width, loss and
     gradients on the card against the CPU; ``python -m
     repro_torch.launch.train --device cuda`` as a subprocess. Of the
     kernels training reaches only the RG-LRU's two, in the
     recurrentgemma smoke gradient: ``rglru_scan`` and ``rglru_scan_bwd``
     launch once per RG-LRU block, every other count stays 0 (xlstm
     trains through ``chunked_scan``);
  12. sharding (slice E) with every launch count set to 0 just before
     it: a world of one on ``nccl`` and the (1, 1) test mesh; full-width
     internlm2_1_8b (``scan_layers=False``) decodes 8 steps through
     DTensor params and a DTensor decode state, held bitwise to the plain
     ``decode_step`` (every placement replicates) and timed both ways by
     CUDA events (the gap is DTensor's dispatch cost); one smoke train
     step with 2 microbatches on the mesh: the loss equal to the plain
     step's, each param leaf within 1e-6 of its largest entry.
     Every launch count must still be 0 after (the sharded path runs
     no recurrent model). Then, each in a process
     of its own and all started together: ``python -m
     repro_torch.launch.dryrun --device cuda`` for internlm2_1_8b's
     train_4k and decode_32k cells on the fake 256- and 512-rank meshes
     (train cells cut to 2 of 24 blocks, decode cells whole), each
     ``ok``, its per-device argument bytes equal to the sharding rules'
     local shard shapes, printed with its trace time, temp bytes,
     FLOPs, collective bytes by kind and its ``roofline.py`` row; and
     ``examples/torch/*.py --device cuda``, each exiting 0, the host-side
     ones (quickstart, placement_sweep, fleet_demo, serve_dynamic)
     printing what their ``--device cpu`` runs print;
  13. the recurrent scans (slice F): ``rglru_scan`` and ``rglru_scan_bwd``
     bitwise, ``mlstm_scan`` and ``slstm_scan`` within 4e-6 of the
     largest |h|, against their plain versions on the card at the smoke
     and full widths (d 2560, d 2048, 4 heads of 512) at S = 1, 200 and
     4096; each timed at B=2, S=4096 by CUDA events and torch.profiler
     beside its bound and its plain version. Each path with every launch
     count set to 0 just before and read just after:
     recurrentgemma_2b at full width (26 layers, bf16, unscanned),
     ``lm.forward`` at B=2, S=4096 without autograd, one ``rglru_scan``
     per RG-LRU block, bitwise to the same forward through the plain
     loops; 2 Trainer steps of it at full depth (``dryrun_config``,
     AdamW) at B=2, S=4096 in a child process (``--recurrent-train``;
     the step peaks near the card's 80 GB), each step launching the
     forward scan twice per block (remat) and the backward once; a
     2-layer fp32 full-width loss and gradient against the CPU;
     xlstm_1_3b at full width (48 layers, bf16) ``lm.forward`` at B=2,
     S=4096 without autograd, one ``mlstm_scan`` or ``slstm_scan`` per
     block, and its whole stack in fp32 at S=512 against the plain loops
     within 1e-3 of the largest logit. Then ``python -m
     repro_torch.launch.dryrun --device cuda`` for recurrentgemma_2b's
     train_4k (cut to 2 of 26 blocks) and prefill_32k and xlstm_1_3b's
     prefill_32k (whole) on both fake meshes, each ``ok`` with its
     argument bytes equal to the rules' local shards;
  14. print each phase's seconds, the ``{"kernels": [...]}`` line (each
     kernel's CUDA-event ``ms`` and profiler ``device_ms``, its launches
     in total and per driven path, ``train``, ``sharded`` and slice F's
     among them; ``pim_mac``
     also its comparison with the library call at M=32 under
     ``at_library_shape`` and its recurrentgemma row under
     ``at_recurrentgemma_shape``) and, last,
     the ``{"ok": true, "device": {...}}`` line.

Any failure exits non-zero without the last line, as does a machine
without a CUDA card or a directory without the repository's ``src/``.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
# and fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12                 # dense int8 tensor cores

# Golden digests of the JAX package's LUTs (tests/test_multipool.py),
# built at n_points=6, k_groups=64 for every registered substrate.
GOLDEN_LUT_DIGESTS = {
    "cxl-tier:closed_form": "3653af7c0d0569cb",
    "cxl-tier:dp": "549a9fef6ae223b4",
    "edge-baseline:closed_form": "f76a5f3c6ead009a",
    "edge-baseline:dp": "f76a5f3c6ead009a",
    "edge-hetero:closed_form": "cda0ae1977f42590",
    "edge-hetero:dp": "cda0ae1977f42590",
    "edge-hhpim:closed_form": "c44f42c135341f75",
    "edge-hhpim:dp": "c44f42c135341f75",
    "edge-hybrid:closed_form": "02f9711c2b0627e2",
    "edge-hybrid:dp": "847c8c5fc106581b",
    "gpu-pool:closed_form": "5bbccc0162bc4de2",
    "gpu-pool:dp": "5bbccc0162bc4de2",
    "gpu-pool-mixed:closed_form": "5bbccc0162bc4de2",
    "gpu-pool-mixed:dp": "5bbccc0162bc4de2",
    "tpu-pool:closed_form": "90c5bdf20b5fec46",
    "tpu-pool:dp": "abee1aab40e12410",
    "tpu-pool-mixed:closed_form": "90c5bdf20b5fec46",
    "tpu-pool-mixed:dp": "abee1aab40e12410",
}

SCENARIO_SLICES = 10
SERVE_SLICES = 10
# cuda against cpu on the 2-layer fp32 model: fp32 sums of up to 8192
# terms taken in another order (logits are O(1))
DECODE_ATOL = 1e-3
# bf16 tiers of tiered_forward, cuda against cpu: one bf16 rounding of
# the product taken in another order (outputs are O(1))
BF16_TIER_ATOL = 6e-2


def lut_digest(lut) -> str:
    """Canonical bit-exact digest of a LUT (float bytes via hex)."""
    payload = []
    for e in lut.entries:
        payload.append([e.t_constraint_ns.hex(),
                        sorted((k, int(v)) for k, v in e.placement.items()),
                        float(e.e_task_pj).hex(), float(e.t_task_ns).hex(),
                        bool(e.feasible)])
    blob = json.dumps([lut.arch_name, lut.model_name, payload],
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over elements that differ (inf == inf counts 0)."""
    import torch
    if a.shape != b.shape:
        return math.inf
    diff = (a.double() - b.double()).abs()
    diff = torch.where(a == b, torch.zeros_like(diff), diff)
    return float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(fn) -> dict:
    """Device time by kernel name and the device's busy share over one
    call of ``fn``, from torch.profiler's CUDA activity trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:           # tracing unavailable: no number
        print(f"[profile] torch.profiler failed: {exc}")
        return dict(by_name={}, busy_ms=0.0, wall_ms=0.0)
    by_name: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
            spans.append((ev.time_range.start, ev.time_range.end))
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):            # union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return dict(by_name=by_name, busy_ms=busy_us / 1e3, wall_ms=wall_ms)


def op_ms(prof: dict, op: str):
    """Device time of every CUDA kernel an op launches: the port names
    each of an op's kernels with the op's name as prefix (``dp_stages``
    runs a base fill, one chain kernel per stage and a gather). None
    when nothing was traced."""
    if not prof["by_name"]:
        return None
    return sum(v for n, v in prof["by_name"].items() if op in n)


def print_profile(label: str, prof: dict, ops) -> dict:
    """Print and return the ops' device-only ms over the profiled call."""
    if not prof["by_name"]:
        print(f"[profile] {label}: not measured (no CUDA activity traced)")
        return {k: None for k in ops}
    found = {k: op_ms(prof, k) for k in ops}
    parts = [f"{k}_ms={ms!r}" for k, ms in found.items()]
    copy_ms = sum(v for n, v in prof["by_name"].items() if "Memcpy" in n)
    print(f"[profile] {label}: {' '.join(parts)} memcpy_ms={copy_ms!r} "
          f"device_busy_ms={prof['busy_ms']!r} wall_ms={prof['wall_ms']!r} "
          f"idle_share={1 - prof['busy_ms'] / prof['wall_ms']!r}")
    return found


# -- problems at the main path's shapes ------------------------------------

def dp_inputs(sub, em, t_slice: float):
    """One build's Algorithm-1 discretization, made exactly as
    ``build_lut`` makes it at the substrate's defaults (k_groups=256,
    dp_ticks=2048). Returns the problem and its group count."""
    import numpy as np

    from repro_torch.core.placement import _dp_problem, _entry_fns

    model = em.model
    group = max(1, math.ceil(model.n_params / 256))
    _, _, tc_peak = _entry_fns(em.arch, model, em, group, t_slice,
                               sub.static_window)
    t_grid = np.linspace(t_slice / sub.lut_points, t_slice, sub.lut_points)
    if tc_peak.t_task_ns <= t_slice:
        t_grid = np.unique(np.concatenate([t_grid, [tc_peak.t_task_ns]]))
    prob = _dp_problem(em, em.arch, group, t_slice, 2048, t_grid)
    return prob, math.ceil(model.n_params / group)


def grid_inputs(name: str, workload, n_clocks: int = 5):
    """The fused op's inputs for one substrate's DVFS clock grid, stacked
    as ``build_lut_grid`` stacks them, plus the energy models."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core.energy import EnergyModel

    sub = api.substrate(name)
    model = sub.model_spec(workload)
    t_slice = sub.default_t_slice_ns(model)
    clocks = sub.tech_model().clock_grid(n_clocks, include=(sub.lp_clock,))
    ems = [EnergyModel(sub.with_clock(c).arch, model, rho=sub.rho)
           for c in clocks]
    probs = [dp_inputs(sub, em, t_slice) for em in ems]
    T, K = probs[0][0].T, probs[0][1]
    require(all((p.T, k) == (T, K) for p, k in probs),
            f"{name}: grid shapes differ")
    return dict(sub=sub, ems=ems, t_slice=t_slice, T=T, K=K,
                t=np.stack([p.t_items for p, _ in probs]),
                e=np.stack([p.e_items for p, _ in probs]),
                rows=np.stack([p.rows for p, _ in probs]))


def edge_inputs():
    from repro_torch import api

    sub = api.substrate("edge-baseline")
    model = sub.model_spec()
    p, K = dp_inputs(sub, sub.energy_model(model),
                     sub.default_t_slice_ns(model))
    return dict(T=p.T, K=K, t=p.t_items[None], e=p.e_items[None],
                rows=p.rows[None])


def knapsack_case(grid: dict) -> tuple:
    """One cluster of gpu-pool's grid for ``knapsack_dp``: the LP cluster
    at the clock point whose items are 18 ticks."""
    v = [i for i in range(grid["t"].shape[0])
         if list(grid["t"][i, 1]) == [18, 18]]
    require(bool(v), "no gpu-pool clock point with t=[18, 18]")
    return ([int(x) for x in grid["t"][v[0], 1]],
            [float(x) for x in grid["e"][v[0], 1]])


def synthetic_c5_inputs(seed: int = 5):
    """Five clusters, two spaces each, one space inert-padded."""
    import numpy as np
    rng = np.random.default_rng(seed)
    V, C, n, T, K, R = 2, 5, 2, 4096, 256, 33
    t = rng.integers(1, 41, size=(V, C, n)).astype(np.int32)
    e = rng.uniform(1.0, 100.0, size=(V, C, n)).astype(np.float32)
    t[0, C - 1, n - 1], e[0, C - 1, n - 1] = 1, np.inf
    rows = rng.integers(0, T + 1, size=(V, R)).astype(np.int32)
    return dict(T=T, K=K, t=t, e=e, rows=rows)


# -- phases ----------------------------------------------------------------

def phase_build(out: dict) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    print(f"[build] {len(info)} kernels in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.2f} s"
              f"{' (cached)' if rec['cached'] else ''}")
        for line in rec["log"].splitlines():
            # ptxas -v: registers, shared memory, and (unprefixed) spills
            if ("ptxas" in line or "spill" in line
                    or "error" in line.lower()):
                print(f"[build]   {line.strip()}")
    out["build"] = info


def phase_parity(cases: dict, out: dict) -> None:
    import torch

    from repro_torch.core.multipool import combine_rows_torch
    from repro_torch.kernels.knapsack_dp.ops import dp_stages, knapsack_dp
    from repro_torch.kernels.knapsack_dp.ref import (dp_stages_ref,
                                                     gather_rows)
    from repro_torch.kernels.lut_pipeline.ops import (lut_build,
                                                      minplus_combine)
    from repro_torch.kernels.lut_pipeline.ref import lut_pipeline_ref

    errs = {"dp_stages": 0.0, "minplus_combine": 0.0}
    for label, c in cases.items():
        t = torch.as_tensor(c["t"], dtype=torch.int32, device="cuda")
        e = torch.as_tensor(c["e"], dtype=torch.float32, device="cuda")
        rows = torch.as_tensor(c["rows"], dtype=torch.int32, device="cuda")
        T, K = c["T"], c["K"]
        # each kernel against its plain version on the same inputs
        stages_k, g_k = dp_stages(t, e, T, K, rows)
        stages_p = dp_stages_ref(t, e, T, K)
        g_p = gather_rows(stages_p[:, :, -1], rows)
        torch.cuda.synchronize()
        ok_dp = torch.equal(stages_k, stages_p) and torch.equal(g_k, g_p)
        err_dp = max(max_abs_err(stages_k, stages_p), max_abs_err(g_k, g_p))
        me_k, sp_k = minplus_combine(g_p)
        me_p, sp_p = combine_rows_torch(g_p)
        torch.cuda.synchronize()
        ok_mc = torch.equal(me_k, me_p) and torch.equal(sp_k, sp_p)
        err_mc = max(max_abs_err(me_k, me_p), max_abs_err(sp_k, sp_p))
        # and the chained op against the chained plain versions
        s_op, me_op, sp_op = lut_build(t, e, T, K, rows, device="cuda")
        s_ref, me_ref, sp_ref = lut_pipeline_ref(t, e, rows, T=T, K=K)
        ok_op = (torch.equal(s_op, s_ref) and torch.equal(me_op, me_ref)
                 and torch.equal(sp_op, sp_ref))
        feasible = int(torch.isfinite(me_op).sum())
        print(f"[parity] {label}: V,C,n={tuple(t.shape)} T={T} K={K} "
              f"R={rows.shape[1]} stages={tuple(s_op.shape)} "
              f"dp_stages={'equal' if ok_dp else 'DIFFER'} "
              f"minplus_combine={'equal' if ok_mc else 'DIFFER'} "
              f"lut_build={'equal' if ok_op else 'DIFFER'} "
              f"feasible_rows={feasible}/{me_op.numel()}")
        require(ok_dp and ok_mc and ok_op, f"{label}: kernel != plain")
        errs["dp_stages"] = max(errs["dp_stages"], err_dp)
        errs["minplus_combine"] = max(errs["minplus_combine"], err_mc)
        del stages_k, stages_p, s_op, s_ref
        torch.cuda.empty_cache()

    grid = cases["gpu-pool grid"]
    t_l, e_l = knapsack_case(grid)
    k_cuda = knapsack_dp(t_l, e_l, grid["T"], grid["K"], device="cuda",
                         return_stages=True)
    k_plain = dp_stages_ref(
        torch.tensor([[t_l]], dtype=torch.int32, device="cuda"),
        torch.tensor([[e_l]], dtype=torch.float32, device="cuda"),
        grid["T"], grid["K"])[0, 0]
    ok = torch.equal(k_cuda, k_plain)
    print(f"[parity] knapsack_dp T={grid['T']} K={grid['K']} t={t_l}: "
          f"{'equal' if ok else 'DIFFER'}")
    require(ok, "knapsack_dp kernel != plain")
    errs["dp_stages"] = max(errs["dp_stages"], max_abs_err(k_cuda, k_plain))
    errs["minplus_combine"] = max(errs["minplus_combine"],
                                  parity_minplus_ties())
    out["max_abs_err"] = errs


# V, C, R, K of the tie-heavy combine rows: the gpu-pool and cxl-tier-3
# grids, synthetic C=5, C=1, K=0, K+1 > blockDim, and K=2047 at C=5 (80 KB
# of dynamic shared memory, above the 48 KB default)
TIE_SHAPES = [(6, 2, 33, 256), (6, 3, 33, 256), (2, 5, 33, 256),
              (3, 1, 12, 256), (2, 3, 12, 0), (1, 5, 12, 1100),
              (1, 5, 6, 2047)]


def parity_minplus_ties() -> float:
    """``minplus_combine`` against ``combine_rows_torch`` on rows full of
    exact ties and infeasible rows; the largest error (0 when equal)."""
    import torch

    from repro_torch.core.multipool import combine_rows_torch
    from repro_torch.kernels.lut_pipeline.ops import (combine_plan,
                                                      minplus_combine)
    from repro_torch.kernels.lut_pipeline.ref import tie_heavy_rows

    err = 0.0
    for V, C, R, K in TIE_SHAPES:
        g = tie_heavy_rows(V, C, R, K, seed=V * 1000 + C * 100 + K,
                           device="cuda")
        me_k, sp_k = minplus_combine(g)
        me_p, sp_p = combine_rows_torch(g)
        torch.cuda.synchronize()
        ok = torch.equal(me_k, me_p) and torch.equal(sp_k, sp_p)
        plan = combine_plan(V, C, R, K)
        print(f"[parity] minplus_combine tie-heavy V={V} C={C} R={R} K={K} "
              f"({plan.blocks} blocks x {plan.threads} threads, "
              f"{plan.shared_bytes} B shared): "
              f"{'equal' if ok else 'DIFFER'} "
              f"feasible_rows={int(torch.isfinite(me_k).sum())}/{V * R}")
        require(ok, f"minplus_combine tie-heavy {(V, C, R, K)} != plain")
        err = max(err, max_abs_err(me_k, me_p), max_abs_err(sp_k, sp_p))
    # rows beyond one block's shared memory: raised, never launched
    n0 = minplus_combine.launches
    try:
        minplus_combine(torch.zeros((1, 5, 1, 5805), device="cuda"))
        raised = False
    except ValueError as exc:
        raised = "shared memory" in str(exc)
    require(raised and minplus_combine.launches == n0,
            "minplus_combine took rows beyond one block's shared memory")
    print("[parity] minplus_combine (1, 5, 1, 5805): ValueError, no launch")
    return err


def run_scenarios(name: str, workload, device: str, pc) -> list:
    from repro_torch import api
    from repro_torch.core import workloads
    runs = []
    for scen, loads in workloads.SCENARIOS.items():
        sched = api.scheduler(name, workload, solver="dp", dvfs=True,
                              device=device, compiler=pc)
        runs.append((scen, sched.run(loads[:SCENARIO_SLICES])))
    return runs


def phase_main_path(cfg, out: dict) -> None:
    import torch

    from repro_torch import api
    from repro_torch.core.placement import build_lut
    from repro_torch.kernels.knapsack_dp.ops import dp_stages
    from repro_torch.kernels.lut_pipeline.ops import minplus_combine

    dp_stages.launches = 0
    minplus_combine.launches = 0
    t0 = time.perf_counter()

    bad = []
    for key in sorted(GOLDEN_LUT_DIGESTS):
        name, method = key.split(":")
        sub = api.substrate(name)
        model = sub.model_spec()
        lut = build_lut(sub.arch, model,
                        t_slice_ns=sub.default_t_slice_ns(model),
                        n_points=6, k_groups=64, em=sub.energy_model(model),
                        method=method, static_window=sub.static_window,
                        device="cuda")
        if lut_digest(lut) != GOLDEN_LUT_DIGESTS[key]:
            bad.append(key)
        if method == "dp":
            require(lut.backend == "cuda", f"{key} built on {lut.backend}")
    print(f"[main] golden LUT digests on cuda: "
          f"{len(GOLDEN_LUT_DIGESTS) - len(bad)}/{len(GOLDEN_LUT_DIGESTS)}"
          f" match")
    require(not bad, f"digest mismatch: {bad}")

    # the per-point batched=False anchor (knapsack_dp per cluster plus
    # the host fold) against the fused build, at gpu-pool's full size
    sub = api.substrate("gpu-pool")
    model = sub.model_spec(cfg)
    kw = dict(t_slice_ns=sub.default_t_slice_ns(model),
              n_points=sub.lut_points, em=sub.energy_model(model),
              method="dp", static_window=sub.static_window, device="cuda")
    fused = build_lut(sub.arch, model, **kw)
    anchor = build_lut(sub.arch, model, batched=False, **kw)
    require(fused.entries == anchor.entries, "fused LUT != per-point LUT")
    print(f"[main] gpu-pool fused dp LUT == per-point anchor "
          f"({len(fused.entries)} entries, "
          f"{sum(e.feasible for e in fused.entries)} feasible)")

    results = {}
    for name in ("gpu-pool", "cxl-tier-3"):
        pc = api.compiler(device="cuda")
        runs = run_scenarios(name, cfg, "cuda", pc)
        torch.cuda.synchronize()
        results[name] = runs
        stats = pc.stats()
        require(stats["builds_by_backend"].get("cuda", 0) > 0,
                f"{name}: no LUT built on cuda: {stats}")
        for scen, reps in runs:
            require(len(reps) == SCENARIO_SLICES, f"{name}/{scen} slices")
            for r in reps:
                require(math.isfinite(r.energy_pj) and r.energy_pj > 0,
                        f"{name}/{scen}: energy {r.energy_pj}")
                require(sum(r.placement.values()) == model.n_params,
                        f"{name}/{scen}: placement does not hold the model")
                require(r.clock is not None, f"{name}/{scen}: no clock")
            e_uj = sum(r.energy_pj for r in reps) * 1e-6
            miss = sum(not r.deadline_met for r in reps)
            clocks = sorted({round(r.clock, 4) for r in reps})
            print(f"[main] {name} {scen}: energy={e_uj!r} uJ "
                  f"misses={miss}/{len(reps)} clocks={clocks}")
        print(f"[main] {name} compiler: {stats}")
    elapsed = time.perf_counter() - t0
    launches = {"dp_stages": dp_stages.launches,
                "minplus_combine": minplus_combine.launches}
    print(f"[main] launches during the main path: {launches} "
          f"({elapsed:.2f} s)")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    out["launches"] = launches

    # the same scheduler runs on the plain versions must agree exactly
    for name in ("gpu-pool", "cxl-tier-3"):
        cpu_runs = run_scenarios(name, cfg, "cpu", api.compiler(device="cpu"))
        require(cpu_runs == results[name],
                f"{name}: cuda SliceReports != cpu SliceReports")
        print(f"[main] {name}: cuda SliceReports == cpu SliceReports "
              f"({len(cpu_runs)} scenarios)")


def dp_stages_bound_ms(t, e, rows, T: int, K: int) -> tuple:
    V, C, n = t.shape
    R = rows.shape[1]
    out_bytes = 4 * V * C * ((n + 1) * (T + 1) * (K + 1) + R * (K + 1))
    in_bytes = t.nbytes + e.nbytes + rows.nbytes
    ops = 2 * V * C * n * (T + 1) * (K + 1)         # one add, one min
    return (max((in_bytes + out_bytes) / HBM_BYTES_PER_S,
                ops / FP32_OPS_PER_S) * 1e3,
            "bytes" if (in_bytes + out_bytes) / HBM_BYTES_PER_S
            >= ops / FP32_OPS_PER_S else "operations")


def minplus_bound_ms(V: int, C: int, R: int, K: int) -> tuple:
    K1 = K + 1
    nbytes = 4 * V * C * R * K1 + 4 * V * R + 4 * V * R * C
    # folds: an add and a compare per (r, k, i <= k); final: per (r, i)
    ops = 2 * V * R * (max(C - 2, 0) * K1 * (K1 + 1) // 2 + K1)
    b, o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(b, o) * 1e3, ("bytes" if b >= o else "operations")


def phase_timing(grid: dict, cxl: dict, syn: dict, out: dict) -> None:
    import torch

    from repro_torch import obs
    from repro_torch.core.multipool import combine_rows_torch
    from repro_torch.core.placement import build_lut_grid
    from repro_torch.kernels.knapsack_dp.ops import dp_stages, knapsack_dp
    from repro_torch.kernels.knapsack_dp.ref import (dp_stages_ref,
                                                     gather_rows)
    from repro_torch.kernels.lut_pipeline.ops import (combine_plan,
                                                      minplus_combine)

    # knapsack_dp (one cluster, V = C = 1) at gpu-pool's shape
    t_l, e_l = knapsack_case(grid)
    T, K = grid["T"], grid["K"]
    t1 = torch.tensor([[t_l]], dtype=torch.int32, device="cuda")
    e1 = torch.tensor([[e_l]], dtype=torch.float32, device="cuda")
    k_ms = cuda_ms(lambda: knapsack_dp(t_l, e_l, T, K, device="cuda",
                                       return_stages=True), reps=3)
    k_plain_ms = cuda_ms(lambda: dp_stages_ref(t1, e1, T, K), reps=2)
    k_bound, k_by = dp_stages_bound_ms(t1.cpu().numpy(), e1.cpu().numpy(),
                                       torch.zeros((1, 0)).numpy(), T, K)
    k_dev = op_ms(profile_device(lambda: knapsack_dp(
        t_l, e_l, T, K, device="cuda", return_stages=True)), "dp_stages")
    print(f"[time] knapsack_dp dp_stages: ms={k_ms!r} "
          f"device_only_ms={k_dev!r} plain_ms={k_plain_ms!r} "
          f"bound_ms={k_bound!r} ({k_by}) shape V=1 C=1 n=2 T={T} K={K} "
          f"t={t_l}")

    timings = {}
    for label, c in (("gpu-pool grid", grid), ("cxl-tier-3 grid", cxl),
                     ("synthetic C=5", syn)):
        t = torch.as_tensor(c["t"], dtype=torch.int32, device="cuda")
        e = torch.as_tensor(c["e"], dtype=torch.float32, device="cuda")
        rows = torch.as_tensor(c["rows"], dtype=torch.int32, device="cuda")
        T, K = c["T"], c["K"]
        V, C, _ = t.shape
        R = rows.shape[1]
        dp_ms = cuda_ms(lambda: dp_stages(t, e, T, K, rows), reps=3)
        dp_plain_ms = cuda_ms(
            lambda: gather_rows(dp_stages_ref(t, e, T, K)[:, :, -1], rows),
            reps=2)
        _, g = dp_stages(t, e, T, K, rows)
        mc_ms = cuda_ms(lambda: minplus_combine(g), reps=20)
        mc_plain_ms = cuda_ms(lambda: combine_rows_torch(g), reps=3)
        dp_bound, dp_by = dp_stages_bound_ms(c["t"], c["e"], c["rows"], T, K)
        mc_bound, mc_by = minplus_bound_ms(V, C, R, K)
        timings[label] = {
            "dp_stages": dict(ms=dp_ms, plain_ms=dp_plain_ms,
                              bound_ms=dp_bound, bound_by=dp_by),
            "minplus_combine": dict(ms=mc_ms, plain_ms=mc_plain_ms,
                                    bound_ms=mc_bound, bound_by=mc_by)}
        for k, rec in timings[label].items():
            print(f"[time] {label} {k}: ms={rec['ms']!r} "
                  f"plain_ms={rec['plain_ms']!r} bound_ms={rec['bound_ms']!r}"
                  f" ({rec['bound_by']}) shape V={V} C={C} "
                  f"n={t.shape[2]} T={T} K={K} R={R}")
        # kernel-only device times (the event loop above also holds the
        # wrappers' host work, which dominates a microsecond kernel)
        dev = print_profile(f"{label} lut_build", profile_device(
            lambda: minplus_combine(dp_stages(t, e, T, K, rows)[1])),
            ("dp_stages", "minplus_combine"))
        timings[label]["dp_stages"]["device_ms"] = dev["dp_stages"]
        # the combine alone, 20 launches: its device time per launch
        mc_dev = op_ms(profile_device(
            lambda: [minplus_combine(g) for _ in range(20)]),
            "minplus_combine")
        mc_dev = None if mc_dev is None else mc_dev / 20
        timings[label]["minplus_combine"]["device_ms"] = mc_dev
        plan = combine_plan(V, C, R, K)
        print(f"[time] {label} minplus_combine: device_only_ms={mc_dev!r} "
              f"(mean of 20 launches; one launch in the lut_build profile:"
              f" {dev['minplus_combine']!r}) events_ms={mc_ms!r} "
              f"bound_ms={mc_bound!r} ({mc_by}) device_bound_share="
              f"{mc_bound / mc_dev if mc_dev else None!r} grid="
              f"{plan.blocks} blocks x {plan.threads} threads, "
              f"{plan.shared_bytes} B dynamic shared memory")
        del g
        torch.cuda.empty_cache()

    # one build_lut_grid on the gpu-pool clock grid, split by its spans
    kw = dict(t_slice_ns=grid["t_slice"], n_points=grid["sub"].lut_points,
              static_window=grid["sub"].static_window, device="cuda")
    build_lut_grid(grid["ems"], **kw)                      # warm-up
    obs.reset()
    obs.enable()
    t0 = time.perf_counter()
    luts = build_lut_grid(grid["ems"], **kw)
    total_ms = (time.perf_counter() - t0) * 1e3
    spans = {ev["name"].rsplit(".", 1)[-1]: ev["dur"] / 1e3
             for ev in obs.tracer().events() if ev.get("ph") == "X"
             and ev["name"].startswith("placement.lut_grid.")}
    obs.reset()
    require(len(luts) == grid["t"].shape[0], "build_lut_grid LUT count")
    print(f"[time] build_lut_grid gpu-pool V={len(luts)}: "
          f"total_ms={total_ms!r} kernel_ms={spans.get('kernel')!r} "
          f"d2h_ms={spans.get('d2h')!r} "
          f"finalize_ms={spans.get('finalize')!r}")
    print_profile("build_lut_grid gpu-pool", profile_device(
        lambda: build_lut_grid(grid["ems"], **kw)),
        ("dp_stages", "minplus_combine"))
    out["timings"] = timings
    out["lut_grid_ms"] = dict(total=total_ms, **spans)


# -- the serving slice -----------------------------------------------------

def serve_config():
    """internlm2_1_8b at full width, unscanned: ``_retier`` walks the
    stack's entries and finds no FFN inside a "scan" group, as in the JAX
    package (ROADMAP reference note (c))."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("internlm2_1_8b"),
                               scan_layers=False)


def tier_columns(segs: dict) -> dict:
    """{tier: (first column, segment)} in split order."""
    cols, off = {}, 0
    for name, seg in segs.items():
        if seg.get("empty"):
            continue
        n = seg["q"].shape[1] if "q" in seg else seg["w"].shape[1]
        cols[name] = (off, seg)
        off += n
    return cols


def check_tiering(eng, params) -> float:
    """Every tiered matrix: int8 segments dequantize to within one step
    of their fp32 columns, bf16 segments are the columns' bf16 cast.
    Returns the largest error in quantization steps."""
    import torch

    from repro_torch.quant.int8 import dequantize
    worst = 0.0
    for (lname, wname), segs in eng._tiered.items():
        w = params["stack"][lname]["ffn"][wname]
        for name, (off, seg) in tier_columns(segs).items():
            if "q" in seg:
                n = seg["q"].shape[1]
                err = (dequantize(seg["q"], seg["scale"])
                       - w[:, off:off + n]).abs()
                steps = float((err / seg["scale"][None, :]).max())
                require(steps <= 1.0, f"{lname}/{wname}/{name}: int8 "
                        f"segment off by {steps} steps")
                worst = max(worst, steps)
            else:
                n = seg["w"].shape[1]
                require(torch.equal(seg["w"],
                                    w[:, off:off + n].to(torch.bfloat16)),
                        f"{lname}/{wname}/{name}: bf16 segment differs")
    return worst


def check_tiered_forward(eng, x, y) -> dict:
    """``y = eng.tiered_forward(x)`` on the card against the same
    segments composed on the CPU: int8 tiers bitwise, bf16 tiers within
    BF16_TIER_ATOL."""
    import torch

    from repro_torch.models.hetero_linear import tiered_matmul
    segs = eng._tiered[next(iter(eng._tiered))]
    cpu_segs = {k: {f: (v.cpu() if isinstance(v, torch.Tensor) else v)
                    for f, v in seg.items()} for k, seg in segs.items()}
    y_cpu = tiered_matmul(x.cpu(), cpu_segs)
    y = y.cpu()
    widths = {}
    for name, (off, seg) in tier_columns(segs).items():
        n = seg["q"].shape[1] if "q" in seg else seg["w"].shape[1]
        a, b = y[:, off:off + n], y_cpu[:, off:off + n]
        if "q" in seg:
            require(torch.equal(a, b), f"tiered_forward {name}: cuda != cpu")
        else:
            err = float((a - b).abs().max())
            require(err <= BF16_TIER_ATOL,
                    f"tiered_forward {name}: |cuda - cpu| = {err}")
        widths[name] = n
    return widths


def serve_slices(cfg, params, x, label: str) -> dict:
    """Drive ``cfg``'s serving path through ``api.engine("gpu-pool")``
    for SERVE_SLICES slices of ``case6_random`` with
    ``pim_matmul.launches`` set to 0 just before and read just after.
    Every retier must tier both FFN input matrices of every layer, each
    int8 segment must dequantize to within one step of its columns, and
    ``tiered_forward`` on ``x`` must equal the same segments composed on
    the CPU (int8 tiers bitwise)."""
    import torch

    from repro_torch import api
    from repro_torch.core import workloads
    from repro_torch.kernels.pim_mac.ops import pim_matmul

    pim_matmul.launches = 0
    t0 = time.perf_counter()
    eng = api.engine("gpu-pool", cfg, params, max_batch=16, device="cuda")
    loads = workloads.SCENARIOS["case6_random"][:SERVE_SLICES]
    widths, placements, worst = {}, [], 0.0
    for i, n in enumerate(loads):
        r = eng.run_slice(min(n, eng.max_batch))
        if r.retiered:
            require(len(eng._tiered) == 2 * cfg.n_layers,
                    f"{label} slice {i}: {len(eng._tiered)} matrices tiered")
            worst = max(worst, check_tiering(eng, params))
            placements.append(dict(r.report.placement))
        y = eng.tiered_forward(x)
        require(y.shape == (16, cfg.d_ff) and bool(torch.isfinite(y).all()),
                f"{label} slice {i}: tiered_forward {tuple(y.shape)}")
        if r.retiered:
            for name, w in check_tiered_forward(eng, x, y).items():
                widths.setdefault(name, set()).add(w)
        require(len(r.tokens) == min(r.report.n_done, eng.max_batch),
                f"{label} slice {i}: {len(r.tokens)} tokens")
        used = {k: v for k, v in r.report.placement.items() if v}
        print(f"[serve] {label} slice {i} load {n}: "
              f"E={r.report.energy_pj!r} pJ "
              f"retier={'y' if r.retiered else 'n'} "
              f"{'ok' if r.report.deadline_met else 'MISS'} {used} "
              f"tokens={r.tokens.tolist()}")
    torch.cuda.synchronize()
    launches = pim_matmul.launches
    elapsed = time.perf_counter() - t0
    print(f"[serve] {label} gpu-pool: {len(placements)} retiers x "
          f"{2 * cfg.n_layers} matrices; int8 segments within {worst!r} "
          f"steps; tiered_forward int8 tiers == cpu; tier widths "
          f"{ {k: sorted(v) for k, v in widths.items()} }; pim_matmul "
          f"launches during the serving path: {launches} ({elapsed:.2f} s)")
    require(launches > 0, f"pim_mac never launched on {label}'s serving path")
    return dict(engine=eng, launches=launches, placements=placements,
                int8_widths=sorted({w for k, v in widths.items()
                                    if k.endswith("int8") for w in v}))


def decode_engine_run(cfg, params, label: str) -> None:
    """``DecodeEngine``: 6 requests of 8 tokens at batch 4."""
    import torch

    from repro_torch.serve.engine import DecodeEngine, Request

    t0 = time.perf_counter()
    deng = DecodeEngine(cfg, params, max_batch=4, max_len=64, device="cuda")
    for rid in range(6):
        deng.submit(Request(rid=rid, prompt=[1 + rid, 2, 3],
                            max_new_tokens=8))
    done = deng.run_until_done()
    torch.cuda.synchronize()
    require(sorted(r.rid for r in done) == list(range(6))
            and all(len(r.out) == 8 for r in done),
            f"{label} DecodeEngine: {[(r.rid, len(r.out)) for r in done]}")
    steps = deng.step_times_s
    print(f"[serve] {label} DecodeEngine: 6/6 requests x 8 tokens in "
          f"{len(steps)} steps, {time.perf_counter() - t0:.2f} s; median "
          f"step {sorted(steps)[len(steps) // 2] * 1e3!r} ms; "
          f"outputs {[r.out for r in sorted(done, key=lambda r: r.rid)]}")


def phase_serving(cfg, out: dict) -> None:
    import dataclasses

    import torch

    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_lm(gen, cfg)
    x = torch.randn((16, cfg.d_model), generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype}: {n_params} params "
          f"initialised on cuda in {time.perf_counter() - t0:.2f} s")

    run = serve_slices(cfg, params, x, cfg.name)
    out["pim_launches"] = run["launches"]
    out["int8_widths"] = run["int8_widths"]
    out["engine"], out["x"] = run["engine"], x
    out["placements"] = run["placements"]
    decode_engine_run(cfg, params, cfg.name)

    # one decode_step of a 2-layer fp32 model at the same widths, cuda
    # against cpu
    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    p_gpu = lm.init_lm(torch.Generator(device="cuda").manual_seed(1), small)
    p_cpu = _tree_to(p_gpu, "cpu")
    toks = torch.tensor([5, 17, cfg.vocab_size - 1, 3], device="cuda")
    pos = torch.tensor([0, 3, 7, 1], device="cuda")
    logits = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        st = lm.init_decode_state(small, 4, 16, device=dev)
        logits[dev], _ = lm.decode_step(p, small, st, toks.to(dev),
                                        pos.to(dev))
    err = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
    print(f"[serve] 2-layer fp32 decode_step, cuda vs cpu: max |diff| "
          f"{err!r} (atol {DECODE_ATOL}), max |logit| "
          f"{float(logits['cpu'].abs().max())!r}")
    require(err <= DECODE_ATOL, f"decode_step cuda vs cpu: {err}")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def pim_bound_ms(M: int, K: int, N: int, out_bytes: int) -> tuple:
    nbytes = M * K + K * N + 4 * (M + N) + out_bytes * M * N
    b, o = nbytes / HBM_BYTES_PER_S, 2 * M * K * N / INT8_OPS_PER_S
    return max(b, o) * 1e3, ("bytes" if b >= o else "operations")


def pim_inputs(gen, M: int, K: int, N: int, copies: int = 1, lo=-128):
    """x, scales and ``copies`` weight matrices (enough to stream past
    the 50 MB L2 between launches, as successive layers do)."""
    import torch
    x = torch.randint(lo, 128, (M, K), dtype=torch.int8, device="cuda",
                      generator=gen)
    ws = [torch.randint(lo, 128, (K, N), dtype=torch.int8, device="cuda",
                        generator=gen) for _ in range(copies)]
    sx = torch.rand(M, device="cuda", generator=gen) * 0.2 + 1e-3
    sw = torch.rand(N, device="cuda", generator=gen) * 0.2 + 1e-3
    return x, ws, sx, sw


def cold_ms(fn, ws, reps: int) -> float:
    """Mean device time of ``fn(w)`` cycling through ``ws`` (CUDA
    events after one warm-up call)."""
    calls = [0]

    def step():
        fn(ws[calls[0] % len(ws)])
        calls[0] += 1
    return cuda_ms(step, reps=reps, warmup=1)


def pim_time_row(gen, M: int, K: int, N: int, sms: int) -> dict:
    """``pim_mac`` at (M, K, N), L2-cold with fp32 output: CUDA-event and
    profiler device-only ms beside its bound, its plain version and, at
    M > 16, ``torch._int_mm`` plus the same epilogue."""
    import torch

    from repro_torch.kernels.pim_mac.ops import pim_matmul, split_plan
    from repro_torch.kernels.pim_mac.ref import pim_matmul_ref

    # enough copies to stream past the 50 MB L2 (capped: a narrow tier's
    # weights stay L2-resident, as its layers' would)
    copies = min(64, max(2, -(-160 * 2 ** 20 // (K * N))))
    x, ws, sx, sw = pim_inputs(gen, M, K, N, copies=copies)
    ms = cold_ms(lambda w: pim_matmul(x, w, sx, sw), ws, reps=60)
    plain_ms = cold_ms(lambda w: pim_matmul_ref(x, w, sx, sw), ws, reps=6)

    def device_ms(fn, op):
        """Device-only ms per call of ``fn`` over 8 weight copies."""
        total = op_ms(profile_device(lambda: [fn(w) for w in ws[:8]]), op)
        return None if total is None else total / min(8, len(ws))

    lib_ms = lib_dev = None
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        def library(w):
            return torch._int_mm(x, w).float() * sx[:, None] * sw[None, :]
        lib_ms = cold_ms(library, ws, reps=60)
        lib_dev = device_ms(library, "")      # all of its kernels
    bound, by = pim_bound_ms(M, K, N, 4)
    dev_ms = device_ms(lambda w: pim_matmul(x, w, sx, sw), "pim_mac")
    plan = split_plan(M, K, N, sms)
    print(f"[time] pim_mac M={M} K={K} N={N}: ms={ms!r} "
          f"device_only_ms={dev_ms!r} plain_ms={plain_ms!r} "
          f"bound_ms={bound!r} ({by}) library_ms={lib_ms!r} "
          f"library_device_only_ms={lib_dev!r} (torch._int_mm + "
          f"epilogue) device_bound_share="
          f"{bound / dev_ms if dev_ms else None!r} splits={plan.splits}"
          f" blocks={plan.blocks} ({copies} weight copies, "
          f"{copies * K * N / 2 ** 20:.1f} MiB cycled)")
    del x, ws
    torch.cuda.empty_cache()
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev)


def phase_pim(out: dict) -> None:
    import torch

    from repro_torch.kernels.pim_mac.ops import pim_matmul
    from repro_torch.kernels.pim_mac.ref import pim_matmul_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(12)
    K = 2048
    shapes = [(16, K, n) for n in out["int8_widths"]] + [
        (16, K, 8192), (1, K, 8192), (32, K, 8192), (256, K, 8192)]
    err = 0.0
    for M, K_, N in shapes:
        x, (w,), sx, sw = pim_inputs(gen, M, K_, N)
        for od in (torch.float32, torch.bfloat16):
            a = pim_matmul(x, w, sx, sw, out_dtype=od)
            b = pim_matmul_ref(x, w, sx, sw, od)
            torch.cuda.synchronize()
            require(torch.equal(a, b), f"pim_mac {M}x{K_}x{N} {od} != plain")
            err = max(err, max_abs_err(a, b))
        print(f"[parity] pim_mac M={M} K={K_} N={N}: fp32 and bf16 equal")
    # worst-case magnitudes: every product +-127^2 summed over K
    x = torch.full((16, K), 127, dtype=torch.int8, device="cuda")
    w = torch.full((K, 40), -127, dtype=torch.int8, device="cuda")
    w[:, ::2] = 127
    ones = torch.ones(16, device="cuda"), torch.ones(40, device="cuda")
    a = pim_matmul(x, w, *ones)
    expect = torch.tensor([127 * 127 * K, -127 * 127 * K] * 20,
                          dtype=torch.float32, device="cuda").expand(16, 40)
    require(torch.equal(a, expect) and torch.equal(
        a, pim_matmul_ref(x, w, *ones)), "pim_mac worst case != exact")
    # scalar scales
    x, (w,), _, _ = pim_inputs(gen, 16, K, 1000)
    for od in (torch.float32, torch.bfloat16):
        a = pim_matmul(x, w, 0.0125, torch.tensor(0.5, device="cuda"),
                       out_dtype=od)
        require(torch.equal(a, pim_matmul_ref(x, w, 0.0125, 0.5, od)),
                f"pim_mac scalar scales {od} != plain")
    print(f"[parity] pim_mac worst case (+-127, K={K}) exact; scalar "
          f"scales equal; max_abs_err {err!r}")
    out["max_abs_err"]["pim_mac"] = err

    # timings: L2-cold (weights cycle past the 50 MB L2), fp32 out
    rows = {}
    main_n = max(out["int8_widths"] or [8192])
    for M, N in sorted({(16, n) for n in out["int8_widths"]}
                       | {(16, 8192), (1, 8192), (256, 8192), (32, 8192)}):
        rows[(M, N)] = pim_time_row(gen, M, K, N, sms)
    lib = rows[(32, 8192)]
    # the kernels line: the main path's shape (M=16, widest tier); no
    # library call takes M <= 16, so the comparison is made at M=32
    out["pim_time"] = dict(rows[(16, main_n)], library_ms=None,
                           library_device_ms=None, at_library_shape=dict(
                               M=32, K=K, N=8192, **lib))
    print(f"[time] pim_mac kernels-line shape M=16 K={K} N={main_n}; "
          f"kernel against torch._int_mm + epilogue at M=32 K={K} N=8192 "
          f"(no library call takes M <= 16): device-only "
          f"{lib['device_ms']!r} ms against {lib['library_device_ms']!r} ms")


def phase_serve_timing(cfg, out: dict) -> None:
    import torch

    from repro_torch import obs
    from repro_torch.models import lm

    eng, x = out["engine"], out["x"]
    placements = out["placements"]
    require(len({tuple(sorted(p.items())) for p in placements}) >= 2,
            "the serving run saw fewer than two placements")
    pa, pb = placements[-1], next(p for p in placements
                                  if p != placements[-1])

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    obs.reset()
    obs.enable()
    parts = {}
    for rep in range(3):
        target = pb if rep % 2 == 0 else pa
        parts.setdefault("sched_step", []).append(
            synced(lambda: eng.sched.step(3))[1])
        moved, ms = synced(lambda: eng.apply_placement(target))
        require(moved, "apply_placement did not migrate")
        parts.setdefault("retier", []).append(ms)
        parts.setdefault("decode", []).append(
            synced(lambda: eng.decode(16))[1])
        parts.setdefault("tiered_forward", []).append(
            synced(lambda: eng.tiered_forward(x))[1])
    spans = {}
    for ev in obs.tracer().events():
        if ev.get("ph") == "X" and ev["name"].startswith("engine."):
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    obs.reset()
    print(f"[time] run_slice split (gpu-pool, full width, host clock "
          f"ending in a synchronize, 3 reps, ms): "
          + " ".join(f"{k}={v!r}" for k, v in parts.items())
          + f"; obs spans (host, no synchronize): {spans!r}")
    total = [synced(lambda: eng.run_slice(3)) for _ in range(3)]
    print("[time] run_slice(3) total ms: " + repr(
        [(ms, "retier" if r.retiered else "no retier") for r, ms in total]))

    st = lm.init_decode_state(cfg, 16, 128, device="cuda")
    toks = torch.arange(16, device="cuda")
    step_ms = cuda_ms(lambda: lm.decode_step(eng.params, cfg, st, toks, 5),
                      reps=5)
    print(f"[time] full-width decode_step B=16 (bf16, per-call weight "
          f"cast): {step_ms!r} ms")
    print_profile("full-width decode_step", profile_device(
        lambda: lm.decode_step(eng.params, cfg, st, toks, 6)), ())


# -- the other model families -----------------------------------------------

FAMILIES = ["arctic_480b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
            "xlstm_1_3b", "seamless_m4t_medium", "pixtral_12b"]
# fp32 smoke models (TF32 off), cuda against cpu: sums of at most a few
# hundred terms taken in another order, through at most 16 blocks
FAMILY_ATOL = 1e-4
# full width, forward against prefill + decode of the same tokens,
# relative to the largest |logit|. recurrentgemma_2b in its bf16: both
# paths round every activation to bf16 (2^-8 apart at 1.0) in GEMMs of
# other shapes, which its 26 blocks keep below 16 units of 2^-8.
BF16_PATH_RTOL = 16 * 2.0 ** -8
# xlstm_1_3b's random-init 48-block stack is ill-conditioned (an input
# change of 2^-12 moves its hidden state by about a third in fp32 and
# more than half in bf16 on the H100; ``stack_sensitivity`` prints it),
# so the two paths of its whole stack are held in fp32, where they
# agree an order of magnitude inside 1e-3 of the largest logit. In bf16
# each recurrent block is held alone: it rounds to bf16 at up to seven
# points (projections, gates, the cell output, its product with the
# gate, the output projection) in GEMMs of other shapes, within 8 units
# of 2^-8 of its largest output
XLSTM_FP32_PATH_RTOL = 1e-3
BLOCK_BF16_RTOL = 8 * 2.0 ** -8
# one full-width MoE layer in fp32, cuda against cpu: sums of up to 8192
# terms in another order (outputs O(1))
MOE_LAYER_ATOL = 1e-3


def family_inputs(cfg, B: int, S: int, gen, frames: int, device):
    """Token ids and the family's extra inputs (prefix embeddings, encoder
    frames) drawn from ``gen``."""
    import torch
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=gen.device).to(device)
    extra = {}
    if cfg.n_prefix_embeds:
        extra["prefix_embeds"] = torch.randn(
            (B, cfg.n_prefix_embeds, cfg.d_model), generator=gen,
            device=gen.device).to(device)
    if cfg.is_encdec:
        extra["enc_frames"] = torch.randn(
            (B, frames, cfg.d_model), generator=gen,
            device=gen.device).to(device)
    return toks, extra


def family_logits(cfg, params, toks, extra) -> list:
    """forward (with the family's extra inputs), prefill and three
    decode steps, the last with per-row positions; logits on the CPU."""
    import torch

    from repro_torch.models import lm
    dev = toks.device
    outs = [lm.forward(params, cfg, toks, **extra)[0]]
    logits, st = lm.prefill(params, cfg, toks, max_len=16, **extra)
    outs.append(logits)
    n = toks.shape[1] + cfg.n_prefix_embeds
    for i, pos in enumerate((n, n + 1, [n + 2, 3])):
        logits, st = lm.decode_step(params, cfg, st, toks[:, i],
                                    torch.tensor(pos, device=dev))
        outs.append(logits)
    return [o.float().cpu() for o in outs]


def phase_families_smoke(out: dict) -> None:
    """Every family's smoke model in fp32, params from ``init_lm`` on a
    CPU generator: the card against the CPU on the same params and
    inputs, and a recurrentgemma decode that wraps its ring buffer."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    print("[family] cuda against cpu in fp32, "
          "torch.backends.cuda.matmul.allow_tf32 = False")
    for arch in FAMILIES:
        cfg = get_smoke_config(arch)
        p_cpu = lm.init_lm(torch.Generator().manual_seed(0), cfg)
        p_gpu = _tree_to(p_cpu, "cuda")
        toks, extra = family_inputs(cfg, 2, 6, torch.Generator()
                                    .manual_seed(1), 5, "cpu")
        ref = family_logits(cfg, p_cpu, toks, extra)
        ours = family_logits(cfg, p_gpu, toks.to("cuda"),
                             _tree_to(extra, "cuda"))
        err = max(max_abs_err(a, b) for a, b in zip(ours, ref))
        print(f"[family] {arch} smoke (L={cfg.n_layers} d={cfg.d_model} "
              f"{cfg.block_pattern}): forward, prefill, 3 decode steps "
              f"(one per-row): max |cuda - cpu| {err!r} (atol "
              f"{FAMILY_ATOL})")
        require(err <= FAMILY_ATOL, f"{arch}: cuda vs cpu {err}")
    # a ring of max_len 16 (the smoke window) decoded to position 23
    cfg = get_smoke_config("recurrentgemma_2b")
    p_cpu = lm.init_lm(torch.Generator().manual_seed(2), cfg)
    p_gpu = _tree_to(p_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(3))
    states = {d: lm.init_decode_state(cfg, 2, 16, device=d)
              for d in ("cpu", "cuda")}
    ring = max(v["k"].shape[1] for v in states["cuda"]["layers"].values()
               if "k" in v)
    err = 0.0
    for t in range(24):
        logits = {}
        for d, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            logits[d], states[d] = lm.decode_step(p, cfg, states[d],
                                                  toks[:, t].to(d), t)
        err = max(err, max_abs_err(logits["cuda"].cpu(), logits["cpu"]))
    print(f"[family] recurrentgemma_2b smoke ring buffer: {ring} slots, "
          f"24 decode steps (wraps at 16): max |cuda - cpu| {err!r}")
    require(ring == 16 and err <= FAMILY_ATOL, f"ring decode: {err}")


def model_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def decode_timing(cfg, params, st, toks, pos, label: str) -> None:
    """One full-width ``decode_step`` at B=4: CUDA events over 5 steps,
    torch.profiler's device busy time and idle share over one."""
    import torch

    from repro_torch.models import lm
    ms = cuda_ms(lambda: lm.decode_step(params, cfg, st, toks, pos), reps=5)
    prof = profile_device(lambda: lm.decode_step(params, cfg, st, toks, pos))
    idle = (1 - prof["busy_ms"] / prof["wall_ms"]) if prof["wall_ms"] \
        else None
    # what the step allocates (the per-call bf16 copies of the fp32
    # weights, the activations) and the device time of its copy kernels
    key = "allocated_bytes.all.allocated"
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats()[key]
    lm.decode_step(params, cfg, st, toks, pos)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_stats()[key] - a0
    copy_ms = sum(v for n, v in prof["by_name"].items()
                  if "copy" in n.lower()) if prof["by_name"] else None
    print(f"[family] {label} decode_step B={toks.shape[0]}: {ms!r} ms "
          f"(CUDA events, mean of 5); device busy {prof['busy_ms']!r} ms "
          f"of {prof['wall_ms']!r} ms, idle share {idle!r}; {alloc} bytes "
          f"allocated per step; copy kernels {copy_ms!r} ms on the device")


def decode_vs_forward(cfg, params, gen, label: str, rtol) -> None:
    """prefill of 8 tokens, then 8 decode steps, against ``forward`` on
    the same 16 tokens, in ``cfg.dtype``; the largest difference relative
    to the largest |logit|, held to ``rtol`` (None: measured only)."""
    import torch

    from repro_torch.models import lm
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                         device="cuda")
    full, _ = lm.forward(params, cfg, toks)
    logits, st = lm.prefill(params, cfg, toks[:, :8], max_len=32)
    steps = [logits]
    for t in range(8, 16):
        logits, st = lm.decode_step(params, cfg, st, toks[:, t], t)
        steps.append(logits)
    steps = torch.stack(steps, dim=1).float()
    ref = full[:, 7:16].float()
    scale = float(ref.abs().max())
    rel = float((steps - ref).abs().max()) / scale
    agree = float((steps.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"[family] {label} prefill(8) + 8 decode steps vs forward(16), "
          f"{cfg.dtype}: max |diff| / max |logit| = {rel!r} (rtol "
          f"{rtol!r}), max |logit| {scale!r}, argmax agreement {agree!r}")
    require(rtol is None or rel <= rtol,
            f"{label} {cfg.dtype}: decode vs forward {rel}")


def stack_sensitivity(cfg, params, gen, label: str) -> None:
    """How far the whole stack moves a relative input change of 2^-12:
    the hidden state's largest change relative to its largest value, in
    fp32 and in ``cfg.dtype``."""
    import dataclasses

    import torch

    from repro_torch.models import lm
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                         device="cuda")
    res = {}
    for c in (dataclasses.replace(cfg, dtype=torch.float32), cfg):
        x, pos = lm._embed_inputs(params, c, toks)
        eps = (torch.randn(x.shape, generator=gen, device="cuda")
               * float(x.abs().max()) * 2.0 ** -12).to(c.dtype)
        h0, _ = lm._apply_stack(params["stack"], x, c, positions=pos)
        h1, _ = lm._apply_stack(params["stack"], x + eps, c, positions=pos)
        res[str(c.dtype)] = float((h1.float() - h0.float()).abs().max()
                                  / h0.float().abs().max())
    print(f"[family] {label} stack sensitivity: an input change of 2^-12 "
          f"(relative) moves the hidden state by {res!r} (relative)")


def block_decode_vs_forward(cfg, params, gen, label: str) -> None:
    """Each kind of recurrent block of the stack on its own, in
    ``cfg.dtype``: its full-sequence form on 16 inputs against 16
    single-token decode steps from the zero state."""
    import torch

    from repro_torch.models import lm, recurrent
    x = torch.randn((4, 16, cfg.d_model), generator=gen, device="cuda"
                    ).to(cfg.dtype)
    kinds = lm._stack_layout(cfg)
    for kind in dict.fromkeys(cfg.block_pattern):
        if kind == "attn":
            continue
        if kinds[0]:                          # scanned: group 0's block
            i = cfg.block_pattern.index(kind)
            mix = lm._index_tree(params["stack"]["scan"], 0)[f"p{i}"]["mix"]
        else:
            i = cfg.pattern_for_depth().index(kind)
            mix = params["stack"][f"tail_{i}"]["mix"]
        y = getattr(recurrent, f"{kind}_block")(mix, x, cfg)
        init = getattr(recurrent, f"init_{kind}_state")
        st = (init(cfg, 4, cfg.dtype, "cuda") if kind == "rglru"
              else init(cfg, 4, "cuda"))
        steps = []
        for t in range(16):
            yt, st = getattr(recurrent, f"{kind}_decode")(
                mix, x[:, t:t + 1], cfg, st)
            steps.append(yt)
        rel = float((torch.cat(steps, 1).float() - y.float()).abs().max()
                    / y.float().abs().max())
        print(f"[family] {label} one {kind} block, 16 decode steps vs its "
              f"forward, {cfg.dtype}: max |diff| / max |y| = {rel!r} (rtol "
              f"{BLOCK_BF16_RTOL!r})")
        require(rel <= BLOCK_BF16_RTOL, f"{label} {kind} block: {rel}")


def moe_layer_check(cfg, params) -> None:
    """One MoE layer of the full-width model in fp32 on the card against
    the same layer on the CPU: at a decode batch (no drops) and a
    prefill batch that drops tokens over capacity."""
    import dataclasses

    import torch

    from repro_torch.models import moe
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    ffn = params["stack"]["tail_0"]["ffn"]
    ffn_cpu = _tree_to(ffn, "cpu")
    gen = torch.Generator(device="cuda").manual_seed(21)
    for B, S in ((4, 1), (4, 64)):
        x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
        if S > 1:
            # tokens near one another pick the same experts: past capacity
            x = x[:1, :1] + 0.05 * x
        T = B * S
        cap = moe._block_capacity(T, f32)
        top = torch.topk(x.reshape(T, -1) @ ffn["router"],
                         cfg.experts_per_token, dim=-1).indices
        most = int(torch.bincount(top.reshape(-1),
                                  minlength=cfg.n_experts).max())
        dropped = int(torch.clamp(torch.bincount(
            top.reshape(-1), minlength=cfg.n_experts) - cap, min=0).sum())
        y = moe.moe(ffn, x, f32).cpu()
        y_cpu = moe.moe(ffn_cpu, x.cpu(), f32)
        err = max_abs_err(y, y_cpu)
        print(f"[family] {cfg.name} MoE layer fp32 T={T}: capacity {cap}, "
              f"most tokens on one expert {most}, dropped {dropped}; max "
              f"|cuda - cpu| {err!r} (atol {MOE_LAYER_ATOL}), max |y| "
              f"{float(y_cpu.abs().max())!r}")
        require(err <= MOE_LAYER_ATOL, f"MoE layer T={T}: {err}")
        require((dropped > 0) == (S > 1), f"MoE layer T={T}: {dropped} "
                f"tokens dropped")


# (arch, overrides, the cut as printed)
FULL_WIDTH = [
    ("recurrentgemma_2b", dict(scan_layers=False),
     "whole: 26 layers, uncut; unscanned for the serving engine"),
    ("xlstm_1_3b", {}, "whole: 48 layers in 6 scanned groups of 8, "
     "d_ff=0, uncut"),
    ("seamless_m4t_medium", {}, "whole: 12 encoder + 12 decoder layers, "
     "uncut; encode 32 frames per row"),
    ("pixtral_12b", dict(n_layers=8, scan_layers=False),
     "8 of 40 layers; 256 prefix embeds per row"),
    ("llama4_scout_17b_a16e", dict(n_layers=4, scan_layers=False),
     "4 of 48 layers, all 16 experts at d 5120 / d_ff 8192, top-1"),
]


def phase_families_full(out: dict) -> None:
    """Each family at full width with random weights from a seeded
    generator on the card, one model at a time (freed before the next):
    parameter count, bytes on the card, one B=4 decode_step by CUDA
    events and its device idle share by torch.profiler, and the family's
    consistency checks; recurrentgemma_2b then serves (phase 9)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    for arch, over, cut in FULL_WIDTH:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), **over)
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"[family] {arch} at full width ({cut}): L={cfg.n_layers} "
              f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
              f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
              f"experts={cfg.n_experts} dtype={cfg.dtype}: {n_params} "
              f"params, {model_bytes(params)} bytes of params, "
              f"{torch.cuda.memory_allocated()} bytes allocated on the card")
        if cfg.family in ("hybrid", "ssm"):
            gen = torch.Generator(device="cuda").manual_seed(5)
            block_decode_vs_forward(cfg, params, gen, arch)
            stack_sensitivity(cfg, params, gen, arch)
            if arch == "xlstm_1_3b":
                f32 = dataclasses.replace(cfg, dtype=torch.float32)
                decode_vs_forward(f32, params, gen, arch,
                                  XLSTM_FP32_PATH_RTOL)
                # the whole stack in bf16: measured, not held (above)
                decode_vs_forward(cfg, params, gen, arch, None)
            else:
                decode_vs_forward(cfg, params, gen, arch, BF16_PATH_RTOL)
        if cfg.n_experts:
            moe_layer_check(cfg, params)
        toks, extra = family_inputs(cfg, 4, 8, torch.Generator(
            device="cuda").manual_seed(7), 32, "cuda")
        n = toks.shape[1] + cfg.n_prefix_embeds
        logits, st = lm.prefill(params, cfg, toks, max_len=n + 16, **extra)
        torch.cuda.synchronize()
        require(logits.shape == (4, cfg.vocab_size)
                and bool(torch.isfinite(logits).all()),
                f"{arch}: prefill logits {tuple(logits.shape)}")
        if cfg.is_encdec:
            require(st["enc_out"].shape == (4, 32, cfg.d_model),
                    f"{arch}: enc_out {tuple(st['enc_out'].shape)}")
        nxt = logits.argmax(-1)
        decode_timing(cfg, params, st, nxt, n, arch)
        logits, st = lm.decode_step(params, cfg, st, nxt, n)
        require(bool(torch.isfinite(logits).all()), f"{arch}: decode")
        del st, logits
        if arch == "recurrentgemma_2b":
            phase_serving_recurrentgemma(cfg, params, out)
        del params
        torch.cuda.empty_cache()
        print(f"[family] {arch} done in {time.perf_counter() - t0:.2f} s; "
              f"{torch.cuda.memory_allocated()} bytes still allocated")


def phase_serving_recurrentgemma(cfg, params, out: dict) -> None:
    """Phase 3: recurrentgemma_2b at full width through
    ``api.engine("gpu-pool")`` (52 FFN matrices per migration, int8 tiers
    on ``pim_mac`` at K=2560), its int8 tiers bitwise to the CPU, then
    ``DecodeEngine``, and ``pim_mac`` timed L2-cold at the widest int8
    tier."""
    import torch

    from repro_torch.kernels.pim_mac.ops import pim_matmul
    from repro_torch.kernels.pim_mac.ref import pim_matmul_ref

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((16, cfg.d_model), generator=gen, device="cuda")
    run = serve_slices(cfg, params, x, cfg.name)
    require(len(run["engine"]._tiered) == 52, "recurrentgemma: not 52 "
            "matrices tiered")
    out["pim_launches_rg"] = run["launches"]
    del run["engine"]
    decode_engine_run(cfg, params, cfg.name)
    K = cfg.d_model
    widths = run["int8_widths"] or [cfg.d_ff]
    for N in widths:
        xq, (w,), sx, sw = pim_inputs(gen, 16, K, N)
        for od in (torch.float32, torch.bfloat16):
            require(torch.equal(pim_matmul(xq, w, sx, sw, out_dtype=od),
                                pim_matmul_ref(xq, w, sx, sw, od)),
                    f"pim_mac 16x{K}x{N} {od} != plain")
    print(f"[parity] pim_mac M=16 K={K} N={widths}: fp32 and bf16 equal")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = pim_time_row(gen, 16, K, max(widths), sms)
    out["pim_time_rg"] = dict(row, M=16, K=K, N=max(widths))
    print(f"[serve] recurrentgemma_2b serving phase: "
          f"{time.perf_counter() - t0:.2f} s")


# -- the serving fleet -----------------------------------------------------

FLEET_SLICES = 16
# the trace's backlog drains within a few slices at this load; the cap
# bounds the phase's wall time (each slice decodes up to four full-width
# steps) whatever the trace does
FLEET_DRAIN_SLICES = 16


def fleet_trace():
    from repro_torch.fleet import make_trace
    return make_trace("mmpp", n_slices=FLEET_SLICES, seed=0)


def fleet_reports(fl) -> list:
    return [[dataclasses.asdict(r) for r in w.reports] for w in fl.workers]


def same_stats(a: dict, b: dict, dev_a: str, dev_b: str) -> bool:
    """Two ``pc.stats()`` equal but for the build device's label."""
    a, b = dict(a), dict(b)
    by_a, by_b = a.pop("builds_by_backend"), b.pop("builds_by_backend")
    return (a == b and by_a == {dev_a: a["builds"]}
            and by_b == {dev_b: b["builds"]})


def _wrappers() -> dict:
    """Every kernel's wrapper, which keeps its launch count."""
    from repro_torch.kernels.knapsack_dp.ops import dp_stages
    from repro_torch.kernels.lut_pipeline.ops import minplus_combine
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
    from repro_torch.kernels.pim_mac.ops import pim_matmul
    from repro_torch.kernels.rglru_scan.ops import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.slstm_scan.ops import slstm_scan
    return {"dp_stages": dp_stages, "minplus_combine": minplus_combine,
            "pim_mac": pim_matmul, "rglru_scan": rglru_scan,
            "rglru_scan_bwd": rglru_scan_bwd, "mlstm_scan": mlstm_scan,
            "slstm_scan": slstm_scan}


def kernel_counts() -> dict:
    return {k: w.launches for k, w in _wrappers().items()}


def zero_kernel_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def nearest_rank(xs, q: float) -> float:
    s = sorted(xs)
    return s[max(math.ceil(q / 100 * len(s)) - 1, 0)]


def fleet_decode_run(cfg, params, card: str) -> dict:
    """The flat fleet at full width: ``api.fleet("gpu-pool-mixed", ...,
    decode=True, solver="dp", dvfs=True)`` with four workers (two engine
    shapes) sharing ``params``, driven with every launch count set to 0
    just before bring-up and obs tracing on. Bring-up is timed on the
    host clock with the stage tensors' copies to the host split out;
    each slice ends in a synchronize. Returns the fleet, its result and
    the timings."""
    import torch

    from repro_torch import api, obs
    from repro_torch.core import placement

    kw = dict(n_engines=4, solver="dp", dvfs=True, forecaster="holt",
              max_batch=16)
    d2h = {"ms": 0.0, "n": 0, "bytes": 0}
    host = placement._host

    def timed_host(x):
        torch.cuda.synchronize()          # the kernels end before the copy
        t = time.perf_counter()
        y = host(x)
        d2h["ms"] += (time.perf_counter() - t) * 1e3
        d2h["n"] += 1
        d2h["bytes"] += y.nbytes
        return y

    obs.reset()
    obs.enable()
    zero_kernel_counts()
    placement._host = timed_host
    try:
        t0 = time.perf_counter()
        pc = api.compiler(device="cuda")
        fl = api.fleet("gpu-pool-mixed", cfg, params=params, decode=True,
                       compiler=pc, device="cuda", **kw)
        torch.cuda.synchronize()
        bring_up_ms = (time.perf_counter() - t0) * 1e3
    finally:
        placement._host = host
    at_bring_up = kernel_counts()
    lut_ms = sum(ev["dur"] / 1e3 for ev in obs.tracer().events()
                 if ev["name"] == "compiler.lut_build")
    print(f"[fleet] bring-up of api.fleet(gpu-pool-mixed, internlm2_1_8b, "
          f"4 engines, decode, dp, dvfs): {bring_up_ms!r} ms host clock "
          f"({card}); compiler.lut_build spans {lut_ms!r} ms; stage-tensor "
          f"copies to the host {d2h['ms']!r} ms in {d2h['n']} copies of "
          f"{d2h['bytes']} bytes; {pc.stats()}; launches {at_bring_up}")
    require(at_bring_up["dp_stages"] > 0 and at_bring_up["minplus_combine"]
            > 0, f"a placement kernel never launched at bring-up: "
            f"{at_bring_up}")

    trace = fleet_trace()
    stamps = []

    def cb(s, n_arr, done, workers):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    res = fl.run(trace, max_drain_slices=FLEET_DRAIN_SLICES, verbose_cb=cb)
    slice_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    launches = kernel_counts()
    spans = {r["name"]: r for r in obs.summarize_events(
        obs.tracer().events())}
    migrations = [ev["args"]["n_weights"] for ev in obs.tracer().events()
                  if ev["name"] == "engine.migration"]
    obs.reset()
    print(f"[fleet] {res.n_slices} slices run ({len(trace)} of trace "
          f"{trace.name}, {trace.total} requests, drain capped at "
          f"{FLEET_DRAIN_SLICES}); per-slice wall ms p50 "
          f"{nearest_rank(slice_ms, 50)!r} p99 {nearest_rank(slice_ms, 99)!r}"
          f" max {max(slice_ms)!r} total {sum(slice_ms)!r} ({card})")
    for name in ("worker.step", "engine.migration", "engine.decode",
                 "compiler.lut_build", "sched.slice", "fleet.slice"):
        r = spans.get(name)
        print(f"[fleet] span {name}: "
              + ("none" if r is None else
                 f"count {r['count']} total_us {r['total_us']!r} mean_us "
                 f"{r['mean_us']!r} max_us {r['max_us']!r}"))
    require(migrations and all(n == 2 * cfg.n_layers for n in migrations),
            f"fleet migrations tiered {migrations} matrices")
    print(f"[fleet] {len(migrations)} migrations, each of "
          f"{2 * cfg.n_layers} matrices")
    print(f"[fleet] launches from bring-up to the end of the run: "
          f"{launches}")
    return dict(fleet=fl, res=res, pc=pc, bring_up_ms=bring_up_ms,
                lut_ms=lut_ms, d2h=d2h, slice_ms=slice_ms, spans=spans,
                launches=launches)


def fleet_analytic(cfg, dev: str, trace) -> tuple:
    """The same fleet without engines (``decode=False``) on ``dev``."""
    from repro_torch import api
    pc = api.compiler(device=dev)
    fl = api.fleet("gpu-pool-mixed", cfg, n_engines=4, solver="dp",
                   dvfs=True, forecaster="holt", max_batch=16,
                   compiler=pc, device=dev)
    return fl, fl.run(trace, max_drain_slices=FLEET_DRAIN_SLICES), pc


def hierarchy_check(cfg) -> dict:
    """The two-level fleet with the autoscaler (analytic) on the card
    against the CPU: the same assignments, scale events and summary;
    scale-ups pay 0 LUT builds."""
    import torch

    from repro_torch import api
    from repro_torch.fleet import make_trace, summarize

    # a crowd that starts at once and decays slowly: cells scale up with
    # new workers (not only parked ones) before the load falls
    trace = make_trace("flash", n_slices=24, seed=0, spike=300.0,
                       spike_slice=0, decay=0.9)
    kw = dict(n_cells=4, engines_per_cell=4, autoscale=True,
              max_engines=8, solver="dp")
    runs = {}
    for dev in ("cuda", "cpu"):
        zero_kernel_counts()
        t0 = time.perf_counter()
        pc = api.compiler(device=dev)
        hf = api.hierarchical_fleet("gpu-pool-mixed", cfg, compiler=pc,
                                    device=dev, **kw)
        res = hf.run(trace)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (res, pc.stats(), kernel_counts(),
                     (time.perf_counter() - t0) * 1e3)
    (rc, sc, lc, ms), (rp, sp, _, ms_cpu) = runs["cuda"], runs["cpu"]
    require(rc.assignments == rp.assignments, "hierarchy: assignments "
            "cuda != cpu")
    require([dataclasses.asdict(e) for e in rc.scale_events]
            == [dataclasses.asdict(e) for e in rp.scale_events],
            "hierarchy: scale events cuda != cpu")
    require(summarize(rc) == summarize(rp), "hierarchy: summary")
    require(same_stats(sc, sp, "cuda", "cpu"), f"hierarchy: {sc} / {sp}")
    fresh = sum(e.direction == "up" and not e.unparked
                for e in rc.scale_events)
    require(fresh > 0 and rc.scale_up_builds == 0,
            f"hierarchy: {rc.n_scale_ups} scale-ups ({fresh} new workers) "
            f"paid {rc.scale_up_builds} builds")
    require(lc["dp_stages"] > 0 and lc["minplus_combine"] > 0,
            f"hierarchy: launches {lc}")
    s = summarize(rc)
    print(f"[fleet] hierarchical gpu-pool-mixed 4 cells x 4 engines, "
          f"autoscale to 8, dp, {trace.name}: {len(rc.assignments)} "
          f"assignments, {rc.n_scale_ups} scale-ups ({fresh} new workers, "
          f"{rc.scale_up_builds} builds) / {rc.n_scale_downs} downs, engines "
          f"{rc.n_engines_start} -> {rc.n_engines_peak} -> "
          f"{rc.n_engines_end}; completed {s.n_completed}/{s.n_submitted}, "
          f"miss rate {s.deadline_miss_rate!r}; == cpu; {sc}; launches "
          f"{lc}; {ms!r} ms (cpu {ms_cpu!r} ms)")
    return lc


def dag_check(cfg) -> dict:
    """The DAG fleet on cxl-tier-3 (C=3: the combine's middle fold) on
    the card against the CPU: the whole ``DagResult`` equal."""
    import torch

    from repro_torch import api
    from repro_torch.fleet import dag_arrivals, default_tenants
    from repro_torch.fleet import tenant_breakdown

    dtr = dag_arrivals(default_tenants(), n_slices=16, seed=0)
    runs = {}
    for dev in ("cuda", "cpu"):
        zero_kernel_counts()
        pc = api.compiler(device=dev)
        df = api.dag_fleet("cxl-tier-3", cfg, n_cells=4, engines_per_cell=2,
                           solver="dp", compiler=pc, device=dev)
        res = df.run_dag(dtr)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (df, res, pc.stats(), kernel_counts())
    (fc, rc, sc, lc), (fp, rp, sp, _) = runs["cuda"], runs["cpu"]
    require(dataclasses.asdict(rc) == dataclasses.asdict(rp),
            "dag: DagResult cuda != cpu")
    tb = tenant_breakdown(rc, fc)
    require(tb == tenant_breakdown(rp, fp), "dag: tenant breakdown")
    require(same_stats(sc, sp, "cuda", "cpu"), f"dag: {sc} / {sp}")
    require(lc["dp_stages"] > 0 and lc["minplus_combine"] > 0,
            f"dag: launches {lc}")
    print(f"[fleet] dag cxl-tier-3 4 cells x 2 engines, dp, {dtr.name} "
          f"({dtr.total} dags): completed {len(rc.completed)}, rejected "
          f"{len(rc.rejected)}, unfinished {len(rc.unfinished)}, "
          f"{len(rc.assignments)} stage placements, {rc.handoffs} "
          f"handoffs; == cpu; {sc}; launches {lc}; tenants "
          f"{ {k: v['n_completed'] for k, v in tb.items()} }")
    return lc


def phase_fleet(cfg, card: str, out: dict) -> None:
    """The serving fleet (slice C): full-width internlm2_1_8b workers on
    gpu-pool-mixed, held to the same fleet without engines on the card
    and on the CPU; each worker's int8 tiers through ``pim_mac``
    bitwise to the CPU; then the hierarchical and DAG fleets against the
    CPU."""
    import torch

    from repro_torch.fleet import summarize
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(16), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[fleet] {cfg.name}: {n_params} params, {model_bytes(params)} "
          f"bytes, shared by every worker ({time.perf_counter() - t0:.2f} s)")
    run = fleet_decode_run(cfg, params, card)
    fl, res, pc = run["fleet"], run["res"], run["pc"]
    trace = fleet_trace()
    reports = fleet_reports(fl)
    summary = summarize(res)
    for dev in ("cuda", "cpu"):
        afl, ares, apc = fleet_analytic(cfg, dev, trace)
        require(fleet_reports(afl) == reports,
                f"fleet: decode=True reports != decode=False on {dev}")
        require(summarize(ares) == summary, f"fleet: summary != {dev}")
        if dev == "cpu":
            require(same_stats(pc.stats(), apc.stats(), "cuda", "cpu"),
                    f"fleet: {pc.stats()} / {apc.stats()}")
    print(f"[fleet] per-worker SliceReports and FleetSummary == the same "
          f"fleet with decode=False on cuda and on cpu; pc.stats() == cpu "
          f"but the device: {pc.stats()}")
    print(f"[fleet] summary: completed {summary.n_completed}/"
          f"{summary.n_submitted}, p99 {summary.p99_ms!r} ms (SLO "
          f"{summary.slo_ms!r}), miss rate {summary.deadline_miss_rate!r}, "
          f"{summary.migrations} migrating slices, energy "
          f"{summary.energy_uj!r} uJ")

    from repro_torch.kernels.pim_mac.ops import pim_matmul
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((16, cfg.d_model), generator=gen, device="cuda")
    before = pim_matmul.launches
    widths = {}
    for w in fl.workers:
        eng = w.hetero
        require(len(eng._tiered) == 2 * cfg.n_layers,
                f"worker {w.wid}: {len(eng._tiered)} matrices tiered")
        y = eng.tiered_forward(x)
        require(y.shape == (16, cfg.d_ff) and bool(torch.isfinite(y).all()),
                f"worker {w.wid}: tiered_forward {tuple(y.shape)}")
        for name, n in check_tiered_forward(eng, x, y).items():
            widths.setdefault(name, set()).add(n)
    torch.cuda.synchronize()
    run["launches"]["pim_mac"] = pim_matmul.launches - before
    require(run["launches"]["pim_mac"] > 0, "pim_mac never launched on "
            "the fleet's tiers")
    print(f"[fleet] every worker's tiered_forward (16, {cfg.d_model}): "
          f"int8 tiers == cpu; tier widths "
          f"{ {k: sorted(v) for k, v in widths.items()} }; launches on the "
          f"fleet path {run['launches']}")
    del fl, run["fleet"], params
    torch.cuda.empty_cache()
    out["fleet"] = {k: run[k] for k in ("bring_up_ms", "lut_ms", "d2h",
                                        "launches")}
    out["fleet"]["slice_ms_p50"] = nearest_rank(run["slice_ms"], 50)
    out["fleet"]["slice_ms_p99"] = nearest_rank(run["slice_ms"], 99)
    out["fleet_hierarchy_launches"] = hierarchy_check(cfg)
    out["fleet_dag_launches"] = dag_check(cfg)


# -- training (slice D) -------------------------------------------------------

TRAIN_FAMILIES = ["internlm2_1_8b", "arctic_480b", "llama4_scout_17b_a16e",
                  "recurrentgemma_2b", "xlstm_1_3b", "pixtral_12b",
                  "seamless_m4t_medium"]
# fp32 smoke models (TF32 off), cuda against cpu: a loss is a mean of
# O(10) log-probabilities, each a sum of at most a few hundred terms in
# another order; a gradient leaf is held against its own largest entry.
# xlstm's 16-block stack amplifies each block's rounding (its logits are
# held at 5e-4 against the reference on the CPU)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
XLSTM_LOSS_RTOL = 5e-4
XLSTM_GRAD_RTOL = 1e-3
# a leaf whose CPU gradient is below this share of the tree's largest |g|
# is cancellation noise (the mLSTM input-gate bias, analytically ~0, at
# most 3.1e-9 of it on the CPU) and is held to that level on the card,
# not to its own size
GRAD_NOISE_SHARE = 1e-7
# three Trainer steps, cuda against cpu, with and without int8 gradient
# compression: each AdamW update is about lr * sign(g), so an entry whose
# gradient is rounding noise moves by up to 2 * lr in one run against the
# other; the loss feels that far below 1e-4 of its value
TRAINER_RTOL = 1e-4
# the full-width step with 8 microbatches against the Trainer's first
# step: the same loss on the same params and batch, in bf16 at another
# batch shape
MICRO_RTOL = 2e-2
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate at 700 W
BF16_FLOPS_PER_S = 989e12
TRAIN_FULL_STEPS = 4
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"


def train_batch(cfg, B: int, S: int, gen) -> dict:
    """A next-token batch and the family's extra inputs, on the CPU."""
    import torch
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_prefix_embeds:
        b["prefix_embeds"] = torch.randn(
            (B, cfg.n_prefix_embeds, cfg.d_model), generator=gen)
    if cfg.is_encdec:
        b["enc_frames"] = torch.randn((B, 5, cfg.d_model), generator=gen)
    return b


def loss_and_grads(cfg, params, batch):
    from repro_torch.train.step import make_loss_fn, value_and_grad
    (loss, _), grads = value_and_grad(make_loss_fn(cfg), params, batch)
    return float(loss), grads


def compare_grads(gc, gr, rtol: float) -> dict:
    """Card gradients ``gc`` against CPU gradients ``gr`` leaf by leaf:
    the largest error over a leaf's largest |g|, the noise leaves, and
    how many entries have opposite signs (AdamW's first update is about
    lr * sign(g), so each moves a param by up to 2 * lr). Compared on
    the card: the CPU gradients are copied there."""
    from repro_torch.tree import flatten_with_path
    pairs = [(p, a, b.to(a.device)) for (p, a), (_, b) in
             zip(flatten_with_path(gc), flatten_with_path(gr))]
    top = max(float(b.abs().max()) for _, _, b in pairs)
    worst, noise, flips = 0.0, 0, 0
    for path, a, b in pairs:
        require(a.shape == b.shape, f"grad {path}: {a.shape} != {b.shape}")
        leaf = float(b.abs().max())
        flips += int(((a > 0) & (b < 0) | (a < 0) & (b > 0)).sum())
        if leaf <= GRAD_NOISE_SHARE * top:
            noise += 1
            require(float(a.abs().max()) <= GRAD_NOISE_SHARE * top,
                    f"noise leaf {path}: {float(a.abs().max())}")
            continue
        rel = max_abs_err(a, b) / leaf
        require(rel <= rtol, f"grad {path}: {rel} of its max |g|")
        worst = max(worst, rel)
    return dict(grad_rel=worst, noise_leaves=noise, sign_flips=flips,
                leaves=len(pairs))


def smoke_trainer(cfg, dev: str, params, steps: int, total: int,
                  compression=False, ckpt_dir=None, ckpt_every=50):
    """A Trainer on ``dev`` that starts from a copy of ``params`` (the
    optimizer writes the params in place)."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.optim.compression import init_error_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_map
    t = Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=2,
                                     total_steps=total),
                DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8),
                TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                              ckpt_dir=ckpt_dir,
                              grad_compression=compression), device=dev)
    if params is not None:
        t.params = tree_map(lambda x: x.to(dev, copy=True), params)
        t.opt_state = t.opt.init(t.params)
        if compression:
            t.error_state = init_error_state(t.params)
    return t


def train_smoke() -> None:
    """Every family that trains, smoke size, fp32: loss and gradients on
    the card against the CPU; then Trainer steps (plain, compressed) and
    a resume on the dense smoke model."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in TRAIN_FAMILIES:
        cfg = get_smoke_config(arch)
        params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
        batch = train_batch(cfg, 2, 8, torch.Generator().manual_seed(1))
        lr_, gr = loss_and_grads(cfg, params, batch)
        lc, gc = loss_and_grads(cfg, _tree_to(params, "cuda"),
                                _tree_to(batch, "cuda"))
        xl = arch == "xlstm_1_3b"
        loss_rtol = XLSTM_LOSS_RTOL if xl else TRAIN_LOSS_RTOL
        rel = abs(lc - lr_) / abs(lr_)
        cmp = compare_grads(gc, gr, XLSTM_GRAD_RTOL if xl
                            else TRAIN_GRAD_RTOL)
        extra = sorted(k for k in batch if k not in ("tokens", "labels"))
        print(f"[train] {arch} smoke (L={cfg.n_layers} d={cfg.d_model}"
              f"{' +' + '+'.join(extra) if extra else ''}): loss cpu "
              f"{lr_!r} |cuda - cpu|/cpu {rel!r} (rtol {loss_rtol}); "
              f"{cmp['leaves']} grad leaves, max err {cmp['grad_rel']!r} "
              f"of the leaf's max |g|, {cmp['noise_leaves']} noise leaves, "
              f"{cmp['sign_flips']} entries of opposite sign")
        require(np.isfinite(lc) and rel <= loss_rtol,
                f"{arch}: loss {lc} vs {lr_}")

    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    for comp in (False, True):
        card, cpu = (smoke_trainer(cfg, dev, params, 3, 3, compression=comp)
                     for dev in ("cuda", "cpu"))
        card.run()
        cpu.run()
        ours, ref = ([m["loss"] for m in t.metrics_log] for t in (card, cpu))
        rel = max(abs(a - b) / abs(b) for a, b in zip(ours, ref))
        print(f"[train] Trainer, 3 steps, dense smoke, grad_compression="
              f"{comp}: losses cuda {ours} cpu {ref}; max rel diff {rel!r}")
        require(len(ours) == 3 and all(np.isfinite(ours)) and
                rel <= TRAINER_RTOL,
                f"Trainer cuda vs cpu (compression={comp}): {rel}")
    # resume: checkpoint at step 2, a fresh Trainer takes steps 3-4
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    try:
        whole = smoke_trainer(cfg, "cuda", None, 4, 4)
        whole.run()
        first = smoke_trainer(cfg, "cuda", None, 2, 4,
                              ckpt_dir=str(TRAIN_CKPT_DIR), ckpt_every=2)
        first.run()
        first._ckpt.close()
        resumed = smoke_trainer(cfg, "cuda", None, 4, 4,
                                ckpt_dir=str(TRAIN_CKPT_DIR), ckpt_every=2)
        require(resumed.maybe_resume() and resumed.step == 2,
                f"resume at step {resumed.step}")
        resumed.run()
        resumed._ckpt.close()
        a = [m["loss"] for m in resumed.metrics_log]
        b = [m["loss"] for m in whole.metrics_log[2:]]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        print(f"[train] resume: checkpoint at step 2, a fresh Trainer's "
              f"steps 3-4 {a} vs the uninterrupted run's {b}: max rel "
              f"diff {rel!r}")
        require(len(a) == 2 and rel <= TRAIN_LOSS_RTOL, f"resume: {rel}")
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)


KERNEL_CLASSES = [  # (class, substrings of a CUDA kernel's name), first match
    ("gemm fp32", ("sgemm", "f32f32", "simt")),
    ("gemm bf16", ("gemm", "nvjet", "xmma", "cutlass")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("index/scatter", ("index", "scatter", "gather")),
    ("copy/cast", ("Memcpy", "Memset", "copy", "cat_")),
    ("elementwise", ("elementwise",)),
]


def kernel_split(by_name: dict) -> dict:
    """Device ms of a profiled window by kernel class (``KERNEL_CLASSES``;
    the rest under "other")."""
    split: dict = {}
    for name, ms in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "other")
        split[cls] = split.get(cls, 0.0) + ms
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def train_model_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Model FLOPs of one training step (PaLM's MFU convention): 6 N T
    for the weight matmuls, N the parameters less the embedding table (a
    gather), T = B S tokens, plus 12 L H hd S T for attention's two
    products, causal masking not discounted; remat's recompute is not
    counted."""
    T = B * S
    n = n_params - cfg.vocab_size * cfg.d_model
    return 6.0 * n * T + 12.0 * cfg.n_layers * cfg.n_heads * cfg.hd * S * T


def train_full_width(card: str) -> None:
    """internlm2_1_8b at full width and depth as ``launch/train.py
    --full`` builds it, 4 Trainer steps at S=1024, B=8; then one
    microbatched ``make_train_step`` step on the same params and batch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch.specs import dryrun_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
    from repro_torch.train.step import (default_optimizer_kind,
                                        default_train_memory_plan,
                                        make_train_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dryrun_config(get_config("internlm2_1_8b"))
    B, S = 8, 1024
    ocfg = OptimizerConfig(kind=default_optimizer_kind(cfg), lr=1e-3,
                           warmup_steps=10, total_steps=TRAIN_FULL_STEPS)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t = Trainer(cfg, ocfg, dcfg, TrainerConfig(steps=TRAIN_FULL_STEPS,
                                               ckpt_dir=None), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(t.params))
    state_bytes = model_bytes(t.params) + sum(
        x.numel() * x.element_size() for x in _leaves(t.opt_state))
    print(f"[train-full] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}, {n_params} params; "
          f"dtype={cfg.dtype} scan_layers={cfg.scan_layers} remat="
          f"{cfg.remat}; optimizer {ocfg.kind}; S={S} B={B} (chunked CE: "
          f"{S // lm._CE_CHUNK} chunks of {lm._CE_CHUNK}); params + opt "
          f"state {state_bytes} bytes ({time.perf_counter() - t0:.2f} s)")
    events = []
    step_fn = t._step_fn

    def timed_step(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = step_fn(*a)
        end.record()
        events.append((start, end))
        return r
    t._step_fn = timed_step
    summary = t.run()
    torch.cuda.synchronize()
    losses = [m["loss"] for m in t.metrics_log]
    host_ms = [x * 1e3 for x in t.step_times]
    event_ms = [s.elapsed_time(e) for s, e in events]
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.median(host_ms[1:]))
    flops = train_model_flops(cfg, n_params, B, S)
    mfu = flops / (steady * 1e-3) / BF16_FLOPS_PER_S
    print(f"[train-full] losses {losses}; host-clock step ms (ending in "
          f".item()) {host_ms}; CUDA-event step ms {event_ms}; "
          f"max_memory_allocated {peak} bytes")
    print(f"[train-full] steps 2-{TRAIN_FULL_STEPS} median {steady!r} ms: "
          f"{B * S / (steady * 1e-3)!r} tokens/s; model FLOPs per step "
          f"{flops!r} (6 N T + 12 L H hd S T, N = params less the "
          f"embedding table, T = B S) = {flops / (steady * 1e-3) / 1e12!r}"
          f" TFLOP/s, {mfu!r} of the dense bf16 peak "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s ({card})")
    require(len(losses) == TRAIN_FULL_STEPS and all(
        np.isfinite(losses)), f"full-width losses {losses}")
    require(summary["steps"] == TRAIN_FULL_STEPS, f"{summary}")
    # one more step under the profiler: device busy time and idle share
    t._step_fn = step_fn
    t.tcfg.steps += 1
    prof = profile_device(t.run)
    if prof["by_name"]:
        print(f"[train-full] profiled step {t.step}: device busy "
              f"{prof['busy_ms']!r} ms of {prof['wall_ms']!r} ms, idle "
              f"share {1 - prof['busy_ms'] / prof['wall_ms']!r} (the "
              f"profiler's host cost included; against the unprofiled "
              f"median {steady!r} ms: {1 - prof['busy_ms'] / steady!r})")
        split = kernel_split(prof["by_name"])
        print("[train-full] device ms by kernel class: " + "; ".join(
            f"{k} {v:.2f}" for k, v in split.items()))
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:12]
        print("[train-full] top device kernels (ms): " + "; ".join(
            f"{n.replace('void at::native::', '')[:150]} {v:.2f}"
            for n, v in top))
    else:
        print("[train-full] profiled step: not measured (no CUDA activity "
              "traced)")
    first_loss = losses[0]
    del t, events, step_fn
    torch.cuda.empty_cache()

    # the microbatched step from the same seed on batch 0
    plan = default_train_memory_plan(cfg, B)
    params = lm.init_lm(torch.Generator("cuda").manual_seed(0), cfg)
    opt = make_optimizer(ocfg)
    step = make_train_step(cfg, opt, **plan)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in SyntheticLM(dcfg).batch(0).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, metrics = step(params, opt.init(params), batch)
    loss = metrics["loss"].item()
    ms = (time.perf_counter() - t0) * 1e3
    rel = abs(loss - first_loss) / abs(first_loss)
    print(f"[train-full] make_train_step with {plan['num_microbatches']} "
          f"microbatches ({plan['accum_dtype']} accumulation): loss {loss!r}"
          f" vs the Trainer's first {first_loss!r}, rel {rel!r} (rtol "
          f"{MICRO_RTOL}); {ms:.1f} ms with the optimizer's state init")
    require(np.isfinite(loss) and rel <= MICRO_RTOL,
            f"microbatched loss {loss} vs {first_loss}")
    del params, batch
    torch.cuda.empty_cache()


def train_full_width_parity() -> None:
    """A 2-layer fp32 internlm2 at full width: one loss + gradient on the
    card against the CPU (gradients, not updated params: AdamW's first
    update is about lr * sign(g))."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("internlm2_1_8b"), n_layers=2,
                              dtype=torch.float32, scan_layers=False,
                              remat=False)
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator().manual_seed(3), cfg)
    batch = train_batch(cfg, 2, 128, torch.Generator().manual_seed(4))
    lr_, gr = loss_and_grads(cfg, params, batch)
    cpu_s = time.perf_counter() - t0
    lc, gc = loss_and_grads(cfg, _tree_to(params, "cuda"),
                            _tree_to(batch, "cuda"))
    rel = abs(lc - lr_) / abs(lr_)
    cmp = compare_grads(gc, gr, TRAIN_GRAD_RTOL)
    n = sum(x.numel() for x in _leaves(params))
    print(f"[train-full] 2-layer fp32 internlm2 at full width ({n} params, "
          f"B=2 S=128): loss cpu {lr_!r} |cuda - cpu|/cpu {rel!r}; "
          f"{cmp['leaves']} grad leaves within {cmp['grad_rel']!r} of each "
          f"leaf's max |g| (rtol {TRAIN_GRAD_RTOL}), {cmp['noise_leaves']} "
          f"noise leaves; {cmp['sign_flips']} of {n} gradient entries have "
          f"opposite signs on the two devices ({cpu_s:.1f} s on the CPU)")
    require(rel <= TRAIN_LOSS_RTOL, f"2-layer loss {lc} vs {lr_}")
    del params, gr, gc
    torch.cuda.empty_cache()


def train_cli() -> None:
    """``python -m repro_torch.launch.train`` on the card, 3 steps."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "internlm2_1_8b", "--steps", "3", "--device", "cuda"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(ROOT / "src")))
    print(f"[train] {' '.join(cmd[1:])}: exit {res.returncode} "
          f"({time.perf_counter() - t0:.1f} s): "
          f"{res.stdout.strip().splitlines()}")
    require(res.returncode == 0, f"launch.train failed: {res.stderr}")


def smoke_rglru_launches() -> dict:
    """The RG-LRU launches of one loss + gradient of the recurrentgemma
    smoke model: each RG-LRU block's forward (twice under remat) and its
    backward."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("recurrentgemma_2b")
    n = cfg.pattern_for_depth().count("rglru")
    return {"rglru_scan": n * (2 if cfg.remat else 1), "rglru_scan_bwd": n}


def phase_training(card: str, out: dict) -> None:
    """Training (slice D) with every kernel's launch count set to 0: the
    smoke families, the Trainer and a resume against the CPU, full-width
    internlm2_1_8b steps, a full-width gradient against the CPU and the
    CLI. Of the port's kernels training reaches only the RG-LRU's two,
    in the recurrentgemma smoke gradient (xlstm trains through
    ``chunked_scan``): exactly its blocks' launches, every other count
    still 0 after."""
    zero_kernel_counts()
    timed("training/smoke", train_smoke)
    timed("training/full width", train_full_width, card)
    timed("training/full-width gradient", train_full_width_parity)
    timed("training/cli", train_cli)
    out["train_launches"] = kernel_counts()
    print(f"[train] kernel launches over the training phase: "
          f"{out['train_launches']}")
    expect = dict.fromkeys(out["train_launches"], 0)
    expect.update(smoke_rglru_launches())
    require(out["train_launches"] == expect,
            f"training launches {out['train_launches']}, expected {expect}")


# -- phase 12: sharding, the dry run and the examples ---------------------

DRYRUN_CELLS = (("internlm2_1_8b", "train_4k", "single"),
                ("internlm2_1_8b", "train_4k", "multi"),
                ("internlm2_1_8b", "decode_32k", "single"),
                ("internlm2_1_8b", "decode_32k", "multi"))
# a train cell traces all 8 microbatches op by op through DTensor's
# dispatch on the host, minutes at full depth: its depth is cut to 2
# blocks here (decode cells run whole)
DRYRUN_TRAIN_LAYERS = 2
HOST_EXAMPLES = ("quickstart", "placement_sweep", "fleet_demo",
                 "serve_dynamic")
SHARDED_DECODE_B = 16
SHARDED_DECODE_LEN = 256
# the mesh step's embedding gradient is F.embedding's backward, the plain
# step's index_put's accumulate: the same fp32 terms summed in another
# order on the card, so each param leaf is held to its largest entry
SHARDED_PARAM_RTOL = 1e-6


def _subprocess(cmd) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, what: str, timeout: float) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    require(proc.returncode == 0,
            f"{what}: exit {proc.returncode}: {err[-3000:]}")
    return out


def start_dryruns(out_dir: Path, cells) -> dict:
    """One ``launch.dryrun`` process per (arch, shape, mesh) cell, all
    started together (each starts its own fake world of 256 or 512
    ranks); train cells cut to ``DRYRUN_TRAIN_LAYERS`` blocks."""
    procs = {}
    for arch, shape, mesh in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
               "cuda", "--arch", arch, "--shape", shape, "--mesh",
               mesh, "--out", str(out_dir), "--force"]
        if shape.startswith("train"):
            cmd += ["--layers", str(DRYRUN_TRAIN_LAYERS)]
        procs[(arch, shape, mesh)] = (_subprocess(cmd), time.perf_counter())
    return procs


def start_examples(ckpt_dir: Path) -> dict:
    procs = {}
    for name in HOST_EXAMPLES:
        for dev in ("cuda", "cpu"):
            procs[(name, dev)] = _subprocess(
                [sys.executable, f"examples/torch/{name}.py", "--device",
                 dev])
    procs[("train_tiny", "cuda")] = _subprocess(
        [sys.executable, "examples/torch/train_tiny.py", "--device", "cuda",
         "--ckpt-dir", str(ckpt_dir)])
    return procs


def rules_argument_bytes(rec: dict) -> int:
    """The per-device bytes of a dry-run cell's inputs as the sharding
    rules lay them out: each leaf's local shard shape, summed."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch import specs as sp
    from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import flatten_with_path

    mesh = types.SimpleNamespace(shape=rec["mesh"])
    cfg = dataclasses.replace(get_config(rec["arch"]),
                              n_layers=rec["n_layers"])
    cfg = sp.dryrun_config(cfg, mesh)
    seq, batch, kind = sp.SHAPES[rec["shape"]]
    with FakeTensorMode():
        if kind == "train":
            p = sp.abstract_params(cfg, torch.bfloat16 if rec["zero1"]
                                   else None, device="cpu")
            ps = sh.params_shardings(p, mesh, inference=rec["zero1"])
            o = make_optimizer(OptimizerConfig(kind=rec["optimizer"])
                               ).init(p)
            b = sp.train_batch_specs(cfg, seq, batch, device="cpu")
            trees = [(p, ps), (o, sh.params_shardings_like(o, p, ps, mesh)),
                     (b, sh.batch_shardings(b, mesh))]
        elif kind == "prefill":
            p = sp.abstract_params(cfg, torch.bfloat16, device="cpu")
            b = sp.train_batch_specs(cfg, seq, batch, device="cpu")
            trees = [(p, sh.params_shardings(
                         p, mesh, inference=rec["tp_only_params"])),
                     (b, sh.batch_shardings(b, mesh))]
        else:
            p = sp.abstract_params(cfg, torch.bfloat16, device="cpu")
            st = sp.abstract_decode_state(cfg, batch, seq, device="cpu")
            tok, pos = sp.decode_token_specs(batch, device="cpu")
            trees = [(p, sh.params_shardings(
                         p, mesh, inference=rec["tp_only_params"])),
                     (st, sh.decode_state_shardings(st, mesh)),
                     ({"t": tok, "p": pos}, {"t": (None,), "p": ()})]
    total = 0
    for tree, specs in trees:
        for path, leaf in flatten_with_path(tree):
            spec = specs
            for k in path:
                spec = spec[k]
            total += math.prod(sh.local_shape(tuple(leaf.shape), spec,
                                              mesh)) * leaf.element_size()
    return total


def finish_dryruns(procs: dict, out_dir: Path, card: str,
                   tag: str = "sharded") -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as rl
    rows = {}
    for (arch, shape, mesh), (proc, t0) in procs.items():
        out_file = out_dir / f"{arch}__{shape}__{mesh}.json"
        try:
            _finish(proc, f"dry run {arch} {shape} {mesh}", 900)
        except AssertionError:
            if out_file.exists():     # the cell's own error and traceback
                print(out_file.read_text()[-4000:], file=sys.stderr)
            raise
        wall = time.perf_counter() - t0
        rec = json.loads(out_file.read_text())
        require(rec["status"] == "ok", f"dry run {arch} {shape} {mesh}: "
                f"{rec}")
        mem = rec["memory"]
        expect = rules_argument_bytes(rec)
        row = rl.roofline_row(arch, shape, mesh, out_dir)
        depth = get_config(arch).n_layers
        cut = (f"{rec['n_layers']} of {depth} blocks"
               if rec["n_layers"] != depth else "whole")
        print(f"[{tag}] dry run {arch} {shape} {mesh} "
              f"({rec['mesh']}, {cut}): trace {rec['trace_s']!r} s "
              f"(process {wall:.1f} s); per device: argument "
              f"{mem['argument_size_in_bytes']} B (rules' shards "
              f"{expect} B), temp {mem['temp_size_in_bytes']} B, output "
              f"{mem['output_size_in_bytes']} B; flops "
              f"{rec['cost']['flops']!r} ({rec['cost']['flops_per_device']!r}"
              f" per device); collectives {rec['collectives']}; "
              f"microbatches {rec.get('microbatches')}; feasible LUT "
              f"entries per substrate "
              f"{[x.get('lut_feasible') for x in rec.get('substrates', [])]}"
              f"; card {card}")
        print(f"[{tag}] roofline {arch} {shape} {mesh} (H100 constants; "
              f"analytic cost of all {depth} blocks, collectives of the "
              f"traced ones): {row}")
        require(mem["argument_size_in_bytes"] == expect,
                f"dry run {arch} {shape} {mesh}: argument bytes "
                f"{mem['argument_size_in_bytes']} != rules' {expect}")
        rows[f"{arch} {shape} {mesh}"] = {"trace_s": rec["trace_s"],
                                          "n_layers": rec["n_layers"]}
    return rows


def finish_examples(procs: dict) -> None:
    outs = {key: _finish(proc, f"example {key[0]} --device {key[1]}", 600)
            for key, proc in procs.items()}
    for name in HOST_EXAMPLES:
        same = outs[(name, "cuda")] == outs[(name, "cpu")]
        print(f"[sharded] examples/torch/{name}.py --device cuda: exit 0, "
              f"{len(outs[(name, 'cuda')].splitlines())} lines, stdout "
              f"{'equal to' if same else 'DIFFERENT from'} --device cpu")
        require(same, f"{name}: cuda and cpu stdout differ")
    tail = outs[("train_tiny", "cuda")].strip().splitlines()[-1]
    print(f"[sharded] examples/torch/train_tiny.py --device cuda: {tail}")


def sharded_mesh(card: str, out: dict) -> None:
    """A world of one on ``nccl``: full-width internlm2_1_8b decode
    through DTensor params and a DTensor decode state on the (1, 1) test
    mesh (every placement replicates) against the plain step, timed both
    ways; then one smoke train step on the mesh against the plain step."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_map

    store = ROOT / "build" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(data=1, model=1, device="cuda")
        cfg = serve_config()
        params = lm.init_lm(torch.Generator("cuda").manual_seed(0), cfg)
        dparams = sh.distribute(params, sh.params_shardings(
            params, mesh, inference=True), mesh)
        B, L = SHARDED_DECODE_B, SHARDED_DECODE_LEN
        state = lm.init_decode_state(cfg, B, L, device="cuda")
        st0 = lm.init_decode_state(cfg, B, L, device="cuda")
        dstate = sh.distribute(st0, sh.decode_state_shardings(st0, mesh),
                               mesh)
        toks = torch.randint(0, cfg.vocab_size, (8, B), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(1))
        err = 0.0
        with torch.no_grad():
            for pos in range(8):
                ref, state = lm.decode_step(params, cfg, state, toks[pos],
                                            pos)
                with sh.on_mesh():
                    got, dstate = lm.decode_step(dparams, cfg, dstate,
                                                 toks[pos], pos)
                err = max(err, max_abs_err(got.to_local(), ref))
            plain_ms = cuda_ms(lambda: lm.decode_step(
                params, cfg, state, toks[0], 8), reps=10)

            def mesh_step():
                with sh.on_mesh():
                    lm.decode_step(dparams, cfg, dstate, toks[0], 8)
            mesh_ms = cuda_ms(mesh_step, reps=10)
        print(f"[sharded] full-width internlm2_1_8b decode_step (B={B}, "
              f"max_len={L}, 8 steps) on the (1, 1) nccl mesh against the "
              f"plain step: max |diff| {err!r}; CUDA events: plain "
              f"{plain_ms!r} ms, DTensor {mesh_ms!r} ms (dispatch cost "
              f"{mesh_ms - plain_ms!r} ms a step); card {card}")
        require(err == 0.0, f"sharded decode differs from the plain step "
                            f"by {err}")
        out["sharded_decode"] = {"plain_ms": plain_ms, "mesh_ms": mesh_ms}
        del params, dparams, state, dstate, st0
        torch.cuda.empty_cache()

        scfg = get_smoke_config("internlm2_1_8b")
        p0 = lm.init_lm(torch.Generator("cuda").manual_seed(2), scfg)
        batch = {k: v.cuda() for k, v in train_batch(
            scfg, 8, 32, torch.Generator().manual_seed(3)).items()}
        opt = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=1))
        step = make_train_step(scfg, opt, num_microbatches=2)
        ref_p = tree_map(lambda x: x.clone(), p0)
        ref_p, _, ref_m = step(ref_p, opt.init(ref_p), batch)
        ps = sh.params_shardings(p0, mesh)
        s0 = opt.init(p0)
        dp, _, m = step(sh.distribute(p0, ps, mesh),
                        sh.distribute(s0, sh.params_shardings_like(
                            s0, p0, ps, mesh), mesh),
                        sh.distribute(batch, sh.batch_shardings(batch, mesh),
                                      mesh))
        perr = max(max_abs_err(a.to_local(), b) / float(b.abs().max())
                   for a, b in zip(_leaves(dp), _leaves(ref_p)))
        lerr = abs(float(m["loss"]) - float(ref_m["loss"]))
        print(f"[sharded] smoke internlm2 train step (2 microbatches, "
              f"AdamW) on the mesh against the plain step: |loss diff| "
              f"{lerr!r}, params max |diff| / leaf max {perr!r} (rtol "
              f"{SHARDED_PARAM_RTOL})")
        require(lerr == 0.0 and perr <= SHARDED_PARAM_RTOL,
                f"sharded train step differs: loss {lerr}, params {perr}")
    finally:
        dist.destroy_process_group()


def phase_sharded(card: str, out: dict) -> None:
    """Sharding (slice E): the sharded path on the card with every kernel's
    launch count set to 0 (none is reached: decode runs the untiered
    params, note (b)); then the dry run's cells and the examples, each a
    process of its own, all started together."""
    zero_kernel_counts()
    timed("sharded/mesh", sharded_mesh, card, out)
    out["sharded_launches"] = kernel_counts()
    print(f"[sharded] kernel launches over the sharded path: "
          f"{out['sharded_launches']}")
    require(not any(out["sharded_launches"].values()),
            f"the sharded path launched a kernel: {out['sharded_launches']}")
    work = ROOT / "build" / "chip_smoke_sharded"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    dry = start_dryruns(work / "dryrun", DRYRUN_CELLS)
    ex = start_examples(work / "train_tiny_ckpt")
    try:
        timed("sharded/examples", finish_examples, ex)
        out["dryrun"] = timed("sharded/dry run", finish_dryruns, dry,
                              work / "dryrun", card)
    finally:
        for proc in list(ex.values()) + [p for p, _ in dry.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    print(f"[sharded] dry run and examples: {time.perf_counter() - t0:.1f} "
          f"s wall")


# -- phase 13: the recurrent scans (slice F) ----------------------------------

# mLSTM and sLSTM against their plain versions on the card, relative to
# the output's largest |entry| (tests/test_torch_gpu.py's SCAN_RTOL): the
# kernel sums C q and n q over hd terms in another order than torch's
# einsum, and exp / tanh / log1p need not round as torch's build does (a
# few fp32 ulps, each carried through the state). The RG-LRU's two
# kernels are held bitwise.
SCAN_RTOL = 4e-6
# the main path's batch and length: recurrentgemma_2b and xlstm_1_3b
# forwards, recurrentgemma_2b's training steps
SCAN_B, SCAN_S = 2, 4096
# parity shapes, (B, S, d) and (B, S, H, hd): the smoke widths, then the
# full widths, each at S = 1, at S = 200 (not a multiple of 128 nor of
# the kernels' prefetch depth) and at the main path's S = 4096
PARITY_LENGTHS = (1, 200, SCAN_S)
# xlstm_1_3b's whole stack with the kernels against the plain loops, in
# fp32 at this shorter S (the plain mLSTM loop updates the (2, 4, 512,
# 512) state in ~15 ops a step), within XLSTM_FP32_PATH_RTOL of the
# largest logit: the kernels' rounding, a few ulps of each block's
# output, through the ill-conditioned random-init stack
XLSTM_PLAIN_S = 512
RG_TRAIN_STEPS = 2
RECURRENT_DRYRUN_CELLS = (("recurrentgemma_2b", "train_4k", "single"),
                          ("recurrentgemma_2b", "train_4k", "multi"),
                          ("recurrentgemma_2b", "prefill_32k", "single"),
                          ("recurrentgemma_2b", "prefill_32k", "multi"),
                          ("xlstm_1_3b", "prefill_32k", "single"),
                          ("xlstm_1_3b", "prefill_32k", "multi"))
SCAN_KERNELS = ("rglru_scan", "rglru_scan_bwd", "mlstm_scan", "slstm_scan")
# the substring of each scan's CUDA kernel name in a profile
SCAN_KERNEL_NAMES = {"rglru_scan": "rglru_scan_fwd",
                     "rglru_scan_bwd": "rglru_scan_bwd",
                     "mlstm_scan": "mlstm_scan_fwd",
                     "slstm_scan": "slstm_scan_fwd"}


def scan_inputs(kind: str, shape, gen) -> tuple:
    """Random inputs of one scan at ``shape``, drawn as the blocks make
    them: RG-LRU decays in (0, 1); the mLSTM's k scaled by 1/sqrt(hd) and
    its forget gate a logsigmoid; the sLSTM's forget pre-activation with
    the +3 bias."""
    import torch
    import torch.nn.functional as F

    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda")
    if kind in ("rglru_scan", "rglru_scan_bwd"):
        a = torch.rand(shape, generator=gen, device="cuda") * 0.99 + 0.005
        if kind == "rglru_scan":
            return a, rnd(*shape)
        from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
        return a, rglru_scan_ref(a, rnd(*shape)), rnd(*shape)
    if kind == "mlstm_scan":
        B, S, H, hd = shape
        return (rnd(*shape), rnd(*shape) / math.sqrt(hd), rnd(*shape),
                rnd(B, S, H), F.logsigmoid(rnd(B, S, H) + 3.0))
    z, i, f, o = (rnd(*shape) for _ in range(4))
    return z, i, f + 3.0, o


def scan_fns(kind: str) -> tuple:
    """(kernel wrapper, plain version) of one scan."""
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
    from repro_torch.kernels.rglru_scan.ops import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)
    from repro_torch.kernels.slstm_scan.ops import slstm_scan
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    return {"rglru_scan": (rglru_scan, rglru_scan_ref),
            "rglru_scan_bwd": (rglru_scan_bwd, rglru_scan_bwd_ref),
            "mlstm_scan": (mlstm_scan, mlstm_scan_ref),
            "slstm_scan": (slstm_scan, slstm_scan_ref)}[kind]


def scan_shapes(kind: str, S: int) -> list:
    """The smoke width and the full width of a scan at length S."""
    if kind == "mlstm_scan":
        return [(SCAN_B, S, 4, 16), (SCAN_B, S, 4, 512)]
    d = 2048 if kind == "slstm_scan" else 2560
    return [(SCAN_B, S, 64), (SCAN_B, S, d)]


def scan_bound_ms(kind: str, shape) -> tuple:
    """The least time for one scan at ``shape``: each input read and each
    output written once over the HBM rate, or its fp32 operations over
    the fp32 rate, the larger. RG-LRU: a multiply and an add a step
    (three forms the backward); mLSTM: 5 B S H hd^2 (roofline.py); sLSTM:
    about 25 a step, each transcendental counted as one."""
    n = math.prod(shape)
    if kind == "rglru_scan":
        nbytes, ops = 12 * n, 2 * n
    elif kind == "rglru_scan_bwd":
        nbytes, ops = 20 * n, 3 * n
    elif kind == "mlstm_scan":
        B, S, H, hd = shape
        nbytes, ops = 4 * (4 * n + 2 * B * S * H), 5 * n * hd
    else:
        nbytes, ops = 20 * n, 25 * n
    b, o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(b, o) * 1e3, ("bytes" if b >= o else "operations")


def scan_parity(out: dict) -> None:
    """Each scan kernel against its plain version on the card at the
    smoke and full widths, S = 1, 200 and 4096: the RG-LRU's bitwise,
    the mLSTM's and sLSTM's within SCAN_RTOL of the largest |h|."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(31)
    errs = {}
    for kind in SCAN_KERNELS:
        kern, plain = scan_fns(kind)
        worst_abs = worst_rel = 0.0
        for S in PARITY_LENGTHS:
            for shape in scan_shapes(kind, S):
                args = scan_inputs(kind, shape, gen)
                n0 = kern.launches
                got = kern(*args)
                torch.cuda.synchronize()
                require(kern.launches == n0 + 1, f"{kind} did not launch")
                ref = plain(*args)
                got, ref = ((got,), (ref,)) if kind != "rglru_scan_bwd" \
                    else (got, ref)
                for a, b in zip(got, ref):
                    err = max_abs_err(a, b)
                    rel = err / max(float(b.abs().max()), 1e-30)
                    worst_abs, worst_rel = max(worst_abs, err), max(
                        worst_rel, rel)
                    if kind.startswith("rglru"):
                        require(torch.equal(a, b), f"{kind} {shape}: "
                                f"differs from its plain version by {err}")
                    else:
                        require(rel <= SCAN_RTOL, f"{kind} {shape}: "
                                f"{rel} of the largest |h|")
                del args, got, ref
        errs[kind] = worst_abs
        held = "bitwise" if kind.startswith("rglru") else f"rtol {SCAN_RTOL}"
        print(f"[scan] {kind} against its plain version on the card at "
              f"{[scan_shapes(kind, S) for S in PARITY_LENGTHS]}: max "
              f"|diff| {worst_abs!r}, {worst_rel!r} of the largest |out| "
              f"({held})")
    out["scan_max_abs_err"] = errs
    torch.cuda.empty_cache()


def scan_timing(card: str, out: dict) -> None:
    """Each scan at the main path's full width (B=2, S=4096): CUDA events
    over the wrapper (host work included) and the plain version by
    events, beside the bound. Its device-only time comes from the
    profiled forward or training step of the path that launches it
    (``scan_device_ms``)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(37)
    rows = {}
    for kind in SCAN_KERNELS:
        kern, plain = scan_fns(kind)
        shape = scan_shapes(kind, SCAN_S)[1]
        args = scan_inputs(kind, shape, gen)
        ms = cuda_ms(lambda: kern(*args), reps=10)
        plain_ms = cuda_ms(lambda: plain(*args), reps=1, warmup=0)
        bound, by = scan_bound_ms(kind, shape)
        rows[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, shape=list(shape))
        print(f"[scan] {kind} {shape}: ms={ms!r} plain_ms={plain_ms!r} "
              f"bound_ms={bound!r} ({by}); card {card}")
        del args
    out["scan_time"] = rows
    torch.cuda.empty_cache()


def scan_device_ms(out: dict, profiled: dict, per_window: dict) -> None:
    """Each scan's device-only ms per launch at the main path's shape:
    its kernels' time in a profiled forward or step over its launches
    there; printed beside its bound."""
    for k, ms in profiled.items():
        if per_window.get(k):
            row = out["scan_time"][k]
            row["device_ms"] = None if ms is None else ms / per_window[k]
            dev = row["device_ms"]
            print(f"[scan] {k} device_only_ms={dev!r} per launch (profiled "
                  f"path, {per_window[k]} launches) bound_ms="
                  f"{row['bound_ms']!r} device_bound_share="
                  f"{row['bound_ms'] / dev if dev else None!r}")


@contextlib.contextmanager
def plain_scans():
    """The recurrent blocks run the scans' plain versions on the card (the
    loops over time the port ran before the kernels)."""
    from repro_torch.models import recurrent
    names = ("rglru_scan", "mlstm_scan", "slstm_scan")
    saved = {n: getattr(recurrent, n) for n in names}
    for n in names:
        setattr(recurrent, n, scan_fns(n)[1])
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(recurrent, n, fn)


def full_width_model(arch: str, **over):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(arch), **over)
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    return cfg, params


def lm_forward(params, cfg, toks):
    """The logits of ``lm.forward``."""
    from repro_torch.models import lm
    return lm.forward(params, cfg, toks)[0]


def long_forward(cfg, params, toks, label: str, card: str) -> tuple:
    """``lm.forward`` at the main path's length without autograd: its
    launches (counts set to 0 just before, read just after), its logits,
    then its time by CUDA events and the scans' device time by
    torch.profiler over one more forward."""
    import torch

    def fwd():
        with torch.no_grad():
            return lm_forward(params, cfg, toks)
    zero_kernel_counts()
    logits = fwd()
    torch.cuda.synchronize()
    launches = kernel_counts()
    ms = cuda_ms(fwd, reps=2, warmup=0)
    prof = profile_device(fwd)
    scans = {k: op_ms(prof, SCAN_KERNEL_NAMES[k]) for k in SCAN_KERNELS}
    idle = (1 - prof["busy_ms"] / prof["wall_ms"]) if prof["wall_ms"] \
        else None
    print(f"[scan] {label} lm.forward B={toks.shape[0]} S={toks.shape[1]} "
          f"{cfg.dtype}, no autograd: {ms!r} ms (CUDA events, mean of 2); "
          f"device busy {prof['busy_ms']!r} ms of {prof['wall_ms']!r} ms, "
          f"idle share {idle!r}; scans' device ms {scans}; launches {launches}"
          f"; card {card}")
    return logits, launches, dict(ms=ms, busy_ms=prof["busy_ms"],
                                  idle=idle, scan_device_ms=scans)


def recurrentgemma_forward(card: str, out: dict) -> None:
    """recurrentgemma_2b at full width (26 layers, bf16, unscanned): one
    forward at B=2, S=4096 through ``rglru_scan`` (18 launches) against
    the same forward through the plain loops, bitwise (the kernel equals
    its plain version bit for bit; every other op is the same)."""
    import torch
    cfg, params = full_width_model("recurrentgemma_2b", scan_layers=False)
    toks = torch.randint(0, cfg.vocab_size, (SCAN_B, SCAN_S), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(41))
    logits, launches, t = long_forward(cfg, params, toks, cfg.name, card)
    n = cfg.pattern_for_depth().count("rglru")
    expect = dict.fromkeys(launches, 0)
    expect["rglru_scan"] = n
    require(launches == expect, f"rg forward launches {launches}")
    require(logits.shape == (SCAN_B, SCAN_S, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "rg forward logits")
    with plain_scans(), torch.no_grad():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        ref = lm_forward(params, cfg, toks)
        end.record()
        end.synchronize()
    err = max_abs_err(logits, ref)
    print(f"[scan] {cfg.name} forward through the plain loops at the same "
          f"S: {start.elapsed_time(end)!r} ms (CUDA events, one run); max "
          f"|kernel - plain| over the logits {err!r} (bitwise required)")
    require(err == 0.0, f"rg forward differs from the plain loops: {err}")
    scan_device_ms(out, t["scan_device_ms"], launches)
    out["rg_forward"] = dict(t, plain_ms=start.elapsed_time(end),
                             launches=launches)
    del params, logits, ref
    torch.cuda.empty_cache()


def xlstm_forward(card: str, out: dict) -> None:
    """xlstm_1_3b at full width (48 layers, bf16): one forward at B=2,
    S=4096 without autograd, one ``mlstm_scan`` or ``slstm_scan`` launch
    per block; then the whole stack in fp32 at S=512 through the kernels
    against the plain loops, within XLSTM_FP32_PATH_RTOL of the largest
    logit."""
    import torch
    cfg, params = full_width_model("xlstm_1_3b")
    gen = torch.Generator("cuda").manual_seed(43)
    toks = torch.randint(0, cfg.vocab_size, (SCAN_B, SCAN_S), device="cuda",
                         generator=gen)
    logits, launches, t = long_forward(cfg, params, toks, cfg.name, card)
    kinds = cfg.pattern_for_depth()
    expect = dict.fromkeys(launches, 0)
    expect.update(mlstm_scan=kinds.count("mlstm"),
                  slstm_scan=kinds.count("slstm"))
    require(launches == expect, f"xlstm forward launches {launches}")
    require(logits.shape == (SCAN_B, SCAN_S, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "xlstm forward logits")
    del logits
    scan_device_ms(out, t["scan_device_ms"], launches)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    short = toks[:, :XLSTM_PLAIN_S]
    with torch.no_grad():
        ours = lm_forward(params, f32, short).float()
        with plain_scans():
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            ref = lm_forward(params, f32, short).float()
            end.record()
            end.synchronize()
        k_ms = cuda_ms(lambda: lm_forward(params, f32, short), reps=1,
                       warmup=0)
    rel = max_abs_err(ours, ref) / float(ref.abs().max())
    print(f"[scan] {cfg.name} whole stack fp32 at S={XLSTM_PLAIN_S}: "
          f"kernels {k_ms!r} ms, plain loops {start.elapsed_time(end)!r} ms "
          f"(CUDA events); max |diff| / max |logit| {rel!r} (rtol "
          f"{XLSTM_FP32_PATH_RTOL})")
    require(rel <= XLSTM_FP32_PATH_RTOL, f"xlstm kernels vs plain: {rel}")
    out["xlstm_forward"] = dict(t, launches=launches, fp32_rel=rel,
                                plain_ms_short=start.elapsed_time(end),
                                ms_short=k_ms)
    del params, ours, ref
    torch.cuda.empty_cache()


def recurrentgemma_train_child() -> int:
    """``python chip_smoke.py --recurrent-train``: full-width, full-depth
    recurrentgemma_2b as ``launch/train.py --full`` builds it
    (``dryrun_config``: bf16 compute, fp32 params, scanned, remat;
    AdamW), RG_TRAIN_STEPS Trainer steps at B=2, S=4096, in a process of
    its own (the step peaks at ~78 GB of the card's 80). Prints one JSON
    line: the launches of the steps (counts set to 0 just before), losses,
    step times, peak memory, and a profiled step's scan device times."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch.specs import dryrun_config
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.step import default_optimizer_kind
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dryrun_config(get_config("recurrentgemma_2b"))
    ocfg = OptimizerConfig(kind=default_optimizer_kind(cfg), lr=1e-3,
                           warmup_steps=10, total_steps=RG_TRAIN_STEPS)
    t = Trainer(cfg, ocfg, DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=SCAN_S, global_batch=SCAN_B),
                TrainerConfig(steps=RG_TRAIN_STEPS, ckpt_dir=None),
                device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(t.params))
    events = []
    step_fn = t._step_fn

    def timed_step(*a):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        r = step_fn(*a)
        end.record()
        events.append((start, end))
        return r
    t._step_fn = timed_step
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t.run()
    torch.cuda.synchronize()
    launches = kernel_counts()
    rec = dict(n_params=n_params, n_layers=cfg.n_layers, optimizer=ocfg.kind,
               remat=cfg.remat, scan_layers=cfg.scan_layers,
               losses=[m["loss"] for m in t.metrics_log],
               host_ms=[x * 1e3 for x in t.step_times],
               event_ms=[s.elapsed_time(e) for s, e in events],
               peak_bytes=torch.cuda.max_memory_allocated(),
               total_bytes=torch.cuda.get_device_properties(0).total_memory,
               launches=launches,
               n_rglru=cfg.pattern_for_depth().count("rglru"))
    t._step_fn = step_fn
    t.tcfg.steps += 1
    prof = profile_device(t.run)
    rec["profiled_step"] = dict(
        busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
        scan_device_ms={k: op_ms(prof, SCAN_KERNEL_NAMES[k])
                        for k in ("rglru_scan", "rglru_scan_bwd")})
    rec["finite"] = bool(np.all(np.isfinite(rec["losses"])))
    print(json.dumps(rec))
    return 0


def recurrentgemma_train(card: str, out: dict) -> None:
    """RG_TRAIN_STEPS full-width recurrentgemma_2b Trainer steps at S=4096
    through the RG-LRU kernels, in a child process (the card's memory to
    itself): each step launches the forward scan twice per RG-LRU block
    (remat recomputes it) and the backward scan once."""
    import torch
    torch.cuda.empty_cache()
    print(f"[scan] before the training child: {torch.cuda.memory_reserved()}"
          f" bytes reserved by this process")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--recurrent-train"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    require(res.returncode == 0, f"recurrentgemma training child: exit "
            f"{res.returncode}: {res.stderr[-3000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    n, steps = rec["n_rglru"], RG_TRAIN_STEPS
    expect = dict.fromkeys(rec["launches"], 0)
    expect.update(rglru_scan=steps * n * (2 if rec["remat"] else 1),
                  rglru_scan_bwd=steps * n)
    tokens = SCAN_B * SCAN_S
    print(f"[scan] recurrentgemma_2b training at full width and depth "
          f"({rec['n_layers']} layers, {rec['n_params']} params, "
          f"{rec['optimizer']}, remat={rec['remat']}, scan_layers="
          f"{rec['scan_layers']}), {steps} Trainer steps at B={SCAN_B} "
          f"S={SCAN_S}: losses {rec['losses']}; host-clock step ms "
          f"{rec['host_ms']}; CUDA-event step ms {rec['event_ms']} "
          f"({tokens / (rec['event_ms'][-1] * 1e-3)!r} tokens/s at the "
          f"last); max_memory_allocated {rec['peak_bytes']} of "
          f"{rec['total_bytes']} bytes; launches {rec['launches']}; a "
          f"profiled step: device busy {rec['profiled_step']['busy_ms']!r} "
          f"ms of {rec['profiled_step']['wall_ms']!r} ms, scans' device ms "
          f"{rec['profiled_step']['scan_device_ms']}; card {card}")
    require(rec["finite"] and len(rec["losses"]) == steps,
            f"rg training losses {rec['losses']}")
    require(rec["launches"] == expect, f"rg training launches "
            f"{rec['launches']}, expected {expect}")
    scan_device_ms(out, rec["profiled_step"]["scan_device_ms"],
                   {"rglru_scan_bwd": n})
    out["rg_train"] = rec


def recurrentgemma_grad_parity(out: dict) -> None:
    """A 2-layer (both RG-LRU) fp32 recurrentgemma_2b at full width: one
    loss + gradient on the card, through both RG-LRU kernels, against the
    CPU (the plain versions)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(
        get_config("recurrentgemma_2b"), n_layers=2, dtype=torch.float32,
        scan_layers=False, remat=False)
    params = lm.init_lm(torch.Generator().manual_seed(3), cfg)
    batch = train_batch(cfg, 2, 128, torch.Generator().manual_seed(4))
    t0 = time.perf_counter()
    lr_, gr = loss_and_grads(cfg, params, batch)
    cpu_s = time.perf_counter() - t0
    zero_kernel_counts()
    lc, gc = loss_and_grads(cfg, _tree_to(params, "cuda"),
                            _tree_to(batch, "cuda"))
    launches = kernel_counts()
    rel = abs(lc - lr_) / abs(lr_)
    cmp = compare_grads(gc, gr, TRAIN_GRAD_RTOL)
    print(f"[scan] 2-layer fp32 recurrentgemma_2b at full width (B=2 "
          f"S=128): loss cpu {lr_!r} |cuda - cpu|/cpu {rel!r}; "
          f"{cmp['leaves']} grad leaves within {cmp['grad_rel']!r} of each "
          f"leaf's max |g| (rtol {TRAIN_GRAD_RTOL}), {cmp['noise_leaves']} "
          f"noise leaves; launches {launches} ({cpu_s:.1f} s on the CPU)")
    require(rel <= TRAIN_LOSS_RTOL, f"rg 2-layer loss {lc} vs {lr_}")
    expect = dict.fromkeys(launches, 0)
    expect.update(rglru_scan=2, rglru_scan_bwd=2)
    require(launches == expect, f"rg 2-layer launches {launches}")
    out["rg_grad_launches"] = launches
    del params, gr, gc
    torch.cuda.empty_cache()


def phase_recurrent(card: str, out: dict) -> None:
    """The recurrent scans (slice F): each kernel against its plain version
    and timed; full-width recurrentgemma_2b and xlstm_1_3b forwards at
    S=4096, recurrentgemma_2b training at S=4096 and a 2-layer gradient
    against the CPU, each path with its launch counts set to 0 just
    before; then the recurrent families' dry-run cells, each a process of
    its own, all started together."""
    timed("recurrent/parity", scan_parity, out)
    timed("recurrent/timing", scan_timing, card, out)
    timed("recurrent/recurrentgemma forward", recurrentgemma_forward, card,
          out)
    timed("recurrent/recurrentgemma training", recurrentgemma_train, card,
          out)
    work = ROOT / "build" / "chip_smoke_recurrent"
    work.mkdir(parents=True, exist_ok=True)
    dry = start_dryruns(work / "dryrun", RECURRENT_DRYRUN_CELLS)
    try:
        timed("recurrent/recurrentgemma gradient", recurrentgemma_grad_parity,
              out)
        timed("recurrent/xlstm forward", xlstm_forward, card, out)
        out["dryrun_recurrent"] = timed("recurrent/dry run", finish_dryruns,
                                        dry, work / "dryrun", card, "scan")
    finally:
        for proc, _ in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    res = fn(*args)
    print(f"[phase] {label}: {time.perf_counter() - t0:.2f} s")
    return res


def main() -> int:
    if sys.argv[1:] == ["--recurrent-train"]:      # phase 13's child
        sys.path.insert(0, str(ROOT / "src"))
        return recurrentgemma_train_child()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    out: dict = {}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")

        from repro_torch.configs import get_config
        cfg = get_config("internlm2_1_8b")

        timed("build", phase_build, out)
        grid = grid_inputs("gpu-pool", cfg)
        cxl = grid_inputs("cxl-tier-3", cfg)
        cases = {"gpu-pool grid": grid, "cxl-tier-3 grid": cxl,
                 "edge-baseline C=1": edge_inputs(),
                 "synthetic C=5": synthetic_c5_inputs()}
        timed("parity", phase_parity, cases, out)
        timed("placement main path", phase_main_path, cfg, out)
        timed("placement timing", phase_timing, grid, cxl,
              cases["synthetic C=5"], out)
        scfg = serve_config()
        timed("serving internlm2_1_8b", phase_serving, scfg, out)
        timed("pim_mac", phase_pim, out)
        timed("serving timing", phase_serve_timing, scfg, out)
        for key in ("engine", "x", "placements"):
            out.pop(key)
        torch.cuda.empty_cache()
        timed("families smoke", phase_families_smoke, out)
        timed("families full width", phase_families_full, out)
        timed("fleet", phase_fleet, scfg, card, out)
        timed("training", phase_training, card, out)
        timed("sharded", phase_sharded, card, out)
        timed("recurrent scans", phase_recurrent, card, out)
    except Exception:                    # every phase failure is fatal
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    main_t = out["timings"]["gpu-pool grid"]
    # launches on each driven path, each counted from 0 just before it
    by_path = {k: {"placement main path": out["launches"].get(k, 0),
                   "fleet (internlm2_1_8b, decode)":
                       out["fleet"]["launches"][k],
                   "hierarchical fleet": out["fleet_hierarchy_launches"][k],
                   "dag fleet": out["fleet_dag_launches"][k]}
               for k in ("dp_stages", "minplus_combine")}
    by_path["pim_mac"] = {
        "internlm2_1_8b serving": out["pim_launches"],
        "recurrentgemma_2b serving": out["pim_launches_rg"],
        "fleet (internlm2_1_8b, decode)": out["fleet"]["launches"]["pim_mac"]}
    by_path.update({k: {} for k in SCAN_KERNELS})
    for k in by_path:
        by_path[k]["train"] = out["train_launches"][k]
        by_path[k]["sharded"] = out["sharded_launches"][k]
        by_path[k]["recurrentgemma_2b forward (S=4096)"] = \
            out["rg_forward"]["launches"][k]
        by_path[k]["recurrentgemma_2b training (S=4096)"] = \
            out["rg_train"]["launches"][k]
        by_path[k]["recurrentgemma_2b 2-layer gradient"] = \
            out["rg_grad_launches"][k]
        by_path[k]["xlstm_1_3b forward (S=4096)"] = \
            out["xlstm_forward"]["launches"][k]
    scans = {
        "rglru_scan": ("rglru_scan.cu", "src/repro/models/recurrent.py:116 "
                       "(jax.lax.associative_scan in rglru_block; no Pallas "
                       "kernel)"),
        "rglru_scan_bwd": ("rglru_scan.cu", "src/repro/models/recurrent.py"
                           ":116 (the associative scan's transpose under "
                           "jax.grad; no Pallas kernel)"),
        "mlstm_scan": ("mlstm_scan.cu", "src/repro/models/recurrent.py:209 "
                       "(lax.scan of _mlstm_step in chunked_scan; no Pallas "
                       "kernel)"),
        "slstm_scan": ("slstm_scan.cu", "src/repro/models/recurrent.py:282 "
                       "(lax.scan of _slstm_step in chunked_scan; no Pallas "
                       "kernel)")}
    kernels = [
        dict(name="dp_stages", route="cuda",
             source="src/repro_torch/csrc/dp_stages.cu",
             replaces="src/repro/kernels/knapsack_dp/kernel.py:34 "
                      "(_dp_kernel); src/repro/kernels/lut_pipeline/"
                      "kernel.py:69 (_fused_kernel, stage part)",
             launches=sum(by_path["dp_stages"].values()),
             launches_by_path=by_path["dp_stages"],
             max_abs_err=out["max_abs_err"]["dp_stages"],
             library_ms=None, **main_t["dp_stages"]),
        dict(name="minplus_combine", route="cuda",
             source="src/repro_torch/csrc/minplus_combine.cu",
             replaces="src/repro/kernels/lut_pipeline/kernel.py:69 "
                      "(_fused_kernel, fold/combine/backtrace part)",
             launches=sum(by_path["minplus_combine"].values()),
             launches_by_path=by_path["minplus_combine"],
             max_abs_err=out["max_abs_err"]["minplus_combine"],
             library_ms=None, **main_t["minplus_combine"]),
        dict(name="pim_mac", route="cuda",
             source="src/repro_torch/csrc/pim_mac.cu",
             replaces="src/repro/kernels/pim_mac/kernel.py:25 "
                      "(_pim_mac_kernel)",
             launches=sum(by_path["pim_mac"].values()),
             launches_by_path=by_path["pim_mac"],
             max_abs_err=out["max_abs_err"]["pim_mac"],
             at_recurrentgemma_shape=out["pim_time_rg"],
             **out["pim_time"]),
    ] + [dict(name=k, route="cuda", source=f"src/repro_torch/csrc/{src}",
              replaces=rep, launches=sum(by_path[k].values()),
              launches_by_path=by_path[k],
              max_abs_err=out["scan_max_abs_err"][k], library_ms=None,
              **out["scan_time"][k])
         for k, (src, rep) in scans.items()]
    print(f"[done] {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
