#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an
H100; the kernels are built for sm_90a). Phases:

  1. print the card's name and power limit; build both CUDA kernels from
     ``src/repro_torch/csrc`` (nvcc, one process per source, in
     parallel), printing ``-Xptxas -v`` and the build times;
  2. hold each kernel bitwise (``torch.equal``) against its plain
     PyTorch version on the same inputs, at the main path's shapes: the
     gpu-pool DVFS clock grid of internlm2_1_8b (V=6, C=2, n=2,
     T=14376, K=256, R=33), the cxl-tier-3 grid (C=3), an edge C=1
     build, a synthetic C=5 build with inert padding, and
     ``knapsack_dp`` at gpu-pool's T=14376, K=256, t=[18, 18];
  3. drive the main path with every launch count set to 0: all 18
     golden LUT digests built with ``device="cuda"``, the per-point
     ``batched=False`` anchor against the fused build, then
     ``api.scheduler(..., solver="dp", dvfs=True, device="cuda")`` on
     gpu-pool and cxl-tier-3 through the six load scenarios (10 slices
     each), held equal to the same run with ``device="cpu"``; the counts
     are read right after and every kernel must have launched;
  4. time each kernel and its plain version with CUDA events at the
     gpu-pool grid shape, beside the bound (bytes written once over
     3.35 TB/s, or operations over 67 TFLOP/s fp32, the larger), and
     split one ``build_lut_grid`` into kernel, D2H copy and host
     finalize; torch.profiler adds the kernels' device-only times and
     the device's idle share over one ``build_lut_grid``;
  5. print the ``{"kernels": [...]}`` line and, last, the
     ``{"ok": true, "device": {...}}`` line.

Any failure exits non-zero without the last line, as does a machine
without a CUDA card or a directory without the repository's ``src/``.
The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
# and fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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


def print_profile(label: str, prof: dict, kernels) -> None:
    if not prof["by_name"]:
        print(f"[profile] {label}: not measured (no CUDA activity traced)")
        return
    parts = []
    for k in kernels:
        ms = sum(v for n, v in prof["by_name"].items() if k in n)
        parts.append(f"{k}_ms={ms!r}")
    copy_ms = sum(v for n, v in prof["by_name"].items() if "Memcpy" in n)
    print(f"[profile] {label}: {' '.join(parts)} memcpy_ms={copy_ms!r} "
          f"device_busy_ms={prof['busy_ms']!r} wall_ms={prof['wall_ms']!r} "
          f"idle_share={1 - prof['busy_ms'] / prof['wall_ms']!r}")


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
            if "ptxas" in line or "error" in line.lower():
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
    out["max_abs_err"] = errs


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


def phase_timing(grid: dict, cxl: dict, out: dict) -> None:
    import torch

    from repro_torch import obs
    from repro_torch.core.multipool import combine_rows_torch
    from repro_torch.core.placement import build_lut_grid
    from repro_torch.kernels.knapsack_dp.ops import dp_stages, knapsack_dp
    from repro_torch.kernels.knapsack_dp.ref import (dp_stages_ref,
                                                     gather_rows)
    from repro_torch.kernels.lut_pipeline.ops import minplus_combine

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
    print(f"[time] knapsack_dp dp_stages: ms={k_ms!r} "
          f"plain_ms={k_plain_ms!r} bound_ms={k_bound!r} ({k_by}) shape "
          f"V=1 C=1 n=2 T={T} K={K} t={t_l}")

    timings = {}
    for label, c in (("gpu-pool grid", grid), ("cxl-tier-3 grid", cxl)):
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
        print_profile(f"{label} lut_build", profile_device(
            lambda: minplus_combine(dp_stages(t, e, T, K, rows)[1])),
            ("dp_stages_kernel", "minplus_combine_kernel"))
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
        ("dp_stages_kernel", "minplus_combine_kernel"))
    out["timings"] = timings
    out["lut_grid_ms"] = dict(total=total_ms, **spans)


def main() -> int:
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

        phase_build(out)
        grid = grid_inputs("gpu-pool", cfg)
        cxl = grid_inputs("cxl-tier-3", cfg)
        cases = {"gpu-pool grid": grid, "cxl-tier-3 grid": cxl,
                 "edge-baseline C=1": edge_inputs(),
                 "synthetic C=5": synthetic_c5_inputs()}
        phase_parity(cases, out)
        phase_main_path(cfg, out)
        phase_timing(grid, cxl, out)
    except Exception:                    # every phase failure is fatal
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    main_t = out["timings"]["gpu-pool grid"]
    kernels = [
        dict(name="dp_stages", route="cuda",
             source="src/repro_torch/csrc/dp_stages.cu",
             replaces="src/repro/kernels/knapsack_dp/kernel.py:34 "
                      "(_dp_kernel); src/repro/kernels/lut_pipeline/"
                      "kernel.py:69 (_fused_kernel, stage part)",
             launches=out["launches"]["dp_stages"],
             max_abs_err=out["max_abs_err"]["dp_stages"],
             library_ms=None, **main_t["dp_stages"]),
        dict(name="minplus_combine", route="cuda",
             source="src/repro_torch/csrc/minplus_combine.cu",
             replaces="src/repro/kernels/lut_pipeline/kernel.py:69 "
                      "(_fused_kernel, fold/combine/backtrace part)",
             launches=out["launches"]["minplus_combine"],
             max_abs_err=out["max_abs_err"]["minplus_combine"],
             library_ms=None, **main_t["minplus_combine"]),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
