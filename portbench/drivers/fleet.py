"""The serving fleet: ``api.fleet(..., decode=True)`` driven slice by
slice by ``Fleet.run`` in a closed loop.

Set-up makes the weights on the card from the seed, brings the fleet up
(every worker's placement LUTs and DVFS grid) and runs ``warm_slices``
slices. The window then runs the mix's slices: a slice is timed from the
end of the previous one to its own end, which follows a
``torch.cuda.synchronize()`` in ``Fleet.run``'s per-slice callback; the
window closes at the first slice that ends ``--seconds`` after it
opened. Untraced, torch.profiler records the card's activity over the
whole window, for the card's busy time. Each engine's ``decode`` and ``apply_placement`` are wrapped to
record the tokens every decode step produced (all rows of the engine's
batch) and a sample of the segments the migrations produced; traced,
the wrappers also synchronize at both edges and time the call.

Afterwards the program is freed and ``correct`` decided:

- ``decode_gap``: the reference computes the logits of every position of
  each engine's token history (the engine starts from token 0 at
  position 0 and feeds each step's argmax back); for every token the
  fleet served, the gap by which the reference's logit of that token lies
  below the reference's best; the widest gap.
- ``segment_mismatch``: for every sampled migration and each engine's
  last one, the elements of the int8 values, scales and bf16 columns
  that differ from the reference's split of the same weight under the
  placement the scheduler chose.
- ``lut_mismatch``: the entries of every engine's DVFS grid of LUTs, as
  the fleet's bring-up built them on the card, that differ by a bit from
  the reference's (``portbench.reference.placement``) for that engine's
  shape and the fleet's slice, plus a clock grid that differs.
- ``slice_choice_mismatch``: the slices, warm-up and window, of every
  engine whose clock, placement or number of tasks run differs from the
  reference's choice (``placement.choose``) on the reference's LUTs for
  the tasks the router planned. The reference starts from the placement
  the engine held at bring-up and carries its own choices on.

With ``--control 1`` the fp8 control's ``decode_gap`` is also judged by
the same limit, so such a run comes out not correct.
"""
from __future__ import annotations

import gc
import time
from contextlib import nullcontext

import numpy as np

from portbench.drivers import (Window, lut_entries, lut_mismatch,
                               program_config, sync)


class _WindowClosed(Exception):
    pass


class _Engines:
    """Wrappers around each engine's ``decode`` and ``apply_placement``."""

    def __init__(self, run, fleet, rng):
        self.run = run
        self.rng = rng
        self.history = {}        # wid -> [(pos, tokens of every row, n)]
        self.snapshots = []      # (placement, (layer, matrix), segments)
        self.migrations = 0
        self.migration_s = 0.0   # traced: this slice's synchronized time
        self.rows_decoded = 0
        self.tracing = False
        # wid -> (placement at bring-up, [(tasks, planned, clock,
        # placement, tasks run)] of every slice)
        self.slices = {}
        for w in fleet.workers:
            self._wrap(w.wid, w.hetero)
            self._wrap_scheduler(w.wid, w.sched)

    def _wrap_scheduler(self, wid, sched):
        step0 = sched.step
        log = []
        self.slices[wid] = (dict(sched.placement), log)

        def step(n_tasks, *, lookup_tasks=None, cap_to_capacity=False):
            rep = step0(n_tasks, lookup_tasks=lookup_tasks,
                        cap_to_capacity=cap_to_capacity)
            log.append((n_tasks, lookup_tasks, rep.clock,
                        dict(rep.placement), rep.n_executed))
            return rep

        sched.step = step

    def _timed(self, name):
        if not self.tracing:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _wrap(self, wid, eng):
        apply0, decode0 = eng.apply_placement, eng.decode
        hist = self.history.setdefault(wid, [])
        run = self.run

        def apply_placement(placement):
            t0 = self._edge()
            with self._timed("pb.migration"):
                moved = apply0(placement)
            if self.tracing:
                self.migration_s += self._edge() - t0
            if moved:
                self.migrations += 1
                self._maybe_snapshot(eng)
            return moved

        def decode(n):
            pos = eng._pos
            t0 = self._edge()
            with self._timed("pb.decode"):
                toks = decode0(n)
            if self.tracing:
                run.span("decode", self._edge() - t0)
            rows = min(n, eng.max_batch)
            hist.append((pos, eng._toks.clone(), rows))
            self.rows_decoded += rows
            return toks

        eng.apply_placement = apply_placement
        eng.decode = decode

    def _edge(self) -> float:
        if self.tracing:
            sync(self.run.device)
        return time.perf_counter()

    def _maybe_snapshot(self, eng) -> None:
        limit = self.run.traffic["check_migrations"]
        if len(self.snapshots) >= limit or not eng._tiered or \
                self.rng.random() >= 0.5:
            return
        keys = sorted(eng._tiered)
        key = keys[self.rng.integers(len(keys))]
        segs = {t: {k: v.clone() for k, v in s.items() if k != "empty"}
                for t, s in eng._tiered[key].items()}
        self.snapshots.append((dict(eng._tiered_placement), key, segs))


def run(run) -> None:
    import torch

    from repro_torch import api, obs
    from repro_torch.fleet.traces import Trace
    from repro_torch.kernels.pim_mac.ops import pim_matmul

    from portbench import bench, generate, weights

    c, tr = run.config, run.traffic
    cfg = program_config(c)
    params = weights.make(c, run.seed, run.device)
    fleet = api.fleet(tr["substrate"], cfg, params=params, decode=True,
                      solver=tr["solver"], dvfs=tr["dvfs"],
                      forecaster=tr["forecaster"],
                      n_engines=tr["n_engines"], max_batch=tr["max_batch"],
                      device=run.device)
    engines = _Engines(run, fleet, np.random.default_rng(run.seed))
    luts = {w.wid: [(clock, lut_entries(w.sched.dvfs.lut_for(clock)))
                    for clock in w.sched.dvfs.clocks]
            for w in fleet.workers}
    warm = tr["warm_slices"]
    # enough slices for any window: a slice takes far more than 1 ms
    arr = generate.arrivals(tr["arrivals"],
                            warm + int(run.seconds * 1000) + 16)
    fleet.run(Trace("warm", arr[:warm]), max_drain_slices=0)

    win = Window(run)
    state = {"completed": 0, "slices": 0, "prof": None, "rf": None}
    if run.trace:
        obs.reset()
        obs.enable()
        engines.tracing = True
        state["prof"] = bench.Profiled()

    def open_slice():
        if state["prof"] is not None:
            from torch.profiler import record_function
            state["rf"] = record_function("pb.slice")
            state["rf"].__enter__()

    def close_slice():
        if state["rf"] is not None:
            state["rf"].__exit__(None, None, None)
            state["rf"] = None

    def on_slice(s, n_arr, done, workers):
        state["completed"] += len(done)
        state["slices"] += 1
        close_slice()
        if run.trace:
            run.span("migration_slice", engines.migration_s)
            engines.migration_s = 0.0
            if state["prof"] is not None and \
                    state["slices"] == tr["trace_slices"]:
                state["rows"] = engines.rows_decoded - state["rows0"]
                run.device_trace = state["prof"].stop()
                state["prof"] = None
        if win.unit_done():
            raise _WindowClosed
        open_slice()

    # untraced, the card's activity over the whole window, for its busy
    # time (``device_ms_per_req``); started before the window opens
    whole = (bench.Profiled(host=False)
             if not run.trace and run.device == "cuda" else None)
    if whole is not None:
        whole.start()
    pim0 = pim_matmul.launches
    win.open()
    if state["prof"] is not None:
        state["rows0"] = engines.rows_decoded
        state["prof"].start()
    open_slice()
    try:
        fleet.run(Trace("window", arr[warm:]), max_drain_slices=0,
                  verbose_cb=on_slice)
    except _WindowClosed:
        pass
    else:
        raise RuntimeError("the arrivals ended before the window closed")
    close_slice()
    run.memory_peak = (torch.cuda.max_memory_allocated()
                       if run.device == "cuda" else 0)
    if whole is not None:
        t0 = time.perf_counter()
        tr = whole.stop()
        run.counts["window_busy_s"] = tr["busy_s"]
        run.counts["window_device_events"] = tr["device_events"]
        run.counts["window_trace_read_s"] = time.perf_counter() - t0
        del whole, tr
    run.counts["completed"] = state["completed"]
    run.counts["slices"] = state["slices"]
    run.counts["migrations"] = engines.migrations
    run.counts["pim_mac_launches"] = pim_matmul.launches - pim0
    run.counts["matmul_params"] = weights.n_matmul_params(c)
    run.attempted = state["completed"]
    if run.trace:
        run.counts["sched_s"] = sum(
            ev["dur"] for ev in obs.tracer().events()
            if ev["name"] == "sched.slice") / 1e6
        run.counts["traced_rows"] = state.get("rows", 0)
        obs.disable()
        obs.reset()

    # what is judged, then the program is freed before the reference
    history = {w: ([p for p, _, _ in h], torch.stack([t for _, t, _ in h])
                   .cpu() if h else None, [n for _, _, n in h])
               for w, h in engines.history.items()}
    finals = [(dict(w.hetero._tiered_placement), key,
               {t: {k: v for k, v in s.items() if k != "empty"}
                for t, s in segs.items()})
              for w in fleet.workers if w.hetero._tiered
              for key, segs in w.hetero._tiered.items()]
    snapshots = engines.snapshots + finals
    plan = {wid: (start, luts[wid], log)
            for wid, (start, log) in engines.slices.items()}
    del fleet, engines, params, finals
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    judge(run, history, snapshots, plan)


def _maximal(histories):
    """The histories no other one extends, and for each history the
    index of a maximal one that has it as its prefix."""
    order = sorted(range(len(histories)), key=lambda i: -len(histories[i]))
    keep, owner = [], {}
    for i in order:
        h = histories[i]
        for j in keep:
            if histories[j][:len(h)] == h:
                owner[i] = j
                break
        else:
            keep.append(i)
            owner[i] = i
    return keep, owner


def judge_placement(run, plan) -> None:
    """Every engine's LUTs and every slice's choice against the
    reference's."""
    from portbench.reference import placement as ref

    c, tr = run.config, run.traffic
    sub = tr["substrate_params"]
    n = tr["n_engines"]
    t_slice = min(ref.default_t_slice_ns(c, ref.shape(sub, i, tr["mixed"]))
                  for i in range(n))
    grids = {}
    lut_bad = choice_bad = slices = 0
    for wid, (start, luts, log) in sorted(plan.items()):
        sw = ref.shape(sub, wid, tr["mixed"])
        key = (sw["n_hp_clusters"], sw["n_lp_clusters"])
        if key not in grids:
            grids[key] = ref.grid(c, sw, t_slice)
        points = grids[key]
        got = dict(luts)
        if [clock for clock, _ in luts] != [p[0] for p in points]:
            lut_bad += 1
        for clock, _, want in points:
            lut_bad += lut_mismatch(got.get(clock, []), want)
        prev = start
        for n_tasks, planned, clock, placement, n_run in log:
            want = ref.choose(points, t_slice, n_tasks, planned, prev)
            choice_bad += (clock, placement, n_run) != want
            prev = want[1]
            slices += 1
    run.counts["engine_slices_checked"] = slices
    run.check("lut_mismatch", lut_bad, run.cell.limits["lut_mismatch"])
    run.check("slice_choice_mismatch", choice_bad,
              run.cell.limits["slice_choice_mismatch"])


def judge(run, history, snapshots, plan) -> None:
    import torch

    from portbench import weights
    from portbench.reference import common, dense, quant

    common.exact()
    c, tr = run.config, run.traffic
    judge_placement(run, plan)
    params = weights.make(c, run.seed, run.device)
    # every row's inputs: token 0, then what the row decoded; the tokens
    # it served at each step are judged
    seqs, served = [], []
    for w in sorted(history):
        pos, toks, ns = history[w]
        if toks is None:
            continue
        if pos != list(range(len(pos))):
            raise RuntimeError(f"engine {w} decoded positions {pos[:8]}...")
        for r in range(toks.shape[1]):
            steps = [j for j, n in enumerate(ns) if r < n]
            if not steps:
                continue
            out = toks[:steps[-1] + 1, r].tolist()
            seqs.append(tuple([0] + out[:-1]))
            served.append((len(seqs) - 1, steps, out))
    gap = ctl = 0.0
    n_served = 0
    if seqs:
        keep, owner = _maximal(seqs)
        L = max(len(seqs[i]) for i in keep)
        window = tr.get("kv_ring", 0)
        mms = [common.Matmul()]
        if run.control:
            mms.append(common.Matmul(fp8=True))
        for idx in range(0, len(keep), 4):
            batch = keep[idx:idx + 4]
            toks = torch.zeros((len(batch), L), dtype=torch.long,
                               device=run.device)
            for b, i in enumerate(batch):
                toks[b, :len(seqs[i])] = torch.tensor(seqs[i])
            with torch.no_grad():
                ref = dense.logits(params, c, toks, window, mms[0])
                low = (dense.logits(params, c, toks, window, mms[1])
                       if run.control else None)
            best = ref.max(-1).values
            for si, steps, out in served:
                if owner[si] not in batch:
                    continue
                b = batch.index(owner[si])
                st = torch.tensor(steps, device=run.device)
                tk = torch.tensor([out[j] for j in steps], device=run.device)
                g = best[b, st] - ref[b, st, tk]
                gap = max(gap, float(g.max()))
                n_served += len(steps)
                if low is not None:
                    lt = low[b, st].argmax(-1)
                    ctl = max(ctl, float((best[b, st] - ref[b, st, lt]).max()))
            del ref, low
    run.counts["served_checked"] = n_served
    run.check("decode_gap", gap, run.cell.limits["decode_gap"])
    if run.control:
        run.readings["decode_gap_fp8"] = ctl
        run.check("decode_gap.fp8_control", ctl, run.cell.limits["decode_gap"])
    bad = 0
    K = quant.model_spec_params(c)
    plan = [tuple(x) for x in tr["tier_plan"]]
    for placement, (lname, wname), segs in snapshots:
        w = params["stack"][lname]["ffn"][wname]
        bad += quant.mismatches(w, placement, K, plan, segs)
    run.counts["segments_checked"] = len(snapshots)
    run.check("segment_mismatch", bad, run.cell.limits["segment_mismatch"])
