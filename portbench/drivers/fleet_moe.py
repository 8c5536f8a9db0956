"""The serving fleet on an MLA + DeepSeekMoE model (one card's share of
the routed experts): ``api.fleet(..., decode=True)`` driven slice by
slice by ``Fleet.run`` in a closed loop, as ``drivers/fleet.py`` drives
the dense model, with these differences:

- the weights are ``portbench.weights_moe``'s and the program's config
  is the registry's entry with the file's sizes and held experts;
- each engine's batch rows start from tokens drawn from the run's seed
  (``HeteroServeEngine.start_tokens``), so the rows route to different
  experts;
- the logits of the first ``check_logit_rows`` rows at
  ``check_logit_ids`` vocabulary ids drawn from the seed are kept on the
  card at every decode step (one gather a step), for ``logit_err``;
- at every ``check_expert_stride``-th MoE layer the program runs, that
  layer's input and output of the same rows are kept on the card, for
  ``expert_err``;
- the window closes at the first end of a period of the mix after
  ``--seconds`` (``_unit_done``);
- traced, the rows decoded for requests and the weights a row uses,
  the held experts' routed share at its expected size (``traced_rows``,
  ``matmul_params``, which ``fleet.decode_mfu`` reads as on the dense
  cells), the held experts' token-choices that the program counts on
  the card (``moe.expert_tokens``), read as the trace stops, and, after
  the window, the card time launched inside the program's
  ``moe.experts`` and ``attn.mla`` spans, by ``portbench.attribution``'s
  join over the traced stretch.

``correct`` is decided as in ``drivers/fleet.py``: ``decode_gap``
against ``reference/mla_moe.py`` (every row's history from its own first
token); ``logit_err``, the largest gap between the program's kept
logits and the reference's at a step the row served, over the rms of
the reference's logits at that step (a fault that flips no token, such
as an expert left out of a sum, moves the logits); ``expert_err``, the
largest gap between a kept MoE layer output and the reference layer's
on the same input, over the rms of the reference's (at the cell's
size the logits of a run with a held expert left out read within 1.9x
of a correct run's, the layer's far apart); ``segment_mismatch``
on the sampled migrations and, of each engine's last placement, the
dense layer's and the shared experts' matrices and
``check_final_experts`` expert matrices drawn from the seed; and
``lut_mismatch``/``slice_choice_mismatch`` with the MoE model spec
(``mla_moe.placement_model``). With ``--control 1`` the fp8
control's ``decode_gap``, ``logit_err`` and ``expert_err`` are judged
by the same limits, on the program's rows, steps, ids and layer inputs.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from portbench import bench
from portbench.drivers import Window, lut_entries, sync
from portbench.drivers.fleet import (_Engines, _maximal, _WindowClosed,
                                     judge_placement)


def program_config(c: dict):
    """The program's ModelConfig of configuration file ``c``. Raises on a
    published setting the program does not implement."""
    import torch

    from repro_torch.configs import get_config
    fixed = {"rope_theta": 10000, "scoring_func": "softmax",
             "topk_method": "greedy", "q_lora_rank": None, "n_group": 1,
             "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
             "attention_bias": False, "norm_topk_prob": False,
             "routed_scaling_factor": 1}
    bad = {k: c[k] for k, v in fixed.items() if c[k] != v}
    if bad:
        raise ValueError(f"the program does not implement {bad}")
    rs = c["rope_scaling"]
    return dataclasses.replace(
        get_config(c["registry"]),
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], norm_eps=c["rms_norm_eps"],
        n_experts=c["n_routed_experts"],
        experts_per_token=c["num_experts_per_tok"],
        moe_d_ff=c["moe_intermediate_size"],
        moe_shared_ff=c["n_shared_experts"] * c["moe_intermediate_size"],
        moe_held=(c["deployment"]["held_first"], c["n_experts"]),
        first_dense_layers=c["first_k_dense_replace"],
        kv_lora_rank=c["kv_lora_rank"], qk_nope_dim=c["qk_nope_head_dim"],
        qk_rope_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        yarn_factor=float(rs["factor"]), yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]),
        yarn_original_len=rs["original_max_position_embeddings"],
        yarn_mscale=rs["mscale"], yarn_mscale_all_dim=rs["mscale_all_dim"],
        tie_embeddings=c["tie_word_embeddings"],
        scan_layers=c["scan_layers"],
        dtype=getattr(torch, c["compute_dtype"]))


class _Logits:
    """Wraps ``lm.decode_step`` while the fleet runs: every step's
    logits of the first rows at the sampled ids, kept on the card in the
    order the engines decode (the wrapped engine ``decode`` records the
    engine and position of each)."""

    def __init__(self, lm, rows: int, ids):
        self.lm, self.step0 = lm, lm.decode_step
        self.rows, self.ids = rows, ids
        self.kept = []

    def __enter__(self):
        def step(*a, **k):
            logits, state = self.step0(*a, **k)
            self.kept.append(logits[:self.rows, self.ids].float())
            return logits, state
        self.lm.decode_step = step
        return self

    def __exit__(self, *exc):
        self.lm.decode_step = self.step0


class _Experts:
    """Wraps ``moe.moe_held`` while the fleet runs: at every
    ``stride``-th call, the layer's name and its input and output of the
    first rows, kept on the card in fp32."""

    def __init__(self, moe, params, rows: int, stride: int):
        self.moe, self.held0 = moe, moe.moe_held
        self.names = {layer["ffn"]["router"].data_ptr(): lname
                      for lname, layer in params["stack"].items()
                      if "router" in layer.get("ffn", {})}
        self.rows, self.stride = rows, stride
        self.calls = 0
        self.kept = []

    def __enter__(self):
        import torch

        def held(p, x, cfg):
            y = self.held0(p, x, cfg)
            if self.calls % self.stride == 0:
                self.kept.append((
                    self.names[p["router"].data_ptr()],
                    x[:self.rows].to(torch.float32, copy=True),
                    y[:self.rows].to(torch.float32, copy=True)))
            self.calls += 1
            return y
        self.moe.moe_held = held
        return self

    def __exit__(self, *exc):
        self.moe.moe_held = self.held0


class _Profiled(bench.Profiled):
    """A host-and-device profile that keeps its events for the join."""

    def stop(self) -> dict:
        out = super().stop()
        self.events = self._prof.profiler.kineto_results.events()
        return out


def _traced_layers(run, events, anchor, n_rows) -> None:
    """The join's card time of the traced stretch by the program's MLA
    and MoE spans, and the decode steps in it (after the window: the
    join takes seconds)."""
    from repro_torch import obs

    from portbench import attribution
    j = attribution.join(attribution.device_intervals(events),
                         obs.tracer().events(), anchor)
    run.counts["traced_decodes"] = j["spans"].get("engine.decode", 0)
    run.counts["traced_batch_rows"] = run.counts["traced_decodes"] * n_rows
    for span, key in (("moe.experts", "expert_busy_s"),
                      ("attn.mla", "mla_busy_s")):
        if span in j["spans"]:
            run.counts[key] = j["busy_by_span"].get(span, 0) / 1e9


def run(run) -> None:
    import torch

    from repro_torch import api
    from repro_torch.models import lm, moe

    from portbench import generate, weights_moe

    c, tr = run.config, run.traffic
    cfg = program_config(c)
    params = weights_moe.make(c, run.seed, run.device)
    fleet = api.fleet(tr["substrate"], cfg, params=params, decode=True,
                      solver=tr["solver"], dvfs=tr["dvfs"],
                      forecaster=tr["forecaster"],
                      n_engines=tr["n_engines"], max_batch=tr["max_batch"],
                      device=run.device)
    rng = np.random.default_rng(run.seed)
    firsts = {w.wid: rng.integers(c["vocab_size"], size=tr["max_batch"])
              for w in fleet.workers}
    order = []               # (engine, position) of every decode step
    _start(fleet, firsts, order)
    engines = _Engines(run, fleet, rng)
    ids = torch.as_tensor(np.sort(rng.choice(
        c["vocab_size"], min(tr["check_logit_ids"], c["vocab_size"]),
        replace=False)), device=run.device)
    kept = _Logits(lm, tr["check_logit_rows"], ids)
    layers = _Experts(moe, params, tr["check_logit_rows"],
                      tr["check_expert_stride"])
    luts = {w.wid: [(clock, lut_entries(w.sched.dvfs.lut_for(clock)))
                    for clock in w.sched.dvfs.clocks]
            for w in fleet.workers}
    warm = tr["warm_slices"]
    # enough slices for any window: a slice takes far more than 1 ms,
    # and the window runs on to the end of a period
    arr = generate.arrivals(tr["arrivals"],
                            warm + int(run.seconds * 1000) + 16
                            + tr["arrivals"]["period_slices"])
    with kept, layers:
        _serve(run, fleet, engines, arr)
    history = {w: ([p for p, _, _ in h], torch.stack([t for _, t, _ in h])
                   .cpu() if h else None, [n for _, _, n in h])
               for w, h in engines.history.items()}
    snapshots = engines.snapshots + _finals(fleet, tr, rng)
    plan = {wid: (start, luts[wid], log)
            for wid, (start, log) in engines.slices.items()}
    logits = dict(zip(order, kept.kept))   # (engine, position) -> logits
    experts = layers.kept
    del fleet, engines, params, kept, layers
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    judge(run, history, firsts, snapshots, plan, (ids, logits), experts)


def _serve(run, fleet, engines, arr) -> None:
    """Warm-up, then the window; the run's counts."""
    import torch

    from repro_torch import obs
    from repro_torch.fleet.traces import Trace

    from portbench import weights_moe

    c, tr = run.config, run.traffic
    warm = tr["warm_slices"]
    fleet.run(Trace("warm", arr[:warm]), max_drain_slices=0)

    win = Window(run)
    period = tr["arrivals"]["period_slices"]
    state = {"completed": 0, "slices": 0, "prof": None, "rf": None}
    if run.trace:
        obs.reset()
        obs.enable()
        engines.tracing = True
        state["prof"] = _Profiled()

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
                prof, state["prof"] = state["prof"], None
                t0 = time.perf_counter()
                run.device_trace = prof.stop()
                state["events"] = prof.events
                # the held experts' token-choices of the traced stretch
                tokens = obs.read_device_counts().get("moe.expert_tokens")
                if tokens is not None:
                    run.counts["traced_expert_tokens"] = sum(tokens)
                del prof
                # reading the profile (seconds, for the MoE step's many
                # host and device events) is left out of the window and
                # of every slice
                dt = time.perf_counter() - t0
                win.t0 += dt
                win.last += dt
        if _unit_done(win, (warm + state["slices"]) % period == 0):
            raise _WindowClosed
        open_slice()

    whole = (bench.Profiled(host=False)
             if not run.trace and run.device == "cuda" else None)
    if whole is not None:
        whole.start()
    win.open()
    if state["prof"] is not None:
        state["rows0"] = engines.rows_decoded
        state["prof"].start()
        state["anchor"] = obs.clock_anchor()
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
        busy = whole.stop()
        run.counts["window_busy_s"] = busy["busy_s"]
        run.counts["window_device_events"] = busy["device_events"]
        run.counts["window_trace_read_s"] = time.perf_counter() - t0
        del whole, busy
    run.counts["completed"] = state["completed"]
    run.counts["slices"] = state["slices"]
    run.counts["migrations"] = engines.migrations
    run.counts["row_params"] = weights_moe.row_params(c)
    run.counts["expert_params"] = weights_moe.expert_params(c)
    run.counts["matmul_params"] = weights_moe.matmul_params(c)
    run.attempted = state["completed"]
    if run.trace:
        run.counts["traced_rows"] = state.get("rows", 0)
        run.counts["sched_s"] = sum(
            ev["dur"] for ev in obs.tracer().events()
            if ev["name"] == "sched.slice") / 1e6
        if "events" in state:
            _traced_layers(run, state.pop("events"), state["anchor"],
                           tr["max_batch"])
        obs.disable()
        obs.reset()


def _unit_done(win, at_period_end: bool) -> bool:
    """``Window.unit_done``, but the window closes only where a period of
    the mix ends: it holds whole periods, at least ``--seconds`` long.
    The card's time a request follows the period's phase (a burst's
    requests complete at a lower cost each), so a window that ended
    anywhere in a period would read differently as the host's pace
    moved its end."""
    run = win.run
    sync(run.device)
    t = time.perf_counter()
    run.units.append(t - win.last)
    win.last = t
    if at_period_end and t - win.t0 >= run.seconds:
        run.window_s = t - win.t0
        gc.unfreeze()
        return True
    return False


def _start(fleet, firsts, order) -> None:
    """Each engine's first tokens; then (engine, position) of each of its
    decode steps is recorded in ``order`` as it starts, beneath the
    benchmark's other wrapper. (A helper, so that no name of the caller
    keeps an engine, and with it the weights, past the run.)"""
    for w in fleet.workers:
        eng = w.hetero
        eng.start_tokens(firsts[w.wid])

        def decode(n, wid=w.wid, eng=eng, decode0=eng._decode_tokens):
            order.append((wid, eng._pos))
            return decode0(n)
        eng._decode_tokens = decode


def _finals(fleet, tr, rng) -> list:
    """Of each engine's last placement: the matrices outside the routed
    experts and ``check_final_experts`` expert matrices drawn from
    ``rng``."""
    out = []
    for w in fleet.workers:
        tiered = w.hetero._tiered
        if not tiered:
            continue
        keys = sorted(tiered, key=str)
        experts = [k for k in keys if isinstance(k[-1], int)]
        pick = [k for k in keys if not isinstance(k[-1], int)]
        n = min(tr["check_final_experts"], len(experts))
        pick += [experts[i] for i in rng.choice(len(experts), n,
                                                replace=False)]
        placement = dict(w.hetero._tiered_placement)
        for key in pick:
            # copies: a view would hold the whole stacked kernel output
            out.append((placement, key, {
                t: {k: v.clone() for k, v in s.items() if k != "empty"}
                for t, s in tiered[key].items()}))
    return out


def _matrix(params: dict, key: tuple):
    """The fp32 matrix of a tiered key: (layer, name), (layer, name,
    expert) or (layer, "shared", name)."""
    node = params["stack"][key[0]]["ffn"]
    for k in key[1:]:
        node = node[k]
    return node


def _expert_err(params, c, experts, mm) -> float:
    """The largest gap between a kept MoE layer output (with ``mm``, the
    reference layer's by that product in its place) and the float32
    reference layer's on the same input, over the rms of the latter."""
    import torch

    from portbench.reference import common, mla_moe
    err = 0.0
    for name, x, y in experts:
        p = params["stack"][name]["ffn"]
        with torch.no_grad():
            ref = mla_moe.moe(p, x, c, common.Matmul())
            if mm is not None:
                y = mla_moe.moe(p, x, c, mm)
        rms = ref.square().mean(-1).sqrt()
        err = max(err, float(((y - ref).abs().max(-1).values / rms).max()))
    return err


def judge(run, history, firsts, snapshots, plan, kept, experts) -> None:
    import torch

    from portbench import weights_moe
    from portbench.reference import common, mla_moe, quant

    common.exact()
    c, tr = run.config, run.traffic
    with mla_moe.placement_model():
        judge_placement(run, plan)
    params = weights_moe.make(c, run.seed, run.device)
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
            seqs.append(tuple([int(firsts[w][r])] + out[:-1]))
            served.append((len(seqs) - 1, steps, out, w, r))
    ids, prog = kept
    gap = ctl = err = err_ctl = 0.0
    n_logits = 0
    n_served = 0
    if seqs:
        keep, owner = _maximal(seqs)
        L = max(len(seqs[i]) for i in keep)
        window = tr["kv_ring"]
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
                ref = mla_moe.logits(params, c, toks, window, mms[0])
                low = (mla_moe.logits(params, c, toks, window, mms[1])
                       if run.control else None)
            best = ref.max(-1).values
            rms = ref.square().mean(-1).sqrt()
            for si, steps, out, w, r in served:
                if owner[si] not in batch:
                    continue
                b = batch.index(owner[si])
                st = torch.tensor(steps, device=run.device)
                tk = torch.tensor([out[j] for j in steps], device=run.device)
                gap = max(gap, float((best[b, st] - ref[b, st, tk]).max()))
                n_served += len(steps)
                if low is not None:
                    lt = low[b, st].argmax(-1)
                    ctl = max(ctl, float((best[b, st] - ref[b, st, lt]).max()))
                if r >= run.traffic["check_logit_rows"]:
                    continue
                # the control on the program's rows, steps and ids
                for j in steps:
                    e = (prog[(w, j)][r] - ref[b, j, ids]).abs().max()
                    err = max(err, float(e / rms[b, j]))
                    if low is not None:
                        e = (low[b, j, ids] - ref[b, j, ids]).abs().max()
                        err_ctl = max(err_ctl, float(e / rms[b, j]))
                    n_logits += 1
            del ref, low
    run.counts["served_checked"] = n_served
    run.counts["logit_steps_checked"] = n_logits
    run.counts["expert_layers_checked"] = len(experts)
    run.check("decode_gap", gap, run.cell.limits["decode_gap"])
    run.check("logit_err", err, run.cell.limits["logit_err"])
    run.check("expert_err", _expert_err(params, c, experts, None),
              run.cell.limits["expert_err"])
    if run.control:
        err_exp = _expert_err(params, c, experts, common.Matmul(fp8=True))
        run.readings["decode_gap_fp8"] = ctl
        run.readings["logit_err_fp8"] = err_ctl
        run.readings["expert_err_fp8"] = err_exp
        run.check("decode_gap.fp8_control", ctl, run.cell.limits["decode_gap"])
        run.check("logit_err.fp8_control", err_ctl,
                  run.cell.limits["logit_err"])
        run.check("expert_err.fp8_control", err_exp,
                  run.cell.limits["expert_err"])
    bad = 0
    K, _ = mla_moe.model_spec(c, tr["substrate_params"]["tokens_per_task"])
    tiers = [tuple(x) for x in tr["tier_plan"]]
    for placement, key, segs in snapshots:
        bad += quant.mismatches(_matrix(params, key), placement, K, tiers,
                                segs)
    run.counts["segments_checked"] = len(snapshots)
    run.check("segment_mismatch", bad, run.cell.limits["segment_mismatch"])
