"""Fleet serving launcher: ``python -m repro_torch.launch.fleet``.

Runs a trace-driven multi-engine serving fleet: N HH-PIM serve engines
(TPU parameterization), per-engine load forecasting driving proactive
weight migration, SLO-aware routing with optional admission control.
The LUT builds, and with ``--decode`` every engine's re-tiering and
decode, run on ``--device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions):

    python -m repro_torch.launch.fleet --workload mmpp --engines 2 \\
        --requests 32
    python -m repro_torch.launch.fleet --substrate gpu-pool \\
        --dvfs-controller ...
    python -m repro_torch.launch.fleet --substrate cxl-tier-3 \\
        --lut-cache ckpt/luts.json ...                    # warm-start
    python -m repro_torch.launch.fleet --trace --flight-recorder ...
    python -m repro_torch.launch.fleet --cells 16 --engines 128 \\
        --autoscale --max-engines 512 --no-decode          # DESIGN SS.9
    python -m repro_torch.launch.fleet --workload dag:mixed --cells 4 \\
        --engines 8                                        # DESIGN SS.11
    python -m repro_torch.launch.fleet --device cpu --no-decode

``--workload dag:<spec>`` switches to the multi-tenant DAG-serving
fleet (:mod:`repro_torch.fleet.dag`): requests become stage DAGs
(``dag:mixed`` runs the stock mixed-tenant registry; ``dag:agentic`` /
``dag:prefill_decode`` / ``dag:draft_verify`` run one canonical spec
for an interactive + a batch tenant), stages are co-scheduled across
cells against the bring-up placement LUTs, and the summary gains
per-tenant columns. ``--tenants name:class[:spec[:weight]],...``
replaces the registry; unknown spec names raise shaped errors listing
the registered ones. ``--request-level`` pins every stage to its DAG's
admission cell (the baseline ``fleet_bench --suite dag_serving``
compares against).

``--cells N`` switches to the two-level hierarchical fleet
(:mod:`repro_torch.fleet.hierarchy`): ``--engines`` becomes the total
initial engine count split evenly across N cells, the global tier routes by
queue-aware per-class scoring, and ``--autoscale`` attaches the cell
autoscaler (``--max-engines`` caps the total; scale-ups are served from
placement-compiler warm starts, so the ``lut-cache:`` line must report
0 builds on a warm run). The hierarchical path is analytic-only.

``--trace [PATH]`` turns on the observability layer (repro_torch.obs)
and writes a Perfetto-loadable ``trace.json`` plus a ``metrics.json``
snapshot after the run; ``--flight-recorder [PATH]`` arms the SLO-breach
flight recorder (ring buffer of per-slice fleet state, dumped as JSON
when the running deadline-miss rate crosses ``--miss-threshold``).

With ``--decode`` (default on the flat path) every worker carries a real
``HeteroServeEngine``: each slice's placement is applied as an actual
weight re-tiering and tokens are decoded on the engine's device.
``--no-decode`` runs the analytic scheduler/energy path only (fast; what
``benchmarks/fleet_bench.py`` sweeps).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch import api, obs
from repro_torch.device import resolve as resolve_device
from repro_torch.fleet import make_trace, summarize
from repro_torch.fleet.forecast import FORECASTERS
from repro_torch.fleet.hierarchy import CELL_POLICIES
from repro_torch.fleet.router import POLICIES
from repro_torch.fleet.traces import TRACES


def _dag_tenants(spec_str):
    """Parse ``--tenants name:slo_class[:dag_spec[:weight]],...`` into a
    TenantRegistry (shaped errors surface as SystemExit)."""
    from repro_torch.fleet.dag import Tenant, TenantRegistry
    tenants = []
    for part in spec_str.split(","):
        bits = part.split(":")
        if len(bits) < 2 or not bits[0] or not bits[1]:
            raise SystemExit(
                f"bad --tenants entry {part!r}; expected "
                f"name:slo_class[:dag_spec[:weight]]")
        dag = bits[2] if len(bits) > 2 and bits[2] else "prefill_decode"
        weight = float(bits[3]) if len(bits) > 3 else 1.0
        try:
            tenants.append(Tenant(bits[0], bits[1], weight=weight,
                                  dag=dag))
        except ValueError as e:
            raise SystemExit(f"--tenants: {e}") from None
    return TenantRegistry(tuple(tenants))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="mmpp",
                    help=f"arrival trace: one of {sorted(TRACES)}, a "
                         f"case* scenario, or dag:<spec> for the DAG "
                         f"fleet (default mmpp)")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="DAG tenant registry: comma-separated "
                         "name:slo_class[:dag_spec[:weight]] entries "
                         "(dag:* workloads; default: the stock mixed "
                         "registry)")
    ap.add_argument("--dag-base", default="mmpp", metavar="TRACE",
                    help="arrival process under a dag:* workload "
                         "(default mmpp)")
    ap.add_argument("--request-level", action="store_true",
                    help="disable stage affinity: route whole DAGs at "
                         "admission (comparison baseline)")
    ap.add_argument("--trace", nargs="?", const="trace.json", default=None,
                    metavar="PATH",
                    help="enable structured tracing; write Chrome "
                         "trace-event JSON to PATH (default trace.json, "
                         "with a metrics.json snapshot alongside)")
    ap.add_argument("--flight-recorder", nargs="?", const="flight.json",
                    default=None, metavar="PATH",
                    help="arm the SLO-breach flight recorder; dump the "
                         "last --flight-capacity slice frames to PATH "
                         "when the running deadline-miss rate crosses "
                         "--miss-threshold")
    ap.add_argument("--flight-capacity", type=int, default=32)
    ap.add_argument("--miss-threshold", type=float, default=0.3,
                    help="flight-recorder deadline-miss-rate trigger")
    ap.add_argument("--engines", type=int, default=2,
                    help="engine count (with --cells: total across cells)")
    ap.add_argument("--cells", type=int, default=None, metavar="N",
                    help="hierarchical fleet with N cells (two-level "
                         "router + per-class SLO admission; DESIGN SS.9)")
    ap.add_argument("--autoscale", action="store_true",
                    help="attach the cell autoscaler (requires --cells)")
    ap.add_argument("--max-engines", type=int, default=None,
                    help="autoscale ceiling, total across cells "
                         "(default: --engines, i.e. no growth)")
    ap.add_argument("--cell-policy", default="least_loaded",
                    choices=CELL_POLICIES,
                    help="engine selection inside a cell")
    ap.add_argument("--requests", type=int, default=None,
                    help="total request budget (truncates the trace)")
    ap.add_argument("--steps", type=int, default=25,
                    help="number of trace time slices")
    ap.add_argument("--forecaster", default="ewma",
                    choices=sorted(FORECASTERS))
    ap.add_argument("--policy", default="slo", choices=POLICIES)
    ap.add_argument("--margin", type=float, default=1.0,
                    help="forecast over-provisioning factor")
    ap.add_argument("--admission-limit", type=int, default=None,
                    help="max queued tasks per engine before rejecting "
                         "(flat fleet; --cells admits by expected wait)")
    ap.add_argument("--substrate", default=None,
                    help=f"one of {api.available_substrates()} "
                         f"(default tpu-pool; --mixed => tpu-pool-mixed)")
    ap.add_argument("--solver", default=None,
                    help=f"placement solver, one of {sorted(api.SOLVERS)}")
    ap.add_argument("--mixed", action="store_true",
                    help="heterogeneous pool: odd engines get half chips")
    ap.add_argument("--dvfs-controller", type=int, nargs="?", const=5,
                    default=None, metavar="N",
                    help="solve the DVFS clock online: pick the energy-"
                         "minimal (placement, clock) pair per slice over "
                         "an N-point TechModel grid (default 5; gpu-pool "
                         "and cxl-tier substrates, flat fleet path). The "
                         "chosen clock prints per slice (clk column) and "
                         "in the dvfs-controller: summary")
    ap.add_argument("--tokens-per-task", type=int, default=2)
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode", dest="decode", action="store_true",
                    default=True)
    ap.add_argument("--no-decode", dest="decode", action="store_false")
    ap.add_argument("--lut-cache", default=None, metavar="PATH",
                    help="warm-start: load the placement-compiler LUT "
                         "cache from PATH when it exists and save it back "
                         "after the run (serialize next to checkpoints so "
                         "a restarted fleet skips bring-up compiles)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where LUTs build and engines decode (default "
                         "cuda; a card is required)")
    ap.add_argument("--json", default=None,
                    help="write the summary to this path as JSON")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    is_dag = args.workload.startswith("dag:")
    if is_dag and args.cells is None:
        args.cells = 2                # DAG serving is inherently celled
    if not is_dag and args.tenants is not None:
        raise SystemExit("--tenants requires a dag:<spec> workload")

    if args.autoscale and args.cells is None:
        raise SystemExit("--autoscale requires --cells")

    obs_on = args.trace is not None or args.flight_recorder is not None
    if obs_on:
        obs.reset()
        rec = None
        if args.flight_recorder is not None:
            rec = obs.FlightRecorder(
                capacity=args.flight_capacity,
                miss_rate_threshold=args.miss_threshold,
                path=args.flight_recorder)
        obs.enable(flight_recorder=rec)

    trace = None
    if not is_dag:
        trace = make_trace(args.workload, n_slices=args.steps,
                           seed=args.seed)
        if args.requests is not None:
            trace = trace.truncated(args.requests)

    if args.substrate and args.mixed \
            and not args.substrate.endswith("-mixed"):
        raise SystemExit(
            f"--mixed conflicts with --substrate {args.substrate}; "
            f"use a *-mixed substrate such as tpu-pool-mixed or "
            f"gpu-pool-mixed (or drop --mixed)")
    substrate = args.substrate or ("tpu-pool-mixed" if args.mixed
                                   else "tpu-pool")
    over = {"solver": args.solver} if args.solver else {}
    if args.dvfs_controller is not None:
        if args.cells is not None:
            raise SystemExit("--dvfs-controller runs on the flat fleet "
                             "path; drop --cells")
        if api.substrate(substrate, **over).tech_model() is None:
            raise SystemExit(
                f"--dvfs-controller needs a substrate with a registered "
                f"TechModel (gpu-pool / cxl-tier families); "
                f"{substrate} has none")
    if args.decode and args.cells is not None:
        if not args.quiet:
            print("hierarchical fleets run the analytic path only; "
                  "running as --no-decode")
        args.decode = False
    if args.decode and not api.substrate(substrate).supports_decode:
        print(f"substrate {substrate} is accounting-only (no functional "
              f"decode engine); running as --no-decode")
        args.decode = False

    params = cfg = None
    if args.decode:
        from repro_torch.configs import canonical, get_smoke_config
        from repro_torch.models import lm
        cfg = get_smoke_config(args.arch)
        params = lm.init_lm(
            torch.Generator(device=dev).manual_seed(args.seed), cfg)
        print(f"arch={canonical(args.arch)} ({cfg.n_layers}L "
              f"d={cfg.d_model}, reduced config) device={dev}")

    pc = api.compiler(device=dev)
    if args.lut_cache:
        n = pc.load(args.lut_cache)
        if n:
            print(f"warm-start: loaded {n} cached LUTs from "
                  f"{args.lut_cache}")

    hier = None
    if is_dag:
        from repro_torch.fleet.dag import (DEFAULT_DAG_BUDGETS,
                                           dag_arrivals, default_tenants,
                                           make_dag_spec, tenant_breakdown)
        spec_name = args.workload[len("dag:"):] or "mixed"
        if args.tenants is not None:
            tenants = _dag_tenants(args.tenants)
        elif spec_name == "mixed":
            tenants = default_tenants()
        else:
            from repro_torch.fleet.dag import Tenant, TenantRegistry
            try:
                make_dag_spec(spec_name)
            except ValueError as e:
                raise SystemExit(f"--workload {args.workload}: {e}") \
                    from None
            tenants = TenantRegistry((
                Tenant("interactive", "interactive", dag=spec_name),
                Tenant("batch", "batch", dag=spec_name),
            ))
        # every tenant class must be registered; the CLI registers
        # unbudgeted ones at the default 2-slice SLO explicitly
        budgets = dict(DEFAULT_DAG_BUDGETS)
        for t in tenants:
            budgets.setdefault(t.slo_class, 2.0)
        per_cell = max(args.engines // args.cells, 1)
        dagf = api.dag_fleet(
            substrate, cfg, tenants=tenants, budgets=budgets,
            stage_affinity=not args.request_level,
            n_cells=args.cells, engines_per_cell=per_cell,
            forecaster=args.forecaster, cell_policy=args.cell_policy,
            autoscale=args.autoscale,
            tokens_per_task=args.tokens_per_task,
            forecast_margin=args.margin, compiler=pc, seed=args.seed,
            device=dev, **over)
        dag_tr = dag_arrivals(tenants, n_slices=args.steps,
                              base=args.dag_base, seed=args.seed)
        T_us = dagf.cells[0].t_slice_ns / 1e3
        mode = "request-level" if args.request_level else "stage-level"
        print(f"dag fleet: {args.cells} cells x {per_cell} engines on "
              f"{substrate}, {mode} placement, "
              f"tenants={','.join(tenants.names())}, "
              f"t_slice={T_us:.2f} us, trace={dag_tr.name} "
              f"({dag_tr.total} dags / {len(dag_tr)} slices)")

        def cb(s, arrivals, done_dags, cells):
            if args.quiet:
                return
            bl = "/".join(str(c.backlog) for c in cells)
            print(f"  slice {s:3d} dags-in {len(arrivals):3d} dags-done "
                  f"{done_dags:3d} backlog {bl}")

        res = dagf.run_dag(dag_tr, verbose_cb=cb)
        s = summarize(res)
        n_dags = (len(res.completed) + len(res.rejected)
                  + len(res.unfinished))
        print(f"dags: completed {len(res.completed)}/{n_dags} "
              f"(rejected {len(res.rejected)}, unfinished "
              f"{len(res.unfinished)}), {res.handoffs} handoffs "
              f"({res.handoff_energy_pj / 1e6:.2f} uJ handoff energy)")
        tb = tenant_breakdown(res, dagf)
        print(f"{'tenant':<10s} {'class':<12s} {'dag':<15s} "
              f"{'done':>5s} {'rej':>4s} {'unf':>4s} {'miss':>6s} "
              f"{'p95_us':>8s} {'handoffs':>8s}")
        for name, row in tb.items():
            print(f"{name:<10s} {row['slo_class']:<12s} "
                  f"{row['dag']:<15s} {row['n_completed']:5d} "
                  f"{row['n_rejected']:4d} {row['n_unfinished']:4d} "
                  f"{row['deadline_miss_rate']:6.3f} "
                  f"{row['p95_ms'] * 1e3:8.2f} {row['handoffs']:8d}")
    elif args.cells is not None:
        per_cell = max(args.engines // args.cells, 1)
        max_per_cell = (per_cell if args.max_engines is None
                        else max(args.max_engines // args.cells, per_cell))
        hier = api.hierarchical_fleet(
            substrate, cfg, n_cells=args.cells,
            engines_per_cell=per_cell, forecaster=args.forecaster,
            cell_policy=args.cell_policy,
            autoscale=args.autoscale, max_engines=max_per_cell,
            tokens_per_task=args.tokens_per_task,
            forecast_margin=args.margin, compiler=pc, seed=args.seed,
            device=dev, **over)
        n_engines = hier.n_engines
        T_us = hier.cells[0].t_slice_ns / 1e3
        ceiling = (f" (ceiling {max_per_cell * args.cells})"
                   if args.autoscale else "")
        print(f"fleet: {args.cells} cells x {per_cell} engines "
              f"({n_engines} total) on {substrate}, "
              f"cell-policy={args.cell_policy}, "
              f"autoscale={'on' if args.autoscale else 'off'}{ceiling}, "
              f"forecaster={args.forecaster}, t_slice={T_us:.2f} us, "
              f"trace={trace.name} ({trace.total} requests / "
              f"{len(trace)} slices, peak {trace.peak}/slice)")

        def cb(s, n_arr, done, cells):
            if args.quiet:
                return
            bl = "/".join(str(c.backlog) for c in cells)
            eng = "/".join(str(c.n_active) for c in cells)
            print(f"  slice {s:3d} arrivals {n_arr:4d} done "
                  f"{len(done):4d} backlog {bl} engines {eng}")

        res = hier.run(trace, verbose_cb=cb)
        s = summarize(res)
    else:
        fleet = api.fleet(
            substrate, cfg, n_engines=args.engines,
            forecaster=args.forecaster, policy=args.policy,
            tokens_per_task=args.tokens_per_task,
            admission_limit=args.admission_limit,
            forecast_margin=args.margin, params=params,
            decode=args.decode, compiler=pc,
            dvfs=args.dvfs_controller, device=dev, **over)

        T_us = fleet.workers[0].t_slice_ns / 1e3
        dvfs_on = args.dvfs_controller is not None
        grid = fleet.workers[0].sched.dvfs.clocks if dvfs_on else ()
        print(f"fleet: {args.engines} engines on {substrate}"
              f", policy={args.policy}, forecaster={args.forecaster}, "
              f"t_slice={T_us:.2f} us, trace={trace.name} "
              f"({trace.total} requests / {len(trace)} slices, "
              f"peak {trace.peak}/slice)"
              + (f", dvfs-grid=[{'/'.join(f'{c:.2f}' for c in grid)}]"
                 if dvfs_on else ""))

        def cb(s, n_arr, done, workers):
            if args.quiet:
                return
            bl = "/".join(str(len(w.backlog)) for w in workers)
            mig = "/".join(
                "y" if (w.reports and w.reports[-1].moved_weights) else "."
                for w in workers)
            line = (f"  slice {s:3d} arrivals {n_arr:3d} done "
                    f"{len(done):3d} backlog {bl:12s} migrated {mig}")
            if dvfs_on:
                # per-slice solved clock, one column per engine
                clk = "/".join(
                    f"{w.reports[-1].clock:.2f}"
                    if w.reports and w.reports[-1].clock is not None
                    else "-" for w in workers)
                line += f" clk {clk}"
            print(line)

        res = fleet.run(trace, verbose_cb=cb)
        s = summarize(res)
        if dvfs_on:
            clocks = sorted(r.clock for w in fleet.workers
                            for r in w.reports if r.clock is not None)
            mean = sum(clocks) / len(clocks) if clocks else float("nan")
            print(f"dvfs-controller: {len(grid)}-point grid, solved clock "
                  f"min {clocks[0]:.2f} / mean {mean:.2f} / max "
                  f"{clocks[-1]:.2f} over {len(clocks)} engine-slices")
    print(f"completed {s.n_completed}/{s.n_submitted} "
          f"(rejected {s.n_rejected}) over {s.n_slices} slices")
    print(f"latency   p50 {s.p50_ms * 1e3:.2f} us | "
          f"p95 {s.p95_ms * 1e3:.2f} us | p99 {s.p99_ms * 1e3:.2f} us "
          f"(SLO {s.slo_ms * 1e3:.2f} us)")
    print(f"deadline-miss-rate {s.deadline_miss_rate:.3f}")
    print(f"energy    {s.energy_uj:.1f} uJ total, "
          f"{s.energy_per_token_uj:.2f} uJ/token over {s.tokens} tokens")
    print(f"placement {s.migrations} migrating slices, "
          f"{s.weights_moved} weights moved")
    if hier is not None and args.autoscale:
        print(f"autoscale {res.n_scale_ups} up / {res.n_scale_downs} down, "
              f"engines {res.n_engines_start} -> peak "
              f"{res.n_engines_peak} -> end {res.n_engines_end}, "
              f"scale-up LUT builds {res.scale_up_builds}")
    # the compiler's cache traffic, printed unconditionally: warm-started
    # runs (and autoscaler scale-ups) must show "0 builds" here
    print(f"lut-cache: {len(pc)} LUTs ({pc.n_builds} builds, "
          f"{pc.n_hits} hits, {pc.n_loaded} loaded)")
    if args.lut_cache:
        pc.save(args.lut_cache)
        print(f"lut-cache: saved {len(pc)} LUTs to {args.lut_cache}")
    if obs_on:
        rec = obs.flight_recorder()
        if rec is not None:
            if rec.n_dumps:
                print(f"flight-recorder: {rec.n_dumps} SLO-breach dump(s) "
                      f"-> {args.flight_recorder} "
                      f"({rec.last_dump['reason']})")
            else:
                print(f"flight-recorder: no SLO breach "
                      f"({len(rec)} frames buffered)")
        if args.trace is not None:
            paths = obs.export(
                trace_path=args.trace,
                metrics_path=Path(args.trace).with_name("metrics.json"))
            print(f"wrote {paths['trace']} ({len(obs.tracer())} events; "
                  f"load at ui.perfetto.dev) and {paths['metrics']}")
    if args.json:
        out = s.as_dict()
        if is_dag:
            out["dag"] = {
                "n_completed": len(res.completed),
                "n_rejected": len(res.rejected),
                "n_unfinished": len(res.unfinished),
                "handoffs": res.handoffs,
                "handoff_energy_pj": res.handoff_energy_pj,
                "tenants": tb,
            }
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
