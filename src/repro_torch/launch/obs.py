"""Observability launcher: ``python -m repro_torch.launch.obs``.

Runs one instrumented fleet scenario end-to-end with tracing, metrics
and the SLO-breach flight recorder enabled (LUT builds on ``--device``,
``cuda`` by default), then renders a text summary
(top spans by total wall time, counters, histograms, flight-recorder
status) and writes ``trace.json`` (Chrome trace-event JSON - load it at
ui.perfetto.dev) plus ``metrics.json`` (registry snapshot):

    python -m repro_torch.launch.obs --workload mmpp --engines 2 \\
        --steps 25
    python -m repro_torch.launch.obs --device cpu     # no card
    python -m repro_torch.launch.obs --summarize out/trace.json

The heavier fleet CLI (``repro_torch.launch.fleet``) exposes the same
layer via ``--trace``/``--flight-recorder`` on its full option surface; this
launcher is the quick one-command way to get an attributable timeline.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch import api, obs
from repro_torch.device import resolve as resolve_device
from repro_torch.fleet import make_trace, summarize
from repro_torch.fleet.traces import TRACES


def render_spans(events, limit: int = 20) -> None:
    rows = obs.summarize_events(events)
    print(f"spans ({sum(r['count'] for r in rows)} events, "
          f"{len(rows)} names; top {min(limit, len(rows))} by total time)")
    print(f"  {'name':26s} {'cat':10s} {'count':>6s} {'total_us':>10s} "
          f"{'mean_us':>9s} {'max_us':>9s}")
    for r in rows[:limit]:
        print(f"  {r['name']:26s} {r['cat']:10s} {r['count']:6d} "
              f"{r['total_us']:10.1f} {r['mean_us']:9.1f} "
              f"{r['max_us']:9.1f}")


def render_metrics(reg: obs.MetricsRegistry) -> None:
    lines = reg.render()
    print(f"metrics ({len(lines)} instruments)")
    for line in lines:
        print(f"  {line}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--summarize", default=None, metavar="TRACE_JSON",
                    help="render the span summary of an existing trace "
                         "file and exit (no fleet run)")
    ap.add_argument("--workload", default="mmpp",
                    help=f"arrival trace: one of {sorted(TRACES)} or a "
                         f"case* scenario")
    ap.add_argument("--substrate", default="tpu-pool",
                    help=f"one of {api.available_substrates()}")
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--forecaster", default="ewma")
    ap.add_argument("--admission-limit", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="obs_out", metavar="DIR",
                    help="where trace.json / metrics.json / flight.json "
                         "are written")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fleet's LUTs build (default cuda)")
    ap.add_argument("--flight-capacity", type=int, default=32)
    ap.add_argument("--miss-threshold", type=float, default=0.3,
                    help="flight-recorder deadline-miss-rate trigger")
    args = ap.parse_args(argv)

    if args.summarize:
        payload = json.loads(Path(args.summarize).read_text())
        events = payload.get("traceEvents", payload)
        render_spans(events)
        return

    dev = resolve_device(args.device)
    out = Path(args.out_dir)
    obs.reset()
    obs.enable(flight_recorder=obs.FlightRecorder(
        capacity=args.flight_capacity,
        miss_rate_threshold=args.miss_threshold,
        path=out / "flight.json"))

    trace = make_trace(args.workload, n_slices=args.steps, seed=args.seed)
    if args.requests is not None:
        trace = trace.truncated(args.requests)
    fleet = api.fleet(args.substrate, n_engines=args.engines,
                      forecaster=args.forecaster,
                      admission_limit=args.admission_limit, device=dev)
    res = fleet.run(trace)
    s = summarize(res)

    print(f"fleet: {args.engines} engines on {args.substrate}, "
          f"workload={trace.name} ({trace.total} requests / "
          f"{len(trace)} slices)")
    print(f"completed {s.n_completed}/{s.n_submitted}, miss-rate "
          f"{s.deadline_miss_rate:.3f}, p99 {s.p99_ms * 1e3:.2f} us "
          f"(SLO {s.slo_ms * 1e3:.2f} us)")
    print()
    render_spans(obs.tracer().events())
    print()
    render_metrics(obs.metrics())

    rec = obs.flight_recorder()
    if rec.n_dumps:
        print(f"\nflight-recorder: {rec.n_dumps} SLO-breach dump(s), "
              f"last reason: {rec.last_dump['reason']}")
    else:
        print(f"\nflight-recorder: armed, no SLO breach "
              f"({len(rec)} frames buffered)")

    paths = obs.export(trace_path=out / "trace.json",
                       metrics_path=out / "metrics.json")
    for kind, p in paths.items():
        print(f"wrote {kind}: {p}")
    print("open the trace at https://ui.perfetto.dev (or "
          "chrome://tracing)")


if __name__ == "__main__":
    main()
