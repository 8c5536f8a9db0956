"""Fleet serving demo: reactive vs forecasting placement on bursty traffic.

Everything is constructed through the ``repro_torch.api`` facade: a substrate
registry name ("tpu-pool" / "tpu-pool-mixed") plus keyword overrides.
The demo builds a two-engine fleet (analytic path - no model weights
needed), runs the same diurnal trace with the paper's reactive LUT
lookup and with a trend-aware forecaster feeding the scheduler's
``lookup_tasks`` hook, shows a heterogeneous (mixed big/small) fleet
where SLO-aware routing beats round-robin, and finishes with the
two-level hierarchical fleet (``api.hierarchical_fleet``) autoscaling
through a burst at zero LUT-build cost.

The PyTorch port's version: every LUT build runs on ``--device``
(``cuda`` by default; ``cpu`` runs the plain DP).

Run: PYTHONPATH=src python examples/torch/fleet_demo.py [--device cpu]
"""
import argparse

from repro_torch import api
from repro_torch.fleet import make_trace, summarize


def show(tag, s):
    print(f"  {tag:28s} miss={s.deadline_miss_rate:.3f} "
          f"p95={s.p95_ms * 1e3:.2f}us "
          f"energy/token={s.energy_per_token_uj:.2f}uJ "
          f"migrating_slices={s.migrations}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args(argv).device
    trace = make_trace("diurnal", n_slices=48, seed=0, base=4, peak=18)
    print(f"trace: {trace.name}, {trace.total} requests, "
          f"peak {trace.peak}/slice")

    print("reactive vs proactive (2 engines, slo routing):")
    for fc in ("none", "holt"):
        fleet = api.fleet("tpu-pool", n_engines=2, forecaster=fc,
                          forecast_margin=1.0 if fc == "none" else 1.3,
                          device=dev)
        show(f"forecaster={fc}", summarize(fleet.run(trace)))

    print("routing policy on a mixed (big+small) fleet:")
    for policy in ("round_robin", "slo"):
        fleet = api.fleet("tpu-pool-mixed", n_engines=2, forecaster="holt",
                          policy=policy, forecast_margin=1.3, device=dev)
        show(f"policy={policy}", summarize(fleet.run(trace)))

    print("admission control (queue cap 12 tasks/engine):")
    fleet = api.fleet("tpu-pool", n_engines=2, forecaster="holt",
                      forecast_margin=1.3, admission_limit=12, device=dev)
    show("admission_limit=12", summarize(fleet.run(trace)))

    print("hierarchical fleet (4 cells, autoscaling, warm scale-ups):")
    pc = api.compiler(device=dev)
    hier = api.hierarchical_fleet("tpu-pool", n_cells=4,
                                  engines_per_cell=1, autoscale=True,
                                  max_engines=4, compiler=pc, device=dev)
    res = hier.run(trace)
    show("cells=4 autoscale", summarize(res))
    print(f"  engines {res.n_engines_start} -> peak {res.n_engines_peak} "
          f"-> end {res.n_engines_end}; {res.n_scale_ups} scale-ups paid "
          f"{res.scale_up_builds} LUT builds "
          f"(compiler: {pc.n_builds} builds, {pc.n_hits} hits)")


if __name__ == "__main__":
    main()
