"""Fig. 6 sweep for all three TinyML benchmarks + rho sensitivity, plus
the gpu-pool DVFS frontier.

Shows how the optimal placement and E_task evolve with t_constraint for
EfficientNet-B0 / MobileNetV2 / ResNet-18, how the weight-reuse factor
rho moves the LP-MRAM-only crossover (DESIGN.md SS.2 modeling note), and
how the ``gpu-pool`` substrate's LP-pool frequency scale (``lp_clock``,
DESIGN.md SS.5) traces the paper's energy-vs-latency frontier on the GPU
backend: a slower LP pool stretches the achievable per-task latency while
the relaxed-deadline energy drops.

The PyTorch port's version: every LUT is built on ``--device`` (``cuda``
by default; ``cpu`` runs the plain DP).

Run:  PYTHONPATH=src python examples/torch/placement_sweep.py [--device cpu]
"""
import argparse

from repro_torch import api
from repro_torch.core import spaces as sp
from repro_torch.core.system import default_t_slice_ns


def sweep(model: sp.ModelSpec, rho: float, device: str) -> None:
    T = default_t_slice_ns(model, rho)
    lut = api.lut("edge-hhpim", model, t_slice_ns=T, n_points=32, rho=rho,
                  device=device)
    print(f"-- {model.name} (rho={rho}, T={T/1e6:.2f} ms)")
    seen = None
    for e in lut.entries:
        if not e.feasible:
            continue
        key = tuple(sorted(k for k, v in e.placement.items() if v))
        if key != seen:
            seen = key
            share = {k: f"{100*v/model.n_params:.0f}%"
                     for k, v in e.placement.items() if v}
            print(f"   t_c >= {e.t_constraint_ns/1e6:7.2f} ms  "
                  f"E_task {e.e_task_pj*1e-6:9.1f} uJ  {share}")


def dvfs_frontier(device: str, n_clocks: int = 5,
                  tokens_per_task: int = 2) -> None:
    """2-D (clock x placement) energy-latency frontier of the gpu-pool
    substrate (DESIGN.md SS.10).

    Axis 1 is the DVFS clock grid of the substrate's TechModel (the same
    grid the online controller solves over); axis 2 is the placement LUT
    at each grid point, batch-built through one PlacementCompiler pass.
    The per-clock rows show the 1-D frontier a static ``lp_clock`` pin
    reaches; the solved frontier below them is what the controller picks
    per latency budget - the lower envelope over both axes, with the
    chosen clock printed wherever the winning (clock, placement) pair
    changes."""
    sub = api.substrate("gpu-pool", tokens_per_task=tokens_per_task)
    tm = sub.tech_model()
    grid = tm.clock_grid(n_clocks, include=(sub.lp_clock,))
    model = sub.model_spec()
    T = sub.default_t_slice_ns(model)
    pc = api.compiler(device=device)
    luts = pc.compile_clock_grid(sub, clocks=grid, t_slice_ns=T,
                                 n_points=24)
    print(f"== gpu-pool 2-D DVFS frontier: {len(grid)}-point TechModel "
          f"grid [{tm.dvfs_min:.2f}, {tm.dvfs_max:.2f}] x placement ==")
    for clock, lut in luts.items():
        feasible = [e for e in lut.entries if e.feasible]
        peak, relaxed = feasible[0], feasible[-1]
        print(f"   lp_clock {clock:4.2f}  t_peak {peak.t_task_ns:8.2f} ns  "
              f"E_peak {peak.e_task_pj:10.1f} pJ  "
              f"E_relaxed {relaxed.e_task_pj:10.1f} pJ")
    print("   -- solved (placement, clock) per latency budget "
          "(the online controller's lower envelope) --")
    t_lo = min(e.t_task_ns for lut in luts.values()
               for e in lut.entries if e.feasible)
    seen = None
    for i in range(25):
        budget = t_lo + (T - t_lo) * i / 24
        best = None
        for clock, lut in luts.items():
            e = lut.lookup(budget)
            if not e.feasible or e.t_task_ns > budget:
                continue
            if best is None or e.e_task_pj < best[1].e_task_pj:
                best = (clock, e)
        if best is None:
            continue
        clock, e = best
        key = (clock,
               tuple(sorted(k for k, v in e.placement.items() if v)))
        if key == seen:
            continue
        seen = key
        share = {k: f"{100 * v / model.n_params:.0f}%"
                 for k, v in e.placement.items() if v}
        print(f"   t <= {budget:8.2f} ns  clk {clock:4.2f}  "
              f"E_task {e.e_task_pj:10.1f} pJ  {share}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args(argv).device
    for model in sp.TINYML_MODELS.values():
        sweep(model, rho=4.0, device=dev)
        print()
    print("== rho sensitivity (EfficientNet-B0): the LP-MRAM-only regime "
          "appears once weight fetches amortize over >=2 MACs ==")
    for rho in (1.0, 2.0, 4.0, 16.0):
        sweep(sp.EFFICIENTNET_B0, rho, dev)
        print()
    dvfs_frontier(dev)


if __name__ == "__main__":
    main()
