"""Quickstart: the paper's core in 60 seconds.

Builds the HH-PIM system from Tables I/III/V, runs the placement optimizer
(Algorithms 1+2) for EfficientNet-B0, prints the Fig.6-style placement
migration, and simulates one dynamic-workload scenario against the three
comparison PIMs (Fig. 5).

The PyTorch port's version: the placement LUT is built on ``--device``
(``cuda`` by default; ``cpu`` runs the plain DP).

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch import api
from repro_torch.core import spaces as sp
from repro_torch.core.system import (default_t_slice_ns, run_baseline,
                                     run_hh_pim)

RHO = 4.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args(argv).device
    model = sp.EFFICIENTNET_B0
    sub = api.substrate("edge-hhpim")
    arch = sub.arch
    em = sub.energy_model(model, rho=RHO)
    T = default_t_slice_ns(model, RHO)

    print(f"== HH-PIM ({arch.name}) / {model.name} ==")
    print(f"   {model.n_params:,} weights, {model.pim_ops:,} PIM MACs/task, "
          f"time slice T = {T / 1e6:.2f} ms\n")

    peak = em.peak_placement(sram_only=True)
    t_peak = em.task_cost(peak).t_task_ns / 1e6
    print(f"peak placement (green dot): {peak}  -> {t_peak:.3f} ms/task")
    mram = em.peak_placement(sram_only=False)
    t_mram = em.task_cost(mram).t_task_ns / 1e6
    print(f"MRAM-only peak (purple dot): {t_mram:.3f} ms/task  "
          "(paper: SRAM+MRAM wins)\n")

    print("placement LUT (allocation_state) - Fig. 6 migration:")
    lut = api.lut(sub, model, t_slice_ns=T, n_points=24, rho=RHO,
                  device=dev)
    seen = None
    for e in lut.entries:
        if not e.feasible:
            continue
        used = {k: v for k, v in e.placement.items() if v}
        key = tuple(sorted(used))
        if key != seen:
            seen = key
            print(f"  t_constraint >= {e.t_constraint_ns/1e6:6.2f} ms : "
                  f"{used}  E_task = {e.e_task_pj*1e-6:8.1f} uJ")

    print("\nscenario case3 (periodic spikes), 50 slices:")
    hh = run_hh_pim(model, "case3_periodic_spike", rho=RHO, lut_points=32,
                    device=dev)
    print(f"  HH-PIM        : {hh.energy_uj:10.1f} uJ, "
          f"{hh.deadline_miss} deadline misses")
    for kind in ("baseline", "hetero", "hybrid"):
        res = run_baseline(kind, model, "case3_periodic_spike", rho=RHO,
                           device=dev)
        save = 100 * (1 - hh.energy_uj / res.energy_uj)
        print(f"  {kind:14s}: {res.energy_uj:10.1f} uJ  "
              f"(HH-PIM saves {save:5.1f} %)")


if __name__ == "__main__":
    main()
