"""End-to-end driver: serve a small LM with batched requests through the
HH-PIM heterogeneous runtime (the paper's kind of system = inference).

A 12-layer/768-d transformer (the paper-equivalent ~125M edge config) is
served over simulated HP/LP TPU pools. Requests arrive per the paper's
Fig. 4 workload scenarios; every time slice the scheduler re-solves weight
placement across {hp,lp} x {bf16,int8} tiers (the SAME Algorithms 1+2, TPU
parameterization), the engine actually re-quantizes/re-splits the FFN
weights, and decodes one token per active request. Energy/latency per
slice are reported against a static-placement baseline.

The PyTorch port's version: the weights, the LUT builds, the decode and
the int8 tiers (the ``pim_mac`` kernel on a card) run on ``--device``
(``cuda`` by default; ``cpu`` runs the plain versions).

Run:  PYTHONPATH=src python examples/torch/serve_dynamic.py \
          [--scenario case6_random] [--device cpu]
"""
import argparse

import torch

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import workloads
from repro_torch.device import resolve as resolve_device
from repro_torch.models import lm
from repro_torch.models.common import reduced


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="case3_periodic_spike",
                    choices=list(workloads.SCENARIOS))
    ap.add_argument("--slices", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("hhpim_edge"), n_layers=4, d_model=128,
                  d_ff=256, vocab_size=512)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} "
          f"(reduced {get_config('hhpim_edge').name} for CPU demo)")
    params = lm.init_lm(torch.Generator(dev).manual_seed(0), cfg)
    eng = api.engine("tpu-pool", cfg, params, max_batch=8,
                     n_hp_chips=4, n_lp_chips=4, device=dev)
    print(f"time slice (10 tasks at peak): {eng.t_slice_ms:.3f} ms")

    loads = workloads.SCENARIOS[args.scenario][: args.slices]
    print(f"scenario {args.scenario}: loads {loads}\n")
    header = "placement (hp_bf16/hp_int8/lp_bf16/lp_int8)"
    print(f"{'slice':>5} {'load':>4} {header:>46} {'E_slice uJ':>11} "
          f"{'retier':>6} {'deadline':>8}")
    for i, n in enumerate(loads):
        r = eng.run_slice(min(n, eng.max_batch))
        pl = r.report.placement
        frac = "/".join(
            f"{100*pl.get(k,0)/max(sum(pl.values()),1):.0f}%"
            for k in ("hp_sram", "hp_mram", "lp_sram", "lp_mram"))
        print(f"{i:5d} {n:4d} {frac:>46} "
              f"{r.report.energy_pj*1e-6:11.2f} "
              f"{'yes' if r.retiered else '-':>6} "
              f"{'ok' if r.report.deadline_met else 'MISS':>8}")
        if len(r.tokens):
            pass  # decoded tokens available in r.tokens

    print(f"\ntotal energy: {eng.energy_uj():.1f} uJ, "
          f"deadline misses: {eng.deadline_misses()}")

    # static-placement comparison (peak placement all slices)
    from repro_torch.core.scheduler import FixedPlacementScheduler
    fx = FixedPlacementScheduler(
        eng.arch, eng.model_spec, t_slice_ns=eng.t_slice_ms * 1e6,
        placement=eng.sched.em.peak_placement(True), rho=eng.sched.rho)
    e_fixed = sum(fx.step(min(n, eng.max_batch)).energy_pj
                  for n in loads) * 1e-6
    save = 100 * (1 - eng.energy_uj() / e_fixed)
    print(f"static peak placement would use {e_fixed:.1f} uJ -> dynamic "
          f"placement saves {save:.1f} % (the paper's core result, on TPU "
          f"pool constants)")


if __name__ == "__main__":
    main()
