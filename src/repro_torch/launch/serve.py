"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Two modes, on the reduced (smoke) config with random weights drawn from
a seeded ``torch.Generator`` on ``--device`` (``cuda`` by default):
  * ``--engine batch``  - plain batched decode engine (slot continuous
    batching).
  * ``--engine hetero`` - the HH-PIM heterogeneous runtime: requests flow
    through time slices, weight placement re-solved per slice across the
    substrate's tiers and the FFN weights re-tiered on the device. Built
    through the ``repro_torch.api`` facade; ``--substrate`` / ``--solver``
    pick registry entries (DESIGN.md SS.5).

    PYTHONPATH=src python -m repro_torch.launch.serve --engine hetero \\
        --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import api
from repro_torch.configs import ARCH_IDS, canonical, get_smoke_config
from repro_torch.core import workloads
from repro_torch.device import resolve as resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import DecodeEngine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b",
                    help=f"one of {ARCH_IDS}")
    ap.add_argument("--engine", choices=("batch", "hetero"),
                    default="hetero")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--scenario", default="case6_random")
    ap.add_argument("--substrate", default="tpu-pool",
                    help=f"one of {api.available_substrates()}")
    ap.add_argument("--solver", default=None,
                    help=f"placement solver, one of {sorted(api.SOLVERS)}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    print(f"arch={canonical(args.arch)} ({cfg.n_layers}L d={cfg.d_model}, "
          f"reduced config) engine={args.engine} device={dev}")

    if args.engine == "batch":
        eng = DecodeEngine(cfg, params, max_batch=4, max_len=64, device=dev)
        for r in range(args.requests):
            eng.submit(Request(rid=r, prompt=[1 + r, 2, 3],
                               max_new_tokens=args.max_new_tokens))
        done = eng.run_until_done()
        for req in done:
            print(f"  request {req.rid}: {len(req.out)} tokens "
                  f"{req.out[:8]}")
        return

    over = {"solver": args.solver} if args.solver else {}
    try:
        eng = api.engine(args.substrate, cfg, params, max_batch=4,
                         device=dev, **over)
    except ValueError as e:
        raise SystemExit(str(e))
    loads = workloads.SCENARIOS[args.scenario][:10]
    print(f"time slice {eng.t_slice_ms:.3f} ms; loads {loads}")
    for i, n in enumerate(loads):
        r = eng.run_slice(min(n, eng.max_batch))
        used = {k: v for k, v in r.report.placement.items() if v}
        print(f"  slice {i:2d} load {n:2d} E={r.report.energy_pj*1e-6:9.2f}"
              f" uJ retier={'y' if r.retiered else 'n'} "
              f"{'ok' if r.report.deadline_met else 'MISS'} {used}")
    print(f"total {eng.energy_uj():.1f} uJ, "
          f"{eng.deadline_misses()} deadline misses")


if __name__ == "__main__":
    main()
