"""Registry-wide substrate smoke of the port.

Iterates every name in the substrate registry (``api.list_substrates()``)
and, for each, resolves the default workload, builds the placement LUT
through the substrate's default solver and runs one
scheduler slice - the minimum end-to-end exercise of a registry entry,
so a broken registration (bad constants, an arch the solvers cannot
handle, a workload mapping that raises) fails instead of shipping
silently. Device work runs on ``--device`` (``cuda`` by default).

    PYTHONPATH=src python -m repro_torch.launch.substrate_smoke
    PYTHONPATH=src python -m repro_torch.launch.substrate_smoke \
        --device cpu --only gpu
"""
from __future__ import annotations

import argparse
import time
import traceback

from repro_torch import api


def smoke_one(name: str, *, lut_points: int = 8, n_tasks: int = 2,
              device: str = "cuda") -> dict:
    """LUT build + one scheduler slice for one registry entry."""
    sub = api.substrate(name)
    model = sub.model_spec()
    t_slice_ns = sub.default_t_slice_ns(model)
    lut = sub.build_lut(model, t_slice_ns=t_slice_ns, n_points=lut_points,
                        device=device)
    n_feasible = sum(e.feasible for e in lut.entries)
    if not n_feasible:
        raise RuntimeError("LUT has no feasible entries")
    sched = api.scheduler(sub, model, t_slice_ns=t_slice_ns,
                          lut_points=lut_points, device=device)
    rep = sched.step(n_tasks)
    if rep.n_tasks != n_tasks or not rep.energy_pj > 0:
        raise RuntimeError(f"bad slice report: {rep}")
    return {"substrate": name, "model": model.name,
            "t_slice_us": t_slice_ns / 1e3,
            "lut_feasible": n_feasible, "lut_entries": len(lut.entries),
            "slice_energy_pj": rep.energy_pj,
            "deadline_met": rep.deadline_met}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="run only substrates whose name contains this")
    ap.add_argument("--lut-points", type=int, default=8)
    ap.add_argument("--tasks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    names = [n for n in api.list_substrates()
             if not args.only or args.only in n]
    if not names:
        raise SystemExit(f"no registered substrate matches {args.only!r}")
    failures = []
    for name in names:
        t0 = time.perf_counter()
        try:
            s = smoke_one(name, lut_points=args.lut_points,
                          n_tasks=args.tasks, device=args.device)
            print(f"{name:18s} ok   model={s['model']:24s} "
                  f"T={s['t_slice_us']:10.2f}us "
                  f"lut={s['lut_feasible']}/{s['lut_entries']} "
                  f"E={s['slice_energy_pj']:.3e}pJ "
                  f"({time.perf_counter() - t0:.2f}s)")
        except Exception as e:
            failures.append(name)
            print(f"{name:18s} FAIL {e!r}")
            traceback.print_exc()
    print(f"\n{len(names) - len(failures)}/{len(names)} substrates ok")
    if failures:
        raise SystemExit(f"substrate smoke failed for: {failures}")


if __name__ == "__main__":
    main()
