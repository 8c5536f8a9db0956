"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; ``checks`` last, each number compared beside its limit,
which are also the last lines on standard error. ``--control 1`` also
computes the cell's lower-precision control and prints its readings
under ``control`` (the upper readings the limits are set from).
Exits 2 and prints no result without enough cards, and 3 if ``jax``,
``jaxlib``, ``flax`` or ``repro`` was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


# mallopt's parameters (glibc's malloc.h)
_M_TRIM_THRESHOLD, _M_MMAP_MAX = -1, -4


def _allocator() -> None:
    """Host memory that is freed stays with the process. By default
    glibc maps every block of 32 MiB or more on its own and unmaps it on
    free, so each copy of a large device tensor to the host (the stage
    tables of the placement LUT builds, up to about 100 MB each) faults
    in fresh pages, at a pace that follows the host kernel's load; here
    such blocks come from the heap, which is never trimmed, and are used
    again."""
    import ctypes
    import ctypes.util
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        libc.mallopt(_M_MMAP_MAX, 0)
        libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
    except (OSError, AttributeError):
        pass


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a
    library; the host allocator set (``_allocator``)."""
    _allocator()
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    t_enter = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from portbench import bench

    try:
        t_start = bench.process_start_s()
    except (OSError, ValueError, IndexError):
        t_start = t_enter
    cell = bench.Cell(bench.manifest(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = bench.Run(cell, args.seed, args.seconds, bool(args.trace),
                    control=bool(args.control))
    run.t_start = t_start
    bench.driver(cell.traffic["driver"]).run(run)
    bad = bench.loaded_forbidden()
    if bad:
        print(f"portbench: modules loaded that no run may load: {bad}",
              file=sys.stderr)
        return 3
    out = bench.result(run)
    print("portbench: " + json.dumps({"counts": run.counts,
                                      "notes": run.notes}, default=str),
          file=sys.stderr)
    for name, v, lim in run.checks:
        print(f"check {name} = {v!r} (limit {lim!r}) "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
