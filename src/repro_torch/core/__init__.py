"""Core HH-PIM library: the paper's primary contribution.

  spaces     - hardware constants (Tables I/III/IV/V) and arch builders
  energy     - timing/energy model of placements
  placement  - Algorithms 1+2 (verbatim DP) + closed-form solver + LUT
  scheduler  - time-slice runtime (+ straggler feedback)
  solvers    - pluggable placement-solver strategy registry
  substrate  - Substrate protocol + string-keyed backend registry
  workloads  - Fig. 4 scenarios
  baselines  - Baseline-/Heterogeneous-/Hybrid-PIM comparison policies
  system     - end-to-end scenario simulation (Fig. 5 / Table VI)

Construct the stack through the ``repro_torch.api`` facade (DESIGN.md SS.5).
"""
from repro_torch.core import (baselines, energy, placement, scheduler, solvers,
                        spaces, substrate, system, workloads)

__all__ = ["baselines", "energy", "placement", "scheduler", "solvers",
           "spaces", "substrate", "system", "workloads"]
