"""GPU SM-pool re-parameterization of Eq. (1) - DESIGN.md SS.5.

The same placement engine that runs on edge PIM macros (Table III/V) and
TPU chip pools (``serve/hetero.py``) runs here on a GPU whose streaming
multiprocessors are partitioned into two pools pinned at different DVFS
operating points:

- **Clusters**: the HP pool (``n_hp`` SM clusters at the full boost
  clock) and the LP pool (``n_lp`` SM clusters capped at ``lp_clock`` of
  the boost frequency with a proportionally lowered rail voltage) play
  the paper's HP-PIM / LP-PIM roles. ``lp_clock`` is the DVFS sweep knob:
  per-op latency scales as ``1/lp_clock`` while dynamic energy scales as
  :func:`dvfs_energy_scale` (``V^2`` at the frequency-matched voltage),
  which traces the energy-vs-latency frontier.
- **Memory kinds as residency precisions**: bf16 HBM residency is the
  "SRAM" tier (2 bytes fetched per use; a pool holding bf16 shards must
  stay at its operating point, i.e. volatile), fp8/int8 residency is the
  "MRAM" tier (1 byte per use plus a dequant surcharge; a pool holding
  only low-precision shards may drop to retention sleep when idle, i.e.
  non-volatile). ``rho`` is the decode batch size: one weight fetch from
  HBM serves the whole batch step (weight-stationary reuse).

Eq. (1) is isomorphic under this substitution - Algorithms 1/2 only see
per-space ``(t_i, e_i)`` - so ``gpu_arch()`` just builds a
:class:`~repro_torch.core.spaces.PIMArch` from the constants below and the
whole stack (solvers, scheduler, fleet, serve engine) runs unchanged.

This module is import-light on purpose (no jax): the substrate registry
builds archs from it without pulling in the serving runtime.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import spaces as sp
from repro_torch.core.techmodel import SM_POOL_7NM

# -- A100-class constants (per SM cluster of 16 SMs; estimates, documented)
SMS_PER_CLUSTER = 16
PEAK_FLOPS = 46e12           # bf16 FMA throughput of one SM cluster
HBM_BW = 250e9               # B/s, one cluster's slice of HBM bandwidth
HBM_PJ_PER_BYTE = 6.5        # HBM2e access energy
MAC_PJ = 1.1                 # bf16 MAC incl. operand routing / tensor core
DEQUANT_PJ = 0.3             # fp8/int8 -> bf16 up-convert per weight use
# Pool static power models only the INCREMENTAL cost of keeping the SM
# cluster pinned at its operating point (rail leakage + HBM refresh of the
# resident shard), not whole-board idle draw: decode is memory-bound, so
# the placement trade-off must stay dynamic-dominated for Eq. (1)'s DP
# (which, verbatim from the paper, optimizes dynamic energy only) to
# remain near-optimal - the same regime the edge Table V constants are in.
IDLE_W = 3.5                 # SM cluster pinned at clock, holding bf16
SLEEP_W = 0.5                # retention sleep (fp8/int8-resident pool)
HBM_GB_PER_CLUSTER = 8       # capacity slice per SM cluster

LP_CLOCK = 0.45              # default DVFS point of the low-power pool

#: registered per-tech-node physics of this pool family (DESIGN.md SS.10)
TECH = SM_POOL_7NM
#: rail voltage floor as a fraction of nominal - now owned by the
#: TechModel; kept as a module constant for compatibility
V_MIN_FRAC = TECH.v_min_frac


def dvfs_energy_scale(clock: float) -> float:
    """Dynamic-energy scale at a DVFS frequency scale ``clock``.

    Voltage tracks frequency linearly down to the retention floor
    (``V = V_MIN_FRAC + (1 - V_MIN_FRAC) * clock`` of nominal) and
    switching energy goes as ``V^2`` - the standard DVFS model, and the
    same shape the paper's 1.2 V / 0.8 V HP/LP split instantiates.
    Delegates to the registered :data:`TECH` model
    (:mod:`repro_torch.core.techmodel`), whose arithmetic is byte-identical
    to the historic inline expression.
    """
    return TECH.energy_scale(clock)


def _mem(kind: str, clock: float, energy: float) -> sp.MemorySpec:
    """One residency precision on one pool's HBM slice.

    ``mram`` = fp8/int8 (1 byte/use + dequant, non-volatile analogue),
    ``sram`` = bf16 (2 bytes/use, pool pinned while holding).
    """
    bytes_per_use = 1 if kind == "mram" else 2
    read_ns = bytes_per_use / HBM_BW / clock * 1e9
    read_pj = bytes_per_use * HBM_PJ_PER_BYTE * energy
    if kind == "mram":
        read_pj += DEQUANT_PJ * energy
    static_w = SLEEP_W if kind == "mram" else IDLE_W
    return sp.MemorySpec(
        kind, read_ns=read_ns, write_ns=4 * read_ns,
        read_mw=read_pj / read_ns, write_mw=read_pj / (2 * read_ns),
        static_mw=static_w * 1e3 * energy,       # W -> mW
        volatile=(kind == "sram"),
        capacity_bytes=HBM_GB_PER_CLUSTER * 2 ** 30)


def _pe(clock: float, energy: float) -> sp.PESpec:
    op_s = 2.0 / PEAK_FLOPS / clock              # one MAC = 2 flops
    op_ns = op_s * 1e9
    return sp.PESpec(op_ns=op_ns, dyn_mw=MAC_PJ * energy / op_ns,
                     static_mw=0.0)


def gpu_arch(n_hp_clusters: int = 8, n_lp_clusters: int = 8, *,
             lp_clock: float = LP_CLOCK) -> sp.PIMArch:
    """HP/LP SM-cluster pools x {bf16, fp8/int8} residency as a PIMArch."""
    lp_energy = dvfs_energy_scale(lp_clock)
    hp = sp.ClusterSpec("hp", _pe(1.0, 1.0), n_hp_clusters, ())
    lp = sp.ClusterSpec("lp", _pe(lp_clock, lp_energy), n_lp_clusters, ())

    def spaces_for(c: sp.ClusterSpec, clock: float,
                   energy: float) -> tuple:
        mram = _mem("mram", clock, energy)
        sram = _mem("sram", clock, energy)
        return (
            sp.StorageSpace(f"{c.name}_mram", c.name, mram, sram, c.pe,
                            c.n_modules),
            sp.StorageSpace(f"{c.name}_sram", c.name, sram, sram, c.pe,
                            c.n_modules),
        )

    hp = dataclasses.replace(hp, spaces=spaces_for(hp, 1.0, 1.0))
    lp = dataclasses.replace(lp, spaces=spaces_for(lp, lp_clock, lp_energy))
    return sp.PIMArch("gpu_pool", (hp, lp))
