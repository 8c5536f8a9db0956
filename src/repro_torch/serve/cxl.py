"""CXL-tier re-parameterization of Eq. (1) - the edge-to-cloud memory
tiering substrate (ROADMAP item; after Oliveira et al., "Accelerating
NN Inference with Processing-in-DRAM", PAPERS.md).

Oliveira et al. argue edge-to-cloud PIM viability hinges on cheap
re-optimization as workloads move across memory tiers; this substrate
instantiates exactly that tier pair for the placement engine:

- **Clusters**: an HP pool of performance nodes at full clock and an LP
  pool of efficiency nodes at ``lp_clock`` of it (voltage tracking
  frequency, the same DVFS voltage curve as the GPU pools, owned by
  the registered :data:`TECH` model - see :mod:`repro_torch.core.techmodel`).
- **Memory kinds as residency tiers**: node-local DDR residency is the
  "SRAM" tier (the node's DRAM channels stay active while holding
  weights: refresh + PHY, i.e. volatile), CXL-attached residency is the
  "MRAM" tier (far memory behind the CXL link; reads pay the link's
  latency/SerDes-energy premium, but the expander can drop to deep
  power-down when the pool idles, i.e. non-volatile). Weights are INT8
  in both tiers - unlike the bf16/int8 pools, the trade is purely
  locality vs standby power, the Oliveira et al. DRAM-tiering trade.
  ``rho`` is the batch reuse of one weight fetch.

Eq. (1) is isomorphic - Algorithms 1/2 only see per-space ``(t_i,
e_i)`` - so ``cxl_arch()`` builds a :class:`~repro_torch.core.spaces.PIMArch`
from the constants below and the whole placement stack runs unchanged.
Constants are documented DDR5/CXL-1.1-class estimates per node.

``cxl_arch3()`` deepens the hierarchy to THREE pools (HBM accelerator
nodes / node-DDR standard nodes / a DVFS-scaled far pool behind the
CXL link), each anchoring one residency tier - the first 3-cluster
arch, solved through the K-pool min-plus combine
(:mod:`repro_torch.core.multipool`, DESIGN.md SS.7).

This module is import-light on purpose (no jax): the substrate registry
builds archs from it without pulling in the serving runtime.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import spaces as sp
from repro_torch.core.techmodel import CXL_NODE_10NM

#: registered per-tech-node physics of the CXL node pools (DESIGN.md
#: SS.10). The voltage curve matches the GPU pools' (this module
#: historically imported ``repro_torch.serve.gpu.dvfs_energy_scale``), so
#: existing LUTs are byte-identical; only the DVFS operating bounds
#: differ (node fabrics hold a higher frequency floor).
TECH = CXL_NODE_10NM


def dvfs_energy_scale(clock: float) -> float:
    """Dynamic-energy scale at frequency scale ``clock`` - the
    registered :data:`TECH` model's ``V^2`` curve."""
    return TECH.energy_scale(clock)

# -- per-node constants (documented estimates) ------------------------------
PEAK_FLOPS = 4e12            # INT8 MAC throughput of one node's engine
DDR_BW = 64e9                # B/s, local DDR5 channels of one node
CXL_BW = 24e9                # B/s, the node's CXL.mem link share
DDR_PJ_PER_BYTE = 12.0       # device + controller access energy
CXL_PJ_PER_BYTE = 21.0       # DDR on the expander + link SerDes both ways
MAC_PJ = 2.0                 # INT8 MAC incl. operand routing
# Incremental standby power of keeping a residency tier live (same
# dynamic-dominated regime as the other pool substrates): local DDR must
# keep refresh + channel PHY up while holding weights; the CXL expander
# supports deep power-down with retention when its pool idles.
DDR_IDLE_W = 9.0             # node DDR channels active, holding weights
CXL_SLEEP_W = 1.5            # expander in retention power-down
DDR_GB_PER_NODE = 32         # local capacity slice
CXL_GB_PER_NODE = 128        # far-memory capacity slice

LP_CLOCK = 0.5               # default clock scale of the efficiency pool

# -- three-tier (cxl-tier-3) constants --------------------------------------
# An accelerator-node pool whose weights sit in on-package HBM: the
# fastest, most access-efficient tier, but the stack's PHY + controller
# stay powered while it holds data (volatile, like local DDR).
HBM_BW = 819e9               # B/s per node (HBM2e-class stack share)
HBM_PJ_PER_BYTE = 5.0        # on-package access energy
HBM_GB_PER_NODE = 16         # HBM capacity slice per node
# Three-tier statics model only the INCREMENTAL cost of pinning a
# residency tier on - the refresh + PHY share attributable to the held
# weight shard (a model is a sliver of a 16-128 GB tier), not
# whole-channel idle draw. Same rationale as repro_torch.serve.gpu.IDLE_W:
# the placement trade must stay dynamic-dominated for the paper's
# dynamic-only DP to remain near-optimal - the multipool
# dp-vs-closed-form CI gate holds at <= ~1% deviation with identical
# deadline behaviour in this regime (it degrades to ~10% with
# whole-channel statics, where the statics-aware closed-form argmin
# departs from the DP's in the near-tie mid-constraint region).
# (DDR_IDLE_W above stays as the 2-pool cxl-tier's whole-channel
# constant for LUT compatibility.)
HBM_PIN_W = 0.2              # stack PHY + refresh share of the shard
DDR_PIN_W = 0.15             # channel refresh + PHY share while holding
CXL_RETENTION_W = 0.05       # expander retention power-down


def _mem(kind: str, energy: float) -> sp.MemorySpec:
    """One residency tier on one node: ``sram`` = local DDR (volatile),
    ``mram`` = CXL-attached (non-volatile analogue). INT8 weights, one
    byte per use in both tiers; link bandwidth does not scale with the
    node's DVFS point, only node-side compute does."""
    bw = DDR_BW if kind == "sram" else CXL_BW
    pj_byte = DDR_PJ_PER_BYTE if kind == "sram" else CXL_PJ_PER_BYTE
    cap_gb = DDR_GB_PER_NODE if kind == "sram" else CXL_GB_PER_NODE
    static_w = DDR_IDLE_W if kind == "sram" else CXL_SLEEP_W
    read_ns = 1.0 / bw * 1e9
    return sp.MemorySpec(
        kind, read_ns=read_ns, write_ns=4 * read_ns,
        read_mw=pj_byte / read_ns, write_mw=pj_byte / (2 * read_ns),
        static_mw=static_w * 1e3 * energy,       # W -> mW
        volatile=(kind == "sram"),
        capacity_bytes=cap_gb * 2 ** 30)


def _pe(clock: float, energy: float) -> sp.PESpec:
    op_ns = 1.0 / PEAK_FLOPS / clock * 1e9       # one INT8 MAC
    return sp.PESpec(op_ns=op_ns, dyn_mw=MAC_PJ * energy / op_ns,
                     static_mw=0.0)


def cxl_arch(n_hp_nodes: int = 4, n_lp_nodes: int = 4, *,
             lp_clock: float = LP_CLOCK) -> sp.PIMArch:
    """HP/LP node pools x {local DDR, CXL-attached} residency as a
    PIMArch."""
    lp_energy = dvfs_energy_scale(lp_clock)
    hp = sp.ClusterSpec("hp", _pe(1.0, 1.0), n_hp_nodes, ())
    lp = sp.ClusterSpec("lp", _pe(lp_clock, lp_energy), n_lp_nodes, ())

    def spaces_for(c: sp.ClusterSpec, energy: float) -> tuple:
        mram = _mem("mram", energy)
        sram = _mem("sram", energy)
        return (
            sp.StorageSpace(f"{c.name}_mram", c.name, mram, sram, c.pe,
                            c.n_modules),
            sp.StorageSpace(f"{c.name}_sram", c.name, sram, sram, c.pe,
                            c.n_modules),
        )

    hp = dataclasses.replace(hp, spaces=spaces_for(hp, 1.0))
    lp = dataclasses.replace(lp, spaces=spaces_for(lp, lp_energy))
    return sp.PIMArch("cxl_tier", (hp, lp))


def _tier_mem(kind: str, bw: float, pj_byte: float, cap_gb: int,
              static_w: float, energy: float) -> sp.MemorySpec:
    """One residency tier of the three-tier hierarchy. ``kind`` carries
    the volatility semantics the placement engine keys on: ``sram`` =
    stays powered while holding (HBM stack / DDR refresh+PHY), ``mram``
    = retention power-down when the pool idles (CXL expander)."""
    read_ns = 1.0 / bw * 1e9
    return sp.MemorySpec(
        kind, read_ns=read_ns, write_ns=4 * read_ns,
        read_mw=pj_byte / read_ns, write_mw=pj_byte / (2 * read_ns),
        static_mw=static_w * 1e3 * energy,       # W -> mW
        volatile=(kind == "sram"),
        capacity_bytes=cap_gb * 2 ** 30)


def cxl_arch3(n_hbm_nodes: int = 2, n_ddr_nodes: int = 4,
              n_cxl_nodes: int = 4, *,
              lp_clock: float = LP_CLOCK) -> sp.PIMArch:
    """Three-tier memory hierarchy as THREE compute pools: an HBM pool
    (accelerator nodes, on-package residency), a node-DDR pool (standard
    nodes, local-DDR residency) and a DVFS-scaled far pool behind the
    CXL link (expander residency, retention power-down when idle).

    Each pool anchors one residency tier, so placement across the
    hierarchy is a genuine 3-cluster split - the first substrate to
    exercise the K-pool min-plus combine
    (:mod:`repro_torch.core.multipool`). Every pool reads activations from a
    node-local DDR I/O buffer (the cross-tier analogue of the SRAM I/O
    role in the edge archs)."""
    far_energy = dvfs_energy_scale(lp_clock)

    def pool(name: str, n: int, clock: float, energy: float,
             mem: sp.MemorySpec) -> sp.ClusterSpec:
        c = sp.ClusterSpec(name, _pe(clock, energy), n, ())
        io = _tier_mem("sram", DDR_BW, DDR_PJ_PER_BYTE, DDR_GB_PER_NODE,
                       DDR_PIN_W, energy)      # node-local activation path
        space = sp.StorageSpace(f"{name}_{mem.kind}", name, mem, io,
                                c.pe, c.n_modules)
        return dataclasses.replace(c, spaces=(space,))

    hbm = pool("hbm", n_hbm_nodes, 1.0, 1.0,
               _tier_mem("sram", HBM_BW, HBM_PJ_PER_BYTE,
                         HBM_GB_PER_NODE, HBM_PIN_W, 1.0))
    ddr = pool("ddr", n_ddr_nodes, 1.0, 1.0,
               _tier_mem("sram", DDR_BW, DDR_PJ_PER_BYTE,
                         DDR_GB_PER_NODE, DDR_PIN_W, 1.0))
    cxl = pool("cxl", n_cxl_nodes, lp_clock, far_energy,
               _tier_mem("mram", CXL_BW, CXL_PJ_PER_BYTE,
                         CXL_GB_PER_NODE, CXL_RETENTION_W, far_energy))
    return sp.PIMArch("cxl_tier3", (hbm, ddr, cxl))
