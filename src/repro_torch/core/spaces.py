"""Hardware specification of HH-PIM and the comparison PIM architectures.

All constants come verbatim from the paper:
  - Table I   : module configurations of the four evaluated architectures.
  - Table III : read/write/PE latencies (ns) at 1.2 V (HP) and 0.8 V (LP).
  - Table IV  : TinyML benchmark model characteristics.
  - Table V   : dynamic (read/write) and static power (mW) per memory type.

Units used throughout `repro_torch.core`:
  time   : nanoseconds (ns)
  power  : milliwatts  (mW)
  energy : picojoules  (pJ)   [mW x ns = pJ]
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# Memory / PE primitives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    """One memory bank type inside a PIM module."""

    kind: str            # "mram" | "sram"
    read_ns: float
    write_ns: float
    read_mw: float       # dynamic power while reading
    write_mw: float      # dynamic power while writing
    static_mw: float     # leakage per 64 kB bank
    volatile: bool       # True => loses data when power-gated
    capacity_bytes: int = 64 * 1024

    @property
    def read_pj(self) -> float:
        return self.read_ns * self.read_mw

    @property
    def write_pj(self) -> float:
        return self.write_ns * self.write_mw


@dataclasses.dataclass(frozen=True)
class PESpec:
    op_ns: float         # latency of one MAC
    dyn_mw: float
    static_mw: float

    @property
    def op_pj(self) -> float:
        return self.op_ns * self.dyn_mw


# Table III (latency, ns) + Table V (power, mW) - HP runs at 1.2 V.
HP_MRAM = MemorySpec("mram", read_ns=2.62, write_ns=11.81,
                     read_mw=428.48, write_mw=133.78, static_mw=2.98,
                     volatile=False)
HP_SRAM = MemorySpec("sram", read_ns=1.12, write_ns=1.12,
                     read_mw=508.93, write_mw=500.0, static_mw=23.29,
                     volatile=True)
HP_PE = PESpec(op_ns=5.52, dyn_mw=0.9, static_mw=0.48)

# LP runs at 0.8 V.
LP_MRAM = MemorySpec("mram", read_ns=2.96, write_ns=14.65,
                     read_mw=179.05, write_mw=47.78, static_mw=0.84,
                     volatile=False)
LP_SRAM = MemorySpec("sram", read_ns=1.41, write_ns=1.41,
                     read_mw=177.3, write_mw=177.3, static_mw=5.45,
                     volatile=True)
LP_PE = PESpec(op_ns=10.68, dyn_mw=0.51, static_mw=0.25)


# ---------------------------------------------------------------------------
# Storage spaces (the knapsack "items") and clusters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StorageSpace:
    """One of the four placement targets (e.g. HP-MRAM).

    ``io`` is the SRAM bank used as the input/output buffer of the owning
    cluster: every MAC fetches one input operand from it (paper SS.II - SRAM
    retains the I/O-buffer role of H-PIM designs).
    """

    name: str            # "hp_mram" | "hp_sram" | "lp_mram" | "lp_sram"
    cluster: str         # "hp" | "lp"
    mem: MemorySpec
    io: MemorySpec
    pe: PESpec
    n_modules: int       # banks of this type == modules in the cluster
    banks_per_module: int = 1

    # -- per-MAC characteristics (a weight-reuse factor rho >= 1 amortizes the
    #    weight fetch over rho MACs; the paper's PE is weight-per-op, rho=1).
    def op_ns(self, rho: float = 1.0) -> float:
        return self.io.read_ns + self.mem.read_ns / rho + self.pe.op_ns

    def op_pj(self, rho: float = 1.0) -> float:
        return (self.io.read_pj + self.mem.read_pj / rho + self.pe.op_pj)

    @property
    def capacity_weights(self) -> int:
        """INT8 weights storable cluster-wide in this space."""
        return self.mem.capacity_bytes * self.banks_per_module * self.n_modules

    @property
    def static_mw_total(self) -> float:
        return self.mem.static_mw * self.banks_per_module * self.n_modules


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    name: str
    pe: PESpec
    n_modules: int
    spaces: Tuple[StorageSpace, ...]   # (mram?, sram) present in each module

    @property
    def pe_static_mw_total(self) -> float:
        return self.pe.static_mw * self.n_modules

    def space(self, kind: str) -> StorageSpace:
        for s in self.spaces:
            if s.mem.kind == kind:
                return s
        raise KeyError(f"cluster {self.name} has no {kind}")


@dataclasses.dataclass(frozen=True)
class PIMArch:
    """A full PIM processor configuration (Table I row)."""

    name: str
    clusters: Tuple[ClusterSpec, ...]

    @property
    def spaces(self) -> List[StorageSpace]:
        out: List[StorageSpace] = []
        for c in self.clusters:
            out.extend(c.spaces)
        return out

    def cluster(self, name: str) -> ClusterSpec:
        for c in self.clusters:
            if c.name == name:
                return c
        raise KeyError(name)


def _mk_cluster(name: str, mram: MemorySpec | None, sram: MemorySpec,
                pe: PESpec, n_modules: int,
                sram_banks: int = 1) -> ClusterSpec:
    spaces = []
    if mram is not None:
        spaces.append(StorageSpace(f"{name}_mram", name, mram, sram, pe,
                                   n_modules))
    spaces.append(StorageSpace(f"{name}_sram", name, sram, sram, pe,
                               n_modules, banks_per_module=sram_banks))
    return ClusterSpec(name, pe, n_modules, tuple(spaces))


def hh_pim(n_hp: int = 4, n_lp: int = 4) -> PIMArch:
    """HH-PIM: 4 HP + 4 LP modules, 64 kB MRAM + 64 kB SRAM each (Table I)."""
    return PIMArch("hh_pim", (
        _mk_cluster("hp", HP_MRAM, HP_SRAM, HP_PE, n_hp),
        _mk_cluster("lp", LP_MRAM, LP_SRAM, LP_PE, n_lp),
    ))


def baseline_pim(n_modules: int = 8) -> PIMArch:
    """Baseline-PIM: 8 HP modules, 128 kB SRAM (two 64 kB banks) each."""
    return PIMArch("baseline_pim", (
        _mk_cluster("hp", None, HP_SRAM, HP_PE, n_modules, sram_banks=2),
    ))


def hetero_pim(n_hp: int = 4, n_lp: int = 4) -> PIMArch:
    """Heterogeneous-PIM: 4 HP + 4 LP modules, 128 kB SRAM each."""
    return PIMArch("hetero_pim", (
        _mk_cluster("hp", None, HP_SRAM, HP_PE, n_hp, sram_banks=2),
        _mk_cluster("lp", None, LP_SRAM, LP_PE, n_lp, sram_banks=2),
    ))


def hybrid_pim(n_modules: int = 8) -> PIMArch:
    """Hybrid-PIM (H-PIM): 8 HP modules, 64 kB MRAM + 64 kB SRAM each.

    Weights live in MRAM; SRAM is the I/O buffer (conventional H-PIM policy).
    """
    return PIMArch("hybrid_pim", (
        _mk_cluster("hp", HP_MRAM, HP_SRAM, HP_PE, n_modules),
    ))


# ---------------------------------------------------------------------------
# Benchmark workloads (Table IV)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A TinyML benchmark model (Table IV). INT8-quantized and pruned."""

    name: str
    n_params: int        # weight count (= INT8 bytes)
    n_macs: int
    pim_ratio: float     # fraction of MACs executed on the PIM

    @property
    def pim_ops(self) -> int:
        """MACs executed by the PIM fabric per inference (one *task*)."""
        return int(round(self.n_macs * self.pim_ratio))

    @property
    def ops_per_weight(self) -> float:
        return self.pim_ops / self.n_params


EFFICIENTNET_B0 = ModelSpec("efficientnet_b0", 95_000, 3_245_000, 0.85)
MOBILENET_V2 = ModelSpec("mobilenet_v2", 101_000, 2_528_000, 0.80)
RESNET_18 = ModelSpec("resnet_18", 256_000, 29_580_000, 0.75)

TINYML_MODELS: Dict[str, ModelSpec] = {
    m.name: m for m in (EFFICIENTNET_B0, MOBILENET_V2, RESNET_18)
}
