"""``repro_torch.core.substrate`` - one parametric interface over placement
substrates.

DESIGN.md SS.3 proves Eq. (1) of the paper is substrate-agnostic:
Algorithms 1/2 only need per-space ``(t_i, e_i)``. A :class:`Substrate`
bundles everything an entry point needs to instantiate the stack for one
hardware platform - the :class:`~repro_torch.core.spaces.PIMArch`, a
``model_spec(workload)`` mapping, the energy model, the LUT builder
(through the pluggable :mod:`repro_torch.core.solvers`), and
``apply_placement`` (functional weight migration, where the platform has
one) - behind a string-keyed registry:

  ================== ==================================================
  ``edge-hhpim``     HH-PIM (Table I row 4), dynamic closed-form solver
  ``edge-hetero``    Heterogeneous-PIM, fixed balanced-SRAM policy
  ``edge-hybrid``    Hybrid-PIM, fixed MRAM-resident policy
  ``edge-baseline``  Baseline-PIM, fixed all-SRAM policy
  ``tpu-pool``       HP/LP TPU chip pools x {bf16, int8} residency
  ``tpu-pool-mixed`` same, heterogeneous fleet shapes (odd engines half)
  ``gpu-pool``       HP/LP GPU SM-cluster pools at two DVFS points x
                     {bf16, fp8/int8} HBM residency (``lp_clock`` knob)
  ``gpu-pool-mixed`` same, heterogeneous fleet shapes (odd engines half)
  ``cxl-tier``       HP/LP node pools x {node-local DDR, CXL-attached}
                     residency (edge-to-cloud memory tiering)
  ``cxl-tier-3``     THREE pools - HBM / node-DDR / CXL-attached far
                     (DVFS-scaled) - solved through the K-pool
                     min-plus combine (repro_torch.core.multipool)
  ``cxl-tier-3-mixed`` same, heterogeneous fleet shapes (odd engines
                     get half of all THREE pools, floored at 1)
  ================== ==================================================

Adding a backend is one :func:`register_substrate` call (DESIGN.md SS.5);
use :mod:`repro_torch.api` to construct schedulers/engines/fleets from a name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.core import spaces as sp
from repro_torch.core import workloads
from repro_torch.core.energy import EnergyModel, Placement
from repro_torch.core.placement import PlacementLUT
from repro_torch.core.solvers import make_solver
from repro_torch.device import DEFAULT_DEVICE


class Substrate:
    """Protocol: everything Eq. (1) needs from one hardware platform."""

    name: str
    arch: sp.PIMArch
    rho: float
    solver: str                      # default solver registry key
    lut_points: int
    # True when the substrate can drive a functional serve engine
    # (api.engine / api.fleet(decode=True)); accounting-only otherwise
    supports_decode = False
    # window the LUT charges volatile-residency static energy over:
    # "t_constraint" (paper's per-task accounting) or "t_slice" (serving
    # pools with a pinned slice length - see GPUPoolSubstrate)
    static_window = "t_constraint"
    # registered TechModel name (repro_torch.core.techmodel) where the
    # substrate has a DVFS axis; None = fixed-voltage platform (the
    # edge archs' HP/LP split is baked into Table I constants)
    tech: Optional[str] = None

    # -- technology / DVFS axis (DESIGN.md SS.10) --------------------------
    def tech_model(self):
        """The registered :class:`~repro_torch.core.techmodel.TechModel`
        behind this substrate's DVFS axis, or None on fixed-voltage
        platforms."""
        if self.tech is None:
            return None
        from repro_torch.core.techmodel import get_tech_model
        return get_tech_model(self.tech)

    def with_clock(self, clock: float) -> "Substrate":
        """This substrate re-pointed to DVFS scale ``clock`` (clamped
        into the TechModel's operating bounds). The clocked variant has
        a distinct ``variant_key()``, so grid points never collide in a
        shared compiler cache."""
        tm = self.tech_model()
        if tm is None or not hasattr(self, "lp_clock"):
            raise ValueError(
                f"substrate {self.name!r} has no DVFS axis (tech="
                f"{self.tech!r}); register a TechModel and an lp_clock "
                f"field to make the clock a solved variable")
        return dataclasses.replace(self, lp_clock=tm.clamp(clock))

    # -- workload mapping --------------------------------------------------
    def model_spec(self, workload=None, **hint) -> sp.ModelSpec:
        """Resolve a workload handle (name / ModelSpec / ModelConfig) to
        the substrate's :class:`~repro_torch.core.spaces.ModelSpec`. Extra
        keywords are substrate-specific hints (e.g. ``tokens_per_task``)."""
        raise NotImplementedError

    # -- modeling ----------------------------------------------------------
    def energy_model(self, workload=None, *, rho: Optional[float] = None,
                     time_scale=None) -> EnergyModel:
        return EnergyModel(self.arch, self.model_spec(workload),
                           rho=self.rho if rho is None else rho,
                           time_scale=time_scale)

    def default_t_slice_ns(self, workload=None, *,
                           rho: Optional[float] = None) -> float:
        raise NotImplementedError

    def build_lut(self, workload=None, *, solver=None,
                  t_slice_ns: Optional[float] = None,
                  n_points: Optional[int] = None,
                  rho: Optional[float] = None,
                  compiler=None, device=DEFAULT_DEVICE) -> PlacementLUT:
        """Build the placement LUT through the (or the named) solver; a
        :class:`~repro_torch.core.compiler.PlacementCompiler` routes the
        build through its shared cache instead. A solver named by string
        builds on ``device``."""
        em = self.energy_model(workload, rho=rho)
        if t_slice_ns is None:
            t_slice_ns = self.default_t_slice_ns(em.model, rho=rho)
        n = self.lut_points if n_points is None else n_points
        sol = make_solver(solver or self.solver, device=device)
        if compiler is not None:
            return compiler.lut(em, solver=sol,
                                t_slice_ns=t_slice_ns, n_points=n,
                                static_window=self.static_window,
                                variant_key=self.variant_key())
        return sol.build_lut(em, t_slice_ns=t_slice_ns, n_points=n,
                             static_window=self.static_window)

    # -- functional placement ----------------------------------------------
    def apply_placement(self, placement: Placement, sink=None) -> bool:
        """Apply ``placement`` to the functional weight store ``sink``
        (e.g. a serve engine). Accounting-only substrates return False -
        placement lives purely in the energy/timing model."""
        return False

    # -- fleet shaping -----------------------------------------------------
    def engine_variant(self, index: int) -> "Substrate":
        """Substrate for fleet engine ``index`` (homogeneous: self)."""
        return self

    def variant_key(self) -> tuple:
        """Hashable shape key; engines sharing it share one LUT and one
        :class:`~repro_torch.core.compiler.PlacementCompiler` cache entry. The
        default fingerprints the arch's space shaping, so substrates of
        the same name built with different arch kwargs (module/bank
        counts) never collide in a shared compiler cache."""
        return (self.name,) + tuple(
            (s.name, s.n_modules, s.banks_per_module)
            for s in self.arch.spaces)

    def replace(self, **kw) -> "Substrate":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EdgeSubstrate(Substrate):
    """The paper's edge-PIM platforms (Tables I/III/V constants).

    ``reference_arch`` sizes the default time slice: the paper's
    comparison protocol gives every arch the slice that fits
    ``workloads.PEAK_TASKS`` inferences at *HH-PIM* peak performance, so
    savings are measured under identical deadlines.
    """

    name: str
    arch: sp.PIMArch
    rho: float = 1.0
    solver: str = "closed-form"
    lut_points: int = 64
    reference_arch: Optional[sp.PIMArch] = None

    def model_spec(self, workload=None, **hint) -> sp.ModelSpec:
        if workload is None:
            return sp.EFFICIENTNET_B0
        if isinstance(workload, sp.ModelSpec):
            return workload
        if isinstance(workload, str):
            try:
                return sp.TINYML_MODELS[workload]
            except KeyError:
                raise ValueError(
                    f"unknown TinyML workload {workload!r}; one of "
                    f"{sorted(sp.TINYML_MODELS)}") from None
        raise TypeError(f"cannot interpret workload {workload!r} for "
                        f"substrate {self.name}")

    def default_t_slice_ns(self, workload=None, *,
                           rho: Optional[float] = None,
                           headroom: float = 1.01) -> float:
        model = self.model_spec(workload)
        em = EnergyModel(self.reference_arch or self.arch, model,
                         rho=self.rho if rho is None else rho)
        t_peak = em.task_cost(em.peak_placement(sram_only=True)).t_task_ns
        return t_peak * workloads.PEAK_TASKS * headroom


class ServePoolSubstrate(Substrate):
    """Shared protocol of the serving pool substrates (``tpu-pool``,
    ``gpu-pool``): an HP and an LP compute pool with per-precision HBM
    weight residency as the storage spaces, decoded through a functional
    ``HeteroServeEngine`` (DESIGN.md SS.3/SS.5). Subclasses supply the
    pool fields, the arch builder and the mixed-fleet shaping; workload
    mapping (serving ModelConfig -> task spec), slice sizing, mixed-fleet
    shaping (via ``_POOL_FIELDS``) and functional placement application
    are identical across pools."""

    supports_decode = True
    #: names of the dataclass fields holding the pool sizes (chips / SM
    #: clusters / nodes), one per cluster; the shared fleet-shaping
    #: methods below operate on whatever - and however many - fields
    #: the subclass declares (2 for the HP/LP pools, 3 for the
    #: three-tier ``cxl-tier-3``).
    _POOL_FIELDS = ("n_hp", "n_lp")

    def _pool_counts(self) -> Tuple[int, ...]:
        return tuple(getattr(self, f) for f in self._POOL_FIELDS)

    def pool_plan(self, index: int) -> Tuple[int, ...]:
        """Per-cluster pool sizes of fleet engine ``index``:
        ``mixed=True`` gives odd-indexed engines half of each pool
        (floored at 1)."""
        counts = self._pool_counts()
        if self.mixed and index % 2 == 1:
            return tuple(max(c // 2, 1) for c in counts)
        return counts

    def engine_variant(self, index: int) -> "ServePoolSubstrate":
        counts = self.pool_plan(index)
        if counts == self._pool_counts():
            return self
        return dataclasses.replace(self, mixed=False,
                                   **dict(zip(self._POOL_FIELDS, counts)))

    def variant_key(self) -> tuple:
        """(name, *pool sizes[, lp_clock]) - pool sizes fully determine
        the arch, plus the DVFS point where the pool has one (engines
        at different DVFS points must not share a LUT)."""
        key = (self.name,) + self._pool_counts()
        lp_clock = getattr(self, "lp_clock", None)
        if lp_clock is not None:
            key += (round(lp_clock, 4),)
        return key

    def tier_plan(self) -> Tuple[Tuple[str, str, str], ...]:
        """Ordered ``(space_name, tier_name, format)`` triples driving
        the serve engine's functional column split
        (:mod:`repro_torch.models.hetero_linear`). Default mapping: volatile
        residency decodes in bf16, non-volatile residency in int8 (the
        tpu/gpu pool convention - the legacy hp_bf16/.../lp_int8
        order). CXL substrates override with int8/int8 tier pairs."""
        plan = []
        for c in self.arch.clusters:
            for kind, fmt in (("sram", "bf16"), ("mram", "int8")):
                for s in c.spaces:
                    if s.mem.kind == kind:
                        plan.append((s.name, f"{c.name}_{fmt}", fmt))
        return tuple(plan)

    def model_spec(self, workload=None, **hint) -> sp.ModelSpec:
        if isinstance(workload, sp.ModelSpec):
            return workload
        from repro_torch.serve.hetero import tpu_model_spec
        if workload is None:
            from repro_torch.configs import get_smoke_config
            workload = get_smoke_config("internlm2_1_8b")
        tokens = hint.get("tokens_per_task") or self.tokens_per_task
        return tpu_model_spec(workload, tokens)

    def default_t_slice_ns(self, workload=None, *,
                           rho: Optional[float] = None) -> float:
        from repro_torch.serve.hetero import default_t_slice_ms
        return default_t_slice_ms(
            self.arch, self.model_spec(workload),
            rho=self.rho if rho is None else rho,
            peak_tasks=self.peak_tasks) * 1e6

    def apply_placement(self, placement: Placement, sink=None) -> bool:
        """Re-tier the sink engine's weights (real re-quantization and
        column splits); accounting-only when no sink is attached."""
        if sink is None:
            return False
        return sink.apply_placement(placement)


@dataclasses.dataclass(frozen=True)
class TPUPoolSubstrate(ServePoolSubstrate):
    """HP/LP TPU chip pools with {bf16, int8} weight residency as the
    storage spaces (DESIGN.md SS.3). ``mixed=True`` makes
    :meth:`engine_variant` give odd-indexed fleet engines half the chips
    (the heterogeneous-pool serving scenario)."""

    name: str = "tpu-pool"
    n_hp_chips: int = 4
    n_lp_chips: int = 4
    tokens_per_task: int = 8
    rho: float = 64.0
    solver: str = "closed-form"
    lut_points: int = 32
    peak_tasks: int = workloads.PEAK_TASKS
    mixed: bool = False
    arch: sp.PIMArch = dataclasses.field(init=False, compare=False)

    _POOL_FIELDS = ("n_hp_chips", "n_lp_chips")

    def __post_init__(self):
        from repro_torch.serve.hetero import tpu_arch
        object.__setattr__(self, "arch",
                           tpu_arch(self.n_hp_chips, self.n_lp_chips))


@dataclasses.dataclass(frozen=True)
class GPUPoolSubstrate(ServePoolSubstrate):
    """HP/LP GPU SM-cluster pools at two DVFS operating points with
    {bf16, fp8/int8} HBM residency as the storage spaces (DESIGN.md SS.5,
    constants in :mod:`repro_torch.serve.gpu`).

    ``lp_clock`` is the DVFS sweep knob: the LP pool's frequency scale in
    (0, 1]. Lowering it stretches LP per-op latency as ``1/lp_clock`` and
    shrinks LP dynamic/static energy as ``dvfs_energy_scale(lp_clock)``,
    so sweeping it traces the energy-vs-latency frontier on this backend
    (``examples/placement_sweep.py``). ``mixed=True`` gives odd-indexed
    fleet engines half the SM clusters of each pool.

    The LUT charges volatile (bf16) residency statics over the full slice
    (``static_window="t_slice"``): a serving pool runs a pinned slice
    length, so a pool holding bf16 shards stays at its operating point for
    all of ``T`` regardless of the per-task constraint. This also keeps
    the LUT's ranking consistent with realized slice energy, which the
    dp/closed-form agreement check relies on."""

    static_window = "t_slice"
    tech = "sm-pool-7nm"         # repro_torch.serve.gpu.TECH

    name: str = "gpu-pool"
    n_hp_clusters: int = 8
    n_lp_clusters: int = 8
    lp_clock: float = 0.45          # repro_torch.serve.gpu.LP_CLOCK
    tokens_per_task: int = 8
    rho: float = 64.0
    solver: str = "closed-form"
    lut_points: int = 32
    peak_tasks: int = workloads.PEAK_TASKS
    mixed: bool = False
    arch: sp.PIMArch = dataclasses.field(init=False, compare=False)

    _POOL_FIELDS = ("n_hp_clusters", "n_lp_clusters")

    def __post_init__(self):
        from repro_torch.serve.gpu import gpu_arch
        object.__setattr__(self, "arch",
                           gpu_arch(self.n_hp_clusters, self.n_lp_clusters,
                                    lp_clock=self.lp_clock))


@dataclasses.dataclass(frozen=True)
class CXLTierSubstrate(ServePoolSubstrate):
    """HP/LP node pools with {node-local DDR, CXL-attached} residency as
    the volatile/non-volatile storage-space pair (constants in
    :mod:`repro_torch.serve.cxl`; after Oliveira et al., PAPERS.md).

    The edge-to-cloud tiering scenario: weights are INT8 in both tiers,
    so the placement trade is pure locality (local DDR bandwidth, but
    refresh + PHY stay up while holding) versus standby power (the CXL
    expander powers down in retention when its pool idles, but every
    read pays the link premium). ``lp_clock`` scales the efficiency
    pool's node clock exactly as on the GPU pools. Decode-capable:
    weights are INT8 in both tiers, so :meth:`tier_plan` maps every
    space to an int8/int8 tier pair and a placement change re-tiers
    real weight columns through ``HeteroServeEngine`` just like the
    TPU/GPU pools (what moves is the column split, not the format)."""

    static_window = "t_slice"    # pinned-slice pools: see GPUPoolSubstrate
    tech = "cxl-node-10nm"       # repro_torch.serve.cxl.TECH

    name: str = "cxl-tier"
    n_hp_nodes: int = 4
    n_lp_nodes: int = 4
    lp_clock: float = 0.5        # repro_torch.serve.cxl.LP_CLOCK
    tokens_per_task: int = 8
    rho: float = 32.0
    solver: str = "closed-form"
    lut_points: int = 32
    peak_tasks: int = workloads.PEAK_TASKS
    mixed: bool = False
    arch: sp.PIMArch = dataclasses.field(init=False, compare=False)

    _POOL_FIELDS = ("n_hp_nodes", "n_lp_nodes")

    def __post_init__(self):
        from repro_torch.serve.cxl import cxl_arch
        object.__setattr__(self, "arch",
                           cxl_arch(self.n_hp_nodes, self.n_lp_nodes,
                                    lp_clock=self.lp_clock))

    def tier_plan(self) -> Tuple[Tuple[str, str, str], ...]:
        """INT8 in both residency tiers: DDR-local ("sram") and CXL-far
        ("mram") spaces both decode through the W8A8 kernel, so a
        placement change is a pure column move between int8 segments."""
        tier = {"sram": "ddr", "mram": "cxl"}
        plan = []
        for c in self.arch.clusters:
            for kind in ("sram", "mram"):
                for s in c.spaces:
                    if s.mem.kind == kind:
                        plan.append((s.name,
                                     f"{c.name}_{tier[kind]}_int8", "int8"))
        return tuple(plan)


@dataclasses.dataclass(frozen=True)
class CXLTier3Substrate(ServePoolSubstrate):
    """Three-tier memory hierarchy as three compute pools - HBM
    accelerator nodes / node-DDR standard nodes / a DVFS-scaled far
    pool behind the CXL link (``repro_torch.serve.cxl.cxl_arch3``; after
    Oliveira et al., PAPERS.md).

    The first 3-cluster substrate: the LUT builders solve it through
    the K-pool min-plus combine (:mod:`repro_torch.core.multipool`,
    DESIGN.md SS.7) on both the closed-form and the kernel-backed DP
    path. Each pool anchors one residency tier, so the placement
    decision is a genuine three-way split over the hierarchy: HBM
    (fast, highest standby while holding), node DDR (mid), CXL far
    memory (link premium per read, retention power-down when idle,
    DVFS-scaled compute via ``lp_clock``). Decode-capable like
    ``cxl-tier``: all three tiers are int8 segments, so placement
    changes re-tier real weight columns."""

    static_window = "t_slice"    # pinned-slice pools: see GPUPoolSubstrate
    tech = "cxl-node-10nm"       # far pool rides the CXL node curve

    name: str = "cxl-tier-3"
    n_hbm_nodes: int = 2
    n_ddr_nodes: int = 4
    n_cxl_nodes: int = 4
    lp_clock: float = 0.5        # far-pool DVFS scale
    tokens_per_task: int = 8
    rho: float = 32.0
    solver: str = "closed-form"
    lut_points: int = 32
    peak_tasks: int = workloads.PEAK_TASKS
    mixed: bool = False
    arch: sp.PIMArch = dataclasses.field(init=False, compare=False)

    _POOL_FIELDS = ("n_hbm_nodes", "n_ddr_nodes", "n_cxl_nodes")

    def __post_init__(self):
        from repro_torch.serve.cxl import cxl_arch3
        object.__setattr__(self, "arch",
                           cxl_arch3(self.n_hbm_nodes, self.n_ddr_nodes,
                                     self.n_cxl_nodes,
                                     lp_clock=self.lp_clock))

    def tier_plan(self) -> Tuple[Tuple[str, str, str], ...]:
        """One int8 tier per pool (hbm/ddr/cxl): a 3-way column split."""
        return tuple((c.spaces[0].name, f"{c.name}_int8", "int8")
                     for c in self.arch.clusters)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SubstrateFactory = Callable[..., Substrate]
SUBSTRATES: Dict[str, SubstrateFactory] = {}


def register_substrate(name: str, factory: SubstrateFactory) -> None:
    SUBSTRATES[name] = factory


def make_substrate(name: Union[str, Substrate], **over) -> Substrate:
    """Build a substrate by registry name; keyword overrides go to the
    factory (e.g. ``rho=``, ``n_hp_chips=``). Instances pass through
    (overrides applied via ``dataclasses.replace``)."""
    if isinstance(name, Substrate):
        return name.replace(**over) if over else name
    if name not in SUBSTRATES:
        raise ValueError(
            f"unknown substrate {name!r}; one of {sorted(SUBSTRATES)}")
    return SUBSTRATES[name](**over)


def available_substrates() -> Tuple[str, ...]:
    return tuple(sorted(SUBSTRATES))


def list_substrates() -> Tuple[str, ...]:
    """Every registered substrate name, sorted. The CI substrate-smoke
    job iterates this and runs LUT build + one scheduler slice per entry,
    so a broken registry entry fails CI."""
    return available_substrates()


def _edge_factory(name: str, arch_builder: Callable[..., sp.PIMArch],
                  solver: str) -> SubstrateFactory:
    def factory(*, rho: float = 1.0, solver: str = solver,
                lut_points: int = 64, **arch_kw) -> EdgeSubstrate:
        return EdgeSubstrate(name=name, arch=arch_builder(**arch_kw),
                             rho=rho, solver=solver, lut_points=lut_points,
                             reference_arch=sp.hh_pim())
    return factory


def _tpu_factory(name: str, mixed: bool) -> SubstrateFactory:
    def factory(**kw) -> TPUPoolSubstrate:
        return TPUPoolSubstrate(name=name, mixed=mixed, **kw)
    return factory


register_substrate("edge-hhpim",
                   _edge_factory("edge-hhpim", sp.hh_pim, "closed-form"))
register_substrate("edge-hetero",
                   _edge_factory("edge-hetero", sp.hetero_pim,
                                 "fixed-hetero"))
register_substrate("edge-hybrid",
                   _edge_factory("edge-hybrid", sp.hybrid_pim,
                                 "fixed-hybrid"))
register_substrate("edge-baseline",
                   _edge_factory("edge-baseline", sp.baseline_pim,
                                 "fixed-baseline"))
def _gpu_factory(name: str, mixed: bool) -> SubstrateFactory:
    def factory(**kw) -> GPUPoolSubstrate:
        return GPUPoolSubstrate(name=name, mixed=mixed, **kw)
    return factory


def _cxl_factory(**kw) -> CXLTierSubstrate:
    return CXLTierSubstrate(**kw)


def _cxl3_factory(**kw) -> CXLTier3Substrate:
    return CXLTier3Substrate(**kw)


def _cxl3_mixed_factory(**kw) -> CXLTier3Substrate:
    # the generalized _POOL_FIELDS machinery halves all three pools for
    # odd-indexed engines (floored at 1); variant_key() keeps half- and
    # full-shape engines on separate LUT cache entries
    return CXLTier3Substrate(name="cxl-tier-3-mixed", mixed=True, **kw)


register_substrate("tpu-pool", _tpu_factory("tpu-pool", mixed=False))
register_substrate("tpu-pool-mixed",
                   _tpu_factory("tpu-pool-mixed", mixed=True))
register_substrate("gpu-pool", _gpu_factory("gpu-pool", mixed=False))
register_substrate("gpu-pool-mixed",
                   _gpu_factory("gpu-pool-mixed", mixed=True))
register_substrate("cxl-tier", _cxl_factory)
register_substrate("cxl-tier-3", _cxl3_factory)
register_substrate("cxl-tier-3-mixed", _cxl3_mixed_factory)
