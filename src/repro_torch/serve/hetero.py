"""HH-PIM serving runtime on TPU pools: the arch builders.

The SAME placement engine (EnergyModel + LUT + TimeSliceScheduler from
``repro_torch.core``) runs here with a TPU parameterization instead of
Table III/V: ``tpu_arch()`` builds a PIMArch whose two clusters are the
HP pool (n_hp chips, full clock) and LP pool (n_lp chips, DVFS-scaled
clock/energy) and whose memory kinds are weight-residency formats - bf16
("SRAM": 2 HBM-bytes/use, pool pinned on while holding) and int8
("MRAM": 1 byte/use plus dequant, pool may sleep when idle). Eq. (1) is
isomorphic; only (t_i, e_i) change. See DESIGN.md SS.3.

``HeteroServeEngine`` actually re-tiers the model weights every time slice
(real re-quantization + column splits via models.hetero_linear, on the
engine's device) and decodes, so placement changes are functionally
exercised, while energy and latency are accounted by the core model. On
the card the int8 tiers run the ``pim_mac`` CUDA kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import spaces as sp
from repro_torch.core.scheduler import SliceReport, TimeSliceScheduler
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.hetero_linear import (fractions_to_counts,
                                              split_weight, tiered_matmul)

# -- TPU v5e-class constants (per chip; estimates, documented) --------------
PEAK_FLOPS = 197e12          # bf16
HBM_BW = 819e9               # B/s
HBM_PJ_PER_BYTE = 5.0
MAC_PJ = 0.8                 # bf16 MAC incl. systolic overhead
IDLE_W_PER_CHIP = 60.0       # pool kept powered while holding bf16 shards
SLEEP_W_PER_CHIP = 8.0       # retention sleep (int8/"NVM" analogue)
LP_CLOCK = 0.6               # DVFS-scaled low-power pool
LP_ENERGY = 0.5


def _mem(kind: str, clock: float, energy: float) -> sp.MemorySpec:
    bytes_per_use = 1 if kind == "mram" else 2
    read_s = bytes_per_use / HBM_BW / clock
    read_ns = read_s * 1e9
    read_pj = bytes_per_use * HBM_PJ_PER_BYTE * energy
    static = (SLEEP_W_PER_CHIP if kind == "mram" else IDLE_W_PER_CHIP)
    return sp.MemorySpec(
        kind, read_ns=read_ns, write_ns=4 * read_ns,
        read_mw=read_pj / read_ns, write_mw=read_pj / (2 * read_ns),
        static_mw=static * 1e3 * energy,         # W -> mW
        volatile=(kind == "sram"),
        capacity_bytes=16 * 2 ** 30)             # HBM per chip


def _pe(clock: float, energy: float) -> sp.PESpec:
    op_s = 2.0 / PEAK_FLOPS / clock              # one MAC = 2 flops
    op_ns = op_s * 1e9
    return sp.PESpec(op_ns=op_ns, dyn_mw=MAC_PJ * energy / op_ns,
                     static_mw=0.0)


def tpu_arch(n_hp_chips: int = 4, n_lp_chips: int = 4) -> sp.PIMArch:
    """HP/LP chip pools x {bf16, int8} residency as a PIMArch."""
    hp = sp.ClusterSpec("hp", _pe(1.0, 1.0), n_hp_chips, ())
    lp = sp.ClusterSpec("lp", _pe(LP_CLOCK, LP_ENERGY), n_lp_chips, ())
    def spaces_for(c, clock, energy):
        mram = _mem("mram", clock, energy)
        sram = _mem("sram", clock, energy)
        return (
            sp.StorageSpace(f"{c.name}_mram", c.name, mram, sram, c.pe,
                            c.n_modules),
            sp.StorageSpace(f"{c.name}_sram", c.name, sram, sram, c.pe,
                            c.n_modules),
        )
    hp = dataclasses.replace(hp, spaces=spaces_for(hp, 1.0, 1.0))
    lp = dataclasses.replace(lp, spaces=spaces_for(lp, LP_CLOCK, LP_ENERGY))
    return sp.PIMArch("tpu_hetero", (hp, lp))


# legacy tpu/gpu mapping, kept as the engine fallback when a substrate
# does not publish a tier_plan(): (space, tier, format) in split order
_DEFAULT_TIER_PLAN = (("hp_sram", "hp_bf16", "bf16"),
                      ("hp_mram", "hp_int8", "int8"),
                      ("lp_sram", "lp_bf16", "bf16"),
                      ("lp_mram", "lp_int8", "int8"))
_SPACE_TO_TIER = {s: t for s, t, _ in _DEFAULT_TIER_PLAN}


def default_t_slice_ms(arch: sp.PIMArch, model: sp.ModelSpec, *,
                       rho: float, peak_tasks: int = 10) -> float:
    """Slice sized as the paper sizes T: fits ``peak_tasks`` tasks at peak
    performance, plus 1% headroom to absorb a migration. Shared by
    ``HeteroServeEngine`` and the ``repro_torch.api`` fleet constructors."""
    from repro_torch.core.energy import EnergyModel
    em = EnergyModel(arch, model, rho=rho)
    t_peak = em.task_cost(em.peak_placement(True)).t_task_ns
    return t_peak * peak_tasks * 1.01 / 1e6


def tpu_model_spec(cfg: ModelConfig, tokens_per_task: int) -> sp.ModelSpec:
    """One *task* = decoding `tokens_per_task` tokens for one request."""
    n_params = (cfg.n_layers
                * (3 * cfg.d_model * cfg.d_ff
                   if cfg.mlp_act in ("swiglu", "geglu")
                   else 2 * cfg.d_model * cfg.d_ff))
    n_params += cfg.n_layers * 4 * cfg.d_model * cfg.d_model
    macs = n_params * tokens_per_task
    return sp.ModelSpec(f"{cfg.name}_serve", n_params, macs, 1.0)


@dataclasses.dataclass
class HeteroSliceResult:
    report: SliceReport
    tokens: np.ndarray           # decoded token ids (n_requests,)
    retiered: bool


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class HeteroServeEngine:
    """Time-sliced decode engine with placement-driven weight tiering.

    Canonically constructed through ``repro_torch.api.engine(...)``; the
    chip-count/rho keywords remain for direct use and are folded into a
    ``tpu-pool`` substrate when none is passed, as in the JAX package.

    ``device`` runs the scheduler's LUT builds, the decode state and the
    tiering; ``params`` must already live there. ``seed`` is accepted
    for the JAX package's signature and, as there, never read.
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 t_slice_ms: Optional[float] = None,
                 n_hp_chips: int = 4, n_lp_chips: int = 4,
                 tokens_per_task: int = 8, rho: float = 64.0,
                 max_batch: int = 16, peak_tasks: int = 10, seed: int = 0,
                 substrate=None, lut_points: Optional[int] = None,
                 compiler=None, device=DEFAULT_DEVICE):
        from repro_torch.core.solvers import make_solver
        from repro_torch.core.substrate import make_substrate
        dev = resolve_device(device)
        if substrate is None:
            # rho: weight-stationary reuse on TPU = tokens sharing one
            # weight fetch per batch step (batched decode reads W once)
            substrate = make_substrate(
                "tpu-pool", n_hp_chips=n_hp_chips, n_lp_chips=n_lp_chips,
                tokens_per_task=tokens_per_task, rho=rho,
                peak_tasks=peak_tasks)
        if cfg is None:
            from repro_torch.configs import get_smoke_config
            cfg = get_smoke_config("internlm2_1_8b")
        bad = {str(t.device) for t in _leaves(params)
               if t.device.type != dev.type}
        if bad:
            raise ValueError(f"params live on {sorted(bad)}, the engine "
                             f"runs on {dev}; move them first")
        self.cfg = cfg
        self.params = params
        self.device = dev
        self.substrate = substrate
        self.arch = substrate.arch
        self.model_spec = substrate.model_spec(cfg)
        if t_slice_ms is None:
            t_slice_ms = substrate.default_t_slice_ns(self.model_spec) / 1e6
        self.t_slice_ms = t_slice_ms
        # a shared PlacementCompiler (api.fleet passes one) makes this
        # engine's LUT builds - including straggler rebuilds - hit the
        # fleet-wide cache
        self.sched = TimeSliceScheduler.from_substrate(
            substrate, self.model_spec, t_slice_ns=t_slice_ms * 1e6,
            lut_points=32 if lut_points is None else lut_points,
            solver=make_solver(substrate.solver, device=dev),
            compiler=compiler)
        self.max_batch = max_batch
        # substrate-declared (space, tier, format) split order: the cxl
        # substrates re-tier int8/int8 pairs, cxl-tier-3 a 3-way int8
        # split; tpu/gpu pools keep the legacy bf16/int8 mapping
        plan = getattr(substrate, "tier_plan", None)
        self._tier_plan = tuple(plan()) if plan else _DEFAULT_TIER_PLAN
        self._tiered: Optional[Dict] = None
        self._tiered_placement: Optional[Dict[str, int]] = None
        self._toks = torch.zeros((max_batch,), dtype=torch.long, device=dev)
        self._state = lm.init_decode_state(cfg, max_batch, 128, device=dev)
        self._pos = 0
        self.history: List[HeteroSliceResult] = []

    # -- weight tiering ----------------------------------------------------
    def _retier(self, placement: Dict[str, int]) -> bool:
        if placement == self._tiered_placement:
            return False
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        K = self.model_spec.n_params
        space_to_tier = {s: t for s, t, _ in self._tier_plan}
        formats = {t: f for _, t, f in self._tier_plan}
        order = tuple(t for _, t, _ in self._tier_plan)
        tiers = {}
        # walks the stack's entries as the JAX package does: a "scan"
        # group holds its blocks one level down, so a scanned stack tiers
        # no matrix there either (ROADMAP reference note (c))
        stack = self.params["stack"]
        for lname, layer in stack.items():
            ffn = layer.get("ffn") if isinstance(layer, dict) else None
            if not ffn:
                continue
            for wname in ("w_up", "w_gate"):
                if wname not in ffn:
                    continue
                w = ffn[wname]
                if w.ndim != 2:
                    # the JAX package hands MoE's (E, d_model, d_ff)
                    # expert weights to split_weight, whose column-count
                    # assert fails (ROADMAP reference note (e))
                    raise AssertionError(
                        f"{lname}/{wname}: expert weights {tuple(w.shape)}"
                        f" cannot be split by columns")
                counts = fractions_to_counts(
                    w.shape[-1],
                    {space_to_tier[k]: v for k, v in placement.items()},
                    K, order=order)
                tiers[(lname, wname)] = split_weight(
                    w.float(), {t: counts.get(t, 0) for t in order},
                    formats=formats)
        self._tiered = tiers
        self._tiered_placement = dict(placement)
        if _obs:
            # a migration = weights actually re-quantized and re-split
            obs.complete("engine.migration", _t0, cat="engine",
                         args={"placement": dict(placement),
                               "n_weights": len(tiers)})
            obs.counter("engine.migrations")
        return True

    def apply_placement(self, placement: Dict[str, int]) -> bool:
        """Re-tier the model weights to ``placement`` (no-op if unchanged).
        Returns True when a migration actually happened. Fleet routers call
        this with the placement chosen by an externally-driven scheduler."""
        return self._retier(placement)

    def decode(self, n_requests: int) -> np.ndarray:
        """Decode one token for ``n_requests`` active requests (public fleet
        entry point; capped at ``max_batch``)."""
        if n_requests <= 0:
            return np.zeros((0,), np.int32)
        return self._decode_tokens(min(n_requests, self.max_batch))

    def _decode_tokens(self, n_requests: int) -> np.ndarray:
        """Decode one token per active request. As in the JAX package,
        the step runs on the untiered params (ROADMAP reference note
        (b)); ``tiered_forward`` runs the tiered weights."""
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        logits, self._state = lm.decode_step(
            self.params, self.cfg, self._state, self._toks, self._pos)
        self._toks = torch.argmax(logits, dim=-1)
        toks = self._toks[:n_requests].cpu().numpy().astype(np.int32)
        if _obs:
            obs.complete("engine.decode", _t0, cat="engine",
                         args={"n_requests": n_requests})
        self._pos += 1
        return toks

    def run_slice(self, n_requests: int, *,
                  lookup_tasks: Optional[int] = None,
                  cap_to_capacity: bool = False) -> HeteroSliceResult:
        """One time slice: schedule ``n_requests`` tasks, re-tier the
        weights to the chosen placement and decode one token each.
        ``lookup_tasks`` consults the placement LUT on a predicted load
        instead of the actual backlog (proactive migration);
        ``cap_to_capacity`` executes only what fits in the slice (the
        report's ``n_executed``), for fleet-style carryover queueing."""
        n_tasks = int(np.ceil(n_requests))
        report = self.sched.step(n_tasks, lookup_tasks=lookup_tasks,
                                 cap_to_capacity=cap_to_capacity)
        retiered = self._retier(report.placement)
        toks = self._decode_tokens(min(report.n_done, self.max_batch)) \
            if report.n_done else np.zeros((0,), np.int32)
        res = HeteroSliceResult(report, toks, retiered)
        self.history.append(res)
        return res

    def tiered_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Run one tiered FFN matmul (placement-split) - the path through
        the int8 tiers' ``pim_mac`` kernel; tests use it to check the
        placement invariance of the math."""
        if not self._tiered:
            # the JAX package's ``assert self._tiered``: no tiered weights
            # before the first slice, and none in a scanned stack or
            # without FFNs (ROADMAP reference notes (c), (g))
            raise AssertionError("no tiered weights: run_slice first (a "
                                 "scanned stack or d_ff=0 tiers none)")
        key = next(iter(self._tiered))
        return tiered_matmul(x, self._tiered[key])

    # -- summaries ----------------------------------------------------------
    def energy_uj(self) -> float:
        return sum(r.report.energy_pj for r in self.history) * 1e-6

    def deadline_misses(self) -> int:
        return sum(not r.report.deadline_met for r in self.history)
