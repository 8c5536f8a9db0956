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
(real re-quantization + column splits, on the engine's device: on the
card one ``quant_split`` launch per shape of FFN matrix, on the CPU its
plain version, ``split_weight`` of each matrix; an MoE model's held
experts one matrix each, views of the stacked expert weights) and
decodes, so placement changes are functionally exercised, while energy
and latency are accounted by the core model. On the card the int8 tiers
run the ``pim_mac`` CUDA kernel. The decode reads ``lm.compute_copy`` of
the params, made once and shared by every engine on one params tree
(``api.fleet`` makes one for all its engines); the tiering reads the
fp32 masters.
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
from repro_torch.kernels.quant_split.ops import (MatrixTable, matrix_table,
                                                quant_split)
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
    """One *task* = decoding `tokens_per_task` tokens for one request.

    A dense model's resident weights and a token's MACs are one count:
    every layer's FFN and four d x d attention matrices. An MoE model
    holds more than a token uses: resident are the attention matrices,
    the leading dense layers' FFN and, per MoE layer, every held
    expert, the shared experts and a residual dense MLP; a token's MACs
    count of the held experts only its routed share, experts_per_token
    x held / n_experts experts a layer."""
    mats = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    if not cfg.n_experts:
        n_params = cfg.n_layers * (mats * cfg.d_model * cfg.d_ff)
        n_params += cfg.n_layers * 4 * cfg.d_model * cfg.d_model
        macs = n_params * tokens_per_task
        return sp.ModelSpec(f"{cfg.name}_serve", n_params, macs, 1.0)
    d = cfg.d_model
    n_dense = cfg.first_dense_layers
    n_moe = cfg.n_layers - n_dense
    expert = mats * d * cfg.expert_ff
    held = cfg.held_experts[1]
    always = (cfg.n_layers * 4 * d * d + n_dense * mats * d * cfg.d_ff
              + n_moe * mats * d * (cfg.moe_shared_ff + cfg.moe_dense_ff))
    n_params = always + n_moe * held * expert
    routed = n_moe * cfg.experts_per_token * held * expert // cfg.n_experts
    macs = (always + routed) * tokens_per_task
    return sp.ModelSpec(f"{cfg.name}_serve", n_params, macs, 1.0)


@dataclasses.dataclass
class HeteroSliceResult:
    report: SliceReport
    tokens: np.ndarray           # decoded token ids (n_requests,)
    retiered: bool


def _ffn_matrices(ffn):
    """(path, matrix) of every FFN matrix a placement splits, ``w_up``
    before ``w_gate``: a (d_in, d_out) leaf whole; a stacked (E, d_in,
    d_out) expert leaf as each held expert's view ``[i]`` (no copy),
    path ``(name, i)``; then the shared experts' and a residual dense
    MLP's, under ``("shared", ...)`` and ``("dense_mlp", ...)``."""
    for wname in ("w_up", "w_gate"):
        if wname not in ffn:
            continue
        w = ffn[wname]
        if w.ndim == 2:
            yield (wname,), w
        else:
            for i in range(w.shape[0]):
                yield (wname, i), w[i]
    for sub in ("shared", "dense_mlp"):
        if sub in ffn:
            for path, w in _ffn_matrices(ffn[sub]):
                yield (sub,) + path, w


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def compute_copy(cfg: ModelConfig, params, *, shared_by: int = 1):
    """``lm.compute_copy(params, cfg)``, made once for the ``shared_by``
    engines that decode from it. Traced, the span ``engine.compute_copy``
    (args: the leaves cast, their bytes, ``shared_by``)."""
    _obs = obs.enabled()
    _t0 = obs.now_ns() if _obs else 0
    copy = lm.compute_copy(params, cfg)
    if _obs:
        new = [c for c, m in zip(_leaves(copy), _leaves(params))
               if c is not m]
        obs.complete("engine.compute_copy", _t0, cat="engine",
                     args={"n_leaves": len(new),
                           "bytes": sum(t.nbytes for t in new),
                           "shared_by": shared_by})
    return copy


class HeteroServeEngine:
    """Time-sliced decode engine with placement-driven weight tiering.

    Canonically constructed through ``repro_torch.api.engine(...)``; the
    chip-count/rho keywords remain for direct use and are folded into a
    ``tpu-pool`` substrate when none is passed, as in the JAX package.

    ``device`` runs the scheduler's LUT builds, the decode state and the
    tiering; ``params`` must already live there. ``seed`` is accepted
    for the JAX package's signature and, as there, never read.
    ``compute_params`` is :func:`compute_copy` of ``params``, which the
    decode reads; an engine given none makes its own.
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 t_slice_ms: Optional[float] = None,
                 n_hp_chips: int = 4, n_lp_chips: int = 4,
                 tokens_per_task: int = 8, rho: float = 64.0,
                 max_batch: int = 16, peak_tasks: int = 10, seed: int = 0,
                 substrate=None, lut_points: Optional[int] = None,
                 compiler=None, compute_params=None,
                 device=DEFAULT_DEVICE):
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
        self.compute_params = (compute_copy(cfg, params)
                               if compute_params is None else compute_params)
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
        self._tables: Dict[tuple, MatrixTable] = {}
        self._toks = torch.zeros((max_batch,), dtype=torch.long, device=dev)
        self._state = lm.init_decode_state(cfg, max_batch, 128, device=dev)
        self._pos = 0
        self.history: List[HeteroSliceResult] = []

    # -- weight tiering ----------------------------------------------------
    def _retier(self, placement: Dict[str, int]) -> bool:
        """Re-split every FFN matrix to ``placement``. On the card one
        ``quant_split`` launch per shape of matrix, each matrix's
        segments the ``[i]`` views of its stacked outputs; on the CPU the
        kernel's plain version, ``split_weight`` of each matrix."""
        if placement == self._tiered_placement:
            return False
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        K = self.model_spec.n_params
        space_to_tier = {s: t for s, t, _ in self._tier_plan}
        formats = {t: f for _, t, f in self._tier_plan}
        order = tuple(t for _, t, _ in self._tier_plan)
        share = {space_to_tier[k]: v for k, v in placement.items()}
        keys, groups = [], {}
        # walks the stack's entries as the JAX package does: a "scan"
        # group holds its blocks one level down, so a scanned stack tiers
        # no matrix there either (ROADMAP reference note (c)). Each held
        # expert's matrix is split as a dense one is, where the JAX
        # package fails on the stacked leaf (note (e))
        stack = self.params["stack"]
        n_expert = 0
        for lname, layer in stack.items():
            ffn = layer.get("ffn") if isinstance(layer, dict) else None
            if not ffn:
                continue
            for path, w in _ffn_matrices(ffn):
                keys.append(((lname,) + path, tuple(w.shape)))
                groups.setdefault(tuple(w.shape), []).append(
                    w.float().contiguous())
                n_expert += isinstance(path[-1], int)
        # the old placement's tiers go before the new ones are written,
        # so a migration never holds two sets
        self._tiered = self._tiered_placement = None
        # the counts depend only on d_out
        segs = {}
        for shape, ws in groups.items():
            counts = fractions_to_counts(shape[1], share, K, order=order)
            counts = {t: counts.get(t, 0) for t in order}
            if self.device.type == "cpu":
                segs[shape] = iter([split_weight(w, counts, formats=formats)
                                    for w in ws])
                continue
            out = quant_split(self._matrix_table(shape, ws), counts, formats)
            segs[shape] = iter([{t: ({"empty": True} if s.get("empty") else
                                     {f: v[i] for f, v in s.items()})
                                 for t, s in out.items()}
                                for i in range(len(ws))])
        tiers = {key: next(segs[shape]) for key, shape in keys}
        self._tiered = tiers
        self._tiered_placement = dict(placement)
        if _obs:
            # a migration = weights actually re-quantized and re-split
            obs.complete("engine.migration", _t0, cat="engine",
                         args={"placement": dict(placement),
                               "n_weights": len(tiers),
                               "n_expert_weights": n_expert})
            obs.counter("engine.migrations")
        return True

    def _matrix_table(self, shape: tuple, ws: List[torch.Tensor]
                      ) -> MatrixTable:
        """The pointer table of one shape's matrices, built once: it is
        rebuilt only when a matrix lies elsewhere than before (an
        expert's view is a new tensor at every walk; the table holds the
        old one, so its memory cannot have been reused)."""
        tab = self._tables.get(shape)
        if tab is None or len(tab.ws) != len(ws) or any(
                a.data_ptr() != b.data_ptr() for a, b in zip(tab.ws, ws)):
            tab = self._tables[shape] = matrix_table(ws)
        return tab

    def start_tokens(self, tokens) -> None:
        """The token each batch row decodes first (at position 0), in
        place of token 0 for every row; before the first decode only."""
        if self._pos:
            raise RuntimeError("start_tokens comes before the first decode")
        toks = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        if toks.shape != self._toks.shape:
            raise ValueError(f"start_tokens takes {self.max_batch} tokens, "
                             f"got shape {tuple(toks.shape)}")
        self._toks = toks.clone()

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
        (b)), read from ``compute_params``, where they are already in the
        compute dtype; ``tiered_forward`` runs the tiered weights.

        Traced, ``engine.decode`` holds two spans that tile it: the
        host enqueueing the step (``.dispatch``) and the host blocked on
        the card for its tokens (``.wait``), which also waits for
        whatever was queued before the step, such as a migration."""
        _obs = obs.enabled()
        _t0 = obs.now_ns() if _obs else 0
        logits, self._state = lm.decode_step(
            self.compute_params, self.cfg, self._state, self._toks,
            self._pos)
        self._toks = torch.argmax(logits, dim=-1)
        _t1 = obs.now_ns() if _obs else 0
        toks = self._toks[:n_requests].cpu().numpy().astype(np.int32)
        if _obs:
            # the parent first: it shares its start with ``.dispatch``,
            # and viewers nest same-start events in the order recorded
            _t2 = obs.now_ns()
            obs.complete("engine.decode", _t0, cat="engine",
                         args={"n_requests": n_requests}, t_end_ns=_t2)
            obs.complete("engine.decode.dispatch", _t0, cat="engine",
                         t_end_ns=_t1)
            obs.complete("engine.decode.wait", _t1, cat="engine",
                         t_end_ns=_t2)
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
