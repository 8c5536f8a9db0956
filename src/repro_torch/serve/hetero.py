"""HH-PIM serving runtime on TPU pools: the arch builders.

The SAME placement engine (EnergyModel + LUT + TimeSliceScheduler from
``repro_torch.core``) runs here with a TPU parameterization instead of
Table III/V: ``tpu_arch()`` builds a PIMArch whose two clusters are the
HP pool (n_hp chips, full clock) and LP pool (n_lp chips, DVFS-scaled
clock/energy) and whose memory kinds are weight-residency formats - bf16
("SRAM": 2 HBM-bytes/use, pool pinned on while holding) and int8
("MRAM": 1 byte/use plus dequant, pool may sleep when idle). Eq. (1) is
isomorphic; only (t_i, e_i) change. See DESIGN.md SS.3.

Only the numpy arch builders are ported so far; the functional
``HeteroServeEngine`` of ``repro.serve.hetero`` comes with the serving
slice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import spaces as sp
from repro_torch.models.common import ModelConfig

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
