"""Roofline analysis per (arch x shape x mesh) cell, for H100 meshes.

The JAX package's analytic per-op counter, unchanged: FLOPs and HBM bytes
as the lowered step executes them (chunked-attention full-rectangle
scores, MoE capacity slack, remat recompute, CE-chunk recompute). The
port's dry run (:mod:`.dryrun`) counts FLOPs with ``FlopCounterMode`` on
every op it runs, loops included; tests hold those counts to this
counter on reduced configs. Collective bytes per device come from the
dry run's record (:mod:`.collectives`).

Hardware constants, one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit): 989e12 bf16 FLOP/s and 3.35e12 HBM bytes/s.
The collective term divides each device's collective bytes by 50e9 B/s,
one 400 Gb/s InfiniBand NDR link per GPU: the 16-wide ``model`` axis
spans two 8-GPU nodes, so its collectives cross the inter-node network,
whose per-GPU link is the slowest hop (NVLink inside a node is 900 GB/s).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.specs import SHAPES, cell_is_applicable, \
    dryrun_config
from repro_torch.models.common import ModelConfig

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
CHIPS = {"single": 256, "multi": 512}
ATTN_CHUNK = 512


def param_count(cfg: ModelConfig) -> Dict[str, float]:
    """Per-component parameter counts (matches lm.init_lm structure)."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    glu = cfg.mlp_act in ("swiglu", "geglu")
    ffn_dense = (3 if glu else 2) * d * cfg.d_ff
    rglru = 5 * d * d + 4 * d               # in_x,in_g,a,x,out + conv
    mlstm = d * cfg.n_heads * hd * 5 + 2 * d * cfg.n_heads
    slstm = 5 * d * d
    per_kind = {"attn": attn, "rglru": rglru, "mlstm": mlstm,
                "slstm": slstm}
    pattern = cfg.pattern_for_depth()
    mix = sum(per_kind[k] for k in pattern)
    ffn = 0.0
    moe = 0.0
    for k in pattern:
        if k in ("mlstm", "slstm") and not cfg.d_ff:
            continue
        if cfg.n_experts and k == "attn":
            moe += cfg.n_experts * 3 * d * cfg.d_ff + d * cfg.n_experts
            if cfg.moe_dense_ff:
                ffn += (3 if glu else 2) * d * cfg.moe_dense_ff
        else:
            ffn += ffn_dense
    enc = 0.0
    if cfg.is_encdec:
        enc = cfg.n_encoder_layers * (attn + ffn_dense)
        mix += len(pattern) * attn          # decoder cross attention
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return {"mix": mix, "ffn": ffn, "moe": moe, "enc": enc, "embed": embed,
            "total": mix + ffn + moe + enc + embed}


def active_params(cfg: ModelConfig) -> float:
    """Per-token active params (MoE: top-k experts only)."""
    pc = param_count(cfg)
    active_moe = 0.0
    if cfg.n_experts:
        active_moe = pc["moe"] * cfg.experts_per_token / cfg.n_experts
    return pc["mix"] + pc["ffn"] + active_moe + pc["enc"] + pc["embed"]


@dataclasses.dataclass
class CellCost:
    flops: float          # global per step, as executed by the HLO
    hbm_bytes: float      # global per step
    model_flops: float    # 6*N_active*D reference (train) / 2*N*D (serve)


def _attn_flops_fwd(cfg: ModelConfig, B: int, S: int) -> float:
    """Scores+PV fwd FLOPs, as executed: chunked path computes the FULL
    S x S rectangle (masked blocks included); local path S x (W + chunk)."""
    width = cfg.n_heads * cfg.hd
    f = 0.0
    for k in cfg.pattern_for_depth():
        if k != "attn":
            continue
        if cfg.attn_kind == "local" and cfg.local_window < S:
            kspan = cfg.local_window + ATTN_CHUNK
        else:
            kspan = S
        f += 4.0 * B * S * kspan * width
    return f


def _recurrent_flops_fwd(cfg: ModelConfig, B: int, S: int) -> float:
    f = 0.0
    for k in cfg.pattern_for_depth():
        if k == "mlstm":
            f += 5.0 * B * S * cfg.n_heads * cfg.hd * cfg.hd
        elif k in ("rglru", "slstm"):
            f += 12.0 * B * S * cfg.d_model      # elementwise recurrences
    return f


def _matmul_flops_fwd(cfg: ModelConfig, B: int, S: int) -> float:
    """All projection/FFN/MoE/logits matmuls, fwd, as executed."""
    pc = param_count(cfg)
    moe_exec = 0.0
    if cfg.n_experts:
        # capacity-slotted GEMMs: E*C rows with C = tb*k/E * cf
        moe_exec = (pc["moe"] - cfg.d_model * cfg.n_experts) \
            * cfg.experts_per_token / cfg.n_experts * cfg.moe_capacity_factor
        moe_exec += cfg.d_model * cfg.n_experts          # router
    dense = pc["mix"] + pc["ffn"] + pc["enc"]
    head = cfg.vocab_size * cfg.d_model                  # lm head matmul
    return 2.0 * B * S * (dense + moe_exec + head)


def _enc_attn_extra(cfg: ModelConfig, B: int, S: int) -> float:
    if not cfg.is_encdec:
        return 0.0
    Se = max(S // cfg.enc_len_divisor, 1)
    width = cfg.n_heads * cfg.hd
    enc_self = 4.0 * B * Se * Se * width * cfg.n_encoder_layers
    cross = 4.0 * B * S * Se * width * cfg.n_layers
    return enc_self + cross


def train_cost(cfg: ModelConfig, S: int, B: int, n_micro: int) -> CellCost:
    fwd = (_matmul_flops_fwd(cfg, B, S) + _attn_flops_fwd(cfg, B, S)
           + _recurrent_flops_fwd(cfg, B, S) + _enc_attn_extra(cfg, B, S))
    # fwd + bwd(2x) + remat recompute of fwd (checkpointed blocks + CE)
    flops = fwd * 4.0
    N = param_count(cfg)["total"]
    pbytes = N * 2.0
    D = B * S
    hbm = (3 * pbytes                       # weights: fwd + remat + bwd
           + 2 * n_micro * pbytes           # grad accumulation r/w
           + 6 * pbytes                     # optimizer read/write + states
           + 10.0 * B * S * cfg.d_model * 2 * cfg.n_layers)  # act streams
    return CellCost(flops, hbm, 6.0 * active_params(cfg) * D)


def prefill_cost(cfg: ModelConfig, S: int, B: int) -> CellCost:
    fwd = (_matmul_flops_fwd(cfg, B, S) + _attn_flops_fwd(cfg, B, S)
           + _recurrent_flops_fwd(cfg, B, S) + _enc_attn_extra(cfg, B, S))
    # last-position-only head: subtract the full-seq head matmul, add 1 pos
    fwd -= 2.0 * B * (S - 1) * cfg.vocab_size * cfg.d_model
    N = param_count(cfg)["total"]
    hbm = N * 2.0 + 8.0 * B * S * cfg.d_model * 2 * cfg.n_layers
    return CellCost(fwd, hbm, 2.0 * active_params(cfg) * B * S)


def decode_cost(cfg: ModelConfig, S: int, B: int) -> CellCost:
    """One token per sequence with a KV/recurrent state of length S."""
    fwd = (_matmul_flops_fwd(cfg, B, 1) + _recurrent_flops_fwd(cfg, B, 1))
    kv_bytes = 0.0
    width_kv = cfg.n_kv_heads * cfg.hd
    for k in cfg.pattern_for_depth():
        if k == "attn":
            span = min(S, cfg.local_window) if cfg.attn_kind == "local" \
                else S
            fwd += 4.0 * B * span * cfg.n_heads * cfg.hd
            kv_bytes += 2.0 * B * span * width_kv * 2  # read k+v, bf16
        elif k == "mlstm":
            fwd += 5.0 * B * cfg.n_heads * cfg.hd * cfg.hd
            kv_bytes += 2.0 * B * cfg.n_heads * cfg.hd * cfg.hd * 4
        elif k in ("rglru", "slstm"):
            kv_bytes += 4.0 * B * cfg.d_model * 4
    if cfg.is_encdec:
        Se = max(S // cfg.enc_len_divisor, 1)
        fwd += 4.0 * B * Se * cfg.n_heads * cfg.hd * cfg.n_layers
        kv_bytes += 2.0 * B * Se * cfg.d_model * 2
    N = param_count(cfg)["total"]
    hbm = N * 2.0 + kv_bytes
    return CellCost(fwd, hbm, 2.0 * active_params(cfg) * B)


def cell_cost(cfg: ModelConfig, shape: str, n_micro: int = 8) -> CellCost:
    S, B, kind = SHAPES[shape]
    if kind == "train":
        return train_cost(cfg, S, B, n_micro)
    if kind == "prefill":
        return prefill_cost(cfg, S, B)
    return decode_cost(cfg, S, B)


def roofline_row(arch: str, shape: str, mesh_kind: str,
                 dryrun_dir: Path) -> Optional[Dict]:
    cfg = get_config(arch)
    ok, why = cell_is_applicable(cfg, shape)
    rec_file = dryrun_dir / f"{arch}__{shape}__{mesh_kind}.json"
    rec = json.loads(rec_file.read_text()) if rec_file.exists() else {}
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped", "why": why}
    chips = CHIPS[mesh_kind]
    cost = cell_cost(dryrun_config(cfg), shape,
                     n_micro=rec.get("microbatches", 8))
    compute_s = cost.flops / (chips * PEAK_FLOPS)
    memory_s = cost.hbm_bytes / (chips * HBM_BW)
    coll_bytes = rec.get("collectives", {}).get("total", 0.0)
    collective_s = coll_bytes / LINK_BW         # per-device bytes / link BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = compute_s / bound if bound > 0 else 0.0
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "ok",
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "roofline_fraction": frac,
        "model_flops": cost.model_flops, "hlo_flops": cost.flops,
        "useful_ratio": cost.model_flops / cost.flops,
        "mem_gib_per_dev": round(
            (rec.get("memory", {}).get("argument_size_in_bytes", 0)
             + rec.get("memory", {}).get("temp_size_in_bytes", 0)) / 2**30,
            2),
        "coll_bytes_per_dev": coll_bytes,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="experiments/roofline_torch.json")
    args = ap.parse_args(argv)
    rows = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            row = roofline_row(arch, shape, args.mesh,
                               Path(args.dryrun_dir))
            rows.append(row)
            if row["status"] == "ok":
                print(f"{arch:24s} {shape:12s} "
                      f"C={row['compute_s']*1e3:9.3f}ms "
                      f"M={row['memory_s']*1e3:9.3f}ms "
                      f"X={row['collective_s']*1e3:9.3f}ms "
                      f"dom={row['dominant']:10s} "
                      f"frac={row['roofline_fraction']:.3f} "
                      f"useful={row['useful_ratio']:.2f}")
            else:
                print(f"{arch:24s} {shape:12s} skipped")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
