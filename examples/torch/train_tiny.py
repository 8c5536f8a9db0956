"""Train a small LM for a few hundred steps on CPU, demonstrating the
training substrate end to end: synthetic data pipeline, AdamW + cosine
schedule, loss curve, async atomic checkpointing, preemption-safe resume,
and optional int8 gradient compression.

The PyTorch port's version: the steps run on ``--device`` (``cuda`` by
default; ``cpu`` runs the same code on the host).

Run:  PYTHONPATH=src python examples/torch/train_tiny.py [--steps 200] \
          [--compress] [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.data.synthetic import DataConfig
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--compress", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="tiny_lm", family="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                      vocab_size=512, head_dim=32, dtype=torch.float32,
                      scan_layers=False, remat=False)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="hhpim_ckpt_")

    trainer = Trainer(
        cfg,
        OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                        weight_decay=0.01),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=16,
                   structure=0.85),
        TrainerConfig(steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir,
                      grad_compression=args.compress),
        device=args.device)
    if trainer.maybe_resume():
        print(f"resumed from checkpoint at step {trainer.step}")
    n_params = sum(x.numel() for x in leaves(trainer.params))
    print(f"model: {n_params/1e6:.1f} M params; steps: {args.steps}; "
          f"compression: {args.compress}; ckpt: {ckpt_dir}")

    out = trainer.run()
    for m in trainer.metrics_log[:: max(len(trainer.metrics_log) // 10, 1)]:
        print(f"  step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"{m['sec']*1e3:6.1f} ms")
    print(f"\nloss {out['first_loss']:.4f} -> {out['final_loss']:.4f} over "
          f"{out['steps']} steps "
          f"(median step {out['median_step_s']*1e3:.1f} ms, "
          f"{out['straggler_steps']} straggler steps)")
    assert out["final_loss"] < out["first_loss"], "loss must decrease"
    return trainer


if __name__ == "__main__":
    main()
