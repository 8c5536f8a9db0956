"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains the reduced (smoke) config of the chosen architecture end-to-end
with the full substrate: synthetic data, AdamW, async atomic
checkpoints, SIGTERM-preemption safety and resume, on ``--device``
(``cuda`` by default; ``cpu`` runs the same code on the host). ``--full``
takes the architecture's full config as the dry-run lowers it
(``launch.specs.dryrun_config``: bf16 compute, scanned stack, remat);
on one H100 that is a real full-width run.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import signal

from repro_torch.configs import ARCH_IDS, canonical, get_config, \
    get_smoke_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.device import resolve as resolve_device
from repro_torch.launch.specs import dryrun_config
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.step import default_optimizer_kind
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b",
                    help=f"one of {ARCH_IDS}")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config (bf16, scanned, "
                         "remat)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (dryrun_config(get_config(args.arch))
           if args.full else get_smoke_config(args.arch))
    print(f"arch={canonical(args.arch)} layers={cfg.n_layers} "
          f"d={cfg.d_model} optimizer={default_optimizer_kind(cfg)}")

    trainer = Trainer(
        cfg,
        OptimizerConfig(kind=default_optimizer_kind(cfg), lr=1e-3,
                        warmup_steps=10, total_steps=args.steps),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                   global_batch=args.global_batch),
        TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 4, 1),
                      ckpt_dir=args.ckpt_dir,
                      grad_compression=args.compress_grads),
        device=dev)

    # preemption safety: SIGTERM checkpoints at the next step boundary
    signal.signal(signal.SIGTERM, lambda *_: trainer.request_stop())
    if trainer.maybe_resume():
        print(f"resumed at step {trainer.step}")

    out = trainer.run()
    print(f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} in "
          f"{out['steps']} steps "
          f"({out['median_step_s']*1e3:.0f} ms/step median, "
          f"{out['straggler_steps']} stragglers)")


if __name__ == "__main__":
    main()
