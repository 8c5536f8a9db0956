"""Trainer: train step + data pipeline + fault-tolerant checkpointing.

Production behaviors folded in:
  * deterministic resume (data batch i = f(seed, i), optimizer step in the
    checkpoint),
  * async, atomic checkpoints every ``ckpt_every`` steps + final sync save,
  * preemption hook: ``request_stop()`` (wired to SIGTERM by launch.train)
    checkpoints and exits cleanly at the next step boundary,
  * optional int8+error-feedback gradient compression across the DP
    reduction (cross-pod saver),
  * per-step wall-time tracking with a straggler log (steps > 2x median).

The step runs on ``device`` (``"cuda"`` by default; a CUDA request
without a card raises). Params and optimizer state are updated in place
(:mod:`repro_torch.optim.adamw`); each step ends when its loss is read
on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
from repro_torch.optim.compression import (compress_with_feedback,
                                           init_error_state)
from repro_torch.train.step import make_loss_fn, value_and_grad

PyTree = Any


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    grad_compression: bool = False
    seed: int = 0


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.opt = make_optimizer(opt_cfg)
        self.data = SyntheticLM(data_cfg)
        self.loss_fn = make_loss_fn(model_cfg)
        self._stop = False
        self.step_times: List[float] = []
        self.metrics_log: List[Dict[str, float]] = []

        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        self.params = lm.init_lm(gen, model_cfg)
        self.opt_state = self.opt.init(self.params)
        self.error_state = (init_error_state(self.params)
                            if tcfg.grad_compression else None)
        self.step = 0
        self._ckpt = (ckpt.AsyncCheckpointer(tcfg.ckpt_dir)
                      if tcfg.ckpt_dir else None)

    def _step_fn(self, params, opt_state, error_state, batch):
        (loss, _metrics), grads = value_and_grad(self.loss_fn, params,
                                                 batch)
        if self.tcfg.grad_compression:
            grads, error_state = compress_with_feedback(grads, error_state)
        new_params, new_opt = self.opt.update(grads, opt_state, params)
        return new_params, new_opt, error_state, loss

    # -- fault tolerance ---------------------------------------------------
    def request_stop(self) -> None:
        self._stop = True

    def maybe_resume(self) -> bool:
        if not self.tcfg.ckpt_dir:
            return False
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        state = ckpt.restore({"params": self.params,
                              "opt": self.opt_state,
                              "step": np.zeros((), np.int32)},
                             self.tcfg.ckpt_dir, last)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = int(state["step"])
        return True

    def _save(self, final: bool = False) -> None:
        if not self._ckpt:
            return
        tree = {"params": self.params, "opt": self.opt_state,
                "step": np.int32(self.step)}
        self._ckpt.save_async(tree, self.step)
        if final:
            self._ckpt.wait()

    # -- loop ---------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        while self.step < self.tcfg.steps and not self._stop:
            batch_np = self.data.batch(self.step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch_np.items()}
            t0 = time.perf_counter()
            (self.params, self.opt_state, self.error_state,
             loss) = self._step_fn(self.params, self.opt_state,
                                   self.error_state, batch)
            loss = loss.item()
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            self.step += 1
            self.metrics_log.append({"step": self.step, "loss": loss,
                                     "sec": dt})
            if self.step % self.tcfg.ckpt_every == 0:
                self._save()
        self._save(final=True)
        med = float(np.median(self.step_times)) if self.step_times else 0.0
        stragglers = sum(t > 2 * med for t in self.step_times[1:])
        return {"final_loss": self.metrics_log[-1]["loss"],
                "first_loss": self.metrics_log[0]["loss"],
                "steps": self.step, "median_step_s": med,
                "straggler_steps": stragglers}
