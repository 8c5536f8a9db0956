"""The port's train step, Trainer and training launcher against the JAX
package, on the CPU.

* ``make_train_step`` with 1 and 4 microbatches (fp32 and bf16
  accumulators): the loss within LOSS_RTOL; the first moment (0.1 x the
  clipped gradient) leaf by leaf as the gradients are held in
  tests/test_torch_train.py; the params within the sign-flip bound.
* ``Trainer``: five steps on the reference trainer's params and data,
  per-step losses within TRAINER_RTOL, with and without gradient
  compression; the reference's own trainer tests mirrored (loss
  decreases, resume continuity, preemption stop, compression converges).
* ``launch/train.py --device cpu``: its first line equal to the
  reference's; SIGTERM stops at a step boundary with a checkpoint, and a
  second run resumes from it. Without a card the entry points raise.
"""
import os
import re
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch import train as jax_train_cli  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train import step as jax_step  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import DataConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import init_error_state  # noqa: E402
from repro_torch.train import step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

from test_torch_families import _numpy_tree  # noqa: E402
from test_torch_train import (GRAD_RTOL, LOSS_RTOL,  # noqa: E402
                              assert_grads_close, make_batch, torch_batch)

# five AdamW steps on the same params and batches: each step's update is
# ~lr * sign(g), so an entry whose gradient is rounding noise moves by up
# to 2 * lr in one package against the other; the loss feels that as a
# change far below 1e-4 of its value
TRAINER_RTOL = 1e-4
# four microbatch gradients summed in bf16: each add may round to the
# other neighbour of its fp32 sum in one package, one bf16 ulp (2^-8
# relative) per add
BF16_ACCUM_RTOL = 4 * 2.0 ** -8
# the same steps of one package on one device, resumed from a checkpoint
RESUME_RTOL = 1e-5


def _tiny_cfgs():
    kw = dict(name="tiny", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
              head_dim=16, scan_layers=False, remat=False)
    return (JModelConfig(dtype=jnp.float32, **kw),
            ModelConfig(dtype=torch.float32, **kw))


def _tiny_trainer(tmp_path=None, steps=30, compression=False, seed=0):
    """The reference's ``tests/test_train_serve.py::_tiny_trainer`` on
    the port, on the CPU."""
    _, cfg = _tiny_cfgs()
    return Trainer(
        cfg,
        adamw.OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=steps,
                              weight_decay=0.0),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                   seed=seed),
        TrainerConfig(steps=steps, ckpt_every=10,
                      ckpt_dir=str(tmp_path) if tmp_path else None,
                      grad_compression=compression),
        device="cpu")


# -- make_train_step ---------------------------------------------------------


@pytest.mark.parametrize("n,accum", [(1, "float32"), (4, "float32"),
                                     (4, "bfloat16")])
def test_train_step_matches_jax(n, accum):
    cfg_j, cfg_t = jax_smoke("internlm2_1_8b"), get_smoke_config(
        "internlm2_1_8b")
    b = make_batch(cfg_j, np.random.default_rng(n), B=4, S=8)
    kw = dict(lr=0.01, warmup_steps=1, total_steps=10)
    opt_j = jax_adamw.make_optimizer(jax_adamw.OptimizerConfig(**kw))
    opt_t = adamw.make_optimizer(adamw.OptimizerConfig(**kw))
    pj = jax_lm.init_lm(jax.random.PRNGKey(0), cfg_j)
    pt = lm.params_from_numpy(_numpy_tree(pj), "cpu")
    p0 = jax.tree_util.tree_map(np.asarray, pj)
    fn_j = jax.jit(jax_step.make_train_step(
        cfg_j, opt_j, n, getattr(jnp, accum)))
    new_j, sj, mj = fn_j(pj, opt_j.init(pj),
                         {k: jnp.asarray(v) for k, v in b.items()})
    fn_t = step.make_train_step(cfg_t, opt_t, n, getattr(torch, accum))
    new_t, st, mt = fn_t(pt, opt_t.init(pt), torch_batch(b))
    assert sorted(mt) == sorted(mj)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=LOSS_RTOL)
    assert_grads_close(st["m"], sj["m"],
                       BF16_ACCUM_RTOL if accum == "bfloat16" else GRAD_RTOL)
    assert_grads_close(st["v"], sj["v"],
                       BF16_ACCUM_RTOL if accum == "bfloat16" else GRAD_RTOL)
    # params: the first update is ~lr * sign(g), the sign of a gradient
    # that is rounding noise may differ: at most 2 * lr apart
    for (path, a), (_, c) in zip(
            jax.tree_util.tree_leaves_with_path(new_j),
            jax.tree_util.tree_leaves_with_path(new_t)):
        d = np.abs(np.asarray(a) - c.numpy())
        assert d.max() <= 2 * 0.01 * (1 + 1e-5), path
    moved = sum(int((np.asarray(a) != b_).sum()) for a, b_ in zip(
        jax.tree_util.tree_leaves(new_j), jax.tree_util.tree_leaves(p0)))
    assert moved > 0


def test_value_and_grad_gives_zeros_for_unused_leaves():
    """A leaf the loss never reaches gets a zero gradient, as
    ``jax.value_and_grad`` gives, and the params keep no autograd
    state."""
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    params["unused"] = torch.ones((3, 2))
    b = torch_batch(make_batch(cfg, np.random.default_rng(0)))
    (loss, metrics), grads = step.value_and_grad(step.make_loss_fn(cfg),
                                                 params, b)
    assert torch.equal(grads["unused"], torch.zeros((3, 2)))
    assert not loss.requires_grad and not params["embed"].requires_grad
    assert float(grads["embed"].abs().max()) > 0
    assert sorted(metrics) == ["aux", "loss", "tokens"]


def test_default_plans_match_jax():
    """Over the architectures both packages list (the port's registry
    also has deepseek_v2_lite, which the JAX package lacks)."""
    from repro.configs import ARCH_IDS as JAX_ARCHS
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in [a for a in ARCH_IDS if a in JAX_ARCHS]:
        cj, ct = jax_config(arch), get_config(arch)
        assert step.default_optimizer_kind(ct) == \
            jax_step.default_optimizer_kind(cj)
        for gb in (1, 6, 8, 256):
            a = step.default_train_memory_plan(ct, gb)
            r = jax_step.default_train_memory_plan(cj, gb)
            assert a["num_microbatches"] == r["num_microbatches"]
            assert str(a["accum_dtype"]).split(".")[-1] == \
                jnp.dtype(r["accum_dtype"]).name
        full = specs.dryrun_config(ct)
        assert (full.dtype, full.scan_layers, full.remat) == \
            (torch.bfloat16, True, True)
        mesh = type("Mesh", (), {"shape": {"pod": 2, "data": 4,
                                           "model": 8}})()
        assert specs.dryrun_config(ct, mesh).moe_dispatch_blocks == 8
        assert specs.dryrun_config(ct, mesh).act_dp_axes == ("pod", "data")
        assert specs.SHAPES == jax_specs.SHAPES
        for shape in specs.SHAPES:
            assert specs.cell_is_applicable(ct, shape) == \
                jax_specs.cell_is_applicable(cj, shape)


# -- Trainer against the reference trainer ------------------------------------


@pytest.mark.parametrize("compression", [False, True],
                         ids=["plain", "compressed"])
def test_trainer_matches_jax(compression):
    cfg_j, cfg_t = _tiny_cfgs()
    okw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    dkw = dict(vocab_size=128, seq_len=32, global_batch=8, seed=3)
    tj = JTrainer(cfg_j, jax_adamw.OptimizerConfig(**okw), JDataConfig(**dkw),
                  JTrainerConfig(steps=5, grad_compression=compression))
    p0 = jax.tree_util.tree_map(np.asarray, tj.params)
    out_j = tj.run()
    tt = Trainer(cfg_t, adamw.OptimizerConfig(**okw), DataConfig(**dkw),
                 TrainerConfig(steps=5, grad_compression=compression),
                 device="cpu")
    tt.params = lm.params_from_numpy(p0, "cpu")
    tt.opt_state = tt.opt.init(tt.params)
    if compression:
        tt.error_state = init_error_state(tt.params)
    out_t = tt.run()
    losses_j = [m["loss"] for m in tj.metrics_log]
    losses_t = [m["loss"] for m in tt.metrics_log]
    np.testing.assert_allclose(losses_t, losses_j, rtol=TRAINER_RTOL)
    assert out_t["steps"] == out_j["steps"] == 5
    assert sorted(out_t) == sorted(out_j)


def test_trainer_loss_decreases(tmp_path):
    out = _tiny_trainer(tmp_path).run()
    assert out["final_loss"] < out["first_loss"] * 0.9
    assert out["steps"] == 30


def test_trainer_resume_continuity(tmp_path):
    t1 = _tiny_trainer(tmp_path, steps=20)
    t1.run()
    t1._ckpt.wait()
    t2 = _tiny_trainer(tmp_path, steps=25)
    assert t2.maybe_resume()
    assert t2.step == 20
    out = t2.run()
    assert out["steps"] == 25


def test_trainer_resumed_steps_equal_an_uninterrupted_run(tmp_path):
    """A run of 25 steps stopped after 20 (final checkpoint) and resumed
    by a fresh Trainer takes steps 21-25 as the uninterrupted run does,
    within RESUME_RTOL (the CPU's embedding backward adds duplicate
    tokens' rows in a thread-dependent order, so two runs may differ in
    the last bit)."""
    t1 = _tiny_trainer(tmp_path, steps=25)
    t1.tcfg.steps = 20
    t1.run()
    t2 = _tiny_trainer(tmp_path, steps=25)
    assert t2.maybe_resume() and t2.step == 20
    t2.run()
    t3 = _tiny_trainer(None, steps=25)
    t3.run()
    np.testing.assert_allclose([m["loss"] for m in t2.metrics_log],
                               [m["loss"] for m in t3.metrics_log[20:]],
                               rtol=RESUME_RTOL)


def test_trainer_preemption_stop(tmp_path):
    t = _tiny_trainer(tmp_path, steps=1000)
    orig_step = t._step_fn

    def stepper(*a, **k):
        if t.step >= 5:
            t.request_stop()
        return orig_step(*a, **k)

    t._step_fn = stepper
    out = t.run()
    assert out["steps"] <= 7      # stopped promptly
    t._ckpt.wait()
    assert ckpt.latest_step(tmp_path) == out["steps"]


def test_trainer_with_compression_converges():
    base = _tiny_trainer(None, steps=30, seed=1).run()
    comp = _tiny_trainer(None, steps=30, compression=True, seed=1).run()
    assert comp["final_loss"] < comp["first_loss"] * 0.9
    # compressed path tracks the uncompressed one loosely
    assert comp["final_loss"] < base["final_loss"] * 1.5 + 0.5


# -- launch/train.py ------------------------------------------------------


def test_launch_train_first_line_matches_jax(monkeypatch, capsys):
    old = signal.getsignal(signal.SIGTERM)
    try:
        monkeypatch.setattr(sys, "argv", ["train", "--steps", "2"])
        jax_train_cli.main()
        ref = capsys.readouterr().out.splitlines()
        train_cli.main(["--steps", "2", "--device", "cpu"])
        ours = capsys.readouterr().out.splitlines()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert ours[0] == ref[0] == \
        "arch=internlm2_1_8b layers=2 d=64 optimizer=adamw"
    pat = r"loss \d+\.\d{4} -> \d+\.\d{4} in 2 steps \(\d+ ms/step " \
          r"median, \d+ stragglers\)"
    assert re.fullmatch(pat, ours[1]) and re.fullmatch(pat, ref[1])


def test_launch_train_sigterm_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                     capsys):
    """SIGTERM (sent to this process during step 4) stops the run at the
    next step boundary with a final checkpoint; a second run resumes."""
    real = Trainer._step_fn

    def step_fn(self, *a):
        if self.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *a)
    monkeypatch.setattr(Trainer, "_step_fn", step_fn)
    old = signal.getsignal(signal.SIGTERM)
    args = ["--steps", "50", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    try:
        train_cli.main(args)
        first = capsys.readouterr().out.splitlines()
        monkeypatch.setattr(Trainer, "_step_fn", real)
        train_cli.main(["--steps", "6"] + args[2:])
        second = capsys.readouterr().out.splitlines()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert " in 4 steps " in first[1]
    assert second[1] == "resumed at step 4" and " in 6 steps " in second[2]
    assert ckpt.latest_step(tmp_path) == 6


def test_training_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract does "
                    "not apply")
    _, cfg = _tiny_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(cfg, adamw.OptimizerConfig(), DataConfig(128, 8, 2),
                TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_cli.main(["--steps", "1"])
