"""The port's training loss against the JAX package, on the CPU.

``lm.loss_fn`` and its gradients for every family that trains (dense,
MoE, RG-LRU hybrid, xLSTM, VLM with prefix embeddings, encoder-decoder
with encoder frames) at smoke size in fp32, on the reference's init
carried over by ``lm.params_from_numpy`` and batches made with numpy:

* the loss within LOSS_RTOL of the reference's (xlstm XLSTM_LOSS_RTOL),
* every gradient leaf within GRAD_RTOL of that leaf's largest |g|
  (xlstm XLSTM_GRAD_RTOL), by :func:`assert_grads_close`.

Also: the chunked cross-entropy (S=1024), ``cfg.remat`` and
``chunked_scan``'s checkpoints (gradients bitwise equal without them),
``quant.int8.fake_quant`` and ``data.synthetic.SyntheticLM``.
tests/test_torch_optim.py holds the optimizers, gradient compression and
checkpoints; tests/test_torch_trainer.py the train step, the Trainer and
``launch/train.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.quant.int8 import fake_quant as jax_fake_quant  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import recurrent as rec_lib  # noqa: E402
from repro_torch.quant.int8 import fake_quant  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

from test_torch_families import _numpy_tree  # noqa: E402

# fp32 smoke models: a loss is a mean of O(10) log-probabilities, each a
# sum of at most a few hundred terms taken in another order
LOSS_RTOL = 1e-5
# a gradient leaf against its own largest entry: sums of a few hundred
# products through at most 16 blocks, in another order
GRAD_RTOL = 1e-4
# xlstm's 16-block stack amplifies the rounding of each block (its
# logits are held at 5e-4 in tests/test_torch_families.py)
XLSTM_LOSS_RTOL = 5e-4
XLSTM_GRAD_RTOL = 1e-3
# a leaf whose reference gradient is below this share of the tree's
# largest |g| is cancellation noise: the mLSTM input-gate bias shifts
# every input gate of a head by one amount, which the stabilizer absorbs
# (its gradient is analytically 0 but for the |n.q| >= 1 clamp; the
# reference computes at most 3.1e-9 of the tree's largest |g|). Such a
# leaf is held to the same noise level in both packages, not to its own
# size. The smallest real leaf gradient of these models, recurrentgemma's
# w_a of one block at 4.0e-7 of the largest, is held to its own size.
NOISE_SHARE = 1e-7

FAMILIES = ["internlm2_1_8b", "arctic_480b", "llama4_scout_17b_a16e",
            "recurrentgemma_2b", "xlstm_1_3b", "seamless_m4t_medium",
            "pixtral_12b"]


def tolerances(arch):
    if arch == "xlstm_1_3b":
        return XLSTM_LOSS_RTOL, XLSTM_GRAD_RTOL
    return LOSS_RTOL, GRAD_RTOL


def assert_grads_close(ours, ref, rtol):
    """Port gradient tree ``ours`` against the reference's ``ref`` (the
    same key paths, leaf by leaf)."""
    ref_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, ref))
    our_leaves = flatten_with_path(ours)
    assert [tuple(k.key for k in p) for p, _ in ref_leaves] == \
        [p for p, _ in our_leaves]
    top = max(float(np.abs(a).max()) for _, a in ref_leaves)
    for (path, a), (_, b) in zip(ref_leaves, our_leaves):
        b = b.detach().float().numpy()
        assert a.shape == b.shape, path
        leaf = float(np.abs(a).max())
        if leaf <= NOISE_SHARE * top:
            assert float(np.abs(b).max()) <= NOISE_SHARE * top, path
        else:
            err = float(np.abs(a - b).max())
            assert err <= rtol * leaf, (jax.tree_util.keystr(path), err,
                                        leaf)


def make_batch(cfg, rng, B=2, S=8, frames=5):
    """A next-token batch and the family's extra inputs, as numpy."""
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_prefix_embeds:
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["enc_frames"] = rng.standard_normal(
            (B, frames, cfg.d_model)).astype(np.float32)
    return b


def torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cfg_j):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, cfg_j, b), has_aux=True))


def both_losses(cfg_j, cfg_t, b, seed=0):
    """((loss, metrics), grads) of both packages on the reference's init
    and batch ``b``."""
    pj = jax_lm.init_lm(jax.random.PRNGKey(seed), cfg_j)
    pt = lm.params_from_numpy(_numpy_tree(pj), "cpu")
    ref = _jax_value_and_grad(cfg_j)(pj, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    ours = value_and_grad(lambda p, bb: lm.loss_fn(p, cfg_t, bb), pt,
                          torch_batch(b))
    return ours, ref


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    b = make_batch(cfg_j, np.random.default_rng(len(arch)))
    ((lt, mt), gt), ((lj, mj), gj) = both_losses(cfg_j, cfg_t, b)
    loss_rtol, grad_rtol = tolerances(arch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=loss_rtol)
    for k in ("loss", "aux", "tokens"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=loss_rtol, atol=1e-6)
    assert (float(mj["aux"]) > 0) == bool(cfg_j.n_experts)
    assert_grads_close(gt, gj, grad_rtol)


def test_chunked_cross_entropy_matches_jax(monkeypatch):
    """S=1024 takes ``_chunked_ce`` (2 checkpointed chunks of 512) in
    both packages; a loss mask weights the tokens."""
    cfg_j = dataclasses.replace(jax_smoke("internlm2_1_8b"), vocab_size=128)
    cfg_t = dataclasses.replace(get_smoke_config("internlm2_1_8b"),
                                vocab_size=128)
    rng = np.random.default_rng(7)
    b = make_batch(cfg_j, rng, B=1, S=1024)
    b["loss_mask"] = (rng.random((1, 1024)) < 0.7).astype(np.float32)
    assert 1024 % lm._CE_CHUNK == 0 and 1024 > lm._CE_CHUNK
    calls = []
    chunked = lm._chunked_ce

    def spy(*a):
        calls.append(a[-1])
        return chunked(*a)
    monkeypatch.setattr(lm, "_chunked_ce", spy)
    ((lt, mt), gt), ((lj, mj), gj) = both_losses(cfg_j, cfg_t, b)
    assert calls == [2]
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    assert float(mt["tokens"]) == float(mj["tokens"]) == b["loss_mask"].sum()
    assert_grads_close(gt, gj, GRAD_RTOL)


# -- remat and chunked_scan: checkpoints change memory, not values ---------


def _grads_and_saved(cfg, b, seed=0):
    """Gradients of the port's loss and the bytes autograd saved for the
    backward pass while the loss was computed."""
    params = lm.init_lm(torch.Generator().manual_seed(seed), cfg)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (loss, _), grads = value_and_grad(
            lambda p, bb: lm.loss_fn(p, cfg, bb), params, torch_batch(b))
    return loss, grads, sum(saved)


REMAT_CASES = [
    ("internlm2_1_8b", (("scan_layers", True), ("n_layers", 4)), 16),
    ("internlm2_1_8b", (), 16),
    ("llama4_scout_17b_a16e", (), 16),
    # two mLSTM blocks over 256 steps: two checkpointed 128-step chunks
    ("xlstm_1_3b", (("n_layers", 2),), 256),
]


@pytest.fixture
def deterministic():
    """The CPU's embedding backward (an accumulating ``index_put_``)
    adds duplicate tokens' rows in a thread-dependent order from a few
    hundred tokens on: two runs of one config differ in the last bit
    (7e-9 at xlstm's S=256) unless torch runs its deterministic
    algorithms."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("arch,over,S", REMAT_CASES,
                         ids=["dense-scan", "dense", "moe", "xlstm"])
def test_remat_grads_bitwise_equal(arch, over, S, deterministic):
    """``remat=True`` checkpoints every block: the same loss and
    gradients bit for bit as ``remat=False``, with less saved for the
    backward pass."""
    base = dataclasses.replace(get_smoke_config(arch), **dict(over))
    b = make_batch(base, np.random.default_rng(3), B=2, S=S)
    l0, g0, saved0 = _grads_and_saved(dataclasses.replace(base,
                                                          remat=False), b)
    l1, g1, saved1 = _grads_and_saved(dataclasses.replace(base,
                                                          remat=True), b)
    assert torch.equal(l0, l1)
    for (p, a), (_, c) in zip(flatten_with_path(g0), flatten_with_path(g1)):
        assert torch.equal(a, c), p
    assert saved1 < saved0


def test_chunked_scan_checkpoint_grads_bitwise_equal():
    """``chunked_scan`` over 256 steps runs two checkpointed 128-step
    chunks while autograd records; its outputs and gradients equal the
    flat loop's (chunk >= T) bit for bit, and it saves less."""
    B, H, hd, T = 2, 2, 8, 256
    init = (torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
            torch.full((B, H), -torch.inf))

    def run(chunk):
        xs = [torch.randn((T, B, H, hd), generator=torch.Generator()
                          .manual_seed(s)).requires_grad_()
              for s in range(3)]
        gates = [torch.randn((T, B, H), generator=torch.Generator()
                             .manual_seed(s)).requires_grad_()
                 for s in (3, 4)]
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            carry, ys = rec_lib.chunked_scan(rec_lib._mlstm_step, init,
                                             tuple(xs + gates), chunk=chunk)
            out = (ys * torch.linspace(-1, 1, hd)).sum() + carry[0].sum()
        grads = torch.autograd.grad(out, xs + gates)
        return ys.detach(), grads, sum(saved)

    ys_c, g_c, saved_c = run(128)
    ys_f, g_f, saved_f = run(T)
    assert torch.equal(ys_c, ys_f)
    for a, c in zip(g_c, g_f):
        assert torch.equal(a, c)
    assert saved_c < saved_f
    with torch.no_grad():
        xs = tuple(torch.zeros((T, B, H, hd)) for _ in range(3)) + \
            tuple(torch.zeros((T, B, H)) for _ in range(2))
        _, ys = rec_lib.chunked_scan(rec_lib._mlstm_step, init, xs)
    assert ys.shape == (T, B, H, hd)


def test_serving_runs_without_checkpoints(monkeypatch):
    """Without autograd (serving, decode) ``remat`` and ``chunked_scan``
    take the plain path: no checkpoint is entered."""
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"),
                              remat=True)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    entered = []
    real = lm.checkpoint

    def spy(*a, **k):
        entered.append(1)
        return real(*a, **k)
    monkeypatch.setattr(lm, "checkpoint", spy)
    with torch.no_grad():
        lm.forward(params, cfg, toks)
    assert not entered
    lm.forward(params, cfg, toks)
    assert len(entered) == cfg.n_layers


# -- fake_quant and the synthetic data --------------------------------------


@pytest.mark.parametrize("axis", [0, 1])
def test_fake_quant_value_bitwise_and_straight_through(axis):
    w = np.random.default_rng(1 + axis).normal(0, 1, (8, 12)) \
        .astype(np.float32)
    ref = np.asarray(jax_fake_quant(jnp.asarray(w), axis))
    wt = torch.from_numpy(w).requires_grad_()
    ours = fake_quant(wt, axis)
    np.testing.assert_array_equal(ours.detach().numpy(), ref)
    (g,) = torch.autograd.grad((ours ** 2).sum(), wt)
    gj = jax.grad(lambda v: (jax_fake_quant(v, axis) ** 2).sum())(
        jnp.asarray(w))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    # straight-through: gradient = 2 * fake_quant(w) exactly
    np.testing.assert_array_equal(g.numpy(), 2 * ref)


@pytest.mark.parametrize("step,shard,num_shards",
                         [(0, 0, 1), (3, 0, 1), (17, 1, 2), (5, 3, 4)])
def test_synthetic_batches_bitwise(step, shard, num_shards):
    kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=5)
    ours = SyntheticLM(DataConfig(**kw)).batch(step, shard, num_shards)
    ref = JSyntheticLM(JDataConfig(**kw)).batch(step, shard, num_shards)
    assert sorted(ours) == sorted(ref) == ["labels", "tokens"]
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    it = SyntheticLM(DataConfig(**kw)).iterate(step, shard, num_shards)
    np.testing.assert_array_equal(next(it)["tokens"], ref["tokens"])
