"""The xLSTM scans' backward (``repro_torch/kernels/{mlstm,slstm}_scan``:
``mlstm_scan_bwd``, ``slstm_scan_bwd``) on the CPU, where each op runs
its plain version; the CUDA kernels are held to these on the card
(tests/test_torch_gpu.py, chip_smoke.py).

* Each plain backward (an explicit loop back in time) equals autograd
  through the plain forward loop within PLAIN_RTOL of each gradient's
  largest entry.
* The ops' registered backward gives the gradients of ``jax.grad`` of the
  reference's scan of ``_mlstm_step`` / ``_slstm_step`` (its
  ``chunked_scan``) within GRAD_RTOL, also where the mLSTM's clamp
  max(|n . q|, 1) binds (the stabilizer m then has a gradient of its
  own).
* ``mlstm_block`` / ``slstm_block`` gradients (every param and the
  input) equal ``jax.grad`` of the reference blocks within GRAD_RTOL of
  each leaf's largest entry, at S = 1, 200 and 256, with a clamp-binding
  mLSTM draw; a CPU block launches nothing.
* Under ``FakeTensorMode`` a training step of a reduced xlstm_1_3b
  dispatches one backward scan op per block, as many at S=4096 as at
  S=64.
(The backward kernels' chunked algorithms: tests/test_torch_chunked_
scans.py.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.models import recurrent as jax_rec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mops  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import (  # noqa: E402
    mlstm_scan_bwd_ref, mlstm_scan_ref)
from repro_torch.kernels.slstm_scan import ops as sops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import (  # noqa: E402
    slstm_scan_bwd_ref, slstm_scan_ref)
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import lm, recurrent  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.tree import leaves as tree_leaves  # noqa: E402
from test_torch_families import _configs, _params, _t  # noqa: E402
from test_torch_scans import (GRAD_RTOL, LENGTHS, _OpCount,  # noqa: E402
                              _mlstm_inputs, _rand)
from torch_mlstm_chunked import mlstm_chunked  # noqa: E402

# the plain backward against autograd through the plain loop, relative to
# each gradient's largest entry: the same fp32 terms, a few of them
# grouped otherwise (dden from h, not from the numerator)
PLAIN_RTOL = 1e-6
# a block gradient leaf whose reference is below this share of the tree's
# largest |g| is cancellation noise and is held to that level, as the
# training tests hold it (tests/test_torch_train.py; the mLSTM input-gate
# bias: h is invariant to a shift of every i_t, so its gradient, the
# sum of di over the sequence, is 0 but for rounding)
GRAD_NOISE_SHARE = 1e-6
# input-gate spikes at 3% of the steps and q scaled down: the clamp
# max(|n . q|, 1) binds at most steps
CLAMP_SPIKES, CLAMP_Q = 6.0, 0.05


def _max_rel(ours, ref):
    ref = np.asarray(ref, dtype=np.float64)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(ours.detach(), dtype=np.float64)
                       - ref).max())
    return err, scale


def _close_rel(ours, ref, rtol, what):
    err, scale = _max_rel(ours, ref)
    assert err <= rtol * scale, (what, err, scale)


def _clamp_case(rng, S):
    """mLSTM inputs (B 2, H 3, hd 8) where the clamp binds at most steps."""
    q, k, v, i, f = _mlstm_inputs(rng, 2, S, 3, 8)
    i = i + CLAMP_SPIKES * torch.from_numpy(
        (rng.random(i.shape) < 0.03).astype(np.float32))
    return q * CLAMP_Q, k, v, i, f


def _binds(q, k, v, i, f) -> float:
    """The share of steps where |n_t . q_t| < 1."""
    _, den = mlstm_chunked(q, k, v, i, f, 32)
    return float((den.abs() < 1).float().mean())


# -- the plain backwards against autograd through the plain loops ----------


CASES = [(S, False) for S in LENGTHS] + [(200, True)]
CASE_IDS = [f"S{S}" + ("-clamp" if c else "") for S, c in CASES]


@pytest.mark.parametrize("S,clamp", CASES, ids=CASE_IDS)
def test_mlstm_plain_backward_matches_autograd_of_the_loop(S, clamp):
    rng = np.random.default_rng(60 + S)
    args = _clamp_case(rng, S) if clamp else _mlstm_inputs(rng, 2, S, 3, 8)
    if clamp:
        assert _binds(*args) > 0.5
    dh = _rand(rng, 2, S, 3, 8)
    live = [t.clone().requires_grad_() for t in args]
    h = mlstm_scan_ref(*live)
    ref = torch.autograd.grad(h, live, dh)
    ours = mlstm_scan_bwd_ref(*args, h.detach(), dh)
    for name, a, b in zip(("q", "k", "v", "i", "f"), ours, ref):
        _close_rel(a, b, PLAIN_RTOL, name)


@pytest.mark.parametrize("S", LENGTHS)
def test_slstm_plain_backward_matches_autograd_of_the_loop(S):
    rng = np.random.default_rng(70 + S)
    z, i, f, o, dh = (_rand(rng, 2, S, 24) for _ in range(5))
    args = (z, i, f + 3.0, o)
    live = [t.clone().requires_grad_() for t in args]
    ref = torch.autograd.grad(slstm_scan_ref(*live), live, dh)
    ours = slstm_scan_bwd_ref(*args, dh)
    for name, a, b in zip(("z", "i", "f", "o"), ours, ref):
        _close_rel(a, b, PLAIN_RTOL, name)


# -- the registered backward against jax.grad of the reference's scan ------


def _jax_scan(step, init, xs):
    """The reference blocks' scan over axis 1 of (B, S, ...) inputs."""
    _, hs = jax_rec.chunked_scan(step, init,
                                 tuple(x.swapaxes(0, 1) for x in xs))
    return hs.swapaxes(0, 1)


def _jax_mlstm(q, k, v, i, f):
    B, _, H, hd = q.shape
    init = (jnp.zeros((B, H, hd, hd)), jnp.zeros((B, H, hd)),
            jnp.full((B, H), -jnp.inf))
    return _jax_scan(jax_rec._mlstm_step, init, (q, k, v, i, f))


def _jax_slstm(z, i, f, o):
    B, _, d = z.shape
    init = (jnp.zeros((B, d)), jnp.zeros((B, d)), jnp.full((B, d), -jnp.inf))
    return _jax_scan(jax_rec._slstm_step, init, (z, i, f, o))


@pytest.mark.parametrize("S,clamp", CASES, ids=CASE_IDS)
def test_mlstm_registered_backward_matches_jax_grad(S, clamp):
    rng = np.random.default_rng(80 + S)
    args = _clamp_case(rng, S) if clamp else _mlstm_inputs(rng, 2, S, 3, 8)
    w = rng.standard_normal((2, S, 3, 8)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(_jax_mlstm(*a) * w),
                   argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(t.numpy())
                                              for t in args))
    live = [t.clone().requires_grad_() for t in args]
    n0 = mops.mlstm_scan_bwd.launches
    (mops.mlstm_scan(*live) * _t(w)).sum().backward()
    assert mops.mlstm_scan_bwd.launches == n0          # the CPU: none
    for name, a, b in zip(("q", "k", "v", "i", "f"), live, ref):
        _close_rel(a.grad, b, GRAD_RTOL, name)


@pytest.mark.parametrize("S", LENGTHS)
def test_slstm_registered_backward_matches_jax_grad(S):
    rng = np.random.default_rng(90 + S)
    z, i, f, o = (rng.standard_normal((2, S, 16)).astype(np.float32)
                  for _ in range(4))
    f = f + np.float32(3.0)
    w = rng.standard_normal((2, S, 16)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(_jax_slstm(*a) * w),
                   argnums=(0, 1, 2, 3))(*(jnp.asarray(t)
                                           for t in (z, i, f, o)))
    live = [_t(t).requires_grad_() for t in (z, i, f, o)]
    n0 = sops.slstm_scan_bwd.launches
    (sops.slstm_scan(*live) * _t(w)).sum().backward()
    assert sops.slstm_scan_bwd.launches == n0
    for name, a, b in zip(("z", "i", "f", "o"), live, ref):
        _close_rel(a.grad, b, GRAD_RTOL, name)


# -- the blocks' gradients against jax.grad of the reference blocks --------


BLOCK_CASES = [("mlstm", S, False) for S in LENGTHS] + \
    [("mlstm", 200, True)] + [("slstm", S, False) for S in LENGTHS]


@pytest.mark.parametrize("kind,S,clamp", BLOCK_CASES,
                         ids=[f"{k}-S{S}" + ("-clamp" if c else "")
                              for k, S, c in BLOCK_CASES])
def test_block_gradients_match_jax_grad(kind, S, clamp):
    """Every param leaf and the input, within GRAD_RTOL of each leaf's
    largest entry; a noise leaf (the reference's below GRAD_NOISE_SHARE
    of the tree's largest |g|) is held below that level. The clamp draw
    scales the mLSTM's query projection down by CLAMP_Q, so that
    |n . q| < 1 at most steps."""
    cfg_j, cfg_t = _configs("xlstm_1_3b")
    pj, pt = _params("xlstm_1_3b")
    name = next(n for n, k in zip(
        (f"tail_{i}" for i in range(cfg_t.n_layers)),
        cfg_t.pattern_for_depth()) if k == kind)
    mj = dict(pj["stack"][name]["mix"])
    mt = {k: v.clone() for k, v in pt["stack"][name]["mix"].items()}
    if clamp:
        mj["wq"] = mj["wq"] * CLAMP_Q
        mt["wq"] = mt["wq"] * CLAMP_Q
    rng = np.random.default_rng(100 + S)
    x = rng.standard_normal((2, S, cfg_j.d_model)).astype(np.float32)
    wy = rng.standard_normal((2, S, cfg_j.d_model)).astype(np.float32)
    block_j = getattr(jax_rec, f"{kind}_block")
    gj, gx = jax.grad(lambda p, x: jnp.sum(block_j(p, x, cfg_j) * wy),
                      argnums=(0, 1))(mj, jnp.asarray(x))
    live = {k: v.detach().requires_grad_() for k, v in mt.items()}
    xt = _t(x).requires_grad_()
    op, bwd = ((mops.mlstm_scan, mops.mlstm_scan_bwd) if kind == "mlstm"
               else (sops.slstm_scan, sops.slstm_scan_bwd))
    n0 = (op.launches, bwd.launches)
    (getattr(recurrent, f"{kind}_block")(live, xt, cfg_t)
     * _t(wy)).sum().backward()
    assert (op.launches, bwd.launches) == n0           # the CPU: none
    if clamp:
        q, k, v, i, f, _ = recurrent._mlstm_qkv(mt, _t(x), cfg_t)
        assert _binds(q, k.contiguous(), v, i,
                      torch.nn.functional.logsigmoid(f)) > 0.5
    noise = GRAD_NOISE_SHARE * max(float(np.abs(np.asarray(g)).max())
                                   for g in gj.values())
    for k in live:
        if float(np.abs(np.asarray(gj[k])).max()) <= noise:
            assert float(live[k].grad.abs().max()) <= noise, k
        else:
            _close_rel(live[k].grad, gj[k], GRAD_RTOL, k)
    _close_rel(xt.grad, gx, GRAD_RTOL, "x")


# -- FakeTensorMode: one backward op per block at any length ---------------


def _fake_train_ops(cfg, S):
    with FakeTensorMode():
        params = sp.abstract_params(cfg, device="cpu")
        leaves = [p.requires_grad_() for p in tree_leaves(params)
                  if p.is_floating_point()]
        toks = torch.zeros((2, S), dtype=torch.long)
        h, _ = lm.forward_hidden(params, cfg, toks)
        with _OpCount() as c:
            torch.autograd.grad(h.float().square().sum(), leaves,
                                allow_unused=True)
    return c.ops


def test_fake_training_step_dispatches_one_backward_op_per_block():
    """The backward counterpart of test_torch_scans.py::test_fake_forward_
    dispatches_as_many_ops_at_any_length: the gradient of a reduced
    xlstm_1_3b dispatches the same ops at S=64 as at S=4096, one
    ``mlstm_scan_bwd`` or ``slstm_scan_bwd`` per block."""
    cfg = reduced(get_config("xlstm_1_3b"))
    short, long_ = (_fake_train_ops(cfg, S) for S in (64, 4096))
    assert short == long_
    kinds = cfg.pattern_for_depth()
    for kind in ("mlstm", "slstm"):
        assert short[f"repro_torch.{kind}_scan_bwd"] == kinds.count(kind)
