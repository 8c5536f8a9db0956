"""The recurrent families' sequence scans (``repro_torch/kernels/
{rglru,mlstm,slstm}_scan``) on the CPU, where each op runs its plain
version; the CUDA kernels are held to these on the card
(tests/test_torch_gpu.py, chip_smoke.py).

* Each plain version equals the loop the port's blocks ran before the
  ops existed, bit for bit, and so does each block (a CPU tensor launches
  nothing); the RG-LRU's plain backward equals autograd through that
  loop bit for bit.
* Each block equals the JAX package's block within ACT_ATOL, with and
  without autograd recording (its op either way); the RG-LRU's
  registered backward gives gradients of ``a``, ``b`` and the block's
  params within 1e-4 (of each leaf's largest entry) of ``jax.grad``
  (the xLSTM ops' backward: tests/test_torch_scan_grads.py).
* ``torch.library.opcheck`` passes on every op; ``mlstm_plan`` covers
  every head width it takes, within the card's shared memory, with
  strides whose tensor-core fragment reads are free of bank conflicts.
  (The chunked algorithms themselves: tests/test_torch_chunked_scans.py.)
* Under ``FakeTensorMode`` a reduced recurrentgemma_2b and xlstm_1_3b
  ``forward_hidden`` dispatch as many ops at S=4096 as at S=64: one scan
  op per block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import recurrent as jax_rec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mops  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.kernels.slstm_scan import ops as sops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import lm, recurrent  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from test_torch_families import (ACT_ATOL, _close, _configs,  # noqa: E402
                                 _params, _t)

# the RG-LRU's gradients against jax.grad, relative to each leaf's
# largest entry: fp32 sums over S and the batch in another order, and the
# associative scan's products associated otherwise
GRAD_RTOL = 1e-4
# S = 1; S = 200, not a multiple of chunked_scan's 128; S = 256, its
# two-level path in the JAX package
LENGTHS = [1, 200, 256]


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _counts():
    return (rops.rglru_scan.launches, rops.rglru_scan_bwd.launches,
            mops.mlstm_scan.launches, sops.slstm_scan.launches,
            mops.mlstm_scan_bwd.launches, sops.slstm_scan_bwd.launches)


# -- today's loops, as the port's blocks ran them before the ops ------------


def _old_rglru(a, b):
    hs = []
    ht = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        ht = a[:, t] * ht + b[:, t]
        hs.append(ht)
    return torch.stack(hs, dim=1)


def _old_mlstm(q, k, v, i, f):
    B, S, H, hd = q.shape
    init = (torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
            torch.full((B, H), -torch.inf))
    _, hs = recurrent._scan(recurrent._mlstm_step, init, tuple(
        t.transpose(0, 1) for t in (q, k, v, i, f)))
    return hs.transpose(0, 1)


def _old_slstm(z, i, f, o):
    B, S, d = z.shape
    init = (torch.zeros((B, d)), torch.zeros((B, d)),
            torch.full((B, d), -torch.inf))
    _, hs = recurrent._scan(recurrent._slstm_step, init, tuple(
        t.transpose(0, 1) for t in (z, i, f, o)))
    return hs.transpose(0, 1)


def _gates(rng, B, S, d):
    """a in (0, 1) as the block's decay, b of either sign."""
    a = torch.from_numpy(rng.uniform(0.05, 0.999, (B, S, d))
                         .astype(np.float32))
    return a, _rand(rng, B, S, d)


def _mlstm_inputs(rng, B, S, H, hd):
    q, k, v = (_rand(rng, B, S, H, hd) for _ in range(3))
    i = _rand(rng, B, S, H)
    f = torch.nn.functional.logsigmoid(_rand(rng, B, S, H) + 3.0)
    return q, k / hd ** 0.5, v, i, f


@pytest.mark.parametrize("S", LENGTHS)
def test_plain_scans_equal_todays_loops_bitwise(S):
    rng = np.random.default_rng(S)
    a, b = _gates(rng, 2, S, 24)
    assert torch.equal(rglru_scan_ref(a, b), _old_rglru(a, b))
    args = _mlstm_inputs(rng, 2, S, 3, 8)
    assert torch.equal(mlstm_scan_ref(*args), _old_mlstm(*args))
    zifo = [_rand(rng, 2, S, 24) for _ in range(4)]
    assert torch.equal(slstm_scan_ref(*zifo), _old_slstm(*zifo))


@pytest.mark.parametrize("S", LENGTHS)
def test_rglru_plain_backward_equals_autograd_of_the_loop(S):
    rng = np.random.default_rng(10 + S)
    a, b = _gates(rng, 2, S, 24)
    dh = _rand(rng, 2, S, 24)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = _old_rglru(a1, b1)
    da, db = torch.autograd.grad(h, (a1, b1), dh)
    ours = rglru_scan_bwd_ref(a, h.detach(), dh)
    assert torch.equal(ours[0], da) and torch.equal(ours[1], db)


@pytest.mark.parametrize("S", LENGTHS)
def test_ops_on_the_cpu_run_the_plain_versions_and_launch_nothing(S):
    rng = np.random.default_rng(20 + S)
    n0 = _counts()
    a, b = _gates(rng, 2, S, 24)
    h = rops.rglru_scan(a, b)
    assert torch.equal(h, rglru_scan_ref(a, b))
    dh = _rand(rng, 2, S, 24)
    for x, y in zip(rops.rglru_scan_bwd(a, h, dh),
                    rglru_scan_bwd_ref(a, h, dh)):
        assert torch.equal(x, y)
    args = _mlstm_inputs(rng, 2, S, 3, 8)
    assert torch.equal(mops.mlstm_scan(*args), mlstm_scan_ref(*args))
    zifo = [_rand(rng, 2, S, 24) for _ in range(4)]
    assert torch.equal(sops.slstm_scan(*zifo), slstm_scan_ref(*zifo))
    assert _counts() == n0


def test_ops_raise_on_what_the_kernels_do_not_take():
    x = torch.zeros((2, 5, 8))
    with pytest.raises(TypeError, match="float32"):
        rops.rglru_scan(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        rops.rglru_scan(x.transpose(0, 1), x.transpose(0, 1))
    with pytest.raises(ValueError, match="one shape"):
        sops.slstm_scan(x, x, x, x[:, :4])
    q = torch.zeros((2, 5, 3, 8))
    with pytest.raises(ValueError, match=r"\(B, S, H\)"):
        mops.mlstm_scan(q, q, q, q, q)


PLAN_WIDTHS = [1, 8, 9, 16, 31, 33, 48, 64, 100, 256, 511, 512]


@pytest.mark.parametrize("hd", PLAN_WIDTHS)
def test_mlstm_plan_covers_the_head(hd):
    plan = mops.mlstm_plan(hd)
    assert (plan.chunk, plan.warps) == (mops.CHUNK, mops.WARPS) == (32, 8)
    # the fewest rows a warp, a power of two from 16 to 64, covering hd
    assert plan.xw in (16, 32, 64)
    hp = plan.xw * plan.warps
    assert hp >= hd and (plan.xw == 16 or hp // 2 < hd)
    assert plan.tiles * mops.TILE >= hd > (plan.tiles - 1) * mops.TILE
    # strides hold a padded row; the k buffer also holds the partial sums
    assert plan.stride >= hp and plan.kstride >= hp
    assert plan.kbuf >= plan.chunk * plan.kstride
    assert plan.kbuf >= plan.warps * plan.chunk * (mops.RED_STRIDE + 1)
    smalls = ((plan.chunk + 2 * mops.TILE) * mops.P_STRIDE
              + 2 * plan.chunk)
    assert plan.smem == 4 * ((mops.TILE + plan.chunk) * plan.stride
                             + plan.kbuf + hp + 2 * smalls)
    assert plan.smem <= mops.MAX_SMEM


@pytest.mark.parametrize("hd", PLAN_WIDTHS)
def test_mlstm_plan_fragments_read_without_bank_conflicts(hd):
    """The banks (4-byte words mod 32) that the 32 lanes of a warp read
    for one tensor-core fragment register are all different: lane (g =
    lane // 4, q = lane % 4) reads row g, column q of q and of C^T
    (stride ``stride``) and row q, column g of k (stride ``kstride``),
    and 16-byte rows of q, C^T and k stay aligned for cp.async."""
    plan = mops.mlstm_plan(hd)
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for stride, addr in ((plan.stride, lambda g, q, st: g * st + q),
                         (plan.kstride, lambda g, q, st: q * st + g),
                         (mops.P_STRIDE, lambda g, q, st: g * st + q)):
        banks = {addr(g, q, stride) % 32 for g, q in lanes}
        assert len(banks) == 32, stride
        assert stride % 4 == 0


def test_mlstm_plan_at_xlstm_width_and_beyond():
    assert mops.mlstm_plan(512) == (32, 16, 8, 64, 516, 520, 16640, 228864)
    for hd in (0, 513):
        with pytest.raises(ValueError, match="hd"):
            mops.mlstm_plan(hd)


def test_mlstm_scratch_sizes():
    """The mLSTM scratch holds m, b, s, w per step and P per chunk, each
    padded to whole chunks."""
    for S, chunks in ((4096, 128), (33, 2), (1, 1)):
        n = 2 * 4 * chunks * 32                   # B H chunks L
        assert mops.scratch_floats(2, S, 4) == 4 * n + n * 32


# -- the blocks against the JAX package ---------------------------------------


def _block_case(arch, kind, S, seed):
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(arch)
    names = [f"tail_{i}" for i, k in enumerate(cfg_t.pattern_for_depth())
             if k == kind]
    x = np.random.default_rng(seed).standard_normal(
        (2, S, cfg_j.d_model)).astype(np.float32)
    return (cfg_j, cfg_t, pj["stack"][names[0]]["mix"],
            pt["stack"][names[0]]["mix"], x)


BLOCKS = [("recurrentgemma_2b", "rglru"), ("xlstm_1_3b", "mlstm"),
          ("xlstm_1_3b", "slstm")]


@pytest.mark.parametrize("arch,kind", BLOCKS, ids=[k for _, k in BLOCKS])
@pytest.mark.parametrize("S", LENGTHS)
def test_blocks_match_jax_and_todays_loop(arch, kind, S):
    """The block runs its op with autograd recording (params requiring
    grad) and without: both ways equal the reference within ACT_ATOL and
    each other bit for bit, and neither launches a kernel on the CPU."""
    cfg_j, cfg_t, mj, mt, x = _block_case(arch, kind, S, seed=S)
    ref = getattr(jax_rec, f"{kind}_block")(mj, jnp.asarray(x), cfg_j)
    block = getattr(recurrent, f"{kind}_block")
    n0 = _counts()
    with torch.no_grad():
        ours = block(mt, _t(x), cfg_t)
    assert _counts() == n0
    _close(ours, ref, ACT_ATOL)
    live = {k: v.detach().requires_grad_() for k, v in mt.items()}
    recorded = block(live, _t(x), cfg_t)
    assert recorded.grad_fn is not None
    assert torch.equal(recorded.detach(), ours)
    assert _counts() == n0


def _jax_rglru_scan(a, b):
    """The reference block's associative scan on its own."""
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2
    _, hs = jax.lax.associative_scan(combine, (a.swapaxes(0, 1),
                                               b.swapaxes(0, 1)))
    return hs.swapaxes(0, 1)


def _close_grad(ours, ref, what):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours.detach().numpy() - ref).max())
    assert err <= GRAD_RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("S", LENGTHS)
def test_rglru_registered_backward_matches_jax_grad(S):
    rng = np.random.default_rng(30 + S)
    a = rng.uniform(0.05, 0.999, (2, S, 16)).astype(np.float32)
    b = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = rng.standard_normal((2, S, 16)).astype(np.float32)
    ga, gb = jax.grad(lambda a, b: jnp.sum(_jax_rglru_scan(a, b) * w),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a).requires_grad_(), _t(b).requires_grad_()
    (rops.rglru_scan(at, bt) * _t(w)).sum().backward()
    _close_grad(at.grad, ga, "a")
    _close_grad(bt.grad, gb, "b")

    cfg_j, cfg_t, mj, mt, x = _block_case("recurrentgemma_2b", "rglru", S,
                                          seed=40 + S)
    wy = rng.standard_normal((2, S, cfg_j.d_model)).astype(np.float32)
    gj, gx = jax.grad(lambda p, x: jnp.sum(
        jax_rec.rglru_block(p, x, cfg_j) * wy), argnums=(0, 1))(
            mj, jnp.asarray(x))
    live = {k: v.detach().requires_grad_() for k, v in mt.items()}
    xt = _t(x).requires_grad_()
    n0 = rops.rglru_scan_bwd.launches
    (recurrent.rglru_block(live, xt, cfg_t) * _t(wy)).sum().backward()
    assert rops.rglru_scan_bwd.launches == n0          # the CPU: none
    for k in live:
        _close_grad(live[k].grad, gj[k], k)
    _close_grad(xt.grad, gx, "x")


# -- torch.library: opcheck and op counts under FakeTensorMode ----------------


def _opcheck_cases():
    rng = np.random.default_rng(50)
    a, b = _gates(rng, 2, 7, 8)
    h = rglru_scan_ref(a, b)
    m = _mlstm_inputs(rng, 2, 7, 2, 4)
    zifo = tuple(_rand(rng, 2, 7, 8) for _ in range(4))
    return [
        ("rglru_scan", (a, b)),
        ("rglru_scan", (a.clone().requires_grad_(),
                        b.clone().requires_grad_())),
        ("rglru_scan_bwd", (a, h, _rand(rng, 2, 7, 8))),
        ("mlstm_scan", m),
        ("slstm_scan", zifo),
        ("mlstm_scan", tuple(t.clone().requires_grad_() for t in m)),
        ("mlstm_scan_bwd", m + (mlstm_scan_ref(*m), _rand(rng, 2, 7, 2, 4))),
        ("slstm_scan", tuple(t.clone().requires_grad_() for t in zifo)),
        ("slstm_scan_bwd", zifo + (_rand(rng, 2, 7, 8),)),
    ]


@pytest.mark.parametrize("case", range(9))
def test_opcheck(case):
    name, args = _opcheck_cases()[case]
    op = getattr(torch.ops.repro_torch, name).default
    res = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in res.values()), res


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _fake_forward_ops(cfg, S):
    with FakeTensorMode():
        params = sp.abstract_params(cfg, device="cpu")
        toks = torch.zeros((2, S), dtype=torch.long)
        with torch.no_grad(), _OpCount() as c:
            h, _ = lm.forward_hidden(params, cfg, toks)
        assert h.shape == (2, S, cfg.d_model)
    return c.ops


# recurrentgemma cut to its first two blocks, both RG-LRU: its local
# attention's query chunks (a third of the blocks) grow with S by design
FAKE_CASES = [("recurrentgemma_2b", dict(n_layers=2)), ("xlstm_1_3b", {})]


@pytest.mark.parametrize("arch,over", FAKE_CASES,
                         ids=[a for a, _ in FAKE_CASES])
def test_fake_forward_dispatches_as_many_ops_at_any_length(arch, over):
    cfg = reduced(get_config(arch), **over)
    short, long_ = (_fake_forward_ops(cfg, S) for S in (64, 4096))
    assert short == long_
    kinds = cfg.pattern_for_depth()
    for kind in ("rglru", "mlstm", "slstm"):
        assert short.get(f"repro_torch.{kind}_scan", 0) == kinds.count(kind)


def test_fake_forward_of_a_scanned_bf16_stack():
    """The dry run's layout (``dryrun_config``: scanned, bf16 compute)."""
    cfg = sp.dryrun_config(reduced(get_config("xlstm_1_3b")))
    assert cfg.scan_layers and cfg.dtype == torch.bfloat16
    ops = _fake_forward_ops(cfg, 4096)
    assert ops["repro_torch.mlstm_scan"] == 14
    assert ops["repro_torch.slstm_scan"] == 2
