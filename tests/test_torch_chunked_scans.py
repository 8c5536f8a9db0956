"""The chunked algorithms of the ``mlstm_scan`` and ``slstm_scan``
kernels, modelled step for step in PyTorch (``tests/torch_{mlstm,slstm}
_chunked.py``), against the plain loops that define the ops
(``ref.py``), on the CPU. No card can check the decomposition
here; these tests do, at several chunk lengths and at lengths shorter
than a chunk, equal to one, one step either side of one, not a multiple
of one, and long.

* mLSTM: the stabilizer m of the gates pass equals the loop's bit for
  bit (the clamp max(|n . q|, 1) makes h depend on m itself); h is
  within SCAN_RTOL of the loop's largest |h|, also where input-gate
  spikes make the clamp bind.
* sLSTM: the first chunk equals the loop bit for bit (it starts from the
  same zero state with the same step); the rest within SCAN_RTOL.
* The backward kernels' algorithms (``mlstm_chunked_bwd``,
  ``slstm_chunked_bwd``) against the plain backwards (``ref.py``) within
  BWD_RTOL of each gradient's largest entry, at forget biases +3 (the
  blocks' init), +6 and +10 (long memory), the mLSTM also where its clamp
  binds (at S not a multiple of its chunk) and, at +6 and +10, against
  the float64 backward as the kernel is held on the card; at S = 1 the
  gate gradients are 0 exactly, as the loop's are. The mLSTM walks'
  products in 8-deep steps against the whole products.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_scan.ops import mlstm_plan  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import (  # noqa: E402
    mlstm_scan_bwd_exact, mlstm_scan_bwd_ref, mlstm_scan_exact,
    mlstm_scan_ref, mlstm_step)
from repro_torch.kernels.slstm_scan.ops import (  # noqa: E402
    BWD_CHUNK as SLSTM_BWD_CHUNK, BWD_SPAN as SLSTM_BWD_SPAN)
from repro_torch.kernels.slstm_scan.ref import (  # noqa: E402
    slstm_bwd_step, slstm_scan_bwd_ref, slstm_scan_ref, slstm_step)
from torch_mlstm_chunked import (  # noqa: E402
    chunk_update, mlstm_chunk_gates, mlstm_chunked, mlstm_chunked_bwd,
    walk_product)
from torch_slstm_chunked import (  # noqa: E402
    slstm_chunked, slstm_chunked_bwd, span_map)

CHUNKS = [16, 32, 64]
LENGTHS = ["1", "L-1", "L", "L+1", "200", "1024"]
# the tolerance that holds the kernels to the loops on the card
# (tests/test_torch_gpu.py, chip_smoke.py): relative to the output's
# largest |entry|; the chunked sums run in another order than the loop's
SCAN_RTOL = 4e-6


def _length(kind: str, chunk: int) -> int:
    return {"1": 1, "L-1": chunk - 1, "L": chunk, "L+1": chunk + 1,
            "200": 200, "1024": 1024}[kind]


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _mlstm_inputs(rng, S, spikes=0.0, forget_bias=3.0):
    """The smoke width (B 2, H 4, hd 16), gates as ``mlstm_block`` draws
    them: k scaled by 1/sqrt(hd), f = logsigmoid(randn + ``forget_bias``)
    (3 in the blocks); ``spikes`` adds that much to the input gate at 3%
    of the steps."""
    B, H, hd = 2, 4, 16
    q, k, v = (_rand(rng, B, S, H, hd) for _ in range(3))
    i = _rand(rng, B, S, H)
    if spikes:
        i = i + spikes * torch.from_numpy(
            (rng.random((B, S, H)) < 0.03).astype(np.float32))
    f = torch.nn.functional.logsigmoid(_rand(rng, B, S, H) + forget_bias)
    return q, k / hd ** 0.5, v, i, f


def _loop(q, k, v, i, f):
    """h and m of ``ref.mlstm_step`` over the sequence."""
    B, S, H, hd = q.shape
    carry = (torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
             torch.full((B, H), -torch.inf))
    hs, ms = [], []
    for t in range(S):
        carry, h = mlstm_step(carry, tuple(x[:, t] for x in (q, k, v, i, f)))
        hs.append(h)
        ms.append(carry[2])
    return torch.stack(hs, dim=1), torch.stack(ms, dim=1)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("kind", LENGTHS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_mlstm_chunked_matches_the_loop(chunk, kind):
    S = _length(kind, chunk)
    args = _mlstm_inputs(np.random.default_rng(S * 7 + chunk), S)
    h_ref, m_ref = _loop(*args)
    m = mlstm_chunk_gates(args[3], args[4], chunk)[0]
    assert torch.equal(m, m_ref)
    h, _ = mlstm_chunked(*args, chunk)
    assert h.shape == h_ref.shape
    assert _rel(h, h_ref) <= SCAN_RTOL


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mlstm_chunked_where_the_clamp_binds(chunk):
    """Input-gate spikes of +6 at 3% of the steps: after a spike m jumps
    and the older terms of n fade, so |n . q| < 1 at most steps, where
    h = C^T q is unnormalized and its scale e^{-m} depends on m."""
    args = _mlstm_inputs(np.random.default_rng(chunk), 1024, spikes=6.0)
    h_ref, m_ref = _loop(*args)
    assert torch.equal(mlstm_chunk_gates(args[3], args[4], chunk)[0], m_ref)
    h, den = mlstm_chunked(*args, chunk)
    assert float((den.abs() < 1).float().mean()) > 0.5
    assert _rel(h, h_ref) <= SCAN_RTOL


# forget-gate biases of long memory (+6: the top of the xLSTM paper's
# forget-gate init range; +10: the gate within ~5e-5 of 1): the state at
# a chunk's boundary then carries most of h, over many chunks, at the
# kernels' chunk lengths
LONG_MEMORY_BIASES = [6.0, 10.0]


@pytest.mark.parametrize("forget_bias", LONG_MEMORY_BIASES)
def test_mlstm_chunked_with_long_memory(forget_bias):
    """Held to ``ref.mlstm_scan_exact`` (float64, the fp32 loop's m):
    the fp32 loop's f + m - m' rounds to 0 once |f| is below m's ulp, so
    there the loop itself drifts by about SCAN_RTOL over 1,024 steps."""
    args = _mlstm_inputs(np.random.default_rng(32 + int(forget_bias)),
                         1024, forget_bias=forget_bias)
    m_ref = _loop(*args)[1]
    assert torch.equal(mlstm_chunk_gates(args[3], args[4], 32)[0], m_ref)
    h, _ = mlstm_chunked(*args, 32)
    assert _rel(h.double(), mlstm_scan_exact(*args)) <= SCAN_RTOL


@pytest.mark.parametrize("forget_bias", LONG_MEMORY_BIASES)
def test_slstm_chunked_with_long_memory(forget_bias):
    rng = np.random.default_rng(64 + int(forget_bias))
    z, i, f, o = (_rand(rng, 2, 512, 64) for _ in range(4))
    f = f + forget_bias
    h_ref = slstm_scan_ref(z, i, f, o)
    assert _rel(slstm_chunked(z, i, f, o, 64), h_ref) <= SCAN_RTOL


def test_mlstm_exact_reference_matches_the_loop_at_short_memory():
    """``mlstm_scan_exact`` is the loop's recurrence: at the blocks' gates
    it agrees with the fp32 loop within its rounding."""
    args = _mlstm_inputs(np.random.default_rng(5), 200)
    h = mlstm_scan_exact(*args)
    assert h.dtype == torch.float64
    assert _rel(_loop(*args)[0].double(), h) <= SCAN_RTOL


def test_mlstm_chunk_gates_decay_and_weights():
    """s_t is the incoming state's decay to step t and w_s input s's
    weight at the chunk's end, both from sums of f within the chunk:
    against a float64 recomputation, chunk by chunk (the first chunk's
    s is 0: no incoming state)."""
    chunk, S = 32, 96
    _, _, _, i, f = _mlstm_inputs(np.random.default_rng(3), S)
    m, b, s, w = mlstm_chunk_gates(i, f, chunk)
    i64, f64, m64 = i.double(), f.double(), m.double()
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        cum = torch.cumsum(f64[:, sl], dim=1)
        assert torch.allclose(b[:, sl].double(), cum, rtol=0, atol=1e-5)
        m_prev = m64[:, c0 - 1] if c0 else torch.full_like(m64[:, 0],
                                                           -torch.inf)
        s64 = torch.exp(cum + m_prev[:, None] - m64[:, sl])
        w64 = torch.exp(i64[:, sl] + cum[:, -1:] - cum - m64[:, c0 + chunk
                                                            - 1][:, None])
        assert torch.allclose(s[:, sl].double(), s64, rtol=1e-5, atol=0)
        assert torch.allclose(w[:, sl].double(), w64, rtol=1e-5, atol=0)
    assert torch.equal(s[:, :chunk], torch.zeros_like(s[:, :chunk]))


@pytest.mark.parametrize("kind", LENGTHS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_slstm_chunked_matches_the_loop(chunk, kind):
    S = _length(kind, chunk)
    rng = np.random.default_rng(S * 5 + chunk)
    z, i, f, o = (_rand(rng, 2, S, 64) for _ in range(4))
    f = f + 3.0                                   # the forget-open bias
    h_ref = slstm_scan_ref(z, i, f, o)
    h = slstm_chunked(z, i, f, o, chunk)
    assert h.shape == h_ref.shape
    first = min(chunk, S)
    assert torch.equal(h[:, :first], h_ref[:, :first])
    assert _rel(h, h_ref) <= SCAN_RTOL


# the backward kernels' algorithms against the plain backwards, relative
# to each gradient's largest entry (tests/test_torch_gpu.py's BWD_RTOL,
# which holds the kernels on the card): the chunkwise products, the
# gates' reverse sums and the chunked carries run in another order
BWD_RTOL = 2e-5
BWD_CHUNKS = {"mlstm": 32, "slstm": SLSTM_BWD_CHUNK}   # the kernels' chunks
BWD_LENGTHS = ["1", "L-1", "L+1", "200"]
FORGET_BIASES = [3.0, 6.0, 10.0]


def _grads_close(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = float((a - b).abs().max())
        assert err <= BWD_RTOL * float(b.abs().max()), (err, float(
            b.abs().max()))


@pytest.mark.parametrize("kind", BWD_LENGTHS)
@pytest.mark.parametrize("bias", FORGET_BIASES)
def test_mlstm_chunked_bwd_matches_the_plain_backward(bias, kind):
    S = _length(kind, BWD_CHUNKS["mlstm"])
    rng = np.random.default_rng(int(bias) * 1000 + S)
    args = _mlstm_inputs(rng, S, forget_bias=bias)
    h = mlstm_scan_ref(*args)
    dh = _rand(rng, *h.shape)
    got = mlstm_chunked_bwd(*args, h, dh, BWD_CHUNKS["mlstm"])
    _grads_close(got, mlstm_scan_bwd_ref(*args, h, dh))
    if S == 1:
        assert not got[3].any() and not got[4].any()


def test_mlstm_chunked_bwd_where_the_clamp_binds():
    rng = np.random.default_rng(7)
    args = _mlstm_inputs(rng, 200, spikes=6.0)
    h, den = mlstm_chunked(*args, BWD_CHUNKS["mlstm"])
    assert float((den.abs() < 1).float().mean()) > 0.5
    dh = _rand(rng, *h.shape)
    _grads_close(mlstm_chunked_bwd(*args, h, dh, BWD_CHUNKS["mlstm"]),
                 mlstm_scan_bwd_ref(*args, h, dh))


@pytest.mark.parametrize("S", [45, 333, 1000])
def test_mlstm_chunked_bwd_clamp_binds_at_unaligned_lengths(S):
    """The backward's model (n before every chunk from the per-chunk
    sums, the walks' 8-deep steps added once to the decayed state) where
    the clamp binds at most steps and S is not a multiple of the chunk."""
    rng = np.random.default_rng(11 + S)
    args = _mlstm_inputs(rng, S, spikes=6.0)
    h, den = mlstm_chunked(*args, BWD_CHUNKS["mlstm"])
    assert float((den.abs() < 1).float().mean()) > 0.5
    dh = _rand(rng, *h.shape)
    _grads_close(mlstm_chunked_bwd(*args, h, dh, BWD_CHUNKS["mlstm"]),
                 mlstm_scan_bwd_ref(*args, h, dh))


@pytest.mark.parametrize("forget_bias", LONG_MEMORY_BIASES)
def test_mlstm_chunked_bwd_with_long_memory(forget_bias):
    """Forget gates near 1 over 1,000 steps: each gradient of the model no
    farther from ``ref.mlstm_scan_bwd_exact`` (float64, the fp32 loop's
    m) than the larger of BWD_RTOL and the fp32 plain backward's own
    distance (the rule the kernel is held to on the card)."""
    rng = np.random.default_rng(1000 + int(forget_bias))
    args = _mlstm_inputs(rng, 1000, forget_bias=forget_bias)
    h = mlstm_scan_ref(*args)
    dh = _rand(rng, *h.shape)
    got = mlstm_chunked_bwd(*args, h, dh, BWD_CHUNKS["mlstm"])
    loop = mlstm_scan_bwd_ref(*args, h, dh)
    for a, b, e in zip(got, loop, mlstm_scan_bwd_exact(*args, dh)):
        top = float(e.abs().max())
        ours = float((a.double() - e).abs().max()) / top
        plain = float((b.double() - e).abs().max()) / top
        assert ours <= max(BWD_RTOL, plain), (ours, plain)


@pytest.mark.parametrize("hd", [1, 16, 33, 100, 200])
def test_mlstm_walk_steps_add_up_to_the_products(hd):
    """The walks' products in 8-deep steps (M y_t over each warp's
    columns of M, the chunk's update X^T diag(gamma) Z over its four
    steps) against the whole products in float64, at head widths that
    are not multiples of a step or of a warp's columns."""
    rng = np.random.default_rng(hd)
    M = _rand(rng, 2, 3, hd, hd)
    x, y, z = (_rand(rng, 2, 32, 3, hd) for _ in range(3))
    gamma = _rand(rng, 2, 32, 3)
    got = walk_product(M, y, mlstm_plan(hd).xw)
    ref = torch.einsum("bhrx,bthx->bthr", M.double(), y.double())
    assert got.shape == ref.shape
    assert _rel(got.double(), ref) <= 1e-6
    got = chunk_update(x, gamma, z)
    ref = torch.einsum("bshx,bsh,bshj->bhxj", x.double(), gamma.double(),
                       z.double())
    assert _rel(got.double(), ref) <= 1e-6


@pytest.mark.parametrize("kind", BWD_LENGTHS)
@pytest.mark.parametrize("bias", FORGET_BIASES)
def test_slstm_chunked_bwd_matches_the_plain_backward(bias, kind):
    S = _length(kind, BWD_CHUNKS["slstm"])
    rng = np.random.default_rng(int(bias) * 1000 + S + 1)
    z, i, f, o, dh = (_rand(rng, 2, S, 24) for _ in range(5))
    f = f + bias
    _grads_close(slstm_chunked_bwd(z, i, f, o, dh, BWD_CHUNKS["slstm"],
                                   SLSTM_BWD_SPAN),
                 slstm_scan_bwd_ref(z, i, f, o, dh))


@pytest.mark.parametrize("d", [1, 24, 33])
@pytest.mark.parametrize("kind", LENGTHS[:5] + ["1000"])
@pytest.mark.parametrize("bias", FORGET_BIASES)
def test_slstm_chunked_bwd_at_chunk_and_span_edges(bias, kind, d):
    """The kernel's chunks and spans (``ops.BWD_CHUNK``, ``BWD_SPAN``)
    against the plain backward at S shorter than a span, around a chunk,
    not a multiple of one and long; d of one unit, a multiple of 4 and
    neither of 4 nor of 32."""
    L = BWD_CHUNKS["slstm"]
    S = 1000 if kind == "1000" else _length(kind, L)
    rng = np.random.default_rng(int(bias) * 7919 + S * 31 + d)
    z, i, f, o, dh = (_rand(rng, 2, S, d) for _ in range(5))
    f = f + bias
    _grads_close(slstm_chunked_bwd(z, i, f, o, dh, L, SLSTM_BWD_SPAN),
                 slstm_scan_bwd_ref(z, i, f, o, dh))


def _slstm_states(xs, ties=()):
    """The loop's states (c, n, m) before each step and after the last,
    in float64; at the steps ``ties`` the input gate is set to
    logsigmoid(f) + m_{t-1}, so that max(a, i) ties there."""
    B, S, d = xs[0].shape
    carry = (xs[0].new_zeros((B, d)), xs[0].new_zeros((B, d)),
             torch.full((B, d), -torch.inf, dtype=xs[0].dtype))
    states = [carry]
    for t in range(S):
        if t in ties:
            xs[1][:, t] = torch.nn.functional.logsigmoid(xs[2][:, t]) \
                + carry[2]
        carry, _ = slstm_step(carry, tuple(x[:, t] for x in xs))
        states.append(carry)
    return states


@pytest.mark.parametrize("S,ties", [(1, ()), (8, ()), (16, ()),
                                    (8, (1, 4, 5)), (16, (2, 3, 9, 15))])
@pytest.mark.parametrize("bias", [3.0, 10.0])
def test_slstm_span_map_equals_the_dense_map(S, ties, bias):
    """A span's map in its structured form (a, p, q, s and b, one walk)
    equals the dense 3 x 3 map of three unit-column walks of
    ``ref.slstm_bwd_step`` and its zero-carry walk, in float64: the
    zeros and a and s exactly, p, q and b within 1e-12; also where
    max(a, i) ties (sel = 1/2)."""
    rng = np.random.default_rng(S * 13 + len(ties) + int(bias))
    xs = [torch.from_numpy(rng.standard_normal((2, S, 5))) for _ in range(4)]
    xs[2] = xs[2] + bias
    dh = torch.from_numpy(rng.standard_normal((2, S, 5)))
    states = _slstm_states(xs, ties)
    for t in ties:                            # the ties hold in the rerun
        a = torch.nn.functional.logsigmoid(xs[2][:, t]) + states[t][2]
        assert torch.equal(a, xs[1][:, t])
        assert torch.equal(states[t + 1][2], a)
    (a, p, q, s), b = span_map(xs, dh, 0, S, states)

    def walk(carry, grad):
        for t in range(S - 1, -1, -1):
            carry, _ = slstm_bwd_step(states[t], states[t + 1],
                                      tuple(x[:, t] for x in xs),
                                      grad[:, t], carry)
        return carry
    zero = torch.zeros_like(dh[:, 0])
    cols = [walk(tuple(torch.ones_like(zero) if e == j else zero
                       for e in range(3)), torch.zeros_like(dh))
            for j in range(3)]
    dense = torch.stack([torch.stack(col) for col in cols], dim=1)
    assert torch.equal(dense[0, 0], a) and torch.equal(dense[1, 1], a)
    assert torch.equal(dense[2, 2], s)
    for r, c in [(0, 1), (0, 2), (1, 0), (1, 2)]:
        assert torch.equal(dense[r, c], zero)
    assert float((dense[2, 0] - p).abs().max()) <= 1e-12
    assert float((dense[2, 1] - q).abs().max()) <= 1e-12
    b_dense = walk((zero, zero, zero), dh)
    for x, y in zip(b, b_dense):
        assert float((x - y).abs().max()) <= 1e-12
