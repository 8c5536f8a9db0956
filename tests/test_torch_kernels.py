"""The port's two kernels against the JAX package, bitwise.

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the plain ``dp_stages`` (``knapsack_dp``) and the plain fused
pipeline (``lut_build``) against the JAX ops with ``backend="ref"`` and,
at small T, ``pallas_interpret`` - stage tables, ``min_e`` and splits.
tests/test_torch_gpu.py holds the CUDA kernels against the plain
versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.placement import dp_min_energy  # noqa: E402
from repro.kernels.knapsack_dp.ops import knapsack_dp as jax_knapsack  # noqa
from repro.kernels.lut_pipeline.ops import lut_build as jax_lut_build  # noqa
from repro_torch.kernels.knapsack_dp import ops as kops  # noqa: E402
from repro_torch.kernels.lut_pipeline import ops as lops  # noqa: E402
from repro_torch.kernels.lut_pipeline.ref import lut_pipeline_ref  # noqa: E402

# the sweep of tests/test_lut_pipeline.py (bk only matters to Pallas)
SWEEP = [
    (1, 2, 2, 24, 4, 6, 512),       # the edge/pool topology
    (2, 3, 1, 30, 5, 7, 512),       # cxl-tier-3-like, variant-batched
    (1, 2, 3, 40, 7, 5, 4),         # multi-panel carry chain (P=2)
    (3, 1, 2, 16, 3, 4, 512),       # single cluster (no fold)
    (2, 5, 1, 32, 6, 9, 8),         # deep fold, multi-panel
]


def _rand_problem(seed, *, V=1, C=2, n=2, T=24, K=4, R=6):
    rng = np.random.default_rng(seed)
    t_items = rng.integers(1, max(2, T // 3), size=(V, C, n))
    e_items = rng.integers(1, 40, size=(V, C, n)).astype(np.float32)
    rows = rng.integers(0, T + 1, size=(V, R))
    # exercise the inert-padding contract on one space
    e_items[0, C - 1, n - 1] = np.inf
    t_items[0, C - 1, n - 1] = 1
    return t_items, e_items, rows


def _sweep_problem(V, C, n, T, K, R):
    return _rand_problem(V * 7919 + C * 31 + n, V=V, C=C, n=n, T=T, K=K,
                         R=R)


def _assert_same(ours, ref):
    for a, b in zip(ours, ref):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("V,C,n,T,K,R,bk", SWEEP)
def test_plain_lut_build_matches_jax_ref(V, C, n, T, K, R, bk):
    t, e, rows = _sweep_problem(V, C, n, T, K, R)
    ours = lops.lut_build(t, e, T, K, rows, device="cpu")
    ref = jax_lut_build(t, e, T, K, rows, backend="ref", bk=bk)
    _assert_same(ours, ref)


def test_plain_lut_build_matches_jax_pallas_interpret():
    V, C, n, T, K, R, bk = 2, 3, 2, 28, 5, 8, 4
    t, e, rows = _rand_problem(5, V=V, C=C, n=n, T=T, K=K, R=R)
    ours = lops.lut_build(t, e, T, K, rows, device="cpu")
    ref = jax_lut_build(t, e, T, K, rows, backend="pallas_interpret",
                        bk=bk)
    _assert_same(ours, ref)


@pytest.mark.parametrize("V,C,n,T,K,R,bk", SWEEP)
def test_plain_knapsack_dp_matches_jax_ref(V, C, n, T, K, R, bk):
    t, e, _ = _sweep_problem(V, C, n, T, K, R)
    for c in range(C):
        t_l, e_l = list(t[0, c]), list(e[0, c])
        ours = kops.knapsack_dp(t_l, e_l, T, K, device="cpu",
                                return_stages=True)
        ref = jax_knapsack(t_l, e_l, T, K, backend="ref",
                           return_stages=True)
        _assert_same([ours], [ref])
        last = kops.knapsack_dp(t_l, e_l, T, K, device="cpu")
        assert torch.equal(last, ours[-1])


def test_plain_knapsack_dp_matches_float64_oracle():
    """Integer energies keep float32 sums exact: the tables equal the
    verbatim float64 Algorithm 1."""
    t_items, e_items, T, K = [3, 5, 2], [7.0, 2.0, 11.0], 40, 9
    dp, _ = dp_min_energy(t_items, e_items, T, K)
    ours = kops.knapsack_dp(t_items, e_items, T, K, device="cpu",
                            return_stages=True)
    assert np.array_equal(ours.numpy().astype(np.float64), dp)


def test_rows_broadcast_and_validation():
    t, e, rows = _rand_problem(9, V=2)
    s1, e1, p1 = lops.lut_build(t, e, 24, 4, rows[0], device="cpu")
    s2, e2, p2 = lops.lut_build(t, e, 24, 4, np.stack([rows[0], rows[0]]),
                                device="cpu")
    assert torch.equal(s1, s2) and torch.equal(p1, p2)
    assert torch.equal(e1, e2)
    with pytest.raises(ValueError, match=r"\(V, C, n\)"):
        lops.lut_build(t[0], e[0], 24, 4, rows[0], device="cpu")
    with pytest.raises(ValueError, match=r"rows must lie in \[0, T=24\]"):
        lops.lut_build(t, e, 24, 4, rows[0] + 25, device="cpu")
    bad_t = t.copy()
    bad_t[0, 0, 0] = 0
    with pytest.raises(ValueError, match=">= 1 tick"):
        lops.lut_build(bad_t, e, 24, 4, rows, device="cpu")


def test_wrapper_input_checks():
    t = torch.ones((1, 2, 2), dtype=torch.int32)
    e = torch.ones((1, 2, 2), dtype=torch.float32)
    with pytest.raises(TypeError, match="int32"):
        kops.dp_stages(t.long(), e, 8, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kops.dp_stages(t.transpose(1, 2), e.transpose(1, 2), 8, 2)
    with pytest.raises(ValueError, match=r"rows must be int32 \(V, R\)"):
        kops.dp_stages(t, e, 8, 2, torch.zeros((2, 3), dtype=torch.int32))
    g = torch.zeros((1, 2, 3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        lops.minplus_combine(g.transpose(2, 3))
    with pytest.raises(ValueError, match=r"float32 \(V, C, R, K\+1\)"):
        lops.minplus_combine(g.double())


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    t, e, rows = _sweep_problem(*SWEEP[4][:6])
    before = (kops.dp_stages.launches, lops.minplus_combine.launches)
    ours = lops.lut_build(t, e, 32, 6, rows, device="cpu")
    ref = lut_pipeline_ref(torch.as_tensor(t, dtype=torch.int32),
                           torch.as_tensor(e), torch.as_tensor(
                               rows, dtype=torch.int32), T=32, K=6)
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)
    assert (kops.dp_stages.launches,
            lops.minplus_combine.launches) == before


def test_dispatch_counters_record_the_device_that_ran():
    from repro_torch import obs
    t, e, rows = _sweep_problem(*SWEEP[0][:6])
    obs.reset()
    obs.enable()
    try:
        lops.lut_build(t, e, 24, 4, rows, device="cpu")
        kops.knapsack_dp([2, 3], [1.0, 2.0], 8, 2, device="cpu")
        m = obs.metrics()
        assert m.value("kernels.lut_pipeline.dispatch", backend="cpu") == 1
        assert m.value("kernels.knapsack_dp.dispatch", backend="cpu") == 1
        # no host-time histogram: on the card it timed the enqueue of
        # asynchronous kernels, not the kernels
        for op in ("lut_pipeline", "knapsack_dp"):
            assert m.histogram(f"kernels.{op}.us", backend="cpu") is None
    finally:
        obs.reset()
