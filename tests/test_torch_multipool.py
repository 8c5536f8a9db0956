"""The torch twin of the min-plus fold (``repro_torch.core.multipool``)
against both reference folds of the JAX package - the numpy
``combine_many`` and the jax ``combine_rows_jnp`` - bitwise: values,
first-minimum argmin splits, ragged cluster counts, ties and
all-infeasible rows. The twin is the plain version of the
``minplus_combine`` CUDA kernel."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.multipool import (combine_many, combine_rows_jnp,  # noqa: E402
                                  minplus_fold)
from repro_torch.core import multipool as tmp  # noqa: E402


def _tables(C, R, K, seed, inf_frac=0.3):
    rng = np.random.default_rng(seed)
    tables = rng.integers(0, 50, size=(C, R, K + 1)).astype(np.float32)
    tables[rng.random(tables.shape) < inf_frac] = np.inf
    return tables


def _torch_combine(tables):
    min_e, splits = tmp.combine_rows_torch(torch.from_numpy(tables))
    return min_e.numpy(), splits.numpy()


@pytest.mark.parametrize("C,R,K", [(1, 4, 5), (2, 6, 4), (3, 5, 3),
                                   (5, 3, 4)])
def test_combine_rows_torch_matches_both_reference_folds(C, R, K):
    tables = _tables(C, R, K, C * 100 + R * 10 + K)
    min_e, splits = _torch_combine(tables)
    ref_e, ref_s = combine_many(list(tables))
    jnp_e, jnp_s = combine_rows_jnp(tables)
    assert splits.dtype == np.int32
    assert np.array_equal(min_e, ref_e, equal_nan=True)
    assert np.array_equal(min_e, np.asarray(jnp_e), equal_nan=True)
    assert np.array_equal(splits, ref_s)
    assert np.array_equal(splits, np.asarray(jnp_s))


@pytest.mark.parametrize("C", [2, 3, 5])
def test_combine_rows_torch_first_minimum_tie_breaking(C):
    # every split costs 0: the numpy fold takes the first minimum, and
    # so must the twin
    t = np.zeros((C, 2, 4), np.float32)
    min_e, splits = _torch_combine(t)
    ref_e, ref_s = combine_many(list(t))
    assert np.array_equal(splits, ref_s)
    assert np.array_equal(min_e, ref_e)
    assert np.array_equal(splits, np.asarray(combine_rows_jnp(t)[1]))


@pytest.mark.parametrize("C", [1, 2, 3, 5])
def test_combine_rows_torch_all_infeasible_rows(C):
    t = _tables(C, 4, 3, 17 + C, inf_frac=0.2)
    t[:, 1] = np.inf                      # one row infeasible everywhere
    t[0, 3] = np.inf                      # one row infeasible in cluster 0
    min_e, splits = _torch_combine(t)
    ref_e, ref_s = combine_many(list(t))
    assert np.isinf(min_e[1]) and (splits[1] == -1).all()
    assert np.array_equal(min_e, ref_e, equal_nan=True)
    assert np.array_equal(splits, ref_s)


@pytest.mark.parametrize("R,K", [(3, 0), (5, 6), (2, 11)])
def test_minplus_fold_torch_matches_numpy_fold(R, K):
    a, e = _tables(2, R, K, 91 + K, inf_frac=0.25)
    out, arg = tmp.minplus_fold_torch(torch.from_numpy(a),
                                      torch.from_numpy(e))
    ref_out, ref_arg = minplus_fold(a, e)
    assert arg.dtype == torch.int32
    assert np.array_equal(out.numpy(), ref_out, equal_nan=True)
    assert np.array_equal(arg.numpy(), ref_arg)
    with pytest.raises(ValueError, match="table shapes differ"):
        tmp.minplus_fold_torch(torch.from_numpy(a),
                               torch.from_numpy(e[:, :-1]))


def test_combine_rows_torch_batches_over_leading_dims():
    """A (V, C, R, K+1) stack combines like V separate calls."""
    stack = np.stack([_tables(3, 4, 5, s) for s in range(3)])
    min_e, splits = tmp.combine_rows_torch(torch.from_numpy(stack))
    for v in range(3):
        ref_e, ref_s = combine_many(list(stack[v]))
        assert np.array_equal(min_e[v].numpy(), ref_e, equal_nan=True)
        assert np.array_equal(splits[v].numpy(), ref_s)


def test_numpy_pair_carried_over_verbatim():
    """The host numpy pair is a copy of the reference's."""
    tables = _tables(3, 5, 4, 7)
    a = tmp.combine_many(list(tables))
    b = combine_many(list(tables))
    assert all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="at least one cluster table"):
        tmp.combine_many([])
