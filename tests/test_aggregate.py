import numpy as np
import pytest

import jax.numpy as jnp

from gnn_mwvc.ops import build_ell, ell_segment_sum


def exact_agg(indptr, indices, x):
    n = len(indptr) - 1
    out = np.zeros((x.shape[0], x.shape[1]))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    np.add.at(out, rows, x[indices].astype(np.float64))
    return out


def check(indptr, indices, n_pad, w=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_pad, w)).astype(np.float32)
    plan = build_ell(indptr, indices, n_pad)
    got = np.asarray(ell_segment_sum(jnp.asarray(x), plan))
    want = exact_agg(indptr, indices, x)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    return plan


def test_uniform_degrees():
    rng = np.random.default_rng(1)
    n, d = 300, 12
    indices = rng.integers(0, n, size=n * d).astype(np.int64)
    indptr = np.arange(n + 1) * d
    check(indptr, indices, n_pad=n)


def test_power_law_degrees():
    rng = np.random.default_rng(2)
    n = 500
    deg = np.minimum((rng.pareto(1.1, size=n) * 4).astype(np.int64), 2000)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int64)
    plan = check(indptr, indices, n_pad=n)
    assert plan.num_levels >= 2  # high-degree rows forced combine levels


def test_empty_rows_and_padding():
    # rows 0 and 3 empty; n_pad > n
    indptr = np.array([0, 0, 2, 5, 5])
    indices = np.array([0, 2, 1, 1, 3])
    check(indptr, indices, n_pad=8)


def test_single_huge_row():
    n = 4
    d = 5000
    indptr = np.array([0, d, d, d, d])
    rng = np.random.default_rng(3)
    indices = rng.integers(0, n, size=d).astype(np.int64)
    plan = check(indptr, indices, n_pad=n)
    assert plan.num_levels >= 2


def test_no_edges():
    indptr = np.zeros(5, dtype=np.int64)
    indices = np.zeros(0, dtype=np.int64)
    check(indptr, indices, n_pad=8)


def test_w1():
    rng = np.random.default_rng(4)
    n, d = 200, 7
    indices = rng.integers(0, n, size=n * d).astype(np.int64)
    indptr = np.arange(n + 1) * d
    check(indptr, indices, n_pad=n, w=1)
