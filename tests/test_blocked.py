"""Windowed block-sparse aggregation + reorder pipeline tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from gnn_mwvc.core import bfs_order
from gnn_mwvc.graph import DeviceGraph, Graph
from gnn_mwvc.ops.blocked import build_blocked, blocked_segment_sum


def geo_graph(side=50, seed=0, extra=0.1):
    rng = np.random.default_rng(seed)
    n = side * side
    edges = []
    for i in range(side):
        for j in range(side):
            u = i * side + j
            if i + 1 < side:
                edges.append((u, u + side))
            if j + 1 < side:
                edges.append((u, u + 1))
            if rng.random() < extra and u + side + 1 < n:
                edges.append((u, u + side + 1))
    w = rng.integers(1, 100, size=n)
    return Graph(w, np.unique(np.array(edges), axis=0))


def exact_agg(g, x):
    out = np.zeros_like(x, dtype=np.float64)
    rows = np.repeat(np.arange(g.n), g.degrees)
    np.add.at(out, rows, x[g.indices].astype(np.float64))
    return out


@pytest.mark.parametrize("maker", [
    lambda: geo_graph(40, 1),
    lambda: geo_graph(30, 2, extra=0.5),
])
def test_blocked_agg_exact(maker):
    g = maker()
    n_pad = -(-g.n // 128) * 128
    plan = build_blocked(g.indptr, g.indices, n_pad)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(g.n, 16)).astype(np.float32)
    agg = np.asarray(blocked_segment_sum(jnp.asarray(x), plan))
    np.testing.assert_allclose(agg, exact_agg(g, x), rtol=1e-5, atol=1e-4)


def test_blocked_agg_random_graph_correct_but_low_quality():
    from tests.conftest import random_graph

    g = random_graph(2000, 8, seed=3)
    n_pad = -(-g.n // 128) * 128
    plan = build_blocked(g.indptr, g.indices, n_pad)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(g.n, 4)).astype(np.float32)
    agg = np.asarray(blocked_segment_sum(jnp.asarray(x), plan))
    np.testing.assert_allclose(agg, exact_agg(g, x), rtol=1e-5, atol=1e-4)


def test_cluster_reorder_improves_quality():
    from gnn_mwvc.core import cluster_order

    g = geo_graph(120, 4)  # big enough that windows can't cover everything
    rng = np.random.default_rng(5)
    g_scrambled = g.reorder(rng.permutation(g.n))
    n_pad = -(-g.n // 128) * 128
    q_scrambled = build_blocked(
        g_scrambled.indptr, g_scrambled.indices, n_pad
    ).quality
    perm = cluster_order(g_scrambled.indptr, g_scrambled.indices)
    g_fixed = g_scrambled.reorder(perm)
    q_fixed = build_blocked(g_fixed.indptr, g_fixed.indices, n_pad).quality
    assert q_fixed > q_scrambled
    assert q_fixed > 0.5


def test_device_graph_auto_aggregation():
    g = geo_graph(40, 6)
    dg = DeviceGraph.from_graph(g, aggregation="auto")
    assert dg.blocked is not None  # locality-ordered -> blocked plan chosen
    from tests.conftest import random_graph

    # multi-size chunks keep blocked viable even without locality (8-slot
    # chunks amortize the window fetch over 8 edges); explicit "ell" still
    # selects the gather path
    g2 = random_graph(60_000, 6, seed=7)
    dg2 = DeviceGraph.from_graph(g2, aggregation="auto")
    assert dg2.blocked is not None
    dg3 = DeviceGraph.from_graph(g2, aggregation="ell")
    assert dg3.blocked is None and dg3.ell is not None


def test_forward_with_blocked_matches_ell(ex3_graph):
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.models.gnn import score_graph

    g = geo_graph(30, 8)
    m = load_pretrained()
    ws = float(g.weights.max())
    s_ell = np.asarray(
        score_graph(m, DeviceGraph.from_graph(g, aggregation="ell"), ws)
    )[: g.n]
    s_blk = np.asarray(
        score_graph(m, DeviceGraph.from_graph(g, aggregation="blocked"), ws)
    )[: g.n]
    np.testing.assert_allclose(s_blk, s_ell, atol=2e-5)


def test_solve_with_reorder():
    from gnn_mwvc.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc.solver import solve

    g = geo_graph(35, 9)
    res_plain = solve(g, time_limit=2.0)
    res_reord = solve(g, time_limit=2.0, reorder=True)
    for res in (res_plain, res_reord):
        assert is_vertex_cover(g, res.solution)
        assert cover_cost(g, res.solution) == res.cost
    # same instance, both near-optimal: costs should be very close
    assert abs(res_plain.cost - res_reord.cost) <= 0.01 * res_plain.cost
