"""Edge cases and property fuzzing across the full solve pipeline."""

import numpy as np
import pytest

from gnn_mwvc.graph import Graph
from gnn_mwvc.graphio import cover_cost, is_vertex_cover
from gnn_mwvc.solver import solve
from tests.test_core import brute_force_mwvc, small_random


def test_empty_graph():
    g = Graph(np.zeros(0, np.uint32), np.zeros((0, 2), np.int64))
    res = solve(g, time_limit=1.0)
    assert res.cost == 0 and len(res.solution) == 0


def test_no_edges():
    g = Graph(np.array([5, 7, 9], np.uint32), np.zeros((0, 2), np.int64))
    res = solve(g, time_limit=1.0)
    assert res.cost == 0
    assert (res.solution == 0).all()


def test_single_edge():
    g = Graph(np.array([10, 3], np.uint32), np.array([[0, 1]]))
    res = solve(g, time_limit=1.0)
    assert res.cost == 3
    assert list(res.solution) == [0, 1]


def test_star_heavy_center():
    # center weight > leaf sum -> take the leaves
    w = np.array([100, 5, 5, 5], np.uint32)
    e = np.array([[0, 1], [0, 2], [0, 3]])
    res = solve(Graph(w, e), time_limit=1.0)
    assert res.cost == 15


def test_star_light_center():
    w = np.array([4, 50, 50, 50], np.uint32)
    e = np.array([[0, 1], [0, 2], [0, 3]])
    res = solve(Graph(w, e), time_limit=1.0)
    assert res.cost == 4


def test_large_weights_near_u32():
    # weights near 2^31 must not overflow any 32-bit cost paths
    w = np.array([2**31 - 5, 2**31 - 3, 2**31 - 7], np.uint32)
    e = np.array([[0, 1], [1, 2]])
    g = Graph(w, e)
    res = solve(g, time_limit=1.0)
    assert is_vertex_cover(g, res.solution)
    assert res.cost == 2**31 - 3  # the middle vertex covers both edges


def test_disconnected_components():
    rng = np.random.default_rng(5)
    blocks = []
    offset = 0
    edges = []
    weights = []
    expected = 0
    for k in range(6):
        gk = small_random(8, 0.4, seed=k, wmax=20)
        expected += brute_force_mwvc(gk)
        weights.extend(gk.weights)
        for a, b in gk.edge_array():
            edges.append((a + offset, b + offset))
        offset += gk.n
    g = Graph(np.array(weights, np.uint32),
              np.array(edges) if edges else np.zeros((0, 2), int))
    res = solve(g, time_limit=2.0)
    assert is_vertex_cover(g, res.solution)
    assert res.cost == expected  # components < 75 are solved exactly


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_small_optimal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 15))
    g = small_random(n, float(rng.uniform(0.1, 0.7)), seed, wmax=40)
    res = solve(g, time_limit=2.0)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    assert res.cost == brute_force_mwvc(g)  # < 75 nodes: exact


@pytest.mark.parametrize("seed", (21, 22))
def test_fuzz_medium_valid_and_stable(seed):
    from tests.conftest import random_graph

    g = random_graph(3000, 7, seed=seed, wmax=500)
    r1 = solve(g, time_limit=1.0)
    r2 = solve(g, time_limit=1.0)
    assert is_vertex_cover(g, r1.solution)
    assert cover_cost(g, r1.solution) == r1.cost
    # phase 1 is deterministic: same graph -> same peel outcome
    assert r1.kernel_size == r2.kernel_size
    assert r1.initial_cost == r2.initial_cost


def test_duplicate_and_reversed_edges():
    w = np.array([3, 4, 5], np.uint32)
    e = np.array([[0, 1], [1, 0], [0, 1], [1, 2], [2, 1]])
    g = Graph(w, e)
    assert g.indptr[-1] == 4  # deduped, both directions stored
    res = solve(g, time_limit=1.0)
    assert res.cost == 4  # middle vertex
