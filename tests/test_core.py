"""Native core tests: reduction exactness, undo round-trips, local search.

Ground truth is brute-force subset enumeration on small graphs; the
reference binary (oracle) is cross-checked where both should be exact.
"""

import numpy as np
import pytest

from gnn_mwvc.core import CoreSolver, CoreLocalSearch
from gnn_mwvc.graph import Graph
from gnn_mwvc.graphio import is_vertex_cover, cover_cost


def brute_force_mwvc(g: Graph) -> int:
    e = g.edge_array()
    best = None
    for s in range(1 << g.n):
        sel = np.array([(s >> i) & 1 for i in range(g.n)], dtype=bool)
        if len(e) == 0 or np.all(sel[e[:, 0]] | sel[e[:, 1]]):
            c = int(g.weights[sel].sum())
            if best is None or c < best:
                best = c
    return best


def small_random(n, p, seed, wmax=30):
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < p:
                edges.append((i, j))
    w = rng.integers(1, wmax, size=n)
    return Graph(w, np.array(edges if edges else np.zeros((0, 2), int)))


def full_exact_cost(g: Graph) -> int:
    """reduce + medium-solve the whole graph (< 75 nodes) + unfold."""
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce(critical=True)
    s.solve_small_components(75)
    assert s.active_count == 0
    s.unfold(0)
    sol = s.solution()
    assert (sol >= 0).all()
    assert is_vertex_cover(g, sol)
    assert cover_cost(g, sol) == s.cost
    return s.cost


@pytest.mark.parametrize("seed", range(12))
def test_exactness_small(seed):
    n = int(6 + seed)
    g = small_random(min(n, 14), 0.3 + 0.04 * seed, seed)
    assert full_exact_cost(g) == brute_force_mwvc(g)


def test_exactness_ex3(ex3_graph):
    assert full_exact_cost(ex3_graph) == 20


def test_exactness_cliques_and_paths():
    # clique of 5: optimal cover = all but the heaviest vertex
    w = np.array([5, 9, 3, 7, 6])
    edges = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    g = Graph(w, np.array(edges))
    assert full_exact_cost(g) == int(w.sum() - w.max())
    # path: brute check
    g2 = Graph(np.array([4, 1, 5, 2, 6]), np.array([(0, 1), (1, 2), (2, 3), (3, 4)]))
    assert full_exact_cost(g2) == brute_force_mwvc(g2)


@pytest.mark.parametrize("seed", range(6))
def test_undo_roundtrip(seed):
    g = small_random(20, 0.2, 100 + seed)
    s = CoreSolver(g.weights, g.edge_array())
    snap0 = s.snapshot()
    t0 = s.timestamp
    s.reduce(critical=True)
    s.unfold(t0)
    snap1 = s.snapshot()
    assert snap1.n == snap0.n
    np.testing.assert_array_equal(snap0.ids, snap1.ids)
    np.testing.assert_array_equal(snap0.weights, snap1.weights)
    np.testing.assert_array_equal(snap0.nw, snap1.nw)
    np.testing.assert_array_equal(snap0.indptr, snap1.indptr)
    np.testing.assert_array_equal(snap0.indices, snap1.indices)


def test_counters_and_cost_track():
    g = small_random(30, 0.15, 7)
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce(critical=True)
    c = s.counters
    assert c.sum() > 0  # something fired on a random graph


def test_exactness_midsize_vs_oracle(oracle_dir):
    """40-node graphs: reference GNN_VC at 2s vs our exact medium solve."""
    import os
    import subprocess
    import tempfile

    from gnn_mwvc.graphio import write_metis

    for seed in (1, 2, 3):
        g = small_random(40, 0.12, 200 + seed)
        mine = full_exact_cost(g)
        with tempfile.NamedTemporaryFile("w", suffix=".metis",
                                         delete=False) as f:
            write_metis(f, g)
            path = f.name
        sol = path + ".sol"
        out = subprocess.run(
            [os.path.join(oracle_dir, "GNN_VC"), path, sol, "2", "-1", "0"],
            capture_output=True, text=True, timeout=120,
        )
        fields = out.stdout.strip().split(",")
        # fully-reduced: name,N,E,kernel,cost_gnn,t,cost,t (8 fields);
        # with local search: name,cost,best_seen,t (4 fields)
        ref_cost = int(fields[-2]) if len(fields) == 8 else int(fields[1])
        os.unlink(path)
        assert mine <= ref_cost  # ours is exact; reference is heuristic
        assert mine == ref_cost or g.n > 20  # tiny graphs: both exact


def test_local_search_improves():
    g = small_random(60, 0.1, 42)
    # start from the all-in cover
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    c0 = ls.best_cost  # after redundancy drop
    assert c0 <= int(g.weights.sum())
    improved = ls.search(200000, 5.0)
    best = ls.best()
    assert is_vertex_cover(g, best)
    assert cover_cost(g, best) == ls.best_cost
    assert ls.best_cost <= c0
    assert ls.best_seen <= ls.best_cost


def test_local_search_finds_optimum_small():
    # The best cover is snapshotted only at batch end (reference caveat:
    # "written" vs "best seen", README.md:47) — drive in small batches like
    # the real driver does.
    for seed in (3, 5):
        g = small_random(12, 0.3, seed)
        opt = brute_force_mwvc(g)
        ls = CoreLocalSearch(g.weights, g.edge_array(),
                             np.ones(g.n, np.uint8))
        for _ in range(300):
            ls.search(1024, 1.0)
        assert ls.best_seen == opt
        assert ls.best_cost == opt  # small batches snapshot the optimum
        assert is_vertex_cover(g, ls.best())


def test_peel_pipeline_smoke():
    """Score-free peel: decide by weight heuristic, must yield a valid cover."""
    g = small_random(50, 0.15, 9)
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce(critical=True)
    while s.active_count > 0:
        s.solve_small_components(75)
        if s.active_count == 0:
            break
        snap = s.snapshot()
        # fake scores: heavier nodes excluded
        prob = (snap.weights < np.median(snap.weights)).astype(np.float32)
        order = np.argsort(prob)
        s.reset_label_count()
        s.peel(snap.ids[order], prob[order], relable_interval=-1)
    s.unfold(0)
    sol = s.solution()
    assert (sol >= 0).all()
    assert is_vertex_cover(g, sol)
    assert cover_cost(g, sol) == s.cost


def test_local_search_forget_diversification():
    """Opt-in edge-weight forgetting keeps the cover valid and the search
    functional (beyond-reference anytime behavior)."""
    from tests.conftest import random_graph

    g = random_graph(800, 8, seed=13, wmax=50)
    s = CoreSolver(g.weights, g.edge_array(), num_rules=0)
    from gnn_mwvc.core import CoreLocalSearch, greedy_cover

    _cost, cover = greedy_cover(g.weights, g.edge_array())
    ls = CoreLocalSearch(g.weights, g.edge_array(), cover)
    ls.search(20000, 1.0)
    c1 = ls.best_cost
    ls.forget(0.3)
    ls.search(20000, 1.0)
    assert ls.best_cost <= c1  # monotone best under continued search
    from gnn_mwvc.graphio import is_vertex_cover

    best = ls.best()
    assert is_vertex_cover(g, best)


class _GadgetsFirst:
    """Peel scorer that excludes every fold gadget first (confident 0.0) and
    scores the rest from a seeded draw: gadget folds then unfold with the
    gadget out of the cover, their harshest case."""

    def __init__(self, n_org):
        self.n_org = n_org

    def __call__(self, snap, weight_scale):
        p = np.random.default_rng(snap.n).random(snap.n).astype(np.float32)
        p[snap.ids >= self.n_org] = 0.0
        return p


@pytest.mark.parametrize("side,seed", [(30, 77), (30, 108), (40, 290)])
def test_fold_gadget_adjacency_sorted(side, seed):
    """Every live adjacency list stays sorted through reductions and peel
    rounds, a fold gadget's own list included (the merge predicates
    is_twin / is_dominating / has_independent_neighbors rely on it)."""
    import bench
    from gnn_mwvc.solver.pipeline import confidence_order

    g = bench.build_road_graph(side, seed=seed)
    s = CoreSolver(g.weights, g.edge_array())
    scorer = _GadgetsFirst(g.n)
    s.reduce()
    gadgets_seen = False
    while s.active_count > 0:
        s.solve_small_components(75)
        if s.active_count == 0:
            break
        snap = s.snapshot()
        gadgets_seen |= bool((snap.ids >= g.n).any())
        for r in range(snap.n):
            row = snap.indices[snap.indptr[r]:snap.indptr[r + 1]]
            assert (np.diff(row.astype(np.int64)) > 0).all(), snap.ids[r]
        prob = scorer(snap, 1.0)
        order = confidence_order(prob, snap.weights, snap.deg)
        s.reset_label_count()
        s.peel(snap.ids[order], prob[order], relable_interval=-1)
    assert gadgets_seen
    s.unfold(0)
    sol = s.solution()
    assert is_vertex_cover(g, sol) and cover_cost(g, sol) == s.cost
