"""Device-guided bulk reduction prepass: exactness preservation."""

import numpy as np

from gnn_mwvc.core import CoreSolver
from gnn_mwvc.graphio import cover_cost, is_vertex_cover
from gnn_mwvc.solver.device_reduce import device_reduce_prepass
from tests.test_core import brute_force_mwvc, small_random


def test_prepass_preserves_exactness():
    for seed in (1, 2, 3):
        g = small_random(14, 0.3, seed)
        core = CoreSolver(g.weights, g.edge_array())
        stats = device_reduce_prepass(core, min_nodes=0)
        core.reduce(critical=True)
        core.solve_small_components(75)
        assert core.active_count == 0
        core.unfold(0)
        sol = core.solution()
        assert is_vertex_cover(g, sol)
        assert cover_cost(g, sol) == core.cost == brute_force_mwvc(g)


def test_prepass_applies_on_structured_graph():
    # star-heavy graph: many r1 candidates (leaf-dominated centers)
    from gnn_mwvc.graph import Graph

    rng = np.random.default_rng(0)
    edges = []
    n = 4000
    # 200 stars of 19 leaves each + random extra edges
    for c in range(0, n, 20):
        for leaf in range(c + 1, min(c + 20, n)):
            edges.append((c, leaf))
    w = rng.integers(1, 10, size=n)
    w[::20] = 1000  # heavy centers: NW(center) < W? no — leaves light
    g = Graph(w, np.array(edges))
    core = CoreSolver(g.weights, g.edge_array())
    stats = device_reduce_prepass(core, min_nodes=0, max_rounds=2)
    # centers have NW = sum of ~19 light leaves < 1000 -> r1 fires on device
    assert stats["r1_applied"] > 100
    core.reduce(critical=False)
    core.solve_small_components(75)
    core.unfold(0)
    sol = core.solution()
    assert is_vertex_cover(g, sol)


def test_prepass_twin_folding():
    from gnn_mwvc.graph import Graph

    # many twin pairs: i and i+1 share neighborhoods {base, base+1}
    edges = []
    n = 300
    for i in range(0, 200, 2):
        a, b = 200 + (i % 100), 200 + ((i + 7) % 100)
        edges.append((i, a))
        edges.append((i, b))
        edges.append((i + 1, a))
        edges.append((i + 1, b))
    w = np.full(n, 7)
    g = Graph(w, np.unique(np.array(edges), axis=0))
    core = CoreSolver(g.weights, g.edge_array())
    stats = device_reduce_prepass(core, min_nodes=0, max_rounds=1)
    assert stats["twins_applied"] > 10
    core.reduce(critical=False)
    core.solve_small_components(400)
    core.unfold(0)
    sol = core.solution()
    assert is_vertex_cover(g, sol)
    assert cover_cost(g, sol) == core.cost


def _true_r5_condition(g, u):
    """Reference semantics of rule 5 (mwvc_reductions.hpp:235-252): exact
    MWVC of the N(u) subgraph, condition W(u) >= NW(u) - VC."""
    nbrs = sorted(set(g.indices[g.indptr[u]:g.indptr[u + 1]]))
    if len(nbrs) > 8:
        return None
    loc = {v: i for i, v in enumerate(nbrs)}
    k = len(nbrs)
    adj = [0] * k
    for v in nbrs:
        for x in g.indices[g.indptr[v]:g.indptr[v + 1]]:
            if x in loc:
                adj[loc[v]] |= 1 << loc[x]
    w = [int(g.weights[v]) for v in nbrs]
    best = sum(w)
    for s in range(1 << k):
        ok = all(((s >> i) & 1) or ((s & adj[i]) == adj[i]) for i in range(k))
        if ok:
            c = sum(w[i] for i in range(k) if (s >> i) & 1)
            best = min(best, c)
    nw = sum(w)
    return int(g.weights[u]) >= nw - best


def test_r5_candidates_exact_on_low_degree():
    import jax.numpy as jnp

    from gnn_mwvc.ops.rules import build_ell8, r5_candidates

    for seed in (0, 1, 2):
        g = small_random(24, 0.2, seed)
        deg = np.diff(g.indptr)
        ell, ellv = build_ell8(g.indptr.astype(np.int64),
                               g.indices.astype(np.int64), deg)
        nw = np.array([g.weights[g.indices[g.indptr[u]:g.indptr[u + 1]]].sum()
                       for u in range(g.n)], np.int64)
        mask = np.asarray(r5_candidates(
            jnp.asarray(ell), jnp.asarray(ellv),
            jnp.asarray(g.weights.astype(np.int64)), jnp.asarray(nw),
            jnp.asarray(deg.astype(np.int32)), jnp.ones(g.n, bool),
            chunk=16,
        ))
        for u in range(g.n):
            truth = _true_r5_condition(g, u)
            if truth is None:
                assert not mask[u]  # deg > 8 never a candidate
            elif deg.max() <= 8:
                assert bool(mask[u]) == truth  # no truncation -> exact
            elif mask[u]:
                assert truth  # truncation is only ever conservative


def test_r5_candidates_sound_under_truncation():
    import jax.numpy as jnp

    from gnn_mwvc.ops.rules import build_ell8, r5_candidates

    # hub-heavy graph: low-degree candidates whose neighbors have deg > 8
    for seed in (3, 4):
        g = small_random(30, 0.45, seed)
        deg = np.diff(g.indptr)
        assert deg.max() > 8  # truncation actually exercised
        ell, ellv = build_ell8(g.indptr.astype(np.int64),
                               g.indices.astype(np.int64), deg)
        nw = np.array([g.weights[g.indices[g.indptr[u]:g.indptr[u + 1]]].sum()
                       for u in range(g.n)], np.int64)
        mask = np.asarray(r5_candidates(
            jnp.asarray(ell), jnp.asarray(ellv),
            jnp.asarray(g.weights.astype(np.int64)), jnp.asarray(nw),
            jnp.asarray(deg.astype(np.int32)), jnp.ones(g.n, bool),
            chunk=16,
        ))
        for u in np.nonzero(mask)[0]:
            assert _true_r5_condition(g, int(u))


def test_prepass_r5_preserves_exactness():
    # graphs engineered so r5 actually fires: heavy vertices whose light
    # neighborhoods are near-independent
    from gnn_mwvc.graph import Graph

    rng = np.random.default_rng(7)
    edges, n = [], 600
    for c in range(0, n, 6):
        for leaf in range(c + 1, min(c + 4, n)):
            edges.append((c, leaf))
        if c + 4 < n:
            edges.append((c + 1, c + 4))
    w = rng.integers(1, 8, size=n)
    w[::6] = 40  # heavy centers: W(c) >= NW - VC(N(c)) plausible
    g = Graph(w, np.unique(np.array(edges), axis=0))
    core = CoreSolver(g.weights, g.edge_array())
    stats = device_reduce_prepass(core, min_nodes=0, max_rounds=2)
    core.reduce(critical=False)
    core.solve_small_components(400)
    assert core.active_count == 0
    core.unfold(0)
    sol = core.solution()
    assert is_vertex_cover(g, sol)
    assert cover_cost(g, sol) == core.cost
