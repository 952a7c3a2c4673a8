"""Sticky scoring (static device structure + masked re-score)."""

import numpy as np

from gnn_mwvc.core import CoreSolver
from gnn_mwvc.graphio import cover_cost, is_vertex_cover
from gnn_mwvc.solver.pipeline import GnnScorer, solve
from gnn_mwvc.solver.static_score import StickyGnnScorer
from tests.conftest import random_graph


def test_sticky_matches_fresh_after_removals():
    """After plain node removals (no folds) the masked re-score over the
    stale structure must match a fresh-snapshot score on every active node."""
    g = random_graph(800, 8, seed=3, wmax=100)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array(), num_rules=0)

    sticky = StickyGnnScorer(force_sticky=True)
    ids0, prob0, w0, d0 = sticky.score_core(core, ws)
    assert len(ids0) == core.active_count

    # remove ~15% of nodes through real decisions (undo-able surgery)
    rng = np.random.default_rng(0)
    removed = 0
    for u in rng.permutation(g.n):
        if removed > g.n * 0.15:
            break
        if core.is_active(u):
            if rng.random() < 0.5:
                core.select_node(int(u))
            else:
                core.select_neighborhood(int(u))
            removed = g.n - core.active_count

    ids_s, prob_s, _w, _d = sticky.score_core(core, ws)
    assert sticky.stats["rebuilds"] == 1  # no rebuild: same static structure

    fresh = GnnScorer()
    snap = core.snapshot()
    prob_f = fresh(snap, ws)
    m = {int(i): float(p) for i, p in zip(snap.ids, prob_f)}
    assert set(map(int, ids_s)) == set(m)
    for i, p in zip(ids_s, prob_s):
        assert abs(float(p) - m[int(i)]) < 2e-4, (int(i), float(p), m[int(i)])


def test_sticky_rebuild_trigger():
    g = random_graph(600, 6, seed=5, wmax=50)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array(), num_rules=0)
    sticky = StickyGnnScorer(rebuild_active_frac=0.5, force_sticky=True)
    sticky.score_core(core, ws)
    # decide >50% of nodes -> next score must rebuild
    for u in range(g.n):
        if core.active_count <= g.n * 0.4:
            break
        if core.is_active(u):
            core.select_node(u)
    ids, prob, _w, _d = sticky.score_core(core, ws)
    assert sticky.stats["rebuilds"] == 2
    assert len(ids) == core.active_count


def test_solve_sticky_default_end_to_end():
    for seed in (1, 4):
        g = random_graph(2000, 10, seed=seed, wmax=200)
        from gnn_mwvc.solver.static_score import StickyGnnScorer as S
        res_sticky = solve(g, time_limit=1.5, scorer=S(force_sticky=True))
        res_legacy = solve(g, time_limit=1.5, scorer=GnnScorer())
        assert is_vertex_cover(g, res_sticky.solution)
        assert cover_cost(g, res_sticky.solution) == res_sticky.cost
        # same trajectory class: costs agree within local-search noise
        assert res_sticky.cost <= res_legacy.cost * 1.01


def test_shape_templated_rebuild_same_program_shapes():
    """A rebuild fitted into the previous build's template must produce an
    identical jit cache key (same pytree structure, shapes, statics)."""
    import jax

    from gnn_mwvc.graph import DeviceGraph

    g = random_graph(3000, 8, seed=9, wmax=100)
    dg0 = DeviceGraph.from_graph(g, aggregation="blocked")
    # subgraph: drop the last third of the nodes
    keep = np.arange(g.n) < 2 * g.n // 3
    gs = _induced(g, keep)
    dgt = DeviceGraph.build(
        gs.weights, gs.indptr.astype(np.int64), gs.indices.astype(np.int64),
        shape_template=dg0,
    )
    assert dgt is not None
    s0 = jax.tree_util.tree_structure(dg0)
    s1 = jax.tree_util.tree_structure(dgt)
    assert s0 == s1
    l0 = jax.tree_util.tree_leaves(dg0)
    l1 = jax.tree_util.tree_leaves(dgt)
    assert [np.shape(a) for a in l0] == [np.shape(a) for a in l1]
    assert [np.asarray(a).dtype for a in l0] == [np.asarray(a).dtype for a in l1]

    # and the templated aggregation is correct for the subgraph
    from gnn_mwvc.ops.blocked import blocked_segment_sum

    x = np.zeros((dgt.n_pad, 4), np.float32)
    rng = np.random.default_rng(0)
    x[: gs.n] = rng.standard_normal((gs.n, 4)).astype(np.float32)
    agg = np.asarray(blocked_segment_sum(np.asarray(x), dgt.blocked))[: gs.n]
    want = np.zeros((gs.n, 4), np.float32)
    for u in range(gs.n):
        for v in gs.indices[gs.indptr[u]:gs.indptr[u + 1]]:
            want[u] += x[v]
    assert np.allclose(agg, want, atol=1e-4)


def _induced(g, keep_mask):
    from gnn_mwvc.graph import Graph

    ids = np.nonzero(keep_mask)[0]
    remap = -np.ones(g.n, np.int64)
    remap[ids] = np.arange(len(ids))
    e = g.edge_array()
    ek = e[keep_mask[e[:, 0]] & keep_mask[e[:, 1]]]
    return Graph(g.weights[ids], remap[ek])
