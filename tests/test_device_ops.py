"""Device op tests: batched small-solve parity, rule predicate masks."""

import numpy as np
import pytest

import jax.numpy as jnp

from gnn_mwvc.graph import DeviceGraph
from gnn_mwvc.ops.rules import rule_masks, twin_groups
from gnn_mwvc.ops.smallsolve import batched_small_mwvc, pack_instances
from tests.test_core import brute_force_mwvc, small_random


def test_batched_small_mwvc_parity():
    rng = np.random.default_rng(0)
    instances = []
    graphs = []
    for k in range(12):
        n = int(rng.integers(1, 17))
        w = rng.integers(1, 50, size=n)
        edges = [
            (i, j)
            for i in range(n)
            for j in range(i + 1, n)
            if rng.random() < 0.4
        ]
        instances.append((w.tolist(), edges))
        from gnn_mwvc.graph import Graph

        graphs.append(Graph(w, np.array(edges) if edges else None))
    adj, wts = pack_instances(instances)
    costs, sets = batched_small_mwvc(jnp.asarray(adj), jnp.asarray(wts))
    for k, g in enumerate(graphs):
        if g.n <= 14:  # brute force budget
            assert int(costs[k]) == brute_force_mwvc(g), k
        # returned set is a valid cover of claimed cost
        s = int(sets[k])
        sel = np.array([(s >> i) & 1 for i in range(g.n)], dtype=bool)
        e = g.edge_array()
        if len(e):
            assert np.all(sel[e[:, 0]] | sel[e[:, 1]])
        assert int(g.weights[sel].sum()) == int(costs[k])


def test_rule_masks_r1():
    g = small_random(60, 0.1, 3, wmax=200)
    dg = DeviceGraph.from_graph(g)
    masks = rule_masks(
        jnp.asarray(dg.row), jnp.asarray(dg.col), jnp.asarray(dg.weights),
        jnp.asarray(dg.degrees), jnp.asarray(dg.nw),
        jnp.asarray(dg.node_mask),
    )
    r1 = np.asarray(masks["r1"])[: g.n]
    expect = (g.neighborhood_weights <= g.weights) & (g.degrees > 0)
    np.testing.assert_array_equal(r1, expect)


def test_twin_hash_groups():
    # construct explicit twins: vertices 0 and 1 both adjacent to {2, 3}
    from gnn_mwvc.graph import Graph

    w = np.array([5, 7, 3, 4, 9])
    edges = np.array([(0, 2), (0, 3), (1, 2), (1, 3), (2, 4)])
    g = Graph(w, edges)
    dg = DeviceGraph.from_graph(g)
    masks = rule_masks(
        jnp.asarray(dg.row), jnp.asarray(dg.col), jnp.asarray(dg.weights),
        jnp.asarray(dg.degrees), jnp.asarray(dg.nw),
        jnp.asarray(dg.node_mask),
    )
    groups = twin_groups(masks["twin_key"], dg.node_mask)
    # vertices 0 and 1 have equal neighborhoods AND equal NW -> one group
    assert any(set(gr.tolist()) == {0, 1} for gr in groups)


def test_dom_edge_filter_sound():
    """Every actually-dominating edge must pass the device filter."""
    g = small_random(40, 0.25, 9, wmax=30)
    dg = DeviceGraph.from_graph(g)
    masks = rule_masks(
        jnp.asarray(dg.row), jnp.asarray(dg.col), jnp.asarray(dg.weights),
        jnp.asarray(dg.degrees), jnp.asarray(dg.nw),
        jnp.asarray(dg.node_mask),
    )
    dom = np.asarray(masks["dom_edge"])
    row, col = dg.row[: dg.e], dg.col[: dg.e]
    wt, nwt = g.weights, g.neighborhood_weights
    deg = g.degrees

    def dominates(u, v):  # reference is_dominating + caller weight gate
        if deg[u] < deg[v] or wt[u] + nwt[u] < wt[v] + nwt[v]:
            return False
        if wt[v] < wt[u]:
            return False
        nu = set(g.neighbors(u))
        nv = set(g.neighbors(v)) - {u}
        return nv <= nu

    for k in range(dg.e):
        u, v = int(row[k]), int(col[k])
        if dominates(u, v):
            assert dom[k], (u, v)
