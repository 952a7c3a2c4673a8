"""Multi-chip sharding tests on the 8-virtual-device CPU mesh.

The acceptance bar from SURVEY.md §4(d): sharded (edge-partitioned) message
passing must match single-chip results to float tolerance.
"""

import numpy as np
import pytest

import jax

from gnn_mwvc.graph import DeviceGraph
from gnn_mwvc.models import load_pretrained
from gnn_mwvc.models.gnn import score_graph
from gnn_mwvc.parallel import (
    make_mesh,
    partition_device_graph,
    make_sharded_forward,
    make_sharded_train_step,
)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def test_sharded_forward_matches_single(mesh8, rnd_graph):
    g = rnd_graph(700, 10, seed=21)
    dg = DeviceGraph.from_graph(g)
    m = load_pretrained()
    ws = float(g.weights.max())

    single = np.asarray(score_graph(m, dg, ws))[: g.n]

    sg = partition_device_graph(dg, 8)
    fwd = make_sharded_forward(m.kinds, mesh8)
    out = np.asarray(fwd(m.params, sg, ws)).reshape(-1)
    mask = np.asarray(sg.node_mask).reshape(-1)
    sharded = out[mask][: g.n]
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_partition_covers_all_edges(rnd_graph):
    g = rnd_graph(300, 6, seed=1)
    dg = DeviceGraph.from_graph(g)
    sg = partition_device_graph(dg, 4, halo=False)
    # total real edges recoverable: count slots whose (shard, row) is a real node
    rows = np.asarray(sg.row_loc)
    cols = np.asarray(sg.col)
    node_mask = np.asarray(dg.node_mask)
    total = 0
    for p in range(4):
        live = rows[p] < sg.n_loc  # padding slots target segment n_loc
        dst_real = np.zeros_like(live)
        dst_real[live] = np.asarray(sg.node_mask[p])[rows[p][live]]
        total += int((live & dst_real & node_mask[cols[p]]).sum())
    assert total == dg.e


def test_halo_partition_covers_all_edges(rnd_graph):
    g = rnd_graph(300, 6, seed=1)
    dg = DeviceGraph.from_graph(g)
    sg = partition_device_graph(dg, 4)
    assert sg.halo
    total = 0
    for p in range(4):
        for rows in (np.asarray(sg.row_int[p]), np.asarray(sg.row_bnd[p])):
            live = rows < sg.n_loc
            total += int(np.asarray(sg.node_mask[p])[rows[live]].sum())
    assert total == dg.e


def test_halo_fullgather_parity(mesh8, rnd_graph):
    """halo=True and halo=False produce identical scores."""
    g = rnd_graph(500, 8, seed=5)
    dg = DeviceGraph.from_graph(g)
    m = load_pretrained()
    ws = float(g.weights.max())
    fwd = make_sharded_forward(m.kinds, mesh8)
    outs = []
    for halo in (True, False):
        sg = partition_device_graph(dg, 8, halo=halo)
        assert sg.halo == halo
        out = np.asarray(fwd(m.params, sg, ws)).reshape(-1)
        outs.append(out[np.asarray(sg.node_mask).reshape(-1)][: g.n])
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


def test_halo_bytes_proportional_to_boundary():
    """Communicated bytes ride the boundary size, not total nodes.

    A 2-D grid's boundary between contiguous node ranges is O(side), so the
    halo exchange must move far less than the full feature block."""
    import bench

    side = 120
    g = bench.build_road_graph(side, extra=0.0)  # pure grid: tiny boundary
    dg = DeviceGraph.from_graph(g)
    sg = partition_device_graph(dg, 8)
    full = partition_device_graph(dg, 8, halo=False)
    assert sg.halo_bytes_per_chip() < full.halo_bytes_per_chip() / 10
    # the halo buffer is proportional to the cut (~2 grid rows per peer
    # pair), NOT to n_loc: doubling the graph depth would double full-gather
    # bytes but leave h_max unchanged
    assert sg.h_max <= 2 * side + 8
    g2 = bench.build_road_graph(side, extra=0.0)
    # same cut, deeper shards: emulate by partitioning into fewer parts
    sg4 = partition_device_graph(DeviceGraph.from_graph(g2), 4)
    assert abs(int(sg4.h_max) - int(sg.h_max)) <= 16


def test_sharded_blocked_halo_matches_single(mesh8, rnd_graph):
    """Windowed one-hot aggregation over the [local|halo] source space."""
    from tests.test_blocked import geo_graph

    g = geo_graph(40, 3)
    dg = DeviceGraph.from_graph(g)
    m = load_pretrained()
    ws = float(g.weights.max())
    single = np.asarray(score_graph(m, dg, ws))[: g.n]
    sg = partition_device_graph(dg, 8, aggregation="blocked", halo=True)
    assert sg.has_blocked and sg.halo
    fwd = make_sharded_forward(m.kinds, mesh8)
    out = np.asarray(fwd(m.params, sg, ws)).reshape(-1)
    sharded = out[np.asarray(sg.node_mask).reshape(-1)][: g.n]
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_sharded_train_step_runs(mesh8, rnd_graph):
    g = rnd_graph(256, 6, seed=13)
    dg = DeviceGraph.from_graph(g)
    m = load_pretrained()
    ws = float(g.weights.max())
    sg = partition_device_graph(dg, 8)
    step, tx = make_sharded_train_step(m.kinds, mesh8)
    import optax

    opt_state = tx.init(m.params)
    y = np.zeros((8, sg.n_loc), np.float32)
    y[np.asarray(sg.node_mask)] = 1.0
    params, opt_state, loss = step(m.params, opt_state, sg, y, ws)
    assert np.isfinite(float(loss))
    params2, _, loss2 = step(params, opt_state, sg, y, ws)
    assert float(loss2) < float(loss)  # one SGD step reduces full-batch loss


def test_sharded_blocked_matches_single(mesh8, rnd_graph):
    """Per-shard windowed one-hot aggregation == single-device scores."""
    from tests.test_blocked import geo_graph

    g = geo_graph(40, 3)
    dg = DeviceGraph.from_graph(g)
    m = load_pretrained()
    ws = float(g.weights.max())
    single = np.asarray(score_graph(m, dg, ws))[: g.n]

    sg = partition_device_graph(dg, 8, aggregation="blocked", halo=False)
    assert sg.has_blocked
    fwd = make_sharded_forward(m.kinds, mesh8)
    out = np.asarray(fwd(m.params, sg, ws)).reshape(-1)
    mask = np.asarray(sg.node_mask).reshape(-1)
    sharded = out[mask][: g.n]
    np.testing.assert_allclose(sharded, single, atol=1e-5)


# ---- multi-chip scoring integrated into solve() (round 4) ------------------

def test_sharded_scorer_matches_legacy_scores(mesh8, rnd_graph):
    """ShardedGnnScorer's masked mesh forward must match the legacy
    per-snapshot CPU scorer on the same kernel within float tolerance."""
    from gnn_mwvc.core import CoreSolver
    from gnn_mwvc.solver.pipeline import GnnScorer
    from gnn_mwvc.solver.sharded_score import ShardedGnnScorer

    g = rnd_graph(3000, 12, seed=2, wmax=500)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    assert core.active_count > 100  # kernel survives reduction

    sh = ShardedGnnScorer(mesh=mesh8)
    ids_s, prob_s, w_s, deg_s = sh.score_core(core, ws)
    legacy = GnnScorer(device_min_edges=1 << 62)
    snap = core.snapshot()
    prob_l = legacy(snap, ws)
    order = np.argsort(ids_s)
    np.testing.assert_array_equal(ids_s[order], snap.ids)
    np.testing.assert_allclose(prob_s[order], prob_l, atol=2e-5)
    assert sh.stats["rounds"] == 1 and sh.stats["parts"] == 8


def test_solve_with_sharded_scorer_end_to_end(mesh8, rnd_graph):
    """A full solve() routed through the 8-device mesh scorer must produce
    the same phase-1 cover as the single-device solve (multi-device as an
    *integrated* capability, not a standalone demo)."""
    from gnn_mwvc.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc.solver import solve
    from gnn_mwvc.solver.pipeline import GnnScorer
    from gnn_mwvc.solver.sharded_score import ShardedGnnScorer

    g = rnd_graph(3000, 12, seed=2, wmax=500)
    # time_limit=0: phase 2 is skipped, the result is the deterministic
    # peeled cover — comparable across scorers
    res_s = solve(g, time_limit=0.0, scorer=ShardedGnnScorer(mesh=mesh8),
                  device_assist=False)
    res_1 = solve(g, time_limit=0.0, scorer=GnnScorer(device_min_edges=1 << 62),
                  device_assist=False)
    assert is_vertex_cover(g, res_s.solution)
    assert cover_cost(g, res_s.solution) == res_s.cost
    assert res_s.cost == res_1.cost
    np.testing.assert_array_equal(res_s.solution, res_1.solution)


def test_sharded_scorer_gadget_and_rebuild_policy(mesh8, rnd_graph):
    """Past the gadget drift bound the scorer rebuilds its partition; a
    full peel through the sharded scorer stays exact end-to-end.  Round 5:
    drift rebuilds must be SHAPE-TEMPLATED into the first build's shapes
    (no fresh jit program mid-peel)."""
    from gnn_mwvc.core import CoreSolver
    from gnn_mwvc.solver.pipeline import gnn_peel
    from gnn_mwvc.solver.sharded_score import ShardedGnnScorer

    g = rnd_graph(3000, 12, seed=2, wmax=500)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    sh = ShardedGnnScorer(mesh=mesh8, rebuild_gadget_frac=0.005)
    gnn_peel(core, sh, ws)
    assert core.active_count == 0
    assert sh.stats["rounds"] >= 1 and sh.stats["rebuilds"] >= 1
    # on a CPU mesh a template overflow (normal for locality-free random
    # graphs: compaction packs the same density into fewer, fuller shard
    # pairs) falls back to a natural rebuild, never to the dead state
    assert not sh._dead


def _shape_map(sg):
    """Every field that participates in the jit program shape (array shapes
    + static size fields; `n` is data, not shape)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(type(sg)):
        if f.name == "n":
            continue
        v = getattr(sg, f.name)
        if hasattr(v, "shape"):
            out[f.name] = tuple(v.shape)
        elif isinstance(v, tuple):
            out[f.name] = tuple(tuple(a.shape) for a in v)
        else:
            out[f.name] = v
    return out


def _shrunk_subgraph(g, frac=0.7, seed=1):
    """Order-preserving random node subset — the compaction a mid-solve
    kernel snapshot applies when the graph shrinks."""
    from gnn_mwvc.graph import Graph

    rng = np.random.default_rng(seed)
    keep = np.sort(rng.choice(g.n, size=int(g.n * frac), replace=False))
    newid = np.full(g.n, -1, np.int64)
    newid[keep] = np.arange(len(keep))
    e = g.edge_array()
    m = (newid[e[:, 0]] >= 0) & (newid[e[:, 1]] >= 0)
    return Graph(g.weights[keep], newid[e[m]])


@pytest.mark.parametrize("aggregation", ["scatter", "blocked"])
def test_partition_shape_template(mesh8, aggregation):
    """partition_device_graph(shape_template=...) pads a shrunken kernel
    into a previous partition's EXACT shapes (so the compiled mesh program
    is reused) and still scores it exactly; overflow returns None."""
    import bench

    m = load_pretrained()
    g_big = bench.build_road_graph(90)  # locality: the production regime
    g_small = _shrunk_subgraph(g_big, 0.7)
    dg_big = DeviceGraph.from_graph(g_big)
    dg_small = DeviceGraph.from_graph(g_small)
    tmpl = partition_device_graph(dg_big, 8, aggregation=aggregation)
    sg_t = partition_device_graph(dg_small, 8, aggregation=aggregation,
                                  shape_template=tmpl)
    assert sg_t is not None
    assert _shape_map(sg_t) == _shape_map(tmpl)
    # scores through the templated partition == single-device scores
    ws = float(g_small.weights.max())
    single = np.asarray(score_graph(m, dg_small, ws))[: g_small.n]
    fwd = make_sharded_forward(m.kinds, mesh8)
    out = np.asarray(fwd(m.params, sg_t, ws)).reshape(-1)
    got = out[np.asarray(sg_t.node_mask).reshape(-1)][: g_small.n]
    np.testing.assert_allclose(got, single, atol=1e-5)
    # the reverse direction cannot fit: big graph into small template
    tmpl_small = partition_device_graph(dg_small, 8, aggregation=aggregation)
    assert partition_device_graph(
        dg_big, 8, aggregation=aggregation,
        shape_template=tmpl_small) is None
    # template mode mismatches are rejected, not silently mixed
    assert partition_device_graph(
        dg_small, 4, aggregation=aggregation, shape_template=tmpl) is None


def test_sharded_scorer_templated_rebuild(mesh8):
    """The scorer's drift rebuild reuses the first build's shapes on a
    locality-preserving kernel (the road-class production case): no fresh
    jit program is ever traced mid-peel."""
    import bench

    from gnn_mwvc.core import CoreSolver
    from gnn_mwvc.solver.sharded_score import ShardedGnnScorer

    g = bench.build_road_graph(90)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    assert core.active_count > 500
    sh = ShardedGnnScorer(mesh=mesh8)
    ids, prob, _w, _d = sh.score_core(core, ws)
    tmpl_shapes = _shape_map(sh._tmpl)
    # shrink the kernel (select the most-confident vertices), then rebuild
    pick = np.argsort(prob)[-int(0.2 * len(prob)):]
    for u in ids[pick]:
        if core.is_active(int(u)):
            core.select_node(int(u))
    core.reduce()
    assert core.active_count > 0
    assert sh._rebuild(core) is not None
    assert sh.stats["templated_rebuilds"] == 1
    assert _shape_map(sh._state[0]) == tmpl_shapes
    assert not sh._dead


def test_sharded_scorer_delta_rounds(mesh8, rnd_graph):
    """Per-round refresh ships changed-slot deltas, not full re-uploads
    after the first full upload, subsequent rounds
    with small state churn reuse the donated buffers, and every round still
    matches the legacy CPU scorer exactly."""
    from gnn_mwvc.core import CoreSolver
    from gnn_mwvc.solver.pipeline import GnnScorer
    from gnn_mwvc.solver.sharded_score import ShardedGnnScorer

    g = rnd_graph(3000, 12, seed=4, wmax=500)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    sh = ShardedGnnScorer(mesh=mesh8)
    legacy = GnnScorer(device_min_edges=1 << 62)
    for _ in range(3):
        ids_s, prob_s, _w, _d = sh.score_core(core, ws)
        snap = core.snapshot()
        order = np.argsort(ids_s)
        np.testing.assert_array_equal(ids_s[order], snap.ids)
        np.testing.assert_allclose(prob_s[order], legacy(snap, ws),
                                   atol=2e-5)
        # peel a few most-confident vertices to mutate the state (no
        # reduce(): a cascade could touch more than k_loc slots and
        # legitimately force a full re-upload)
        pick = np.argsort(prob_s)[-4:]
        for u in ids_s[pick]:
            if core.is_active(int(u)):
                core.select_node(int(u))
        if core.active_count == 0:
            break
    assert sh.stats["full_uploads"] == 1  # only the first round
    assert sh.stats["rounds"] >= 2


def test_sharded_scorer_template_overflow_goes_legacy(mesh8, rnd_graph):
    """On an accelerator mesh a rebuild that outgrows the shape template
    must permanently exit to the legacy CPU path (never trace a fresh
    mesh program mid-phase-1) and keep returning correct scores."""
    from gnn_mwvc.core import CoreSolver
    from gnn_mwvc.solver.pipeline import GnnScorer
    from gnn_mwvc.solver.sharded_score import ShardedGnnScorer

    g = rnd_graph(3000, 12, seed=9, wmax=500)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    sh = ShardedGnnScorer(mesh=mesh8)
    ids, prob, _w, _d = sh.score_core(core, ws)
    # pretend the mesh is an accelerator mesh (no mid-phase-1 compile) and
    # force a template that nothing fits into
    sh._accel = True
    import dataclasses

    sh._tmpl = dataclasses.replace(sh._tmpl, h_max=8)
    # drop enough confident nodes to keep the kernel alive, then force a
    # rebuild through the (unfittable) template
    pick = np.argsort(prob)[-50:]
    for u in ids[pick]:
        if core.is_active(int(u)):
            core.select_node(int(u))
    assert sh._rebuild(core) is None
    assert sh._dead and sh.stats.get("template_overflow") is True
    # scoring still works, via the legacy CPU scorer, and matches it
    ids2, prob2, _w2, _d2 = sh.score_core(core, ws)
    legacy = GnnScorer(device_min_edges=1 << 62)
    snap = core.snapshot()
    order = np.argsort(ids2)
    np.testing.assert_array_equal(ids2[order], snap.ids)
    np.testing.assert_allclose(prob2[order], legacy(snap, ws), atol=2e-5)
