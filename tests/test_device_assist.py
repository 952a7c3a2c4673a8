"""Device-assisted phase 2 (round 3): region extraction, exact patching,
guided kicks, and the end-to-end assist loop."""

import numpy as np
import pytest

from gnn_mwvc.core import CoreLocalSearch
from gnn_mwvc.graphio import cover_cost, is_vertex_cover
from gnn_mwvc.ops.smallsolve import batched_small_mwvc
from gnn_mwvc.solver.pipeline import solve
from tests.conftest import random_graph


def _path_ls():
    # path 0-1-2-3-4 with heavy endpoints in the cover; optimum is {1,3}
    w = np.array([10, 1, 10, 1, 10], np.uint32)
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 4]], np.uint32)
    s0 = np.array([1, 0, 1, 0, 1], np.uint8)
    return CoreLocalSearch(w, edges, s0)


def test_extract_region_boundary_forcing():
    """A region vertex with an outside non-cover neighbor must carry a
    self-loop bit (forced into the cover)."""
    # star: center 0 with leaves 1..4; cover = {0}; extract rmax=2 around 0
    w = np.array([5, 1, 1, 1, 1], np.uint32)
    edges = np.array([[0, 1], [0, 2], [0, 3], [0, 4]], np.uint32)
    s0 = np.array([1, 0, 0, 0, 0], np.uint8)
    ls = CoreLocalSearch(w, edges, s0)
    ids, adj, wts, k = ls.extract_regions(np.array([0], np.uint32), rmax=2)
    kk = int(k[0])
    assert kk == 2
    # region = {0, leaf}; 0 has 3 outside non-cover leaves -> forced
    i0 = int(np.where(ids[0][:kk] == 0)[0][0])
    assert adj[0][i0] & (1 << i0)  # self-loop on the center
    bc, bs = batched_small_mwvc(adj, wts)
    assert int(bs[0]) & (1 << i0)  # exact solve keeps the forced vertex


def test_extract_regions_disjoint_within_batch():
    g = random_graph(500, 8, seed=1, wmax=50)
    s0 = np.ones(g.n, np.uint8)
    ls = CoreLocalSearch(g.weights, g.edge_array(), s0)
    centers = np.arange(0, 500, 7, dtype=np.uint32)
    ids, adj, wts, k = ls.extract_regions(centers, rmax=12)
    seen = set()
    for i in range(len(centers)):
        for v in ids[i][: int(k[i])]:
            assert int(v) not in seen  # no vertex claimed twice
            seen.add(int(v))


def test_apply_region_rejects_uncovering_and_nonimproving():
    ls = _path_ls()
    ids, adj, wts, k = ls.extract_regions(np.array([0], np.uint32), rmax=16)
    kk = int(k[0])
    # empty cover would uncover every edge -> reject
    assert not ls.apply_region(kk, ids[0][:kk], 0)
    # the incumbent assignment (no improvement) -> reject
    cur_mask = 0
    for i in range(kk):
        if ls.current()[ids[0][i]]:
            cur_mask |= 1 << i
    assert not ls.apply_region(kk, ids[0][:kk], cur_mask)
    # the exact optimum -> accepted, cost drops to 2
    bc, bs = batched_small_mwvc(adj, wts)
    assert ls.apply_region(kk, ids[0][:kk], int(bs[0]))
    assert ls.cost == int(bc[0]) == 2
    assert ls.commit_patches()
    assert ls.best_cost == 2


def test_apply_region_incremental_dscores_exact():
    """After a batch of applied patches the incrementally-maintained
    dscores must equal a from-scratch rebuild."""
    g = random_graph(600, 8, seed=9, wmax=50)
    s0 = np.ones(g.n, np.uint8)
    ls = CoreLocalSearch(g.weights, g.edge_array(), s0)
    ls.search(20000, 5.0)
    centers = np.arange(0, g.n, 11, dtype=np.uint32)
    ids, adj, wts, ks = ls.extract_regions(centers, rmax=12)
    bc, bs = batched_small_mwvc(adj, wts)
    applied = 0
    for i in range(len(centers)):
        k = int(ks[i])
        if k and ls.apply_region(k, ids[i, :k], int(bs[i])):
            applied += 1
    assert applied >= 1
    inc = ls.dscores().copy()
    ls.rebuild_scores()
    np.testing.assert_array_equal(inc, ls.dscores())


def test_perturb_guided_respects_bias_and_seed():
    g = random_graph(400, 6, seed=3, wmax=20)
    s0 = np.ones(g.n, np.uint8)
    ls1 = CoreLocalSearch(g.weights, g.edge_array(), s0)
    ls1.search(2000, 5.0)
    cover = ls1.current().copy()
    # bias 0 on a protected prefix: those vertices must never be removed
    bias = np.ones(g.n, np.float32)
    bias[:200] = 0.0
    ls1.perturb_guided(30, 42, bias)
    cur = ls1.current()
    assert np.array_equal(cur[:200] & cover[:200], cover[:200] & cover[:200])
    # determinism per seed
    ls2 = CoreLocalSearch(g.weights, g.edge_array(), s0)
    ls2.search(2000, 5.0)
    ls2.perturb_guided(30, 42, bias)
    assert np.array_equal(cur, ls2.current())


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _run_until_batch(assist, ls, deadline_s=120):
    import time

    deadline = time.time() + deadline_s  # first call compiles
    while assist.stats["batches"] == 0 and time.time() < deadline:
        assist.tick(ls)
        time.sleep(0.01)


def test_device_assist_worker_round_trip():
    """A dispatched batch is solved in-process and its patches land."""
    from gnn_mwvc.solver.device_assist import DeviceAssist

    g = random_graph(800, 8, seed=5, wmax=100)
    s0 = np.ones(g.n, np.uint8)  # all-in cover: plenty to improve
    ls = CoreLocalSearch(g.weights, g.edge_array(), s0)
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device=_cpu(),
                          batch=32, rmax=14)
    _run_until_batch(assist, ls)
    assist.stop()
    assert assist.stats["batches"] >= 1
    assert assist.stats["patches"] >= 1  # all-in cover is improvable
    assert assist.stats["gain"] > 0
    assert assist.stats["platform"] == "cpu"


def test_solve_device_assist_end_to_end():
    g = random_graph(3000, 12, seed=2, wmax=500)
    res = solve(g, time_limit=2.0, device_assist=True, assist_batch=32)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    assert res.assist_stats is not None
    # the kernel re-score ran on the route a peel round of its size takes
    # (here: the CPU) and its time is reported
    assert res.assist_stats["kernel_score_platform"] == "cpu"
    assert res.assist_stats["t_kernel_score_s"] > 0
    # plain solve on the same budget must not be beaten by more than noise
    res0 = solve(g, time_limit=2.0)
    assert res.cost <= res0.cost * 1.01


def test_kernel_rescore_routes_by_size():
    """GnnScorer.device_for: the accelerator at or above device_min_edges,
    the CPU below it or without an accelerator."""
    from gnn_mwvc.solver.pipeline import GnnScorer

    class _Accel:
        platform = "gpu"

    sc = GnnScorer(device_min_edges=1000)
    assert sc.device_for(10**9).platform == "cpu"  # no accelerator here
    sc._accel_dev = _Accel()
    assert sc.device_for(1000).platform == "gpu"
    assert sc.device_for(999).platform == "cpu"


def test_kernel_rescore_error_raises(monkeypatch):
    """A failed kernel re-score stops the solve; it is not skipped."""
    from gnn_mwvc.solver import pipeline
    from gnn_mwvc.solver.quick import QuickScorer

    def boom(self, snap, weight_scale):
        raise RuntimeError("kernel re-score failed")

    monkeypatch.setattr(pipeline.GnnScorer, "__call__", boom)
    g = random_graph(3000, 12, seed=2, wmax=500)
    with pytest.raises(RuntimeError, match="kernel re-score failed"):
        solve(g, time_limit=2.0, device_assist=True, assist_batch=32,
              scorer=QuickScorer())  # phase 1 does not use GnnScorer


def test_extract_regions_width20():
    """rmax > 16 extracts (B, 20) instances whose exact solves patch back."""
    g = random_graph(600, 6, seed=9, wmax=80)
    s0 = np.ones(g.n, np.uint8)
    ls = CoreLocalSearch(g.weights, g.edge_array(), s0)
    centers = np.arange(0, 600, 31, dtype=np.uint32)
    ids, adj, wts, k = ls.extract_regions(centers, rmax=20)
    assert adj.shape[1] == 20 and wts.shape[1] == 20
    assert int(k.max()) > 16  # BFS actually grows past the old cap
    from gnn_mwvc.ops.smallsolve import mitm_small_mwvc
    bc, bs = mitm_small_mwvc(adj, wts)
    applied = 0
    for i in range(len(centers)):
        kk = int(k[i])
        if kk and ls.apply_region(kk, ids[i][:kk], int(bs[i])):
            applied += 1
    assert applied >= 1  # all-in cover around any center is improvable
    ls.commit_patches()
    cur = ls.current().astype(bool)
    ea = g.edge_array()
    assert (cur[ea[:, 0]] | cur[ea[:, 1]]).all()  # still a cover


def test_device_assist_worker_width20():
    """rmax=20 on a non-CPU device extracts and solves width-20 regions.

    The device is a stand-in whose ``platform`` is not "cpu" (the arrays
    still live on the CPU backend), so the CPU clamp does not apply."""
    import jax

    from gnn_mwvc.solver.device_assist import DeviceAssist

    class _Accel:
        platform = "gpu"

    g = random_graph(400, 6, seed=15, wmax=60)
    s0 = np.ones(g.n, np.uint8)
    ls = CoreLocalSearch(g.weights, g.edge_array(), s0)
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device=_Accel(),
                          batch=16, rmax=20)
    assert assist.rmax == 20
    real_put = jax.device_put
    jax.device_put = lambda x, dev=None: real_put(x, _cpu())
    try:
        _run_until_batch(assist, ls)
        widths = {p["out"][0].shape for p in [assist._pending] if p}
    finally:
        jax.device_put = real_put
    assert assist.stats["batches"] >= 1
    assert assist.stats["patches"] >= 1
    assert assist.stats["gain"] > 0
    assert widths == {(16,)}  # the next batch is in flight


def test_assist_rmax_clamped_on_cpu_backend():
    """On the CPU backend rmax is clamped to 16 when the assist is built;
    extraction then yields width-16 instances."""
    from gnn_mwvc.solver.device_assist import DeviceAssist

    g = random_graph(300, 6, seed=2, wmax=50)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device=_cpu(),
                          batch=8, rmax=20)
    assert assist.rmax == 16
    assist.tick(ls)  # dispatch only
    ids, _ks = assist._pending["ids"], assist._pending["ks"]
    assert ids.shape == (8, 16)
    assist.stop()
    assert assist._pending is None


def test_assist_tick_dispatches_without_waiting():
    """tick() enqueues a batch and returns; a batch that is not ready yet is
    left in flight and nothing is applied."""
    import jax

    from gnn_mwvc.solver.device_assist import DeviceAssist

    g = random_graph(500, 8, seed=4, wmax=80)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device=_cpu(),
                          batch=16, rmax=12)
    assert assist.tick(ls) == 0 and assist._pending is not None
    assert assist.stats["batches"] == 0

    class _NotReady:
        def is_ready(self):
            return False

    pending = assist._pending
    real_out = pending["out"]
    pending["out"] = (_NotReady(), _NotReady())
    assert assist.tick(ls) == 0
    assert assist._pending is pending and assist.stats["batches"] == 0
    pending["out"] = jax.block_until_ready(real_out)  # harvested next tick
    cost0 = ls.cost
    applied = assist.tick(ls)
    assert assist.stats["batches"] == 1
    assert applied == assist.stats["patches"] >= 1
    assert ls.cost < cost0
    assert assist._pending is not None  # the next batch went out at once


def test_assist_device_error_raises():
    """A failed device batch raises on harvest instead of switching paths."""
    import pytest

    from gnn_mwvc.solver.device_assist import DeviceAssist

    g = random_graph(300, 6, seed=8, wmax=40)
    ls = CoreLocalSearch(g.weights, g.edge_array(), np.ones(g.n, np.uint8))
    assist = DeviceAssist(np.full(g.n, 0.5, np.float32), device=_cpu(),
                          batch=8, rmax=12)
    assist.tick(ls)

    class _Failed:
        def is_ready(self):
            return True

        def __array__(self, *a, **k):
            raise RuntimeError("device batch failed")

    assist._pending["out"] = (_Failed(), _Failed())
    with pytest.raises(RuntimeError, match="device batch failed"):
        assist.tick(ls)


def test_device_assist_module_has_no_second_process():
    """One JAX process per card: the assist never spawns a worker."""
    import gnn_mwvc.solver.device_assist as da

    src = open(da.__file__).read()
    assert "multiprocessing" not in src and "Process(" not in src
