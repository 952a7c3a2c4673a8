"""End-to-end solver pipeline + CLI tests (CPU backend)."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from gnn_mwvc.graphio import (
    cover_cost,
    is_vertex_cover,
    read_solution,
    write_metis,
)
from gnn_mwvc.solver import solve
from gnn_mwvc.solver.pipeline import confidence_order


def test_confidence_order_semantics():
    # exclusion (p<0.5) with same confidence sorts before inclusion
    prob = np.array([0.9, 0.1, 0.95, 0.05], dtype=np.float32)
    w = np.array([10, 10, 10, 10])
    d = np.array([1, 1, 1, 1])
    order = confidence_order(prob, w, d)
    # 0.95/0.05 pair has conf 0.05 (more certain) -> first; excl before incl
    assert list(order[:2]) == [3, 2]
    assert list(order[2:]) == [1, 0]
    # inclusion ties: lighter first, then higher degree first
    prob2 = np.array([0.9, 0.9, 0.9], dtype=np.float32)
    w2 = np.array([5, 3, 3])
    d2 = np.array([1, 1, 9])
    assert list(confidence_order(prob2, w2, d2)) == [2, 1, 0]


def test_solve_small(ex3_graph):
    res = solve(ex3_graph, time_limit=2.0)
    assert res.cost == 20
    np.testing.assert_array_equal(res.solution, [0, 0, 1])


@pytest.mark.parametrize("n,deg,wmax,seed", [(800, 10, 50, 4), (1500, 14, 500, 5)])
def test_solve_random_valid_and_competitive(rnd_graph, oracle_dir, n, deg,
                                            wmax, seed):
    from tests.conftest import random_graph

    g = random_graph(n, deg, seed=seed, wmax=wmax)
    res = solve(g, time_limit=4.0)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    assert res.best_seen <= res.cost

    with tempfile.NamedTemporaryFile("w", suffix=".metis", delete=False) as f:
        write_metis(f, g)
        path = f.name
    out = subprocess.run(
        [os.path.join(oracle_dir, "GNN_VC"), path, path + ".sol", "4", "-1",
         "0"],
        capture_output=True, text=True, timeout=120,
    )
    fields = out.stdout.strip().split(",")
    ref_cost = int(fields[-2]) if len(fields) == 8 else int(fields[1])
    os.unlink(path)
    # acceptance bar (SURVEY.md §6): our cover must not be worse
    assert res.cost <= ref_cost * 1.005


def test_solve_quick_mode(rnd_graph):
    from tests.conftest import random_graph
    from gnn_mwvc.solver.quick import QuickScorer

    g = random_graph(600, 8, seed=6)
    res = solve(g, time_limit=2.0, scorer=QuickScorer())
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost


def test_cli_contract(tmp_path, rnd_graph):
    from tests.conftest import random_graph

    g = random_graph(400, 8, seed=7)
    gpath = tmp_path / "g.metis"
    spath = tmp_path / "g.sol"
    write_metis(str(gpath), g)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "gnn_mwvc.solver.cli", str(gpath),
         str(spath), "2", "-1", "0"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr[-800:]
    line = [l for l in out.stdout.splitlines() if l.startswith("g,")][-1]
    fields = line.split(",")
    assert fields[0] == "g"
    sol = read_solution(spath)
    assert len(sol) == g.n
    assert is_vertex_cover(g, sol)
    # cost field must equal the written solution's cost
    cost = int(fields[-2]) if len(fields) == 8 else int(fields[1])
    assert cover_cost(g, sol) == cost


def test_confidence_order_native_matches_numpy():
    import numpy as np

    from gnn_mwvc.core import confidence_order_native
    from gnn_mwvc.solver.pipeline import CONF_EPS

    rng = np.random.default_rng(11)
    n = 30000
    prob = rng.random(n).astype(np.float32)
    w = rng.integers(1, 5000, n).astype(np.uint32)
    d = rng.integers(0, 200, n).astype(np.uint32)
    av = np.minimum(prob, 1.0 - prob)
    bucket = np.floor(av / CONF_EPS)
    incl = prob > 0.5
    k_w = np.where(incl, w.astype(np.int64), -w.astype(np.int64))
    k_d = np.where(incl, -d.astype(np.int64), d.astype(np.int64))
    ref = np.lexsort((k_d, k_w, incl.astype(np.int8), bucket))
    got = confidence_order_native(prob, w, d, CONF_EPS)
    assert np.array_equal(ref.astype(np.uint32), got)


def test_batch_cli(tmp_path):
    import numpy as np

    from gnn_mwvc.graphio import write_metis
    from gnn_mwvc.solver.batch import main as batch_main
    from tests.conftest import random_graph

    paths = []
    for s in (1, 2):
        g = random_graph(300, 6, seed=s, wmax=50)
        p = str(tmp_path / f"g{s}.metis")
        write_metis(p, g)
        paths.append(p)
    out = str(tmp_path / "res")
    rc = batch_main(paths + ["--out", out, "--time", "0.5", "--json"])
    assert rc == 0
    for s in (1, 2):
        sol = np.loadtxt(out + f"/g{s}.sol", dtype=int)
        assert len(sol) == 300


@pytest.mark.parametrize("side,seed", [(30, 77), (30, 108), (40, 290)])
def test_phase1_decisions_cover_the_kernel(side, seed):
    """Road graphs on which a neighborhood fold of a fold gadget once took
    two adjacent neighbors for independent: unfolded with the gadget out,
    the peel decisions left a kernel edge uncovered.  The phase-2 initial
    cover (kernel_state) must cover every kernel edge, and a budget that
    ends before phase 2 writes a valid cover of the reported cost."""
    import bench
    from gnn_mwvc.core import CoreSolver
    from gnn_mwvc.solver.pipeline import gnn_peel, kernel_state
    from tests.test_core import _GadgetsFirst

    g = bench.build_road_graph(side, seed=seed)
    core = CoreSolver(g.weights, g.edge_array())
    t_kernel, _, _ = gnn_peel(core, _GadgetsFirst(g.n),
                              float(g.weights.max()))
    core.unfold(t_kernel)
    snap, kedges, s0 = kernel_state(core)
    assert len(kedges) and (s0[kedges[:, 0]] | s0[kedges[:, 1]]).all()

    res = solve(g, time_limit=0.0, scorer=_GadgetsFirst(g.n),
                device_assist=False)
    assert res.ls_steps == 0
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
