"""Comparison-baseline solver tests: validity + quality sanity."""

import numpy as np
import pytest

from gnn_mwvc.core import baseline_solve
from gnn_mwvc.graphio import cover_cost, is_vertex_cover
from tests.test_core import brute_force_mwvc, small_random


@pytest.mark.parametrize("which", ["fastwvc", "dynwvc2", "numwvc", "hils"])
def test_baseline_valid(which):
    from tests.conftest import random_graph

    g = random_graph(400, 8, seed=77, wmax=100)
    cost, vc, t_best = baseline_solve(which, g.weights, g.edge_array(),
                                      seed=3, cutoff=2.0)
    assert is_vertex_cover(g, vc)
    assert cover_cost(g, vc) == cost
    # quality sanity: strictly better than the all-in cover and the trivial
    # bound of total weight
    assert cost < g.weights.sum() * 0.9


@pytest.mark.parametrize("which", ["fastwvc", "dynwvc2", "numwvc", "hils"])
def test_baseline_near_optimal_small(which):
    g = small_random(12, 0.3, 5)
    opt = brute_force_mwvc(g)
    cost, vc, _ = baseline_solve(which, g.weights, g.edge_array(), seed=1,
                                 cutoff=2.0)
    assert is_vertex_cover(g, vc)
    assert cost == opt  # tiny instances: all baselines find the optimum


def test_baselines_comparable_to_flagship():
    """On a mid graph, our GNN solver should beat or match every baseline."""
    from tests.conftest import random_graph
    from gnn_mwvc.solver import solve

    g = random_graph(1000, 10, seed=88, wmax=200)
    res = solve(g, time_limit=3.0)
    for which in ("fastwvc", "dynwvc2", "numwvc", "hils"):
        cost, vc, _ = baseline_solve(which, g.weights, g.edge_array(),
                                     seed=1, cutoff=3.0)
        assert is_vertex_cover(g, vc)
        assert res.cost <= cost * 1.02, (which, res.cost, cost)


def test_baseline_determinism():
    from tests.conftest import random_graph

    g = random_graph(200, 6, seed=9)
    a = baseline_solve("fastwvc", g.weights, g.edge_array(), seed=7,
                       cutoff=0.5)
    b = baseline_solve("fastwvc", g.weights, g.edge_array(), seed=7,
                       cutoff=0.5)
    # same seed, same budget: costs should coincide on a small instance
    assert a[0] == b[0]


# ---- road-class differential gates vs the reference binaries ---------------
# (all four baselines test-gated within noise of their binaries, with the
# oracle auto-built instead of skipping.)

ORACLE_DIR = "/tmp/gnn_mwvc_oracle"
_DIFF_BINS = ("FastWVC", "DynWVC2", "NuMWVC", "HILS")


@pytest.fixture(scope="session")
def oracle_dir():
    import os
    import subprocess

    if not all(os.path.exists(os.path.join(ORACLE_DIR, b))
               for b in _DIFF_BINS):
        script = os.path.join(os.path.dirname(__file__), "oracle",
                              "build_oracle.sh")
        subprocess.run(["bash", script], check=True, capture_output=True,
                       timeout=900)
    return ORACLE_DIR


@pytest.fixture(scope="session")
def road90():
    import os

    import bench
    from gnn_mwvc.graphio import write_metis

    g = bench.build_road_graph(90)
    path = "/tmp/road90_diff.metis"
    if not os.path.exists(path):
        write_metis(path, g)
    return path, g


def _run_ref_binary(exe, argv, timeout=90):
    import subprocess

    out = subprocess.run([exe] + argv, capture_output=True, text=True,
                         timeout=timeout)
    return out.stdout.strip().splitlines()[-1].split(",")


@pytest.mark.parametrize("which", ["fastwvc", "dynwvc2", "numwvc", "hils"])
def test_baseline_road_differential(which, oracle_dir, road90):
    """Each reimplemented baseline must match its reference binary within
    local-search noise on road90 at an equal cutoff (DynWVC2/FastWVC/NuMWVC
    have beaten their binaries)."""
    import os

    path, g = road90
    cutoff = 3.0
    exe = {"fastwvc": "FastWVC", "dynwvc2": "DynWVC2",
           "numwvc": "NuMWVC", "hils": "HILS"}[which]
    exe = os.path.join(oracle_dir, exe)
    if which in ("fastwvc", "dynwvc2"):
        f = _run_ref_binary(exe, [path, "1", str(int(cutoff)), "3"])
        ref_cost = int(f[1])
    elif which == "numwvc":
        f = _run_ref_binary(exe, [path, "1", str(int(cutoff))])
        ref_cost = int(f[1])
    else:  # hils reports the IS weight; cover = total - IS (README.md:16)
        f = _run_ref_binary(exe, ["-T", str(int(cutoff)), "-s", "1", path])
        ref_cost = int(g.weights.sum()) - int(f[1])
    cost, vc, _ = baseline_solve(which, g.weights, g.edge_array(),
                                 seed=1, cutoff=cutoff)
    assert is_vertex_cover(g, vc)
    assert cover_cost(g, vc) == cost
    # within noise of the binary: never worse than 0.5%
    assert cost <= ref_cost * 1.005, (which, cost, ref_cost)


def test_fastwvc_tuned_road_differential(oracle_dir, road90, tmp_path,
                                         capsys):
    """fastwvc-tuned gated against its reference binary:
    equal-cutoff road90, same 0.5% noise margin as the other four
    baselines.  The oracle reads `E N`, N weights, E 1-indexed edges on
    stdin and prints `best_cost,t_best`
    (reference: old_files/src/apps/fastWVC_tuned.cpp:17-35,88)."""
    import os
    import subprocess

    from gnn_mwvc.solver.baselines.cli import main as bl_main

    exe = os.path.join(oracle_dir, "fastWVC_tuned")
    if not os.path.exists(exe):  # stale oracle dir from an older build
        script = os.path.join(os.path.dirname(__file__), "oracle",
                              "build_oracle.sh")
        subprocess.run(["bash", script], check=True, capture_output=True,
                       timeout=900)
    path, g = road90
    cutoff = 3.0
    e = g.edge_array()
    lines = [f"{len(e)} {g.n}"]
    lines.append(" ".join(map(str, g.weights.tolist())))
    lines.extend(f"{u + 1} {v + 1}" for u, v in e.tolist())
    out = subprocess.run([exe, str(cutoff)], input="\n".join(lines),
                         capture_output=True, text=True, timeout=60)
    ref_cost = int(out.stdout.strip().splitlines()[-1].split(",")[0])
    assert ref_cost > 0

    sol = str(tmp_path / "fwt.sol")
    rc = bl_main(["fastwvc-tuned", path, "1", str(int(cutoff)),
                  "--out", sol])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    cost = int(line.split(",")[1])
    vc = __import__("gnn_mwvc.graphio", fromlist=["read_solution"]
                    ).read_solution(sol)
    assert is_vertex_cover(g, vc)
    assert cover_cost(g, vc) == cost
    assert cost <= ref_cost * 1.005, (cost, ref_cost)


def test_fastwvc_tuned_cli(tmp_path, capsys):
    """fastwvc-tuned subcommand (round 4, closes the last reference app
    gap — old_files/src/apps/fastWVC_tuned.cpp): greedy construction +
    shared local search must beat the bare construction and emit the CSV
    contract."""
    from gnn_mwvc.core import greedy_cover
    from gnn_mwvc.graphio import read_solution, write_metis
    from gnn_mwvc.solver.baselines.cli import main as bl_main
    from tests.conftest import random_graph

    g = random_graph(1500, 8, seed=6, wmax=100)
    path = str(tmp_path / "g.metis")
    write_metis(path, g)
    out = str(tmp_path / "g.sol")
    greedy_cost, _ = greedy_cover(g.weights, g.edge_array())
    rc = bl_main(["fastwvc-tuned", path, "1", "2", "--out", out])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    parts = line.split(",")
    assert parts[0] == path
    cost = int(parts[1])
    assert cost < greedy_cost
    vc = read_solution(out)
    assert is_vertex_cover(g, vc)
    assert cover_cost(g, vc) == cost
