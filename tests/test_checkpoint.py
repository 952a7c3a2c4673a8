"""Checkpoint/resume + observability tests."""

import os

import numpy as np
import pytest

from gnn_mwvc.core import CoreSolver
from gnn_mwvc.graphio import cover_cost, is_vertex_cover
from gnn_mwvc.solver.checkpoint import (
    graph_fingerprint,
    load_checkpoint,
    resume_solve,
    save_checkpoint,
)
from tests.conftest import random_graph


def test_preview_solution_nondestructive():
    g = random_graph(200, 6, seed=61)
    s = CoreSolver(g.weights, g.edge_array())
    s.reduce(critical=True)
    s.solve_small_components(1000)  # solve everything (small graph)
    t_before = s.timestamp
    preview = s.preview_solution()
    # preview did not unfold the real solver
    assert s.timestamp == t_before
    assert (preview >= 0).all()
    assert is_vertex_cover(g, preview)
    # destructive unfold agrees with the preview
    s.unfold(0)
    np.testing.assert_array_equal(s.solution(), preview)


def test_checkpoint_roundtrip(tmp_path):
    g = random_graph(150, 6, seed=62)
    cover = np.ones(g.n, dtype=np.int8)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, g, cover, int(g.weights.sum()), 1.5,
                    extra={"note": "test"})
    c2, meta = load_checkpoint(path, g)
    np.testing.assert_array_equal(c2, cover)
    assert meta["cost"] == int(g.weights.sum())
    assert meta["note"] == "test"
    # wrong graph rejected
    g2 = random_graph(150, 6, seed=63)
    with pytest.raises(ValueError):
        load_checkpoint(path, g2)


def test_checkpoint_rejects_invalid(tmp_path):
    g = random_graph(100, 6, seed=64)
    bad = np.zeros(g.n, dtype=np.int8)
    with pytest.raises(AssertionError):
        save_checkpoint(str(tmp_path / "x.npz"), g, bad, 0, 0.0)


def test_resume_improves(tmp_path):
    g = random_graph(400, 8, seed=65, wmax=100)
    path = str(tmp_path / "ck.npz")
    cover = np.ones(g.n, dtype=np.int8)
    save_checkpoint(path, g, cover, int(g.weights.sum()), 0.0)
    best, cost, seen = resume_solve(g, path, time_limit=2.0)
    assert is_vertex_cover(g, best)
    assert cost == cover_cost(g, best)
    assert cost < g.weights.sum()
    # checkpoint file was updated with the improvement
    c2, meta = load_checkpoint(path, g)
    assert meta["cost"] == cost


def test_solve_with_checkpointing(tmp_path):
    from gnn_mwvc.solver import solve

    g = random_graph(1200, 12, seed=66, wmax=400)
    path = str(tmp_path / "run.npz")
    res = solve(g, time_limit=3.0, checkpoint_path=path,
                checkpoint_interval=0.1)
    if os.path.exists(path):  # improvements occurred after the first interval
        cover, meta = load_checkpoint(path, g)
        assert is_vertex_cover(g, cover)
        assert meta["cost"] >= res.cost  # final result is at least as good


def test_metrics_utils(tmp_path):
    from gnn_mwvc.utils import PhaseTimer, SolveMetrics, trace_span

    t = PhaseTimer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    assert t.as_dict()["a"]["calls"] == 2

    m = SolveMetrics(sink=str(tmp_path / "m.jsonl"))
    m.record_round(nodes_remaining=10, edges_scored=20, decisions=5,
                   label_count=3, seconds_score=0.1, seconds_peel=0.2)
    out = m.summary(cost=42)
    assert out["cost"] == 42 and len(out["rounds"]) == 1
    assert os.path.exists(tmp_path / "m.jsonl")

    with trace_span("x"):
        pass
