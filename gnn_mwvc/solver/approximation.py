"""Standalone 2-phase approximation solver (reference:
old_files/src/apps/approximation_solver.cpp): primal-dual edge-pricing
construction followed by the neighborhood-improvement pass.  No time budget —
one deterministic pass; useful as a warm start or fast baseline."""

from __future__ import annotations

import time

import numpy as np

from gnn_mwvc.core import approx_cover, improve_cover
from gnn_mwvc.graph import Graph
from gnn_mwvc.graphio import is_vertex_cover

__all__ = ["approximate_solve"]


def approximate_solve(g: Graph):
    """Returns (cover ndarray, cost, seconds)."""
    t0 = time.perf_counter()
    edges = g.edge_array()
    _, vc = approx_cover(g.weights, edges)
    cost, vc = improve_cover(g.weights, edges, vc)
    dt = time.perf_counter() - t0
    assert is_vertex_cover(g, vc)
    return vc, cost, dt
