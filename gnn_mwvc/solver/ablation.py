"""Ablation harness: the 8-config grid {GNN|greedy} x {reductions} x
{small_solve}, each followed by the neighborhood-improvement pass, with
rule-fire counters — the reference's GNN_VC_experimental
(reference: old_files/src/apps/GNN_VC_experimental.cpp:104-301).

Config letters follow the reference's output header: G = GNN scoring,
Q = weight/degree priority ("QUICK"), R = reductions, S = small_solve;
every run also reports the cost after ("L") and before the improvement pass.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from gnn_mwvc.core import CoreSolver, improve_cover
from gnn_mwvc.graph import Graph
from gnn_mwvc.graphio import cover_cost, is_vertex_cover
from gnn_mwvc.models import Model
from gnn_mwvc.solver.pipeline import GnnScorer

__all__ = ["AblationResult", "run_config", "run_ablation"]


@dataclasses.dataclass
class AblationResult:
    config: str
    cost: int               # after improvement pass
    time: float
    cost_before: int        # before improvement pass
    time_before: float
    counters: Optional[np.ndarray] = None
    small_solve_count: int = 0
    labels_from_model: int = 0


def run_config(
    g: Graph,
    scorer,
    weight_scale: float,
    use_gnn: bool,
    use_reductions: bool,
    use_small_solve: bool,
    relable_interval: int,
) -> AblationResult:
    t1 = time.perf_counter()
    core = CoreSolver(g.weights, g.edge_array())
    if use_reductions:
        core.reduce()
    interval = relable_interval if use_reductions else 100000
    ss_count = 0
    while core.active_count > 0:
        if use_small_solve:
            ss_count += core.solve_small_components(75)
            if core.active_count == 0:
                break
        snap = core.snapshot()
        if use_gnn:
            prob = scorer(snap, weight_scale)
            if use_reductions:
                # sort purely by confidence (no tie-break,
                # reference: GNN_VC_experimental.cpp:135-138)
                order = np.argsort(np.minimum(prob, 1.0 - prob),
                                   kind="stable")
            else:
                order = np.argsort(prob, kind="stable")
        else:
            # weight desc, degree asc (reference: 144-146)
            prob = np.zeros(snap.n, dtype=np.float32)
            order = np.lexsort((snap.deg.astype(np.int64),
                                -snap.weights.astype(np.int64)))
        core.reset_label_count()
        core.peel(snap.ids[order], prob[order].astype(np.float32),
                  interval, use_gnn=use_gnn, use_reductions=use_reductions)
    core.unfold(0)
    sol = (core.solution() == 1).astype(np.uint8)
    assert is_vertex_cover(g, sol)
    t2 = time.perf_counter()
    cost_before = cover_cost(g, sol)

    new_cost, sol = improve_cover(g.weights, g.edge_array(), sol)
    assert is_vertex_cover(g, sol)
    assert cover_cost(g, sol) == new_cost
    t3 = time.perf_counter()

    letters = ("G" if use_gnn else "Q") + ("R" if use_reductions else "") + \
        ("S" if use_small_solve else "")
    return AblationResult(
        config=letters,
        cost=new_cost,
        time=t3 - t1,
        cost_before=cost_before,
        time_before=t2 - t1,
        counters=core.counters,
        small_solve_count=ss_count,
        labels_from_model=core.labels_from_model,
    )


def run_ablation(g: Graph, model: Optional[Model] = None, scorer=None,
                 verbose=False):
    """All 8 configs; returns list of AblationResult (GRS first, like the
    reference's column order)."""
    scorer = scorer or GnnScorer(model)
    ws = float(g.weights.max())
    relable_interval = max(10, g.m // 500_000)
    results = []
    for use_gnn in (True, False):
        for use_red in (True, False):
            for use_ss in (True, False):
                r = run_config(g, scorer, ws, use_gnn, use_red, use_ss,
                               relable_interval)
                results.append(r)
                if verbose:
                    print(f"{r.config or 'Q'}: {r.cost} ({r.time:.2f}s), "
                          f"before improvement {r.cost_before}")
    return results


def ablation_csv(name: str, g: Graph, results) -> str:
    """Reference output row: Name,N,E,<cost,t,cost_before,t_before>x8,r1..r8,
    ss_count,labels_from_model (for the full GRS config)."""
    parts = [name, str(g.n), str(g.m)]
    for r in results:
        parts += [str(r.cost), f"{r.time:.4f}", str(r.cost_before),
                  f"{r.time_before:.4f}"]
    full = results[0]
    parts += [str(int(c)) for c in full.counters]
    parts += [str(full.small_solve_count), str(full.labels_from_model)]
    return ",".join(parts)
