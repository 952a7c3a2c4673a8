"""Dump a road instance's phase-1 kernel (+ model scores) for phase-2 A/B
experiments (tools/assist_ab.py): runs the production phase 1, then saves
the kernel CSR-as-edges, weights, initial cover, per-vertex model scores,
and the initial reduction cost to an npz.

Usage: python tools/dump_kernel.py road900 [--out kernel_road900.npz]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("instance")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from bench import build_road_graph
    from gnn_mwvc.core import CoreSolver, cluster_order
    from gnn_mwvc.solver.pipeline import gnn_peel
    from gnn_mwvc.solver.static_score import StickyGnnScorer

    assert args.instance.startswith("road")
    g = build_road_graph(int(args.instance[4:]))
    perm = cluster_order(g.indptr, g.indices)
    g = g.reorder(perm)
    ws = float(g.weights.max())
    scorer = StickyGnnScorer()
    core = CoreSolver(g.weights, g.edge_array())
    t0 = time.perf_counter()
    t_kernel, kernel_size, initial_cost = gnn_peel(core, scorer, ws)
    print(f"phase1 {time.perf_counter()-t0:.1f}s kernel={kernel_size} "
          f"init_cost={initial_cost}", flush=True)
    core.unfold(t_kernel)

    snap = core.snapshot()
    rows = np.repeat(np.arange(snap.n, dtype=np.int64),
                     np.diff(snap.indptr.astype(np.int64)))
    keep = rows < snap.indices
    kedges = np.stack([rows[keep], snap.indices[keep]], axis=1)
    s0 = np.array([core.decided(u) == 1 for u in snap.ids], dtype=np.uint8)

    # model scores over the kernel, mapped to snapshot rows
    ids_k, prob_k, _w, _d = scorer.score_core(core, ws)
    prob_local = np.full(snap.n, 0.5, np.float32)
    order = np.argsort(snap.ids)
    sid = snap.ids[order]
    idx = np.searchsorted(sid, ids_k)
    ok = (idx < len(sid)) & (sid[np.minimum(idx, len(sid) - 1)] == ids_k)
    prob_local[order[idx[ok]]] = np.asarray(prob_k)[ok]

    out = args.out or f"kernel_{args.instance}.npz"
    np.savez_compressed(
        out, weights=snap.weights, edges=kedges.astype(np.uint32), s0=s0,
        prob=prob_local, initial_cost=np.int64(initial_cost),
        t_phase1=np.float64(time.perf_counter() - t0),
    )
    print("saved", out, f"n={snap.n} m={len(kedges)}", flush=True)


if __name__ == "__main__":
    main()
