"""Canonical-protocol CPU-mesh solve parity.

Runs the full solve pipeline on a road-class instance with phase-1 scoring
routed through ShardedGnnScorer on a P-device virtual CPU mesh, against
the single-device CPU scorer, and asserts COVER IDENTITY on the
deterministic phase-1 output (time_limit=0: reduce -> score -> peel ->
unfold; phase 2's local search is scorer-independent).  Records phase-1
wall time for both paths plus the halo statistics.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tools/sharded_solve.py road300 --parts 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("instance")
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from bench import build_road_graph
    from gnn_mwvc.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc.parallel import make_mesh
    from gnn_mwvc.solver import ShardedGnnScorer, solve
    from gnn_mwvc.solver.pipeline import GnnScorer

    assert args.instance.startswith("road")
    g = build_road_graph(int(args.instance[4:]))
    print(f"{args.instance}: n={g.n} m={len(g.indices)//2}", flush=True)

    mesh = make_mesh(args.parts)
    # exact-parity mode: rebuild whenever ANY fold gadget exists, so no
    # round ever scores with the gadget-neutrality approximation (which
    # the single-device per-snapshot scorer doesn't share — production
    # uses rebuild_gadget_frac=0.02 + neutral gadgets, like the
    # single-chip sticky scorer).  Rebuilds are shape-templated, so this
    # trades host prep, not compiles.
    sh = ShardedGnnScorer(mesh=mesh, rebuild_gadget_frac=0.0)
    t0 = time.perf_counter()
    res_s = solve(g, time_limit=0.0, reorder=True, scorer=sh,
                  device_assist=False)
    t_mesh = time.perf_counter() - t0

    t0 = time.perf_counter()
    res_1 = solve(g, time_limit=0.0, reorder=True,
                  scorer=GnnScorer(device_min_edges=1 << 62),
                  device_assist=False)
    t_single = time.perf_counter() - t0

    assert is_vertex_cover(g, res_s.solution)
    assert cover_cost(g, res_s.solution) == res_s.cost
    identical = bool(np.array_equal(res_s.solution, res_1.solution))
    rec = {
        "instance": args.instance, "parts": args.parts,
        "cost_mesh": int(res_s.cost), "cost_single": int(res_1.cost),
        "identical_covers": identical,
        "t_phase1_mesh_s": round(t_mesh, 1),
        "t_phase1_single_s": round(t_single, 1),
        "mesh_scorer": {k: v for k, v in sh.stats.items()},
    }
    print(json.dumps(rec), flush=True)
    out = args.out or f"/tmp/sharded_solve_{args.instance}_p{args.parts}.json"
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    if not identical or res_s.cost != res_1.cost:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
