"""mwvc-batch — solve many instances in one warm process (serving mode).

Why a batch driver: the one-time per-process costs (model load, native-core
build, XLA program compiles) amortize across instances.  Geometric shape bucketing
(graph.bucket_size, plan chunk padding) makes instances of similar size hit
the SAME compiled programs, so instance k pays only transfers and compute.

Usage::

    mwvc-batch a.metis b.metis ... --out results/ --time 60
    mwvc-batch --list instances.txt --out results/ --time 1000 --json

Per instance: writes <out>/<name>.sol (0/1 per vertex) and prints the
reference CSV contract ``name,cost_written,best_seen,time_to_best``; --json
appends one structured line per instance plus a final summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mwvc-batch")
    ap.add_argument("graphs", nargs="*")
    ap.add_argument("--list", default=None,
                    help="file with one instance path per line")
    ap.add_argument("--out", default=".")
    ap.add_argument("--time", type=float, default=1000.0,
                    help="per-instance cutoff (reference default 1000 s)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-reorder", action="store_true",
                    help="skip the clustered relabel (on by default: it "
                    "gives the aggregation gathers locality)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    paths = list(args.graphs)
    if args.list:
        with open(args.list) as f:
            paths += [ln.strip() for ln in f if ln.strip()]
    if not paths:
        ap.error("no instances (pass files or --list)")
    os.makedirs(args.out, exist_ok=True)

    from gnn_mwvc.graphio import cover_cost, is_vertex_cover, read_metis
    from gnn_mwvc.solver import solve
    from gnn_mwvc.solver.static_score import StickyGnnScorer

    scorer = None
    if args.quick:
        from gnn_mwvc.solver.quick import QuickScorer

        scorer = QuickScorer()

    rows = []
    t_batch = time.perf_counter()
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        g = read_metis(path)
        t0 = time.perf_counter()
        # a fresh sticky scorer per instance (it is stateful per graph), but
        # the jitted programs, model, and native core stay warm in-process
        res = solve(
            g, time_limit=args.time, reorder=not args.no_reorder,
            scorer=scorer if args.quick else StickyGnnScorer(),
        )
        dt = time.perf_counter() - t0
        # explicit validation (asserts vanish under python -O; this is the
        # serving entry point and must never emit an unvalidated cover)
        if not is_vertex_cover(g, res.solution):
            print(f"{name}: INVALID COVER — not written", file=sys.stderr)
            return 2
        if cover_cost(g, res.solution) != res.cost:
            print(f"{name}: cost mismatch — not written", file=sys.stderr)
            return 2
        sol_path = os.path.join(args.out, name + ".sol")
        with open(sol_path, "w") as f:
            f.write("\n".join(map(str, res.solution.astype(int))) + "\n")
        print(f"{name},{res.cost},{res.best_seen},{res.time_to_best:.4g}",
              flush=True)
        rows.append({
            "name": name, "n": int(g.n), "m": int(g.m),
            "cost": int(res.cost), "best_seen": int(res.best_seen),
            "t_best": round(res.time_to_best, 3),
            "t_total": round(dt, 3),
            "t_phase1": round(res.time_gnn, 3),
            "solution": sol_path,
        })
        if args.json:
            print(json.dumps(rows[-1]), flush=True)
    if args.json:
        print(json.dumps({
            "instances": len(rows),
            "t_batch": round(time.perf_counter() - t_batch, 3),
            "total_cost": int(sum(r["cost"] for r in rows)),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
