"""gnn-vc command line — drop-in compatible with the reference driver.

Positional usage (reference: src/GNN_VC.cpp:244-247)::

    gnn-vc [graph file] [result file] [time] [k (< 0 = auto)] [0|1 verbose]

stdout contract on the default path (reference: GNN_VC.cpp:379)::

    [graph],[VC written to file],[Best VC seen],[time to best]

and on the fully-reduced path (GNN_VC.cpp:317)::

    [graph],[N],[E],[kernel],[cost_gnn],[t_gnn],[cost],[t]

Extras beyond the reference (flag-style, optional): --quick (no-GNN
priority scoring), --model PATH (alternate checkpoint), --json (structured
metrics incl. rule counters).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gnn-vc", add_help=True)
    ap.add_argument("graph")
    ap.add_argument("result")
    ap.add_argument("time", type=float)
    ap.add_argument("k", type=int, nargs="?", default=-1,
                    help="relabel interval; < 0 = auto (N/20 staleness)")
    ap.add_argument("verbose", type=int, nargs="?", default=0)
    ap.add_argument("--quick", action="store_true",
                    help="no-GNN mode: weight/degree priority (QUICK_VC)")
    ap.add_argument("--model", default=None)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device-assist", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="device-assisted phase 2: GNN-guided kicks + "
                         "device-batched exact region patches (default: on "
                         "when an accelerator is present)")
    ap.add_argument("--shards", type=int, default=0,
                    help="score phase 1 over an N-device mesh "
                         "(jax.sharding; edge-partitioned halo-exchange "
                         "forward, solver/sharded_score.py); 0 = "
                         "single-device scoring")
    args = ap.parse_args(argv)

    from gnn_mwvc.graphio import read_metis, write_solution
    from gnn_mwvc.graphio.validate import is_vertex_cover, cover_cost
    from gnn_mwvc.solver.pipeline import GnnScorer, solve
    from gnn_mwvc.solver.quick import QuickScorer

    name = os.path.splitext(os.path.basename(args.graph))[0]
    try:
        g = read_metis(args.graph)
    except OSError as e:
        print(f"Error opening graph file: {e}")
        return 1
    if g.n == 0:
        print("Empty graph")
        return 0
    verbose = bool(args.verbose)
    if verbose:
        print(f"{name}, N = {g.n}, E = {g.m}")

    model = None
    if args.model:
        from gnn_mwvc.models import load_model

        model = load_model(args.model)
    if args.quick:
        scorer = QuickScorer()
    elif args.shards:
        from gnn_mwvc.parallel import make_mesh
        from gnn_mwvc.solver.sharded_score import ShardedGnnScorer

        scorer = ShardedGnnScorer(model, mesh=make_mesh(args.shards))
    else:
        scorer = GnnScorer(model)

    res = solve(g, time_limit=args.time, relable_interval=args.k,
                verbose=verbose, scorer=scorer,
                device_assist=("auto" if args.device_assist is None
                               else args.device_assist))

    if not is_vertex_cover(g, res.solution):
        print("Result is not a vertex cover")
        return 1
    assert cover_cost(g, res.solution) == res.cost

    write_solution(args.result, res.solution)

    if args.json:
        print(json.dumps({
            "name": name, "n": g.n, "m": g.m,
            "cost": res.cost, "best_seen": res.best_seen,
            "time_to_best": round(res.time_to_best, 4),
            "time_gnn": round(res.time_gnn, 4),
            "time_total": round(res.time_total, 4),
            "kernel_size": res.kernel_size,
            "initial_cost": res.initial_cost,
            "counters": res.counters.tolist(),
            "ls_steps": res.ls_steps,
        }))
    elif verbose:
        print(
            f"Vertex cover cost: {res.cost}, found in "
            f"{res.time_to_best:.4f}s, {res.time_total:.4f} total time, "
            f"best seen {res.best_seen}"
        )
    elif res.kernel_size == 0 or res.ls_steps == 0:
        # fully reduced without local search (cost_gnn == final cost here)
        print(f"{name},{g.n},{g.m},{res.kernel_size},{res.cost},"
              f"{res.time_gnn:.6g},{res.cost},{res.time_to_best:.6g}")
    else:
        print(f"{name},{res.cost},{res.best_seen},{res.time_to_best:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
