"""Canonical-protocol head-to-head run (reference README.md:39-47 semantics):
1000 s cutoff, auto relabel interval, silent — prints the reference CSV line
`[graph],[VC written],[best seen],[time to best]` plus a JSON record.

Usage:
    python tools/canonical.py road900 [--time 1000] [--seed 1] [--tag r2a]
        [--out /tmp/canonical_road900_r2a.json]

Instance names: roadNNN (bench.build_road_graph(NNN)).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("instance")
    ap.add_argument("--time", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device-assist", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="device-assisted phase 2 (default: on when an "
                         "accelerator is present — the unified 'auto' "
                         "default; --no-device-assist reverts to the "
                         "round-2 ILS)")
    args = ap.parse_args(argv)

    from bench import build_road_graph
    from gnn_mwvc.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc.solver import solve
    from gnn_mwvc.solver.static_score import StickyGnnScorer

    assert args.instance.startswith("road")
    side = int(args.instance[4:])
    g = build_road_graph(side)
    print(f"instance {args.instance}: n={g.n} m={len(g.indices)//2}",
          flush=True)

    scorer = StickyGnnScorer()
    kw = {"device_assist": ("auto" if args.device_assist is None
                            else args.device_assist)}
    t0 = time.perf_counter()
    res = solve(g, time_limit=args.time, reorder=True, ls_seed=args.seed,
                verbose=True, scorer=scorer, **kw)
    wall = time.perf_counter() - t0
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost

    rec = {
        "instance": args.instance, "tag": args.tag, "seed": args.seed,
        "time_limit": args.time, "written": int(res.cost),
        "best": int(res.best_seen), "t_best": round(res.time_to_best, 1),
        "t_gnn": round(res.time_gnn, 1), "wall": round(wall, 1),
        "ls_steps": int(res.ls_steps),
        "scorer": {k: v for k, v in scorer.stats.items()},
        "device_assist": res.assist_stats is not None,
        "assist": res.assist_stats,
    }
    print(f"{args.instance},{res.cost},{res.best_seen},"
          f"{res.time_to_best:.1f}", flush=True)
    print(json.dumps(rec), flush=True)
    out = args.out or f"chiprun_out/canonical_{args.instance}_{args.tag}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main()
