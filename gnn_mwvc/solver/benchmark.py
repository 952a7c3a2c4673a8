"""Differential benchmark harness: run our solvers, our baseline
reimplementations, and (when available) the reference binaries on the same
instances and emit a comparison table (SURVEY.md §7 step 7).

Usage:
    python -m gnn_mwvc.solver.benchmark g1.metis g2.metis --time 100
    python -m gnn_mwvc.solver.benchmark --suite quick --time 10

Reference binaries are looked up in $MWVC_REFERENCE_BIN (default
/tmp/gnn_mwvc_oracle, where tests/oracle/build_oracle.sh puts them).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REF_BIN = os.environ.get("MWVC_REFERENCE_BIN", "/tmp/gnn_mwvc_oracle")


def run_ours(g, budget, mode="gnn", reorder=False):
    from gnn_mwvc.graphio import cover_cost, is_vertex_cover
    from gnn_mwvc.solver import solve
    from gnn_mwvc.solver.quick import QuickScorer

    kw = {}
    if mode == "quick":
        kw["scorer"] = QuickScorer()
    t0 = time.perf_counter()
    res = solve(g, time_limit=budget, reorder=reorder, **kw)
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
    return {"cost": res.cost, "best_seen": res.best_seen,
            "t_best": round(res.time_to_best, 3),
            "t_total": round(time.perf_counter() - t0, 3)}


def run_approx(g):
    from gnn_mwvc.solver.approximation import approximate_solve

    vc, cost, dt = approximate_solve(g)
    return {"cost": cost, "best_seen": cost, "t_best": round(dt, 3),
            "t_total": round(dt, 3)}


def run_baseline(g, which, budget, seed=1):
    from gnn_mwvc.core import baseline_solve
    from gnn_mwvc.graphio import is_vertex_cover

    t0 = time.perf_counter()
    cost, vc, t_best = baseline_solve(which, g.weights, g.edge_array(),
                                      seed=seed, cutoff=budget)
    assert is_vertex_cover(g, vc)
    return {"cost": cost, "best_seen": cost, "t_best": round(t_best, 3),
            "t_total": round(time.perf_counter() - t0, 3)}


def run_reference(path, name, budget, seed=1):
    """Run a reference binary; returns dict or None if unavailable."""
    exe = os.path.join(REF_BIN, name)
    if not os.path.exists(exe):
        return None
    try:
        if name == "GNN_VC":
            cmd = [exe, path, path + ".refsol", str(budget), "-1", "0"]
        elif name == "HILS":
            cmd = [exe, "-t", str(budget), path]
        else:
            cmd = [exe, path, str(seed), str(budget)] + (
                ["3"] if name in ("FastWVC", "DynWVC2") else []
            )
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=budget * 3 + 300)
        line = out.stdout.strip().splitlines()[-1]
        fields = line.split(",")
        if name == "GNN_VC":
            cost = int(fields[-2]) if len(fields) == 8 else int(fields[1])
            t_best = float(fields[-1])
        elif name == "HILS":
            # prints IS weight; convert via total - IS
            from gnn_mwvc.graphio import read_metis

            g = read_metis(path)
            cost = int(g.weights.sum()) - int(fields[1])
            t_best = float(fields[2]) if len(fields) > 2 else 0.0
        else:
            cost = int(fields[1])
            t_best = float(fields[2])
        return {"cost": cost, "best_seen": cost, "t_best": t_best,
                "t_total": None}
    except Exception:
        return None


def make_suite(which):
    """Built-in synthetic suites (no external data dependency)."""
    import tempfile

    from bench import build_road_graph
    from gnn_mwvc.graphio import write_metis
    from tests.conftest import random_graph

    graphs = []
    if which == "quick":
        specs = [("rnd5k", lambda: random_graph(5000, 16, seed=1, wmax=100)),
                 ("road90", lambda: build_road_graph(90))]
    else:  # full
        specs = [
            ("rnd5k", lambda: random_graph(5000, 16, seed=1, wmax=100)),
            ("rnd50k", lambda: random_graph(50_000, 12, seed=2, wmax=1000)),
            ("road300", lambda: build_road_graph(300)),
            ("road900", lambda: build_road_graph(900)),
        ]
    d = tempfile.mkdtemp(prefix="mwvc_bench_")
    for name, mk in specs:
        g = mk()
        path = os.path.join(d, name + ".metis")
        write_metis(path, g)
        graphs.append(path)
    return graphs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mwvc-bench")
    ap.add_argument("graphs", nargs="*")
    ap.add_argument("--suite", choices=["quick", "full"])
    ap.add_argument("--time", type=float, default=10.0)
    ap.add_argument("--solvers", default="gnn,quick,approx,fastwvc,dynwvc2,"
                    "numwvc,hils,ref:GNN_VC,ref:FastWVC,ref:DynWVC2")
    ap.add_argument("--reorder", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (leaves the card to other work)")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from gnn_mwvc.graphio import read_metis

    paths = list(args.graphs)
    if args.suite:
        paths += make_suite(args.suite)
    if not paths:
        ap.error("no graphs (pass files or --suite)")

    solvers = args.solvers.split(",")
    rows = []
    for path in paths:
        g = read_metis(path)
        name = os.path.splitext(os.path.basename(path))[0]
        row = {"graph": name, "n": g.n, "m": g.m}
        for s in solvers:
            if s == "gnn":
                r = run_ours(g, args.time, "gnn", args.reorder)
            elif s == "quick":
                r = run_ours(g, args.time, "quick", args.reorder)
            elif s == "approx":
                r = run_approx(g)
            elif s.startswith("ref:"):
                r = run_reference(path, s[4:], args.time)
            else:
                r = run_baseline(g, s, args.time)
            row[s] = r
            print(f"  {name} {s}: "
                  f"{r['cost'] if r else 'n/a'}", file=sys.stderr)
        rows.append(row)

    if args.json:
        print(json.dumps(rows))
    else:
        solver_names = [s for s in solvers]
        print("graph,n,m," + ",".join(f"{s}_cost,{s}_t" for s in solver_names))
        for row in rows:
            cells = [row["graph"], str(row["n"]), str(row["m"])]
            for s in solver_names:
                r = row[s]
                cells += ([str(r["cost"]), str(r["t_best"])] if r
                          else ["", ""])
            print(",".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
