"""Quality soak: ours vs the reference GNN_VC binary across instance classes.

Runs each instance twice on our side (the first run warms per-process
program loads — the production-server pattern; both results are recorded)
and once per reference binary, then prints a wins/ties/losses summary on
best-seen cost at equal wall-clock budgets.

Usage:
    python tools/soak.py [--time 30] [--out /tmp/soak.json] [--classes er,pl,road]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_BIN = os.environ.get("MWVC_REFERENCE_BIN", "/tmp/gnn_mwvc_oracle")


def powerlaw_graph(n, m_attach, seed, wmax=1000):
    """Barabasi-Albert-style preferential attachment (vectorized-ish)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated = []
    edges = []
    for v in range(m_attach, n):
        for t in targets[:m_attach]:
            edges.append((t, v))
        # preferential attachment pool
        repeated.extend(targets[:m_attach])
        repeated.extend([v] * m_attach)
        idx = rng.integers(0, len(repeated), size=m_attach)
        targets = [repeated[i] for i in idx]
    e = np.unique(np.sort(np.array(edges), axis=1), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    from gnn_mwvc.graph import Graph

    return Graph(rng.integers(1, wmax + 1, size=n), e)


def instances(classes):
    from bench import build_road_graph
    from tests.conftest import random_graph

    out = []
    if "er" in classes:
        out += [("er100k_d12", lambda: random_graph(100_000, 12, seed=7)),
                ("er300k_d10", lambda: random_graph(300_000, 10, seed=8))]
    if "pl" in classes:
        out += [("pl60k_m4", lambda: powerlaw_graph(60_000, 4, seed=9)),
                ("pl150k_m3", lambda: powerlaw_graph(150_000, 3, seed=10))]
    if "road" in classes:
        out += [("road300", lambda: build_road_graph(300)),
                ("road700", lambda: build_road_graph(700))]
    return out


def run_ref(path, budget):
    exe = os.path.join(REF_BIN, "GNN_VC")
    if not os.path.exists(exe):
        return None
    out = subprocess.run(
        [exe, path, path + ".refsol", str(int(budget)), "-1", "0"],
        capture_output=True, text=True, timeout=budget * 4 + 600,
    )
    f = out.stdout.strip().splitlines()[-1].split(",")
    if len(f) == 8:
        # fully-reduced fast path prints name,N,E,after_init,cost_gnn,
        # t_gnn,cost,t (reference: GNN_VC.cpp:310); best seen == cost
        return {"cost": int(f[6]), "best": int(f[6]), "t_best": float(f[7])}
    return {"cost": int(f[1]), "best": int(f[2]), "t_best": float(f[3])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", type=float, default=30.0)
    ap.add_argument("--out", default="/tmp/soak.json")
    ap.add_argument("--classes", default="er,pl,road")
    args = ap.parse_args(argv)

    from gnn_mwvc.graphio import cover_cost, is_vertex_cover, write_metis
    from gnn_mwvc.solver import solve

    rows = []
    for name, mk in instances(args.classes.split(",")):
        g = mk()
        path = f"/tmp/soak_{name}.metis"
        if not os.path.exists(path):
            write_metis(path, g)
        rec = {"name": name, "n": int(g.n), "e": int(len(g.indices)) // 2}
        for tag in ("cold", "warm"):
            t0 = time.perf_counter()
            res = solve(g, time_limit=args.time, reorder=True)
            assert is_vertex_cover(g, res.solution)
            assert cover_cost(g, res.solution) == res.cost
            rec[tag] = {"cost": int(res.cost),
                        "best": int(res.best_seen),
                        "t_total": round(time.perf_counter() - t0, 1),
                        "t_phase1": round(res.time_gnn, 1)}
            print(name, tag, rec[tag], flush=True)
        rec["ref"] = run_ref(path, args.time)
        print(name, "ref", rec["ref"], flush=True)
        rows.append(rec)

    wins = ties = losses = 0
    for r in rows:
        if not r["ref"]:
            continue
        ours, ref = r["warm"]["best"], r["ref"]["best"]
        if ours < ref:
            wins += 1
        elif ours == ref:
            ties += 1
        else:
            losses += 1
        r["delta_pct"] = round(100.0 * (ours - ref) / max(ref, 1), 4)
    summary = {"wins": wins, "ties": ties, "losses": losses, "rows": rows}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"wins": wins, "ties": ties, "losses": losses,
                      "deltas": {r["name"]: r.get("delta_pct")
                                 for r in rows}}))


if __name__ == "__main__":
    main()
