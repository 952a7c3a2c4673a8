"""Time the three aggregation formulations under the full scoring forward.

For each graph class (the bench road graph, cluster-ordered; Erdos-Renyi
at 200k nodes and average degree 16) and each formulation — windowed
one-hot matmuls (ops/blocked.py), multi-level ELL gathers
(ops/aggregate.py), sorted ``segment_sum`` (models/gnn.py) — build the
DeviceGraph, run the 21-layer scorer at ``Precision.HIGHEST`` once to
compile, then time ``reps`` calls, each ending in ``block_until_ready``.
Scores of the three paths are compared with each other (max abs diff).

Usage (on a machine with a card):
    JAX_PLATFORMS=cuda,cpu python tools/aggregation_bench.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATHS = ("blocked", "ell", "scatter")


def er_graph(n, avg_deg, seed=0):
    from gnn_mwvc.graph import Graph

    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    u = rng.integers(0, n, size=int(m * 1.1))
    v = rng.integers(0, n, size=int(m * 1.1))
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    keep = lo != hi
    e = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)
    e = e[rng.permutation(len(e))[:m]]
    return Graph(rng.integers(1, 1001, size=n), e)


def graphs(side, er_n, classes):
    from bench import build_road_graph
    from gnn_mwvc.core import cluster_order

    g = build_road_graph(side)
    if "road" in classes:
        yield f"road{side}", g.reorder(cluster_order(g.indptr, g.indices))
    if "road_natural" in classes:  # grid row-major order, as solve() sees it
        yield f"road{side}_natural", g
    if "er" in classes:
        yield f"er{er_n // 1000}k_d16", er_graph(er_n, 16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=1200)
    ap.add_argument("--er-nodes", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--classes", default="road,road_natural,er")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--out", default="chiprun_out/aggregation_bench.json")
    args = ap.parse_args(argv)

    import jax

    from gnn_mwvc.graph import DeviceGraph
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.models.gnn import make_scorer
    from gnn_mwvc.utils.device import card_line, require_gpu

    dev = require_gpu()
    model = load_pretrained()
    rows = {"card": card_line(), "device": dev.device_kind}
    for gname, g in graphs(args.side, args.er_nodes, args.classes.split(",")):
        ws = np.float32(g.weights.max())
        scores = {}
        for path in args.paths.split(","):
            t0 = time.perf_counter()
            dg = DeviceGraph.from_graph(g, aggregation=path,
                                        with_ell=path == "ell")
            t_build = time.perf_counter() - t0
            dg = jax.device_put(dg, dev)
            fn = make_scorer(model)
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(model.params, dg, ws))
            t_first = time.perf_counter() - t0
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(model.params, dg, ws))
                ts.append(time.perf_counter() - t0)
            scores[path] = np.asarray(out)[: g.n]
            med = float(np.median(ts))
            rows[f"{gname}_{path}"] = {
                "forward_ms_median": med * 1e3,
                "forward_ms_min": min(ts) * 1e3,
                "edges_per_s": int(len(g.indices) / med),
                "first_call_s": t_first, "host_build_s": t_build,
            }
            print(gname, path, json.dumps(rows[f"{gname}_{path}"]),
                  flush=True)
            del dg
        ref = scores["scatter"]
        rows[f"{gname}_max_abs_diff_vs_scatter"] = {
            p: float(np.abs(scores[p] - ref).max()) for p in scores}
        rows[f"{gname}_edges"] = int(len(g.indices))
    print(json.dumps(rows))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
