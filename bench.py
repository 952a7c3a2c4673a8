"""Benchmark driver: GNN scoring throughput (directed edges/s) on one GPU.

Prints the card line (``nvidia-smi`` name and power limit), then ONE JSON
line:
  {"metric": "gnn_score_edges_per_s", "value": N, "unit": "edges/s",
   "vs_baseline": R, "device": {"platform", "kind", "count"}}

Refuses to run without a GPU.

Workload: a road-network-like graph (2D 8-neighborhood grid with random
extra edges — the SEA-2022 headline instances are road networks and similar
sparse local graphs), cluster-ordered, scored with the production pipeline
shape (analytic first message-passing round + 2 real rounds; the reference's
m.predict runs 3 full rounds per call, reference: src/GNN_VC.cpp:188-192) and
``aggregation="auto"`` (graph.py picks the plan for the graph class).  The
forward runs at the production precision, ``Precision.HIGHEST`` everywhere,
the config the 2e-5 activation-parity tests certify.

vs_baseline: the reference C++ implementation (single-threaded, real
OpenBLAS sgemm, -O3 -march=native) measured on the same host and the same
graph via tests/oracle/bench_predict when available; otherwise a recorded
constant (4.78e6 edges/s on the road-class workload, measured on an earlier
host, 2026-08-17).
"""

import json
import os
import subprocess
import time

import numpy as np

REFERENCE_EDGES_PER_S = 4.78e6  # fallback (road workload); see docstring
ORACLE = "/tmp/gnn_mwvc_oracle/bench_predict"
BENCH_GRAPH_CACHE = "/tmp/gnn_mwvc_oracle/bench_road_{n}.metis"


def build_road_graph(side, seed=42, extra=0.05):
    """8-neighborhood grid + sprinkled shortcut edges; natural locality."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    u = (ii * side + jj).ravel()
    edges = []
    right = u[(jj < side - 1).ravel()]
    edges.append(np.stack([right, right + 1], 1))
    down = u[(ii < side - 1).ravel()]
    edges.append(np.stack([down, down + side], 1))
    diag = u[((ii < side - 1) & (jj < side - 1)).ravel()]
    edges.append(np.stack([diag, diag + side + 1], 1))
    anti = u[((ii < side - 1) & (jj > 0)).ravel()]
    edges.append(np.stack([anti, anti + side - 1], 1))
    # random local-ish shortcuts
    ns = int(n * extra)
    a = rng.integers(0, n - 1, size=ns)
    b = np.clip(a + rng.integers(1, 5 * side, size=ns), 0, n - 1)
    keep = a != b
    edges.append(np.stack([np.minimum(a, b)[keep], np.maximum(a, b)[keep]], 1))
    e = np.unique(np.concatenate(edges, 0), axis=0)
    w = rng.integers(1, 1001, size=n)
    from gnn_mwvc.graph import Graph

    return Graph(w, e)


def measure_reference(g):
    """Reference CPU baseline on the same graph (oracle binary)."""
    path = BENCH_GRAPH_CACHE.format(n=g.n)
    try:
        if not os.path.exists(ORACLE):
            return REFERENCE_EDGES_PER_S
        if not os.path.exists(path):
            from gnn_mwvc.graphio import write_metis

            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_metis(path, g)
        out = subprocess.run(
            [ORACLE, path, "3"],
            capture_output=True, text=True, timeout=600, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        sec, e = out.stdout.split()
        return float(e) / float(sec)
    except Exception:
        return REFERENCE_EDGES_PER_S


def main():
    side = int(os.environ.get("BENCH_SIDE", 1200))
    iters = int(os.environ.get("BENCH_ITERS", 5))

    import jax
    import jax.numpy as jnp

    from gnn_mwvc.core import cluster_order
    from gnn_mwvc.graph import DeviceGraph
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.models.gnn import Model, forward
    from gnn_mwvc.utils.device import card_line, device_record, require_gpu

    require_gpu()
    g = build_road_graph(side)
    ref = measure_reference(g)  # measured on the pre-reorder graph (same E)

    perm = cluster_order(g.indptr, g.indices)
    g = g.reorder(perm)
    dg = DeviceGraph.from_graph(g, aggregation="auto")
    model = load_pretrained()
    ws = float(g.weights.max())
    kinds, name = model.kinds, model.name

    # each iteration's input depends on the previous output
    @jax.jit
    def step(xcol, params, dg, weight_scale):
        x = (dg.weights / weight_scale).reshape(-1, 1) + xcol * 1e-12
        out = forward(
            Model(kinds=kinds, params=params, name=name),
            x.astype(jnp.float32), dg, weight_scale,
            x_is_node_weights=True,
        )
        return out[:, :1]

    xcol = jnp.zeros((dg.n_pad, 1), jnp.float32)
    xcol = step(xcol, model.params, dg, jnp.float32(ws))
    jax.block_until_ready(xcol)  # compile + warmup
    # fastest of BENCH_BATCHES batches of BENCH_ITERS chained iterations
    batches = int(os.environ.get("BENCH_BATCHES", 4))
    dt = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            xcol = step(xcol, model.params, dg, jnp.float32(ws))
        jax.block_until_ready(xcol)
        dt = min(dt, (time.perf_counter() - t0) / iters)

    edges_per_s = dg.e / dt
    result = {
        "metric": "gnn_score_edges_per_s",
        "value": round(edges_per_s),
        "unit": "edges/s",
        "vs_baseline": round(edges_per_s / ref, 3),
        "device": device_record(),
    }
    print(card_line())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
