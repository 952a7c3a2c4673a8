"""Multi-device scaling evidence: shard a
multi-million-edge road instance AND a locality-free ER instance over a
1/2/4/8-device CPU mesh; record per-config forward wall time, edges/s,
measured halo bytes per chip, partition-build wall time, and single-device
parity.

The CPU mesh measures SCALING SHAPE (collective overhead, halo-vs-compute
ratio), not device throughput.

Writes /tmp/scaling_weak.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEV = int(os.environ.get("SCALE_DEVICES", 8))
os.environ.setdefault(
    "XLA_FLAGS", f"--xla_force_host_platform_device_count={N_DEV}")
PARTS = [int(x) for x in os.environ.get("SCALE_PARTS", "1,2,4,8").split(",")]


def run_instance(name, g, parts_list, results, aggregation="scatter"):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gnn_mwvc.graph import DeviceGraph
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.models.gnn import make_scorer
    from gnn_mwvc.parallel.sharded import (
        make_sharded_forward, partition_device_graph)

    model = load_pretrained()
    ws = float(g.weights.max())
    dg = DeviceGraph.from_graph(g, aggregation="scatter")
    e = int(dg.e)

    # single-device reference scores (parity anchor)
    fn1 = make_scorer(model)
    t0 = time.perf_counter()
    ref = np.asarray(fn1(model.params, dg, np.float32(ws)))[: g.n]
    t1 = time.perf_counter() - t0  # includes compile
    t0 = time.perf_counter()
    ref = np.asarray(fn1(model.params, dg, np.float32(ws)))[: g.n]
    t_single = time.perf_counter() - t0

    rows = []
    devs = jax.devices()
    for parts in parts_list:
        mesh = Mesh(np.array(devs[:parts]), ("graph",))
        t0 = time.perf_counter()
        sg = partition_device_graph(dg, parts, halo=parts > 1,
                                    aggregation=aggregation)
        t_build = time.perf_counter() - t0
        scorer = make_sharded_forward(model.kinds, mesh)
        out = scorer(model.params, sg, ws)  # compile + run
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = scorer(model.params, sg, ws)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        flat = np.asarray(out).reshape(-1)
        # rows: shard p holds global nodes [p*n_loc, (p+1)*n_loc)
        got = np.concatenate([
            flat[p * sg.n_loc: p * sg.n_loc + sg.n_loc]
            for p in range(parts)
        ])[: g.n]
        err = float(np.abs(got - ref).max())
        row = {
            "parts": parts, "t_forward_s": round(dt, 3),
            "edges_per_s": round(e / dt),
            "halo_bytes_per_chip": int(sg.halo_bytes_per_chip())
            if parts > 1 else 0,
            "h_max": int(sg.h_max), "t_partition_build_s": round(t_build, 2),
            "max_err_vs_single": err,
        }
        rows.append(row)
        print(name, json.dumps(row), flush=True)

    results[name] = {
        "n": int(g.n), "e_directed": e,
        "t_single_forward_s": round(t_single, 3),
        "single_edges_per_s": round(e / t_single),
        "configs": rows,
    }


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench import build_road_graph
    from gnn_mwvc.core import cluster_order
    from tests.conftest import random_graph

    results = {}
    side = int(os.environ.get("SCALE_SIDE", 700))
    g = build_road_graph(side)
    perm = cluster_order(g.indptr, g.indices)
    g = g.reorder(perm)
    run_instance(f"road{side}", g, PARTS, results)

    n_er = int(os.environ.get("SCALE_ER_N", 200_000))
    g = random_graph(n_er, 16, seed=42, wmax=1000)
    run_instance(f"er{n_er // 1000}k", g, PARTS, results)

    out_path = os.environ.get("SCALE_OUT", "/tmp/scaling_weak.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
