"""Weak/strong-scaling harness for the edge-partitioned sharded forward.

On the virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N)
it validates the sharding/collective structure and measures the partition
overheads; on GPUs the same code path measures the NVLink halo exchange.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scale_bench.py --n 200000 --deg 12 --parts 1,2,4,8
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
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--deg", type=int, default=12)
    ap.add_argument("--parts", default="1,2,4,8")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import jax

    # force the CPU pool (with XLA_FLAGS-provided virtual device count) and
    # drop any already-initialized backend
    jax.config.update("jax_platforms", "cpu")
    import jax.extend.backend as _jeb

    _jeb.clear_backends()

    from gnn_mwvc.graph import DeviceGraph
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.models.gnn import score_graph
    from gnn_mwvc.parallel import (make_mesh, make_sharded_forward,
                                       partition_device_graph)
    from tests.conftest import random_graph

    g = random_graph(args.n, args.deg, seed=3)
    dg = DeviceGraph.from_graph(g, aggregation="scatter", with_ell=False)
    model = load_pretrained()
    ws = float(g.weights.max())

    ref = np.asarray(score_graph(model, dg, ws))[: g.n]

    rows = []
    for p in map(int, args.parts.split(",")):
        if p > len(jax.devices()):
            print(f"skip parts={p}: only {len(jax.devices())} devices",
                  file=sys.stderr)
            continue
        mesh = make_mesh(p, devices=np.asarray(jax.devices()[:p]))
        sg = partition_device_graph(dg, p)
        fwd = make_sharded_forward(model.kinds, mesh)
        out = fwd(model.params, sg, ws)
        jax.block_until_ready(out)
        scores = np.asarray(out).reshape(-1)[: g.n]
        err = float(np.max(np.abs(scores - ref)))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fwd(model.params, sg, ws)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        rows.append({"parts": p, "seconds": round(dt, 4),
                     "edges_per_s": round(dg.e / dt),
                     "max_abs_err_vs_single": err})
        print(rows[-1], file=sys.stderr)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
