"""Decisive device-vs-host reduction experiment.

The question: does O(E) device mask evaluation amortize against the host
worklist engine on instances of 50-200 M edges, where the host pays tens of
seconds?

Measures, on a synthetic road-like instance of the requested scale:
  * host: CoreSolver build + full worklist reduce() to the kernel;
  * device: CoreSolver build + device_reduce_prepass (mask rounds +
    bulk-apply) + host reduce() to finish.

Usage:
    python tools/reduce_scale.py [--side 3600] [--out /tmp/reduce_scale.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(side, with_device):
    import numpy as np  # noqa: F401

    from bench import build_road_graph
    from gnn_mwvc.core import CoreSolver

    g = build_road_graph(side)
    e = len(g.indices) // 2
    t0 = time.perf_counter()
    core = CoreSolver(g.weights, g.edge_array())
    t_build = time.perf_counter() - t0

    rec = {"n": int(g.n), "e": int(e), "t_build": round(t_build, 2)}
    t0 = time.perf_counter()
    if with_device:
        from gnn_mwvc.solver.device_reduce import device_reduce_prepass

        stats = device_reduce_prepass(core)
        rec["prepass"] = stats
        rec["t_prepass"] = round(time.perf_counter() - t0, 2)
        rec["active_after_prepass"] = int(core.active_count)
        t0 = time.perf_counter()
    core.reduce()
    rec["t_reduce"] = round(time.perf_counter() - t0, 2)
    rec["kernel"] = int(core.active_count)
    rec["cost"] = int(core.cost)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=3600)
    ap.add_argument("--out", default="/tmp/reduce_scale.json")
    args = ap.parse_args(argv)

    host = run(args.side, with_device=False)
    print("host:", json.dumps(host), flush=True)
    dev = run(args.side, with_device=True)
    print("device:", json.dumps(dev), flush=True)

    rep = {"side": args.side, "host": host, "device": dev}
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    h = host["t_reduce"]
    d = dev.get("t_prepass", 0) + dev["t_reduce"]
    print(json.dumps({"host_to_kernel_s": h, "device_to_kernel_s": round(d, 2),
                      "winner": "device" if d < h else "host"}), flush=True)


if __name__ == "__main__":
    main()
