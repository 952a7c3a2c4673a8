"""Reference-binary canonical run (1000 s protocol) on a bench instance.

Usage: python tools/canonical_ref.py road1600 [--time 1000]
Writes /tmp/canonical_ref_<instance>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_BIN = "/tmp/gnn_mwvc_oracle"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("instance")
    ap.add_argument("--time", type=float, default=1000.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from bench import build_road_graph
    from gnn_mwvc.graphio import write_metis

    assert args.instance.startswith("road")
    side = int(args.instance[4:])
    g = build_road_graph(side)
    path = f"/tmp/canonical_{args.instance}.metis"
    if not os.path.exists(path):
        write_metis(path, g)

    exe = os.path.join(REF_BIN, "GNN_VC")
    assert os.path.exists(exe), "build the oracle first"
    t0 = time.perf_counter()
    out = subprocess.run(
        [exe, path, path + ".refsol", str(int(args.time)), "-1", "0"],
        capture_output=True, text=True, timeout=args.time * 4 + 600,
    )
    wall = time.perf_counter() - t0
    f = out.stdout.strip().splitlines()[-1].split(",")
    if len(f) == 8:  # fully-reduced fast path (reference: GNN_VC.cpp:310)
        rec = {"written": int(f[6]), "best": int(f[6]), "t_best": float(f[7])}
    else:
        rec = {"written": int(f[1]), "best": int(f[2]), "t_best": float(f[3])}
    rec.update(instance=args.instance, time_limit=args.time,
               wall=round(wall, 1), n=int(g.n), m=int(len(g.indices) // 2))
    print(json.dumps(rec), flush=True)
    with open(args.out or f"/tmp/canonical_ref_{args.instance}.json",
              "w") as fh:
        json.dump(rec, fh)


if __name__ == "__main__":
    main()
