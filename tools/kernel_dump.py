"""Dump the phase-1 kernel (residual graph + initial cover) of an instance.

Runs GNN-guided kernelization (pipeline phase 1) once, then writes the
local-search input — kernel weights, unique edges, initial cover, and the
initial reduction cost — to an .npz plus a flat binary the reference-LS
oracle (tests/oracle/ls_oracle.cpp) can read.  This lets local-search
experiments iterate on the *identical* kernel without re-running the
device scoring phase.

Binary layout (little-endian):
    8s  magic  b"MWVCKRN1"
    u32 n, u32 m
    u64 initial_cost
    n*u32 weights | m*u32 eu | m*u32 ev | n*u8 s0

Usage:
    python tools/kernel_dump.py --instance road900 --out /tmp/k_road900
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_instance(name):
    from bench import build_road_graph

    if name.startswith("road"):
        return build_road_graph(int(name[4:]))
    if name.startswith("er"):  # erN_dD
        from tests.conftest import random_graph

        n, d = name[2:].split("_d")
        return random_graph(int(float(n)), int(d), seed=7)
    raise SystemExit(f"unknown instance {name}")


def write_kernel(path, weights, eu, ev, s0, initial_cost):
    with open(path, "wb") as f:
        f.write(b"MWVCKRN1")
        f.write(struct.pack("<IIQ", len(weights), len(eu), initial_cost))
        f.write(np.ascontiguousarray(weights, np.uint32).tobytes())
        f.write(np.ascontiguousarray(eu, np.uint32).tobytes())
        f.write(np.ascontiguousarray(ev, np.uint32).tobytes())
        f.write(np.ascontiguousarray(s0, np.uint8).tobytes())


def read_kernel(path):
    with open(path, "rb") as f:
        assert f.read(8) == b"MWVCKRN1"
        n, m, c0 = struct.unpack("<IIQ", f.read(16))
        w = np.frombuffer(f.read(4 * n), np.uint32)
        eu = np.frombuffer(f.read(4 * m), np.uint32)
        ev = np.frombuffer(f.read(4 * m), np.uint32)
        s0 = np.frombuffer(f.read(n), np.uint8)
    return w, eu, ev, s0, c0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--instance", default="road900")
    ap.add_argument("--out", required=True, help="output path stem")
    ap.add_argument("--reorder", action="store_true", default=True)
    args = ap.parse_args(argv)

    from gnn_mwvc.core import CoreSolver, cluster_order
    from gnn_mwvc.solver.pipeline import gnn_peel
    from gnn_mwvc.solver.static_score import StickyGnnScorer

    g = build_instance(args.instance)
    if args.reorder:
        perm = cluster_order(g.indptr, g.indices)
        g = g.reorder(perm)

    t0 = time.perf_counter()
    weight_scale = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    scorer = StickyGnnScorer()
    t_kernel, kernel_size, initial_cost = gnn_peel(core, scorer, weight_scale)
    core.unfold(t_kernel)
    t_phase1 = time.perf_counter() - t0

    snap = core.snapshot()
    rows = np.repeat(np.arange(snap.n, dtype=np.int64),
                     np.diff(snap.indptr.astype(np.int64)))
    keep = rows < snap.indices
    eu = rows[keep].astype(np.uint32)
    ev = snap.indices[keep].astype(np.uint32)
    s0 = np.array([core.decided(u) == 1 for u in snap.ids], dtype=np.uint8)

    write_kernel(args.out + ".kern", snap.weights, eu, ev, s0, initial_cost)
    np.savez_compressed(args.out + ".npz", weights=snap.weights, eu=eu, ev=ev,
                        s0=s0, initial_cost=initial_cost,
                        cost_gnn=core.cost, t_phase1=t_phase1)
    print(f"instance={args.instance} kernel n={snap.n} m={len(eu)} "
          f"initial_cost={initial_cost} cost_after_peel={core.cost} "
          f"t_phase1={t_phase1:.1f}s -> {args.out}.kern")


if __name__ == "__main__":
    main()
