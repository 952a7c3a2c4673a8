"""Run OUR local search (CoreLocalSearch) on a dumped phase-1 kernel with
the pipeline's adaptive step-size driver — the experiment twin of
tests/oracle/ls_oracle.cpp (which runs the reference search on the same
kernel).  Both are deterministic in step space, so best-seen-vs-steps curves
are directly comparable; wall-clock noise only affects steps/s.

Variants (--variant):
    plain    — exact pipeline phase-2 behavior (no diversification)
    forget   — round-1 edge-weight forgetting on stall (ls_forget_after)
    restart  — restore best cover on stall
    perturb  — restore best + force(k) random-removal perturbation (ILS)
    fw       — FastWVC-style ave-weight-triggered forgetting

Usage:
    python tools/ls_run.py /tmp/k_road900.kern --time 900 [--steps N]
        [--variant plain] [--stall 64] [--k 16] [--seed 1]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.kernel_dump import read_kernel  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel")
    ap.add_argument("--time", type=float, default=900.0)
    ap.add_argument("--steps", type=int, default=0, help="step cap (0 = none)")
    ap.add_argument("--variant", default="plain")
    ap.add_argument("--stall", type=int, default=64,
                    help="non-improving floor batches before diversifying")
    ap.add_argument("--k", type=int, default=16, help="perturbation size seed")
    ap.add_argument("--scale", type=float, default=0.3, help="forget decay")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np

    from gnn_mwvc.core import CoreLocalSearch

    w, eu, ev, s0, c0 = read_kernel(args.kernel)
    ls = CoreLocalSearch(w, np.stack([eu, ev], 1), s0)

    t0 = time.perf_counter()
    el = lambda: time.perf_counter() - t0  # noqa: E731
    step_size = 1 << 16
    total = 0
    batch = 0
    stalled = 0
    events = 0
    k_cur = args.k
    best_at_kick = 1 << 62
    max_steps = args.steps or (1 << 62)
    print(f"init,0,0.0,{ls.best_cost + c0},{ls.best_cost + c0}", flush=True)
    while el() < args.time and total < max_steps:
        total += step_size
        batch += 1
        if ls.search(step_size, 1e18):
            stalled = 0
            step_size = min(step_size * 2, 1 << 16)
            print(f"traj,{total},{el():.2f},{ls.best_cost + c0},"
                  f"{ls.best_seen + c0}", flush=True)
        else:
            step_size = max(step_size // 2, 1 << 10)
            if step_size == 1 << 10:
                stalled += 1
                if args.variant != "plain" and stalled >= args.stall:
                    stalled = 0
                    events += 1
                    if args.variant == "forget":
                        ls.forget(args.scale)
                    elif args.variant == "restart":
                        ls.restore_best()
                    elif args.variant == "perturb":
                        # adaptive ILS kick: restore the best cover, remove
                        # k random cover vertices + greedy repair; k doubles
                        # while kicks fail to find a new best, resets on
                        # success (HILS-style adaptive perturbation)
                        if ls.best_cost < best_at_kick:
                            k_cur = args.k
                        else:
                            k_cur = min(k_cur * 2, 4096)
                        best_at_kick = ls.best_cost
                        ls.restore_best()
                        ls.perturb(k_cur, args.seed + events)
                        step_size = 1 << 16
                    elif args.variant == "fw":
                        ls.restore_best()
                        ls.forget(args.scale)
                    print(f"div,{total},{el():.2f},{events},k={k_cur}",
                          flush=True)
        if batch % 4096 == 0:
            print(f"tick,{total},{el():.2f},{ls.best_cost + c0},"
                  f"{ls.best_seen + c0}", flush=True)
    sec = el()
    print(f"final,{total},{sec:.2f},{ls.best_cost + c0},"
          f"{ls.best_seen + c0},{total / sec:.0f}", flush=True)


if __name__ == "__main__":
    main()
