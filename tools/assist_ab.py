"""Phase-2 A/B at equal budget on a dumped kernel (tools/dump_kernel.py):

  plain    — round-2 default: ILS with uniform force-k kicks
  guided   — ILS with GNN-misfit-guided kicks
  regions  — ILS uniform kicks + device-batched exact region patches
  full     — guided kicks + region patches (the device_assist config)

Each variant replays the production phase-2 loop (step-size schedule, ILS
stall/kick policy) from the same initial cover for --time seconds.

Usage:
  python tools/assist_ab.py kernel_road900.npz --time 300 --seeds 1,2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_variant(kern, variant, budget, seed, assist_batch=1024, rmax=14):
    from gnn_mwvc.core import CoreLocalSearch
    from gnn_mwvc.solver.device_assist import DeviceAssist
    from gnn_mwvc.solver.pipeline import pick_devices

    ls = CoreLocalSearch(kern["weights"], kern["edges"], kern["s0"])
    prob = kern["prob"]
    bias = np.clip(1.0 - prob, 0.05, 1.0).astype(np.float32)

    assist = None
    if variant in ("regions", "full"):
        cpu, accel = pick_devices()
        assist = DeviceAssist(prob, device=accel or cpu, batch=assist_batch,
                              rmax=rmax, seed=seed)
    guided = variant in ("guided", "full")

    t0 = time.perf_counter()
    t_best = t0
    step_size = 1 << 16
    stalled = 0
    kicks = 0
    k_cur = 16
    best_at_kick = 1 << 62
    while time.perf_counter() - t0 < budget:
        remaining = budget - (time.perf_counter() - t0)
        if ls.search(step_size, remaining):
            stalled = 0
            t_best = time.perf_counter()
            step_size = min(step_size * 2, 1 << 16)
        else:
            step_size = max(step_size // 2, 1 << 10)
            if step_size == 1 << 10:
                stalled += 1
                if stalled >= 256:
                    stalled = 0
                    kicks += 1
                    k_cur = 16 if ls.best_cost < best_at_kick else min(
                        k_cur * 2, 4096)
                    best_at_kick = ls.best_cost
                    ls.restore_best()
                    if guided:
                        ls.perturb_guided(k_cur, seed + kicks, bias)
                    else:
                        ls.perturb(k_cur, seed + kicks)
                    step_size = 1 << 16
        if assist is not None:
            prev_best = ls.best_cost
            assist.tick(ls)
            if ls.best_cost < prev_best:
                t_best = time.perf_counter()
    if assist is not None:
        assist.stop()
    return {
        "variant": variant, "seed": seed,
        "best_cost": int(ls.best_cost), "best_seen": int(ls.best_seen),
        "steps": int(ls.steps), "kicks": kicks,
        "t_best": round(t_best - t0, 1),
        "assist": dict(assist.stats) if assist else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel")
    ap.add_argument("--time", type=float, default=300.0)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--variants", default="plain,guided,regions,full")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rmax", type=int, default=14,
                    help="region size cap; >16 solves 2^20 regions "
                         "(width-20 extraction)")
    ap.add_argument("--out", default="chiprun_out/assist_ab.json")
    args = ap.parse_args(argv)

    kern = dict(np.load(args.kernel))
    init = int(kern["initial_cost"])
    rows = []
    for seed in map(int, args.seeds.split(",")):
        for variant in args.variants.split(","):
            r = run_variant(kern, variant, args.time, seed,
                            assist_batch=args.batch, rmax=args.rmax)
            r["total_with_init"] = r["best_cost"] + init
            rows.append(r)
            print(json.dumps(r), flush=True)
    with open(args.out, "w") as f:
        json.dump({"kernel": args.kernel, "time": args.time, "rows": rows},
                  f, indent=1)


if __name__ == "__main__":
    main()
