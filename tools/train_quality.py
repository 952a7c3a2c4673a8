"""Quality-validate the training pipeline.

Runs the full SURVEY §3.5 chain at corpus scale — random-weight instances
-> 3-rule kernels -> near-optimal labels from our own solver -> gnn-train —
then compares the freshly trained model against the published SEA-2022
weights end-to-end on held-out instances:

  * phase-1 cover cost (GNN peel before local search) — the model's direct
    contribution (reference: old_files/src/apps/gnn_train.cpp:72-111 trains
    for exactly this per-vertex in-cover probability), and
  * final cover at a short equal budget.

Everything runs on the CPU backend (small graphs; avoids per-shape device
compiles).  Writes a JSON report.

Usage:
    taskset -c 1 python tools/train_quality.py [--epochs 120]
        [--out /tmp/train_quality.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def corpus(rng):
    """Training instances across the classes the solver meets in practice."""
    from tests.conftest import random_graph
    from tools.soak import powerlaw_graph

    graphs = []
    for i in range(10):
        graphs.append((f"er{i}", random_graph(
            2000 + 900 * i, 8 + (i % 4) * 2, seed=100 + i, wmax=1000)))
    # power-law doubled to 12 samples spanning
    # up to the held-out pl15k scale — the one class where the from-scratch
    # model measurably lagged (+0.146 % final on pl15k, round 2)
    for i in range(16):
        graphs.append((f"pl{i}", powerlaw_graph(
            3000 + 1000 * i, 3 + (i % 3), seed=200 + i)))
    from bench import build_road_graph
    for i, side in enumerate((40, 55, 70, 85)):
        graphs.append((f"grid{i}", build_road_graph(side, seed=300 + i)))
    return graphs


def heldout():
    from bench import build_road_graph
    from tests.conftest import random_graph
    from tools.soak import powerlaw_graph

    return [
        ("er12k", random_graph(12_000, 10, seed=901, wmax=1000)),
        ("er25k", random_graph(25_000, 14, seed=902, wmax=1000)),
        ("pl15k", powerlaw_graph(15_000, 4, seed=903)),
        ("grid110", build_road_graph(110, seed=904)),
        ("grid160", build_road_graph(160, seed=905)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--label-budget", type=float, default=4.0)
    ap.add_argument("--eval-budget", type=float, default=10.0)
    ap.add_argument("--out", default="/tmp/train_quality.json")
    ap.add_argument("--workdir", default="/tmp/train_quality")
    args = ap.parse_args(argv)

    from gnn_mwvc.graphio import write_edge_graph
    from gnn_mwvc.models import load_model, load_pretrained
    from gnn_mwvc.solver import solve
    from gnn_mwvc.solver.pipeline import GnnScorer
    from gnn_mwvc.train.cli import main as train_main
    from gnn_mwvc.train.data import gen_reduced_graph

    rng = np.random.default_rng(0)
    gdir = os.path.join(args.workdir, "graphs")
    ldir = os.path.join(args.workdir, "labels")
    os.makedirs(gdir, exist_ok=True)
    os.makedirs(ldir, exist_ok=True)

    t0 = time.time()
    kept = 0
    for name, g in corpus(rng):
        gp = os.path.join(gdir, f"{name}.mtx")
        lp = os.path.join(ldir, f"{name}.txt")
        if os.path.exists(lp):
            kept += 1
            continue
        kernel, _cost, _ids = gen_reduced_graph(g)
        if kernel.n < 150:
            print(f"corpus {name}: fully reduced (kernel {kernel.n}), skip",
                  flush=True)
            continue
        res = solve(kernel, time_limit=args.label_budget, ls_seed=3)
        y = res.solution.astype(int)
        frac = y.mean()
        if not 0.2 <= frac <= 0.8:
            print(f"corpus {name}: class imbalance {frac:.2f}, skip",
                  flush=True)
            continue
        write_edge_graph(gp, kernel)
        np.savetxt(lp, y, fmt="%d")
        kept += 1
        print(f"corpus {name}: kernel n={kernel.n} cover_frac={frac:.2f}",
              flush=True)
    print(f"corpus: {kept} samples in {time.time()-t0:.0f}s", flush=True)

    model_path = os.path.join(args.workdir, "model.txt")
    t0 = time.time()
    rc = train_main([gdir, ldir, model_path, str(args.epochs), "0"])
    assert rc == 0
    print(f"training: {args.epochs} epochs in {time.time()-t0:.0f}s",
          flush=True)

    trained = load_model(model_path)
    published = load_pretrained()

    rows = []
    for name, g in heldout():
        row = {"name": name, "n": int(g.n)}
        for tag, model in (("published", published), ("trained", trained)):
            # time_limit=0: solve returns right after the GNN peel — the
            # model's direct contribution, before local search evens things
            # out (pipeline.solve skips phase 2 when the budget is spent)
            res0 = solve(g, time_limit=0.0, scorer=GnnScorer(model))
            res = solve(g, time_limit=args.eval_budget,
                        scorer=GnnScorer(model), ls_seed=5)
            row[tag] = {"phase1": int(res0.cost), "final": int(res.best_seen)}
        row["delta_final_pct"] = round(
            100.0 * (row["trained"]["final"] - row["published"]["final"])
            / max(row["published"]["final"], 1), 3)
        row["delta_phase1_pct"] = round(
            100.0 * (row["trained"]["phase1"] - row["published"]["phase1"])
            / max(row["published"]["phase1"], 1), 3)
        print(name, row["published"]["final"], row["trained"]["final"],
              f"d_final={row['delta_final_pct']}% "
              f"d_phase1={row['delta_phase1_pct']}%", flush=True)
        rows.append(row)

    worst = max(abs(r["delta_final_pct"]) for r in rows)
    rep = {"epochs": args.epochs, "samples": kept, "rows": rows,
           "worst_final_delta_pct": worst}
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps({"worst_final_delta_pct": worst,
                      "mean_final_delta_pct": round(
                          float(np.mean([r["delta_final_pct"]
                                         for r in rows])), 3)}), flush=True)


if __name__ == "__main__":
    main()
