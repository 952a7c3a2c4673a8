"""gnn-train command line (reference: old_files/src/apps/gnn_train.cpp).

Usage: gnn-train [graph path] [label path] [out path] [epochs] [seed]
Prints the reference's per-epoch CSV metrics and writes the trained model in
the reference text checkpoint format.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gnn-train")
    ap.add_argument("graph_path")
    ap.add_argument("label_path")
    ap.add_argument("out_path")
    ap.add_argument("epochs", type=int)
    ap.add_argument("seed", type=int, nargs="?", default=0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--batch-vertices", type=int, default=500_000)
    args = ap.parse_args(argv)

    from gnn_mwvc.models import save_model
    from gnn_mwvc.train import TrainConfig, load_training_set, train

    samples = load_training_set(args.graph_path, args.label_path)
    if not samples:
        print("No usable training graphs found")
        return 1
    n_test = max(1, int(len(samples) * 0.1))
    print(f"Training graphs: {len(samples) - n_test}, Test graphs: {n_test}")

    cfg = TrainConfig(
        epochs=args.epochs, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, batch_vertices=args.batch_vertices,
        seed=args.seed, log=True,
    )
    model, _ = train(samples, cfg)
    save_model(args.out_path, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
