"""Solve-state checkpoint / resume.

The reference writes its result file once at the end and cannot resume
(reference: src/GNN_VC.cpp:385-388; SURVEY.md §5 "Checkpoint / resume").
Here every checkpoint is a *valid full cover* of the original graph plus
metadata, written atomically — so a killed run always leaves its best-so-far
solution on disk, and `resume_solve` warm-starts the anytime local search
from it.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from gnn_mwvc.core import CoreLocalSearch
from gnn_mwvc.graph import Graph
from gnn_mwvc.graphio import cover_cost, is_vertex_cover

__all__ = ["graph_fingerprint", "save_checkpoint", "load_checkpoint",
           "resume_solve"]


def graph_fingerprint(g: Graph) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(g.weights).tobytes())
    h.update(np.ascontiguousarray(g.indptr).tobytes())
    h.update(np.ascontiguousarray(g.indices).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(path: str, g: Graph, cover: np.ndarray, cost: int,
                    elapsed: float, extra: dict | None = None) -> None:
    assert is_vertex_cover(g, cover), "refusing to checkpoint an invalid cover"
    assert cover_cost(g, cover) == cost
    tmp = path + ".tmp"
    meta = {
        "fingerprint": graph_fingerprint(g),
        "cost": int(cost),
        "elapsed": float(elapsed),
        "n": int(g.n),
        **(extra or {}),
    }
    np.savez_compressed(tmp + ".npz", cover=np.asarray(cover, dtype=np.int8),
                        meta=json.dumps(meta))
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str, g: Graph | None = None):
    """Returns (cover, meta); validates against *g* when given."""
    with np.load(path, allow_pickle=False) as z:
        cover = z["cover"]
        meta = json.loads(str(z["meta"]))
    if g is not None:
        if meta["fingerprint"] != graph_fingerprint(g):
            raise ValueError("checkpoint does not match this graph")
        if not is_vertex_cover(g, cover):
            raise ValueError("checkpoint cover is invalid")
    return cover, meta


def resume_solve(g: Graph, checkpoint_path: str, time_limit: float,
                 checkpoint_interval: float = 60.0):
    """Continue the anytime local search from a checkpointed cover.

    Runs over the full original graph (no re-kernelization needed for
    correctness); periodically re-checkpoints improvements.
    """
    cover, meta = load_checkpoint(checkpoint_path, g)
    t0 = time.perf_counter()
    base_elapsed = meta.get("elapsed", 0.0)
    ls = CoreLocalSearch(g.weights, g.edge_array(),
                         np.asarray(cover, dtype=np.uint8))
    step_size = 1 << 16
    last_ckpt = t0
    while time.perf_counter() - t0 < time_limit:
        remaining = time_limit - (time.perf_counter() - t0)
        improved = ls.search(step_size, remaining)
        step_size = (min(step_size * 2, 1 << 16) if improved
                     else max(step_size // 2, 1 << 10))
        now = time.perf_counter()
        if improved and now - last_ckpt >= checkpoint_interval:
            best = ls.best()
            save_checkpoint(
                checkpoint_path, g, best, ls.best_cost,
                base_elapsed + (now - t0),
            )
            last_ckpt = now
    best = ls.best()
    if ls.best_cost <= meta["cost"]:
        save_checkpoint(checkpoint_path, g, best, ls.best_cost,
                        base_elapsed + (time.perf_counter() - t0))
    return best, ls.best_cost, ls.best_seen
