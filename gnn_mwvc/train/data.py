"""Training data pipeline.

Reproduces the reference's data-prep chain (SURVEY.md §3.5):

  raw .mtx -> gen_weights (random weights)              [graphio.edgelist]
          -> gen_reduced_graph (3-rule kernelization)   [here]
          -> external labels (0/1 per vertex)
          -> load_training_set                          [here]

* ``load_training_set`` loads "E N / weights / edges" graphs paired with
  label files, dropping graphs where either class is under 20% of vertices
  (reference: old_files/src/apps/gnn_train.cpp:56).
* ``gen_reduced_graph`` applies only the first 3 reduction rules
  (neighborhood, twin, domination — reference:
  old_files/src/apps/gen_reduced_graph.cpp:38-47) and emits the kernel graph;
  this is how the SEA-2022 training instances were produced.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from gnn_mwvc.core import CoreSolver
from gnn_mwvc.graph import DeviceGraph, Graph
from gnn_mwvc.graphio import read_edge_graph

__all__ = [
    "TrainSample",
    "make_sample",
    "load_training_set",
    "gen_reduced_graph",
]


@dataclasses.dataclass
class TrainSample:
    dg: DeviceGraph
    y: np.ndarray       # (n_pad,) float32 labels, 0 outside mask
    mask: np.ndarray    # (n_pad,) bool
    n: int
    name: str = ""


def make_sample(g: Graph, labels: np.ndarray, name: str = "",
                with_ell: bool = False) -> TrainSample:
    dg = DeviceGraph.from_graph(g, with_ell=with_ell)
    y = np.zeros(dg.n_pad, dtype=np.float32)
    y[: g.n] = labels
    return TrainSample(dg=dg, y=y, mask=dg.node_mask.copy(), n=g.n, name=name)


def load_training_set(graph_dir, label_dir, min_class_frac=0.2,
                      graph_suffix=".mtx", with_ell=False):
    """Pair each label file with its graph; filter class-imbalanced graphs."""
    samples = []
    for entry in sorted(os.listdir(label_dir)):
        stem = os.path.splitext(entry)[0]
        gpath = os.path.join(graph_dir, stem + graph_suffix)
        if not os.path.exists(gpath):
            continue
        g = read_edge_graph(gpath)
        y = np.loadtxt(os.path.join(label_dir, entry)).reshape(-1)[: g.n]
        tc = float((y > 0.5).sum())
        fc = float(g.n - tc)
        if tc <= g.n * min_class_frac or fc <= g.n * min_class_frac:
            continue
        samples.append(make_sample(g, (y > 0.5).astype(np.float32), stem,
                                   with_ell=with_ell))
    return samples


def gen_reduced_graph(g: Graph):
    """3-rule kernelization; returns (kernel Graph, cost_paid, org_ids).

    org_ids maps kernel vertices back to original ids (folded gadget vertices
    get ids >= g.n).
    """
    core = CoreSolver(g.weights, g.edge_array(), num_rules=3)
    core.reduce(critical=False)
    snap = core.snapshot()
    rows = np.repeat(np.arange(snap.n, dtype=np.int64),
                     np.diff(snap.indptr.astype(np.int64)))
    keep = rows < snap.indices
    edges = np.stack([rows[keep], snap.indices[keep].astype(np.int64)], axis=1)
    kernel = Graph(snap.weights.astype(np.int64), edges)
    return kernel, core.cost, snap.ids.copy()
