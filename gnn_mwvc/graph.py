"""Immutable CSR graph containers (host numpy + device pytree).

The reference keeps one mutable CSR with per-node active windows that shrink
under reductions (reference: include/reduction_graph.hpp:28-35).  For the
device we instead treat graphs as *immutable* CSR snapshots: the host-side
reduction engine owns mutation/undo, and periodically emits a compacted snapshot that is
padded to a bucketed static shape and shipped to the device (SURVEY.md §7).

`Graph` is the host container.  `DeviceGraph` is the padded device pytree used
by the GNN forward pass and the vectorized rule predicates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Graph", "DeviceGraph", "bucket_size"]


class Graph:
    """Undirected vertex-weighted graph in CSR form (host side, numpy).

    Parameters
    ----------
    weights : (N,) integer vertex weights.
    edges : (M, 2) undirected edges.  Canonical form (unique, u < v, sorted
        lexicographically — the normalization the reference parser applies,
        reference: src/GNN_VC.cpp:76-78) is verified with one O(M) pass;
        inputs with duplicates, reversed pairs, or self-loops are
        canonicalized (parallel edges would silently corrupt NW/degree
        semantics and with them reduction-rule soundness).
    """

    __slots__ = ("n", "m", "weights", "indptr", "indices", "_nw")

    def __init__(self, weights: np.ndarray, edges: np.ndarray):
        weights = np.asarray(weights)
        self.n = int(weights.shape[0])
        self.weights = weights
        if edges is None or len(edges) == 0:
            edges = np.zeros((0, 2), dtype=np.int64)
        edges = np.asarray(edges)
        if len(edges):
            key = edges[:, 0].astype(np.int64) * self.n + edges[:, 1]
            canonical = bool(
                (edges[:, 0] < edges[:, 1]).all()
                and (key[1:] > key[:-1]).all()
            )
            if not canonical:
                e = np.sort(edges.astype(np.int64), axis=1)
                e = np.unique(e[e[:, 0] != e[:, 1]], axis=0)
                edges = e
        self.m = int(edges.shape[0])

        # Symmetrize: every undirected edge appears in both endpoint rows.
        row = np.concatenate([edges[:, 0], edges[:, 1]])
        col = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        self.indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(self.indptr, row + 1, 1)
        np.cumsum(self.indptr, out=self.indptr)
        self.indices = col.astype(np.int64)
        self._nw: Optional[np.ndarray] = None

    # -- basic accessors -------------------------------------------------
    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def neighborhood_weights(self) -> np.ndarray:
        """NW(u) = sum of W(v) over v in N(u) (reference: reduction_graph.hpp:154-158)."""
        if self._nw is None:
            nw = np.zeros(self.n, dtype=np.int64)
            np.add.at(nw, self._row_ids(), self.weights[self.indices])
            self._nw = nw
        return self._nw

    def _row_ids(self) -> np.ndarray:
        """Expanded row index per CSR entry (COO rows)."""
        return np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    def edge_array(self) -> np.ndarray:
        """(M, 2) array of unique edges with u < v."""
        rows = self._row_ids()
        keep = rows < self.indices
        return np.stack([rows[keep], self.indices[keep]], axis=1)

    def reorder(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: perm[i] = old id placed at new position i.

        Used with a clustered/BFS order to give neighbor ids locality
        (gives the aggregation gathers locality; graph.py picks the plan).
        """
        perm = np.asarray(perm, dtype=np.int64)
        try:
            from gnn_mwvc.core import relabel_csr

            indptr2, indices2 = relabel_csr(self.indptr, self.indices, perm)
            return Graph.from_csr(self.weights[perm], indptr2, indices2)
        except ImportError:
            inv = np.empty(self.n, dtype=np.int64)
            inv[perm] = np.arange(self.n)
            e = self.edge_array()
            e2 = np.sort(
                np.stack([inv[e[:, 0]], inv[e[:, 1]]], axis=1), axis=1
            )
            e2 = e2[np.lexsort((e2[:, 1], e2[:, 0]))]
            return Graph(self.weights[perm], e2)

    @classmethod
    def from_csr(cls, weights, indptr, indices) -> "Graph":
        """Construct directly from a symmetric CSR (rows sorted)."""
        g = cls.__new__(cls)
        g.weights = np.asarray(weights)
        g.n = int(len(weights))
        g.indptr = np.asarray(indptr, dtype=np.int64)
        g.indices = np.asarray(indices, dtype=np.int64)
        g.m = int(len(indices) // 2)
        g._nw = None
        return g

    def __repr__(self) -> str:
        return f"Graph(n={self.n}, m={self.m})"


def bucket_size(n: int, minimum: int = 128, growth: float = 1.25) -> int:
    """Geometric shape bucket: smallest b = minimum * growth**k with b >= n.

    Re-inference runs on progressively smaller relabeled graphs
    (reference: src/GNN_VC.cpp:188-192); bucketing pad sizes bounds the number
    of distinct XLA compilations to O(log N) instead of O(#relabels).
    """
    if n <= minimum:
        return minimum
    b = float(minimum)
    while b < n:
        b *= growth
    # Round up to a multiple of 128 so padded node counts tile the VPU lanes.
    return int(-(-int(np.ceil(b)) // 128) * 128)


import jax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Padded, static-shape graph snapshot for device compute.

    COO layout sorted by destination row (the device formulation of the
    reference's neighbor-sum loop, reference: src/gnn_inference.cpp:31-41).
    Aggregation uses ``blocked`` (windowed one-hot plan, ops/blocked.py) or
    ``ell`` (multi-level bucketed ELL plan, ops/aggregate.py — pure gathers
    + tree sums) when present, else the sorted segment-sum over
    ``row``/``col`` (which also serve the rule predicates).

    Padding: nodes padded to a bucketed count ``n_pad`` (weight 0, degree 0);
    edge slots padded to ``e_pad`` with row == n_pad - 1 pointing at col 0 and
    ``edge_mask`` False.  The last padded node therefore absorbs all padding
    traffic and real rows stay exact.
    """

    n: int = dataclasses.field(metadata=dict(static=True))
    n_pad: int = dataclasses.field(metadata=dict(static=True))
    e: int = dataclasses.field(metadata=dict(static=True))
    e_pad: int = dataclasses.field(metadata=dict(static=True))
    row: np.ndarray = None       # (e_pad,) int32, sorted ascending
    col: np.ndarray = None       # (e_pad,) int32
    weights: np.ndarray = None   # (n_pad,) float32 raw vertex weights
    degrees: np.ndarray = None   # (n_pad,) float32
    nw: np.ndarray = None        # (n_pad,) float32 neighborhood weights
    node_mask: np.ndarray = None  # (n_pad,) bool
    edge_mask: np.ndarray = None  # (e_pad,) bool
    ell: object = None            # EllPlan or None
    blocked: object = None        # BlockedPlan or None (windowed one-hot path)

    @staticmethod
    def build(
        weights: np.ndarray,
        indptr: np.ndarray,
        indices: np.ndarray,
        bucket: bool = True,
        min_nodes: int = 128,
        min_edges: int = 1024,
        with_ell: bool = True,
        aggregation: str = "ell",
        blocked_min_quality: float = 0.05,
        shape_template: "DeviceGraph | None" = None,
    ) -> "DeviceGraph":
        """aggregation: "blocked", "ell", "scatter" or "auto".  "auto" when
        JAX's default backend is a GPU picks ELL, which
        measured fastest there on both graph classes timed, road-like and
        Erdos-Renyi (PERF.md).  On other backends "auto" keeps the windowed
        one-hot plan when its window occupancy reaches blocked_min_quality,
        else ELL.

        shape_template: build into EXACTLY this DeviceGraph's array shapes
        and static fields (incl. the reported n/e/plan-quality metadata, which
        then describe the template, not this graph) so an already-compiled
        program serves the result — see solver/static_score.py shape-templated
        rebuilds.  Returns None when the graph does not fit the template."""
        n = int(len(weights))
        e = int(len(indices))
        if shape_template is not None:
            if n + 1 > shape_template.n_pad or e > shape_template.e_pad:
                return None
            n_pad, e_pad = shape_template.n_pad, shape_template.e_pad
        else:
            # n_pad strictly > n so the padding-sink row (n_pad - 1) is never
            # a real node; padded edge slots scatter into it harmlessly.
            n_pad = bucket_size(n + 1, minimum=min_nodes) if bucket else n + 1
            e_pad = (bucket_size(max(e, 1), minimum=min_edges) if bucket
                     else max(e, 1))
        deg = np.diff(indptr).astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)

        row = np.full(e_pad, n_pad - 1, dtype=np.int32)
        col = np.zeros(e_pad, dtype=np.int32)
        row[:e] = rows
        col[:e] = indices

        w = np.zeros(n_pad, dtype=np.float32)
        w[:n] = weights
        d = np.zeros(n_pad, dtype=np.float32)
        d[:n] = deg
        nw = np.zeros(n_pad, dtype=np.float32)
        if e:
            np.add.at(nw[:n], rows, np.asarray(weights, dtype=np.float32)[indices])

        node_mask = np.zeros(n_pad, dtype=bool)
        node_mask[:n] = True
        edge_mask = np.zeros(e_pad, dtype=bool)
        edge_mask[:e] = True

        ell = None
        blocked = None
        if shape_template is not None:
            if shape_template.blocked is None:
                return None  # only blocked-plan templates are supported
            from gnn_mwvc.ops.blocked import build_blocked, pad_plan_like

            cand = build_blocked(np.asarray(indptr), np.asarray(indices),
                                 n_pad)
            blocked = pad_plan_like(cand, shape_template.blocked)
            if blocked is None:
                return None
            return DeviceGraph(
                n=shape_template.n, n_pad=n_pad,
                e=shape_template.e, e_pad=e_pad,
                row=row, col=col, weights=w, degrees=d, nw=nw,
                node_mask=node_mask, edge_mask=edge_mask, ell=None,
                blocked=blocked,
            )
        if aggregation == "auto" and jax.default_backend() == "gpu":
            aggregation = "ell"
        if aggregation in ("blocked", "auto"):
            from gnn_mwvc.ops.blocked import build_blocked

            cand = build_blocked(np.asarray(indptr), np.asarray(indices),
                                 n_pad)
            if aggregation == "blocked" or cand.quality >= blocked_min_quality:
                blocked = cand
        if blocked is None and with_ell and aggregation != "scatter":
            from gnn_mwvc.ops.aggregate import build_ell

            ell = build_ell(np.asarray(indptr), np.asarray(indices), n_pad)
        return DeviceGraph(
            n=n, n_pad=n_pad, e=e, e_pad=e_pad,
            row=row, col=col, weights=w, degrees=d, nw=nw,
            node_mask=node_mask, edge_mask=edge_mask, ell=ell,
            blocked=blocked,
        )

    @staticmethod
    def from_graph(g: Graph, **kw) -> "DeviceGraph":
        return DeviceGraph.build(g.weights, g.indptr, g.indices, **kw)
