"""Solution validation and IS<->VC conversion.

Replaces the reference's end-of-run ``validate`` (reference:
src/GNN_VC.cpp:93-110), the offline ``vc_validate`` tool (reference:
old_files/src/apps/vc_validate.cpp:49-65) and ``is_vc_converter`` (reference:
old_files/src/apps/is_vc_converter.cpp:12-66), vectorized over the edge array.
"""

from __future__ import annotations

import numpy as np

from gnn_mwvc.graph import Graph

__all__ = [
    "is_vertex_cover",
    "cover_cost",
    "read_solution",
    "write_solution",
    "is_independent_set",
    "independent_set_to_cover",
]


def is_vertex_cover(g: Graph, s: np.ndarray) -> bool:
    """True iff every edge has at least one endpoint with s == 1."""
    s = np.asarray(s, dtype=bool)
    e = g.edge_array()
    if len(e) == 0:
        return True
    return bool(np.all(s[e[:, 0]] | s[e[:, 1]]))


def cover_cost(g: Graph, s: np.ndarray) -> int:
    s = np.asarray(s, dtype=bool)
    return int(g.weights[s].sum())


def read_solution(path) -> np.ndarray:
    """Read a per-vertex 0/1 solution file (one value per line)."""
    with open(path, "rb") as f:
        return np.array(f.read().split(), dtype=np.int64)


def write_solution(path, s: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("\n".join("1" if int(x) else "0" for x in s))
        f.write("\n")


def is_independent_set(g: Graph, s: np.ndarray) -> bool:
    """True iff no edge has both endpoints selected."""
    s = np.asarray(s, dtype=bool)
    e = g.edge_array()
    if len(e) == 0:
        return True
    return bool(np.all(~(s[e[:, 0]] & s[e[:, 1]])))


def independent_set_to_cover(g: Graph, s: np.ndarray) -> np.ndarray:
    """Complement an IS into a VC; raises if *s* is not independent.

    HILS solves Max Weight IS; comparisons use Sum(w) - IS weight
    (reference: README.md, is_vc_converter.cpp:12-23).
    """
    if not is_independent_set(g, s):
        raise ValueError("input is not an independent set")
    return (~np.asarray(s, dtype=bool)).astype(np.int64)
