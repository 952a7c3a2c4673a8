"""METIS vertex-weighted graph format.

Format (reference: README.md "Graph Format" section): first line
``N E 10`` (10 = vertex weights), then one line per vertex: weight followed by
the 1-indexed sorted neighbor list; each edge appears in both endpoint rows.

The parser mirrors the reference's normalization (reference:
src/GNN_VC.cpp:34-90): keep only neighbors v with v > u (upper triangle),
then sort + deduplicate; self-loops are dropped by the same rule.  Tokens are
bucketed into lines vectorially (newline offsets + searchsorted) instead of
line-by-line Python parsing.
"""

from __future__ import annotations

import io

import numpy as np

from gnn_mwvc.graph import Graph

__all__ = ["read_metis", "write_metis"]

_WS = (ord(" "), ord("\t"), ord("\r"), ord("\n"))


def _tokenize(body: bytes):
    """Return (values, line_of_token) for all integer tokens in *body*."""
    buf = np.frombuffer(body, dtype=np.uint8)
    is_ws = np.isin(buf, _WS)
    prev_ws = np.empty_like(is_ws)
    prev_ws[0] = True
    prev_ws[1:] = is_ws[:-1]
    tok_pos = np.nonzero(~is_ws & prev_ws)[0]
    nl_pos = np.nonzero(buf == ord("\n"))[0]
    line_of_tok = np.searchsorted(nl_pos, tok_pos, side="left")
    values = np.array(body.split(), dtype=np.int64)
    assert len(values) == len(tok_pos)
    return values, line_of_tok, len(nl_pos) + 1


def read_metis(path_or_buf) -> Graph:
    if hasattr(path_or_buf, "read"):
        data = path_or_buf.read()
        if isinstance(data, str):
            data = data.encode()
    else:
        with open(path_or_buf, "rb") as f:
            data = f.read()

    header_end = data.find(b"\n")
    header = data[:header_end].split()
    n = int(header[0])
    body = data[header_end + 1 :]

    if n == 0:
        return Graph(np.zeros(0, dtype=np.int64), None)

    values, line_of_tok, _ = _tokenize(body)
    counts = np.bincount(line_of_tok, minlength=n)[:n]  # tokens per vertex line
    if (counts < 1).any():
        bad = int(np.nonzero(counts < 1)[0][0])
        raise ValueError(f"METIS vertex line {bad + 1} has no weight token")

    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    total = int(starts[-1])
    values = values[:total]

    weights = values[starts[:-1]]
    nbr_mask = np.ones(total, dtype=bool)
    nbr_mask[starts[:-1]] = False
    nbrs = values[nbr_mask] - 1  # to 0-indexed
    rows_idx = np.repeat(np.arange(n, dtype=np.int64), counts - 1)

    keep = nbrs > rows_idx
    edges = np.stack([rows_idx[keep], nbrs[keep]], axis=1)
    if len(edges):
        edges = np.unique(edges, axis=0)
    return Graph(weights, edges)


def write_metis(path_or_buf, g: Graph) -> None:
    """Write in the reference's METIS dialect (weights fmt code 10)."""
    own = False
    if hasattr(path_or_buf, "write"):
        f = path_or_buf
    else:
        f = open(path_or_buf, "w")
        own = True
    try:
        out = io.StringIO()
        out.write(f"{g.n} {g.m} 10\n")
        indptr, indices, w = g.indptr, g.indices, g.weights
        for u in range(g.n):
            nbrs = indices[indptr[u] : indptr[u + 1]] + 1
            if len(nbrs):
                out.write(f"{int(w[u])} " + " ".join(map(str, nbrs.tolist())) + "\n")
            else:
                out.write(f"{int(w[u])}\n")
        f.write(out.getvalue())
    finally:
        if own:
            f.close()
