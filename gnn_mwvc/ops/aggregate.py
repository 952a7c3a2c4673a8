"""Neighborhood aggregation as a multi-level bucketed ELL plan.

Why not scatter: ``jax.ops.segment_sum`` lowers to a scatter-add; on the
H100 this plan is faster on locality-ordered graphs (PERF.md), the sorted
segment-sum on random ones.  Why not prefix-sum differences: fp32 cumsum over
millions of edges suffers catastrophic cancellation (measured abs error > 1
on unit-scale features).

The ELL formulation keeps everything as dense gathers + small exact tree
reductions, with no scatter and no atomics:

* Rows are bucketed by degree into power-of-two widths (8/32/128); each
  bucket is a dense (R, K) table of neighbor ids, padded slots pointing at a
  zero row.  ``x[tbl].sum(axis=1)`` is a gather + lane-parallel reduce.
* Rows wider than the largest bucket are split into chunks (virtual rows)
  whose partials are combined by further, much smaller ELL levels — degree
  skew costs O(log) tiny levels instead of a serialized scatter.
* All inter-level permutations are folded into the next level's index tables
  at build time (host side, per graph snapshot), so the device executes only
  gathers and reshape-sums.  A final (n, W) gather restores node order.

This replaces the reference's per-node neighbor-sum loop
(reference: src/gnn_inference.cpp:31-41) as the hot aggregation primitive.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["EllPlan", "build_ell", "ell_segment_sum"]

LEAF_BUCKETS = (8, 32, 128)
COMBINE_BUCKETS = (1, 2, 4, 8)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EllPlan:
    """Index tables for multi-level ELL aggregation.

    tables: flat tuple of (R_b, K_b) int32 arrays; ``level_sizes`` (static)
    gives how many consecutive tables belong to each level.  Each table
    indexes the previous level's *extended* output (id == previous n_out is
    the zero-row sentinel); level 0 indexes node features.
    final_perm: (n,) int32 gather restoring node order from the last level's
    bucket-concatenated layout.
    """

    tables: tuple = ()
    final_perm: jnp.ndarray = None
    level_sizes: tuple = dataclasses.field(default=(), metadata=dict(static=True))
    n_nodes: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def num_levels(self) -> int:
        return len(self.level_sizes)

    def iter_levels(self):
        i = 0
        for sz in self.level_sizes:
            yield self.tables[i : i + sz]
            i += sz


def _bucket_of(deg: np.ndarray, buckets) -> np.ndarray:
    """Smallest bucket >= deg (deg must be <= buckets[-1])."""
    out = np.full(deg.shape, buckets[-1], dtype=np.int64)
    for b in reversed(buckets):
        out = np.where(deg <= b, b, out)
    return out


def _build_level(counts: np.ndarray, offsets: np.ndarray, item_ids: np.ndarray,
                 n_in: int, buckets, max_k: int):
    """One ELL level.

    counts[u]  : #inputs for output row u (rows in fixed output order)
    offsets[u] : start of row u's inputs inside item_ids
    item_ids   : flat int32 ids into the previous level's output (row-major)
    n_in       : previous level's output size (== zero-row sentinel id)

    Returns (tables, chunk_counts, chunk_pos) where tables is a list of
    (K, tbl) with tbl referencing item_ids values (padding -> n_in);
    chunk_counts[u] = #chunks emitted for row u; chunk_pos = flat positions of
    those chunks in the bucket-concatenated output, row-major order.
    """
    n_rows = len(counts)
    n_chunks_per_row = np.maximum(1, -(-counts // max_k))
    simple = counts <= max_k

    # --- chunk descriptors (start, length, owner row), row-major ------------
    total_chunks = int(n_chunks_per_row.sum())
    chunk_row = np.repeat(np.arange(n_rows, dtype=np.int64), n_chunks_per_row)
    # index of chunk within its row
    first_chunk = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_row, out=first_chunk[1:])
    chunk_k = np.arange(total_chunks, dtype=np.int64) - first_chunk[chunk_row]
    chunk_start = offsets[chunk_row] + chunk_k * max_k
    chunk_len = np.minimum(counts[chunk_row] - chunk_k * max_k, max_k)
    chunk_len = np.maximum(chunk_len, 0)

    chunk_bucket = _bucket_of(np.maximum(chunk_len, 1), buckets)

    # --- bucket-concatenated positions --------------------------------------
    # Table row counts are padded to geometric size buckets so recurring
    # snapshots of similar size produce identical jit shapes (bounds
    # recompiles across peel rounds); padding rows reference the zero
    # sentinel and are never read by later levels.
    from gnn_mwvc.graph import bucket_size

    tables = []
    chunk_pos = np.empty(total_chunks, dtype=np.int64)
    base = 0
    for K in buckets:
        sel = np.nonzero(chunk_bucket == K)[0]
        if len(sel) == 0:
            continue
        r = len(sel)
        idx = chunk_start[sel][:, None] + np.arange(K)[None, :]
        valid = np.arange(K)[None, :] < chunk_len[sel][:, None]
        safe_ids = item_ids if len(item_ids) else np.zeros(1, dtype=np.int64)
        tbl = np.where(valid, safe_ids[np.minimum(idx, len(safe_ids) - 1)], n_in)
        r_pad = bucket_size(r, minimum=8, growth=1.3)
        tbl_p = np.full((r_pad, K), n_in, dtype=np.int32)
        tbl_p[:r] = tbl
        tables.append((K, tbl_p))
        chunk_pos[sel] = base + np.arange(r)
        base += r_pad

    return tables, n_chunks_per_row, chunk_pos, first_chunk


def build_ell(indptr: np.ndarray, indices: np.ndarray, n_pad: int,
              leaf_buckets=LEAF_BUCKETS,
              combine_buckets=COMBINE_BUCKETS) -> EllPlan:
    """Build the aggregation plan for one CSR snapshot (host side).

    indptr: (n,) or (n+1,) CSR row pointers over *n* real rows; rows beyond
    len(indptr)-1 up to n_pad aggregate to zero.
    indices: (e,) neighbor ids in [0, n_pad).
    """
    n = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int64)
    counts = np.zeros(n_pad, dtype=np.int64)
    counts[:n] = deg
    offsets = np.zeros(n_pad, dtype=np.int64)
    offsets[:n] = indptr[:-1]

    all_tables = []
    level_sizes = []
    item_ids = np.asarray(indices, dtype=np.int64)
    n_in = n_pad  # level-0 inputs are node features
    max_k = leaf_buckets[-1]
    buckets = leaf_buckets
    while True:
        tables, n_chunks, chunk_pos, first_chunk = _build_level(
            counts, offsets, item_ids, n_in, buckets, max_k
        )
        n_out = sum(t.shape[0] for _, t in tables)
        all_tables.extend(jnp.asarray(t) for _, t in tables)
        level_sizes.append(len(tables))
        if (n_chunks <= 1).all():
            final_perm = chunk_pos[first_chunk[:-1]]
            break
        # Next level combines this level's chunks (inputs laid row-major via
        # chunk_pos translation).
        counts = n_chunks
        offsets = first_chunk[:-1]
        item_ids = chunk_pos
        n_in = n_out
        buckets = combine_buckets
        max_k = combine_buckets[-1]

    return EllPlan(
        tables=tuple(all_tables),
        final_perm=jnp.asarray(final_perm.astype(np.int32)),
        level_sizes=tuple(level_sizes),
        n_nodes=n_pad,
    )


# Cap on gathered elements materialized at once (elements, not bytes): keeps
# the (chunk, K, W) gather workspace ~512 MB fp32 regardless of graph size.
_CHUNK_ELEMS = 128 * 1024 * 1024


def _table_sum(ext: jnp.ndarray, tbl: jnp.ndarray, width: int) -> jnp.ndarray:
    """sum over K of ext[tbl] without materializing more than _CHUNK_ELEMS."""
    r, k = tbl.shape
    if r * k * width <= _CHUNK_ELEMS:
        g = ext.take(tbl.reshape(-1), axis=0)
        return g.reshape(r, k, width).sum(axis=1)
    chunk = max(8, _CHUNK_ELEMS // (k * width) // 8 * 8)
    n_chunks = -(-r // chunk)
    pad = n_chunks * chunk - r
    tbl_p = jnp.pad(tbl, ((0, pad), (0, 0)), constant_values=ext.shape[0] - 1)
    tbl_p = tbl_p.reshape(n_chunks, chunk, k)

    def one(tb):
        return ext.take(tb.reshape(-1), axis=0).reshape(chunk, k, width).sum(1)

    out = jax.lax.map(one, tbl_p)
    return out.reshape(n_chunks * chunk, width)[:r]


def ell_segment_sum(x: jnp.ndarray, plan: EllPlan) -> jnp.ndarray:
    """agg[u] = sum over v in N(u) of x[v]; x is (n_pad, W)."""
    inp = x
    for tables in plan.iter_levels():
        zero = jnp.zeros((1, inp.shape[1]), inp.dtype)
        ext = jnp.concatenate([inp, zero], axis=0)
        parts = [_table_sum(ext, tbl, inp.shape[1]) for tbl in tables]
        inp = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    return inp.take(plan.final_perm, axis=0)
