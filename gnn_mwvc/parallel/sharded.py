"""Edge-partitioned message passing over a device mesh (shard_map).

Design (SURVEY.md §2.4 / §5 "long-context" entry): nodes are partitioned into
P contiguous, equally padded ranges; every directed edge (dst-sorted COO) is
owned by the shard that owns its destination row.  A graph-layer round is

    1. pack the boundary ("halo") features each peer needs — per-shard index
       sets precomputed at partition time — and exchange them with ONE
       `lax.all_to_all` over the "graph" axis (XLA hands it to the
       collective library; NVLink between the cards of one host).
       Communicated bytes per device are proportional to the boundary
       size (P * h_max * width * 4), NOT to the total node count,
    2. aggregate interior edges (locally owned sources) with a sorted
       segment-sum that does not depend on the collective — XLA's
       latency-hiding scheduler overlaps the halo exchange with it,
    3. aggregate boundary edges out of the received halo buffer and add,
    4. local stat columns (D, W/ws, NW/ws are node-sharded).

Linear/activation layers are node-local, so one inference does exactly
3 halo exchanges.  Autodiff through shard_map transposes the all_to_all to
the reverse all_to_all and the halo gather to a scatter-add, which is what a
hand-written backward would do.  `halo=False` falls back to the round-1
full feature all-gather (kept for differential testing).

This mirrors the reference's only parallel loop (the per-node neighbor sum,
reference: src/gnn_inference.cpp:31-41) but scales graph *size* across chips
instead of threads.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

__all__ = [
    "ShardedGraph",
    "partition_device_graph",
    "make_sharded_forward",
    "make_sticky_sharded_forward",
    "make_sharded_train_step",
]

from gnn_mwvc.graph import DeviceGraph


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedGraph:
    """Per-shard stacked graph arrays; leading axis = graph-mesh axis (P)."""

    n: int = dataclasses.field(metadata=dict(static=True))       # real nodes
    n_loc: int = dataclasses.field(metadata=dict(static=True))   # padded nodes/shard
    e_loc: int = dataclasses.field(metadata=dict(static=True))   # padded edges/shard
    weights: jnp.ndarray = None   # (P, n_loc) f32
    degrees: jnp.ndarray = None   # (P, n_loc) f32
    nw: jnp.ndarray = None        # (P, n_loc) f32
    node_mask: jnp.ndarray = None  # (P, n_loc) bool
    # full-gather mode (halo=False): every edge in one list, global src ids
    row_loc: jnp.ndarray = None   # (P, e_loc) int32 local dst row in [0, n_loc)
    col: jnp.ndarray = None       # (P, e_loc) int32 global src node
    # halo mode: boundary-only exchange
    h_max: int = dataclasses.field(default=0, metadata=dict(static=True))
    send_idx: jnp.ndarray = None  # (P, P*h_max) i32 local rows to pack; slot
    #                               [q*h_max+j] = j-th row peer q needs
    row_int: jnp.ndarray = None   # (P, e_int) i32 interior dst rows (sorted)
    col_int: jnp.ndarray = None   # (P, e_int) i32 interior src, local ids
    row_bnd: jnp.ndarray = None   # (P, e_bnd) i32 boundary dst rows (sorted)
    col_bnd: jnp.ndarray = None   # (P, e_bnd) i32 boundary src, halo-buffer ids
    # optional stacked per-shard windowed one-hot plans (ops/blocked.py):
    # tuples of (P, C_s) / (P, C_s, S) arrays per chunk-size class
    blk_src_win: tuple = None
    blk_dst_win: tuple = None
    blk_lsrc: tuple = None
    blk_ldst: tuple = None
    blk_n_win: int = dataclasses.field(default=0, metadata=dict(static=True))
    blk_n_src_win: int = dataclasses.field(default=0,
                                           metadata=dict(static=True))

    @property
    def parts(self) -> int:
        return self.weights.shape[0]

    @property
    def has_blocked(self) -> bool:
        return self.blk_src_win is not None

    @property
    def halo(self) -> bool:
        return self.send_idx is not None

    def halo_bytes_per_chip(self, width: int = 16) -> int:
        """Bytes moved per chip per graph layer (send side, f32 features)."""
        if self.halo:
            return int(self.parts * self.h_max * width * 4)
        # full all-gather: every other shard's feature block
        return int((self.parts - 1) * self.n_loc * width * 4)


def _pad128(k: int, floor: int = 128) -> int:
    return int(max(floor, -(-int(k) // 128) * 128))


def partition_device_graph(dg: DeviceGraph, parts: int,
                           aggregation: str = "scatter",
                           halo: bool = True,
                           shape_template: ShardedGraph | None = None,
                           headroom: float = 1.0,
                           ) -> ShardedGraph | None:
    """Split a DeviceGraph into *parts* contiguous node ranges.

    Edges go to the shard owning their destination; per-shard edge slots are
    padded to the max shard load.  With halo=True (default), per-peer
    boundary index sets are precomputed: each shard packs only the feature
    rows its peers actually reference, one all_to_all exchanges them, and
    boundary edges read the received halo buffer.  halo=False keeps the
    full-feature all-gather.

    shape_template: a previously-built ShardedGraph whose exact array
    shapes this partition must reuse (the mesh analog of
    DeviceGraph.build(shape_template=...)).  A rebuilt
    kernel padded into the template's shapes is served by the jit program
    already compiled for the template — no compile mid-phase-1.
    Returns None when the graph outgrew any template dimension (callers
    fall back; mid-solve kernels only shrink, so overflow means gadget
    churn restructured the boundary).

    headroom: multiplier on the data-dependent paddings (h_max, e_int,
    e_bnd, e_loc) so a partition built as a future template absorbs the
    boundary drift a shrinking-but-recompacted kernel induces (compaction
    moves shard boundaries, so per-pair halo sets are not monotone in the
    node count).  Blocked chunk arrays already carry growth-1.3 bucket
    padding from build_blocked.  Ignored when shape_template is given.
    """
    tmpl = shape_template
    if tmpl is not None:
        if (tmpl.parts != parts or tmpl.halo != (halo and parts > 1)
                or tmpl.has_blocked != (aggregation == "blocked")):
            return None
        if dg.n_pad > parts * tmpl.n_loc:
            return None
        n_loc = tmpl.n_loc
    else:
        n_loc = max(-(-dg.n_pad // parts), 8)
    grow = (lambda x: int(x * headroom)) if tmpl is None else (lambda x: x)
    shard = np.minimum(dg.row[: dg.e] // n_loc, parts - 1)
    counts = np.bincount(shard, minlength=parts)
    e_loc = _pad128(grow(counts.max() if len(counts) else 1))
    if tmpl is not None:
        if e_loc > tmpl.e_loc:
            return None
        e_loc = tmpl.e_loc

    w = np.zeros((parts, n_loc), dtype=np.float32)
    d = np.zeros((parts, n_loc), dtype=np.float32)
    nw = np.zeros((parts, n_loc), dtype=np.float32)
    mask = np.zeros((parts, n_loc), dtype=bool)
    for p in range(parts):
        nlo, nhi = p * n_loc, min((p + 1) * n_loc, dg.n_pad)
        cnt = max(nhi - nlo, 0)
        if cnt > 0:
            w[p, :cnt] = dg.weights[nlo:nhi]
            d[p, :cnt] = dg.degrees[nlo:nhi]
            nw[p, :cnt] = dg.nw[nlo:nhi]
            mask[p, :cnt] = dg.node_mask[nlo:nhi]

    order = np.argsort(shard, kind="stable")
    rows_sorted = dg.row[: dg.e][order]
    cols_sorted = dg.col[: dg.e][order]
    offsets = np.zeros(parts + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    halo = halo and parts > 1
    fields = {}
    # per-shard edge lists (local rows); in halo mode sources are remapped
    # into the extended space [0, n_loc + parts*h_max)
    loc_rows, loc_cols = [], []
    if halo:
        src_shard = np.minimum(cols_sorted // n_loc, parts - 1).astype(
            np.int64)
        p_edge = np.minimum(rows_sorted // n_loc, parts - 1).astype(np.int64)
        is_bnd = src_shard != p_edge
        # Vectorized per-peer boundary sets (round 3: the previous O(P^2)
        # pair loops with per-pair np.unique dominated partition build at
        # road-class x 16 shards).  One global sorted-unique over the
        # combined (dst_shard, src_shard, col) key yields every need[p][q]
        # list concatenated in block order; block starts give each
        # element's rank j within its (p, q) block.
        colspace = np.int64(parts) * n_loc + 1
        pq = p_edge[is_bnd] * parts + src_shard[is_bnd]
        key = pq * colspace + cols_sorted[is_bnd]
        uniq = np.unique(key)
        u_pq = uniq // colspace
        u_col = uniq % colspace
        blk_ids, blk_starts, blk_counts = np.unique(
            u_pq, return_index=True, return_counts=True)
        h_max = int(blk_counts.max()) if len(blk_counts) else 0
        h_max = int(max(8, -(-grow(h_max) // 8) * 8))
        if tmpl is not None:
            if h_max > tmpl.h_max:
                return None
            h_max = tmpl.h_max
        # sender q packs rows need[p][q] into slot block p
        send_idx = np.zeros((parts, parts * h_max), dtype=np.int32)
        if len(uniq):
            q_arr = u_pq % parts
            p_arr = u_pq // parts
            j_arr = (np.arange(len(uniq), dtype=np.int64)
                     - blk_starts[np.searchsorted(blk_ids, u_pq)])
            send_idx[q_arr, p_arr * h_max + j_arr] = (
                u_col - q_arr * n_loc).astype(np.int32)
        # receiver p remaps boundary source s (j-th in need[p][q]) to halo
        # slot q*h_max + j; interior source to its local id
        c_b_all = np.zeros(int(is_bnd.sum()), dtype=np.int64)
        if len(uniq):
            pos = np.searchsorted(uniq, key)
            bs = blk_starts[np.searchsorted(blk_ids, pq)]
            c_b_all = src_shard[is_bnd] * h_max + (pos - bs)
        e_int_max, e_bnd_max = 1, 1
        per = []
        bnd_cum = np.zeros(len(is_bnd) + 1, dtype=np.int64)
        np.cumsum(is_bnd, out=bnd_cum[1:])
        for p in range(parts):
            lo, hi = offsets[p], offsets[p + 1]
            rl = (rows_sorted[lo:hi] - p * n_loc).astype(np.int64)
            b = is_bnd[lo:hi]
            r_i = rl[~b]
            c_i = cols_sorted[lo:hi][~b] - p * n_loc
            r_b = rl[b]
            c_b = c_b_all[bnd_cum[lo]: bnd_cum[hi]]
            per.append((r_i, c_i, r_b, c_b))
            e_int_max = max(e_int_max, len(r_i))
            e_bnd_max = max(e_bnd_max, len(r_b))
        e_int, e_bnd = _pad128(grow(e_int_max)), _pad128(grow(e_bnd_max))
        if tmpl is not None:
            te_int = int(tmpl.row_int.shape[1])
            te_bnd = int(tmpl.row_bnd.shape[1])
            if e_int > te_int or e_bnd > te_bnd:
                return None
            e_int, e_bnd = te_int, te_bnd
        row_int = np.full((parts, e_int), n_loc, dtype=np.int32)
        col_int = np.zeros((parts, e_int), dtype=np.int32)
        row_bnd = np.full((parts, e_bnd), n_loc, dtype=np.int32)
        col_bnd = np.zeros((parts, e_bnd), dtype=np.int32)
        for p, (r_i, c_i, r_b, c_b) in enumerate(per):
            row_int[p, : len(r_i)] = r_i
            col_int[p, : len(c_i)] = c_i
            row_bnd[p, : len(r_b)] = r_b
            col_bnd[p, : len(c_b)] = c_b
            # blocked mode consumes one remapped edge list over the
            # extended [local | halo] source space
            loc_rows.append(np.concatenate([r_i, r_b]))
            loc_cols.append(np.concatenate([c_i, n_loc + c_b]))
        fields.update(
            h_max=h_max, send_idx=jnp.asarray(send_idx),
            row_int=jnp.asarray(row_int), col_int=jnp.asarray(col_int),
            row_bnd=jnp.asarray(row_bnd), col_bnd=jnp.asarray(col_bnd),
        )
    else:
        row_loc = np.full((parts, e_loc), n_loc, dtype=np.int32)
        col = np.zeros((parts, e_loc), dtype=np.int32)
        for p in range(parts):
            lo, hi = offsets[p], offsets[p + 1]
            k = hi - lo
            row_loc[p, :k] = rows_sorted[lo:hi] - p * n_loc
            col[p, :k] = cols_sorted[lo:hi]
            loc_rows.append(rows_sorted[lo:hi] - p * n_loc)
            loc_cols.append(cols_sorted[lo:hi])
        fields.update(row_loc=jnp.asarray(row_loc), col=jnp.asarray(col))

    if aggregation == "blocked":
        # per-shard windowed plans over the local source space ([local|halo]
        # in halo mode, the all-gathered global block otherwise), padded to
        # common shapes so one shard_map program serves all shards
        from gnn_mwvc.ops.blocked import build_blocked

        n_src = (n_loc + parts * fields["h_max"]) if halo else parts * n_loc
        plans = []
        for p in range(parts):
            rl, cl = loc_rows[p], loc_cols[p]
            srt = np.argsort(rl, kind="stable")
            loc_indptr = np.zeros(n_loc + 1, dtype=np.int64)
            np.add.at(loc_indptr, rl + 1, 1)
            np.cumsum(loc_indptr, out=loc_indptr)
            plans.append(build_blocked(loc_indptr, cl[srt], n_loc,
                                       n_src=n_src, as_numpy=True))
        ncls = len(plans[0].src_win)
        if tmpl is not None and (
                len(tmpl.blk_src_win) != ncls
                or plans[0].n_win != tmpl.blk_n_win
                or plans[0].n_src_win != tmpl.blk_n_src_win):
            return None
        stk = {k: [] for k in ("sw", "dw", "ls", "ld")}
        for c in range(ncls):
            cmax = max(pl.src_win[c].shape[0] for pl in plans)
            if tmpl is not None:
                t_cmax = int(tmpl.blk_src_win[c].shape[1])
                if cmax > t_cmax:
                    return None
                cmax = t_cmax
            size = plans[0].lsrc[c].shape[1]
            n_win = plans[0].n_win
            sw = np.zeros((parts, cmax), np.int32)
            dw = np.full((parts, cmax), n_win, np.int32)
            ls = np.zeros((parts, cmax, size), np.int32)
            ld = np.full((parts, cmax, size), 128, np.int32)
            for p, pl in enumerate(plans):
                cc = pl.src_win[c].shape[0]
                sw[p, :cc] = pl.src_win[c]
                dw[p, :cc] = pl.dst_win[c]
                ls[p, :cc] = pl.lsrc[c]
                ld[p, :cc] = pl.ldst[c]
            stk["sw"].append(jnp.asarray(sw))
            stk["dw"].append(jnp.asarray(dw))
            stk["ls"].append(jnp.asarray(ls))
            stk["ld"].append(jnp.asarray(ld))
        fields.update(
            blk_src_win=tuple(stk["sw"]), blk_dst_win=tuple(stk["dw"]),
            blk_lsrc=tuple(stk["ls"]), blk_ldst=tuple(stk["ld"]),
            blk_n_win=plans[0].n_win, blk_n_src_win=plans[0].n_src_win,
        )
    return ShardedGraph(
        n=dg.n, n_loc=n_loc, e_loc=e_loc,
        weights=jnp.asarray(w), degrees=jnp.asarray(d), nw=jnp.asarray(nw),
        node_mask=jnp.asarray(mask), **fields,
    )


def _exchange_halo(h, send_idx, parts, h_max):
    """Pack the rows peers need and swap with one all_to_all.

    Returns the (parts*h_max, width) halo buffer: rows [q*h_max + j] = j-th
    row this shard needs from peer q.  Slot block q of the send buffer holds
    what peer q needs from us, so the all_to_all transpose lands each block
    where it is consumed.
    """
    send = h.take(send_idx, axis=0).reshape(parts, h_max, h.shape[1])
    halo = jax.lax.all_to_all(send, "graph", split_axis=0, concat_axis=0,
                              tiled=False)
    return halo.reshape(parts * h_max, h.shape[1])


def _aggregate(h, g, n_loc, blocked_plan, precision=None):
    """One graph-layer neighbor sum under shard_map; g = dict of arrays.

    precision reaches the windowed plan's one-hot einsums (the segment-sum
    paths are gather+add and exact at any setting); without HIGHEST a GPU
    runs them in TF32."""
    if g.get("send_idx") is not None:  # halo mode
        parts = jax.lax.axis_size("graph")
        h_max = g["send_idx"].shape[0] // parts
        halo = _exchange_halo(h, g["send_idx"], parts, h_max)
        if blocked_plan is not None:
            from gnn_mwvc.ops.blocked import blocked_segment_sum

            h_ext = jnp.concatenate([h, halo], axis=0)
            return blocked_segment_sum(h_ext, blocked_plan, n_out=n_loc,
                                       precision=precision)
        # interior aggregation is independent of the collective; XLA's
        # latency-hiding scheduler overlaps the halo exchange with it
        agg_int = jax.ops.segment_sum(
            h.take(g["col_int"], axis=0), g["row_int"],
            num_segments=n_loc + 1, indices_are_sorted=True,
        )
        agg_bnd = jax.ops.segment_sum(
            halo.take(g["col_bnd"], axis=0), g["row_bnd"],
            num_segments=n_loc + 1, indices_are_sorted=True,
        )
        return (agg_int + agg_bnd)[:n_loc]
    # full-gather fallback
    h_full = jax.lax.all_gather(h, "graph", axis=0, tiled=True)
    if blocked_plan is not None:
        from gnn_mwvc.ops.blocked import blocked_segment_sum

        return blocked_segment_sum(h_full, blocked_plan, n_out=n_loc,
                                   precision=precision)
    return jax.ops.segment_sum(
        h_full.take(g["col"], axis=0), g["row_loc"],
        num_segments=n_loc + 1, indices_are_sorted=True,
    )[:n_loc]


def _layer_stack(kinds, params, x, g, deg, w, nw, ws, n_loc,
                 compat=True, precision=jax.lax.Precision.HIGHEST,
                 blocked_plan=None, source_mask=None,
                 x_is_node_weights=False):
    """Shared layer walk; runs inside shard_map (axis name "graph").

    source_mask: (n_loc,) 0/1 — masked-rescore mode (the sharded analog of
    models/gnn.py forward's source_mask): the partitioned structure is a
    SUPERSET of the live graph, so masked-out features are zeroed before
    every aggregation (bias terms re-introduce nonzeros on dead rows after
    linear layers).  x_is_node_weights: first message-passing round is
    analytic (sum over live N(u) of W(v)/ws == NW(u)/ws, a refreshed
    per-node stat) — it skips that round's halo exchange entirely.
    """
    h = x
    first_graph = True
    for kind, p in zip(kinds, params):
        if kind == "linear":
            h = (
                jnp.dot(h, p["w"], preferred_element_type=jnp.float32,
                        precision=precision) + p["b"]
            ).astype(h.dtype)
        elif kind == "relu":
            h = jnp.maximum(h, 0)
        elif kind == "sigmoid":
            h = jax.nn.sigmoid(h)
        else:  # graph layer: halo exchange + local aggregation
            width = h.shape[1]
            if first_graph and x_is_node_weights:
                agg = (nw / ws).reshape(-1, 1).astype(h.dtype)
            else:
                if source_mask is not None:
                    h = h * source_mask[:, None].astype(h.dtype)
                agg = _aggregate(h, g, n_loc, blocked_plan,
                                 precision=precision)
            first_graph = False
            stats = jnp.stack([deg, w / ws, nw / ws], axis=1).astype(h.dtype)
            if compat:
                out = jnp.concatenate(
                    [agg, h, jnp.zeros((n_loc, 3), h.dtype)], axis=1
                )
                h = jax.lax.dynamic_update_slice(out, stats, (0, width + 1))
            else:
                h = jnp.concatenate([agg, h, stats], axis=1)
    return h


def _edge_arrays(sg: ShardedGraph):
    """(dict of stacked arrays, matching shard_map in_specs dict)."""
    if sg.halo:
        arrs = dict(send_idx=sg.send_idx, row_int=sg.row_int,
                    col_int=sg.col_int, row_bnd=sg.row_bnd,
                    col_bnd=sg.col_bnd)
    else:
        arrs = dict(row_loc=sg.row_loc, col=sg.col)
    specs = {k: P("graph", None) for k in arrs}
    return arrs, specs


def make_sharded_forward(kinds, mesh: Mesh, compat: bool = True,
                         precision=jax.lax.Precision.HIGHEST,
                         masked: bool = False,
                         x_is_node_weights: bool = False):
    """Build a jitted sharded scorer: (params, sg, ws) -> (P, n_loc) scores.

    When the ShardedGraph carries per-shard windowed plans (partition with
    aggregation="blocked"), each shard aggregates with one-hot matmuls
    instead of a segment-sum.

    masked=True builds the masked-rescore variant used by the sharded
    sticky scorer (solver/sharded_score.py): the input features are
    node_mask-gated and re-masked before every aggregation, so a static
    partition whose structure is a superset of the live graph scores the
    live graph exactly.  x_is_node_weights skips the first round's halo
    exchange via the analytic NW/ws shortcut (models/gnn.py forward).
    """
    cache = {}

    def get_fn(mode_key, n_win, n_src_win, ncls, specs):
        key = (mode_key, n_win, n_src_win, ncls)
        if key in cache:
            return cache[key]
        has_blocked = ncls > 0

        def local_fwd(params, g, blk, wdnwm, ws):
            w, d, nw, m = (a[0] for a in wdnwm)
            g = {k: v[0] for k, v in g.items()}
            n_loc = w.shape[0]
            plan = None
            if has_blocked:
                from gnn_mwvc.ops.blocked import BlockedPlan

                plan = BlockedPlan(
                    n_pad=n_loc, n_win=n_win, n_src_win=n_src_win,
                    src_win=tuple(a[0] for a in blk[0]),
                    dst_win=tuple(a[0] for a in blk[1]),
                    lsrc=tuple(a[0] for a in blk[2]),
                    ldst=tuple(a[0] for a in blk[3]),
                )
            mf = m.astype(jnp.float32)
            x = (w / ws).reshape(-1, 1)
            if masked:
                x = x * mf[:, None]
            h = _layer_stack(kinds, params, x, g, d, w, nw, ws,
                             n_loc, compat=compat, precision=precision,
                             blocked_plan=plan,
                             source_mask=mf if masked else None,
                             x_is_node_weights=x_is_node_weights)
            return h[:, 0][None]

        if has_blocked:
            blk_spec = (
                tuple(P("graph", None) for _ in range(ncls)),
                tuple(P("graph", None) for _ in range(ncls)),
                tuple(P("graph", None, None) for _ in range(ncls)),
                tuple(P("graph", None, None) for _ in range(ncls)),
            )
        else:
            blk_spec = ()
        smap = jax.shard_map(
            local_fwd,
            mesh=mesh,
            in_specs=(P(), specs, blk_spec, (P("graph", None),) * 4, P()),
            out_specs=P("graph", None),
            check_vma=False,
        )
        fn = jax.jit(smap)
        cache[key] = fn
        return fn

    def scorer(params, sg: ShardedGraph, ws):
        g, specs = _edge_arrays(sg)
        if sg.has_blocked:
            blk = (sg.blk_src_win, sg.blk_dst_win, sg.blk_lsrc, sg.blk_ldst)
            fn = get_fn(("blk", sg.halo), sg.blk_n_win, sg.blk_n_src_win,
                        len(sg.blk_src_win), specs)
        else:
            blk = ()
            fn = get_fn(("sct", sg.halo), 0, 0, 0, specs)
        return fn(params, g, blk,
                  (sg.weights, sg.degrees, sg.nw, sg.node_mask),
                  jnp.float32(ws))

    return scorer


def make_sticky_sharded_forward(kinds, mesh: Mesh, compat: bool = True,
                                precision=jax.lax.Precision.HIGHEST):
    """Fused per-shard delta-scatter + masked forward (the mesh analog of
    static_score._make_sticky_fn).

    The per-node feature buffers (weights/nw/degrees/mask, each (P, n_loc))
    live on the mesh and are DONATED to every call; per-round uploads are
    only the (P, k) changed-slot deltas — matching the single-chip sticky
    scorer's ~n/16 delta economics instead of re-shipping the full
    (4, P*n_loc) feature block each peel round.  The
    scatter runs INSIDE shard_map with per-shard local indices, so no
    cross-shard collective is ever inserted for it; padding slots must
    carry (idx, value) pairs that are no-ops (duplicates of a real update,
    or the current value of local slot 0 — the caller guarantees this).

    Returns scorer(params, sg, bufs, upd, ws) ->
    (scores (P, n_loc), wts, nws, degs, mask) with the returned buffers
    replacing the donated ones.  sg supplies only the static edge/plan
    arrays; bufs = (wts, nws, degs, mask); upd = (idx, vw, vnw, vdeg, vm),
    idx int32 (P, k) local row ids.
    """
    cache = {}

    def get_fn(mode_key, n_win, n_src_win, ncls, specs):
        key = (mode_key, n_win, n_src_win, ncls)
        if key in cache:
            return cache[key]
        has_blocked = ncls > 0

        def local_step(params, g, blk, bufs, upd, ws):
            wts, nws, degs, mask = (a[0] for a in bufs)
            idx, vw, vnw, vdeg, vm = (a[0] for a in upd)
            g = {k: v[0] for k, v in g.items()}
            wts = wts.at[idx].set(vw)
            nws = nws.at[idx].set(vnw)
            degs = degs.at[idx].set(vdeg)
            mask = mask.at[idx].set(vm)
            n_loc = wts.shape[0]
            plan = None
            if has_blocked:
                from gnn_mwvc.ops.blocked import BlockedPlan

                plan = BlockedPlan(
                    n_pad=n_loc, n_win=n_win, n_src_win=n_src_win,
                    src_win=tuple(a[0] for a in blk[0]),
                    dst_win=tuple(a[0] for a in blk[1]),
                    lsrc=tuple(a[0] for a in blk[2]),
                    ldst=tuple(a[0] for a in blk[3]),
                )
            mf = mask.astype(jnp.float32)
            x = (wts / ws).reshape(-1, 1) * mf[:, None]
            h = _layer_stack(kinds, params, x, g, degs, wts, nws, ws,
                             n_loc, compat=compat, precision=precision,
                             blocked_plan=plan, source_mask=mf,
                             x_is_node_weights=True)
            return (h[:, 0][None], wts[None], nws[None], degs[None],
                    mask[None])

        if has_blocked:
            blk_spec = (
                tuple(P("graph", None) for _ in range(ncls)),
                tuple(P("graph", None) for _ in range(ncls)),
                tuple(P("graph", None, None) for _ in range(ncls)),
                tuple(P("graph", None, None) for _ in range(ncls)),
            )
        else:
            blk_spec = ()
        smap = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), specs, blk_spec, (P("graph", None),) * 4,
                      (P("graph", None),) * 5, P()),
            out_specs=(P("graph", None),) * 5,
            check_vma=False,
        )
        fn = jax.jit(smap, donate_argnums=(3,))
        cache[key] = fn
        return fn

    def scorer(params, sg: ShardedGraph, bufs, upd, ws):
        g, specs = _edge_arrays(sg)
        if sg.has_blocked:
            blk = (sg.blk_src_win, sg.blk_dst_win, sg.blk_lsrc, sg.blk_ldst)
            fn = get_fn(("blk", sg.halo), sg.blk_n_win, sg.blk_n_src_win,
                        len(sg.blk_src_win), specs)
        else:
            blk = ()
            fn = get_fn(("sct", sg.halo), 0, 0, 0, specs)
        return fn(params, g, blk, bufs, upd, jnp.float32(ws))

    return scorer


def make_sharded_train_step(kinds, mesh: Mesh, lr=0.01, momentum=0.9,
                            compat: bool = True):
    """Full-batch MSE + SGD(momentum) training step over the sharded graph.

    Matches the reference training defaults (reference:
    old_files/src/apps/gnn_train.cpp:72-111, SGD lr 0.01 momentum 0.9); the
    backward pass is jax.grad through the sharded forward (the halo
    all_to_all transposes to the reverse all_to_all, the halo gather to a
    scatter-add).
    """
    import optax

    tx = optax.sgd(learning_rate=lr, momentum=momentum)
    cache = {}

    def get_step(specs_key, specs):
        if specs_key in cache:
            return cache[specs_key]

        def loss_local(params, g, wdnw, mask, y, ws):
            w, d, nw = (a[0] for a in wdnw)
            g = {k: v[0] for k, v in g.items()}
            mask, y = mask[0], y[0]
            n_loc = w.shape[0]
            x = (w / ws).reshape(-1, 1)
            out = _layer_stack(kinds, params, x, g, d, w, nw, ws,
                               n_loc, compat=compat)
            err = jnp.where(mask, out[:, 0] - y, 0.0)
            sse = jax.lax.psum(jnp.sum(err * err), "graph")
            cnt = jax.lax.psum(jnp.sum(mask.astype(jnp.float32)), "graph")
            return sse / jnp.maximum(cnt, 1.0)

        loss_sharded = jax.shard_map(
            loss_local,
            mesh=mesh,
            in_specs=(P(), specs, (P("graph", None),) * 3,
                      P("graph", None), P("graph", None), P()),
            out_specs=P(),
            check_vma=False,
        )

        @jax.jit
        def step_fn(params, opt_state, g, wdnw, mask, y, ws):
            loss, grads = jax.value_and_grad(
                lambda p: loss_sharded(p, g, wdnw, mask, y, jnp.float32(ws))
            )(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        cache[specs_key] = step_fn
        return step_fn

    def step(params, opt_state, sg: ShardedGraph, y, ws):
        g, specs = _edge_arrays(sg)
        step_fn = get_step(sg.halo, specs)
        return step_fn(params, opt_state, g,
                       (sg.weights, sg.degrees, sg.nw), sg.node_mask, y, ws)

    return step, tx
