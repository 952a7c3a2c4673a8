"""Windowed block-sparse aggregation as one-hot matmuls.

Idea: replace per-edge row gathers by large-granule window fetches plus
dense matmuls.  Real MWVC instances (road networks, web graphs) have strong
locality under a clustered vertex order (core.cluster_order); this op
exploits it:

* nodes are split into windows of 128; every edge lives in a (dst-window,
  src-window) pair; each pair's edges are packed into chunks of 128/32/8
  slots (multi-size, so sparse pairs don't waste 128-slot chunks);
* per chunk, aggregation is two one-hot matmuls:
      gathered = onehot(lsrc) @ x_window        (the "gather")
      partial  = onehot(ldst)^T @ gathered      (the "scatter")
  with one-hots built by iota comparison — the only memory gather is the
  *large-granule* (128 x W) source-window fetch, which is bandwidth-bound;
* per-window partials combine with sorted large-granule segment-sums.

`quality` = edges / total chunk slots; callers fall back to the ELL gather
path when the ordering has no locality.  On the H100 at ``HIGHEST`` this
plan measured far slower than ELL on every graph class timed (PERF.md), so
``aggregation="auto"`` does not pick it on a GPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BlockedPlan", "build_blocked", "blocked_segment_sum",
           "pad_plan_like"]

WIN = 128                  # node window
CHUNK_SIZES = (128, 32, 8)  # slot sizes, large to small


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockedPlan:
    n_pad: int = dataclasses.field(metadata=dict(static=True))
    n_win: int = dataclasses.field(metadata=dict(static=True))       # dst windows
    n_src_win: int = dataclasses.field(default=0, metadata=dict(static=True))
    # per size class: (C_s,) src/dst windows + (C_s, S) local ids
    src_win: tuple = ()
    dst_win: tuple = ()
    lsrc: tuple = ()
    ldst: tuple = ()
    quality: float = dataclasses.field(default=0.0, metadata=dict(static=True))


def build_blocked(indptr: np.ndarray, indices: np.ndarray,
                  n_pad: int, n_src: int | None = None,
                  as_numpy: bool = False) -> BlockedPlan:
    """Host prep for one CSR snapshot (rows = destinations).

    n_src: size of the source id space when it differs from the destination
    rows (the sharded case: destinations are one shard's rows, sources index
    the all-gathered global feature block).
    """
    n = len(indptr) - 1
    e = len(indices)
    n_win = -(-n_pad // WIN)
    n_src_win = n_win if n_src is None else -(-n_src // WIN)
    wrap = (lambda a: a) if as_numpy else jnp.asarray
    if e == 0:
        z = np.zeros(8, np.int32)
        return BlockedPlan(
            n_pad=n_pad, n_win=n_win, n_src_win=n_src_win,
            src_win=tuple(wrap(z) for _ in CHUNK_SIZES),
            dst_win=tuple(wrap(np.full(8, n_win, np.int32))
                          for _ in CHUNK_SIZES),
            lsrc=tuple(wrap(np.zeros((8, s), np.int32)) for s in CHUNK_SIZES),
            ldst=tuple(wrap(np.full((8, s), WIN, np.int32))
                       for s in CHUNK_SIZES),
            quality=1.0,
        )

    # Segmented stable sort by (dst window, src window) + one-pass chunk
    # packing, both in the native core (numpy fancy-indexing passes over
    # tens of millions of edges dominate otherwise).
    try:
        from gnn_mwvc.core import blocked_pack, pair_order
        from gnn_mwvc.graph import bucket_size

        order = pair_order(indptr, indices, WIN)
        counts = blocked_pack(indptr, indices, order, WIN)
        src_wins, dst_wins, lsrcs, ldsts = [], [], [], []
        arrs = []
        for cls, size in enumerate(CHUNK_SIZES):
            cpad = bucket_size(max(int(counts[cls]), 1), minimum=8,
                               growth=1.3)
            sw = np.zeros(cpad, dtype=np.uint32)
            dw = np.full(cpad, n_win, dtype=np.uint32)
            ls = np.zeros((cpad, size), dtype=np.uint32)
            ld = np.full((cpad, size), WIN, dtype=np.uint32)
            arrs += [sw, dw, ls, ld]
        blocked_pack(indptr, indices, order, WIN, fill_arrays=arrs)
        total_slots = sum(
            int(counts[c]) * CHUNK_SIZES[c] for c in range(len(CHUNK_SIZES))
        )
        for cls in range(len(CHUNK_SIZES)):
            sw, dw, ls, ld = arrs[cls * 4: cls * 4 + 4]
            src_wins.append(wrap(sw.astype(np.int32)))
            dst_wins.append(wrap(dw.astype(np.int32)))
            lsrcs.append(wrap(ls.astype(np.int32)))
            ldsts.append(wrap(ld.astype(np.int32)))
    except ImportError:  # pure-python fallback
        src_wins, dst_wins, lsrcs, ldsts, total_slots = _build_numpy(
            indptr, indices, n, e, n_win, n_src_win, wrap
        )

    quality = float(e) / float(max(total_slots, 1))
    return BlockedPlan(
        n_pad=n_pad, n_win=n_win, n_src_win=n_src_win,
        src_win=tuple(src_wins), dst_win=tuple(dst_wins),
        lsrc=tuple(lsrcs), ldst=tuple(ldsts),
        quality=quality,
    )


def pad_plan_like(plan: BlockedPlan, tmpl: BlockedPlan) -> BlockedPlan | None:
    """Re-pad *plan*'s chunk arrays to *tmpl*'s exact shapes (and copy its
    static fields) so a jit program traced for tmpl serves plan verbatim.

    Used by shape-templated rebuilds (solver/static_score.py): a kernel
    snapshot rebuilt mid-solve has fewer edges than the first build, so its
    chunk arrays fit inside the template with dead-chunk padding (dst window
    = n_win sentinel, local dst = WIN sentinel — both already the builder's
    padding scheme, appended at the tail so dst windows stay sorted).
    Returns None when any chunk class outgrew the template.
    """
    if plan.n_win != tmpl.n_win or plan.n_src_win != tmpl.n_src_win:
        return None
    src_win, dst_win, lsrc, ldst = [], [], [], []
    for i, s in enumerate(CHUNK_SIZES):
        c = int(np.asarray(plan.src_win[i]).shape[0])
        ct = int(np.asarray(tmpl.src_win[i]).shape[0])
        if c > ct:
            return None
        pad = ct - c
        src_win.append(np.concatenate(
            [np.asarray(plan.src_win[i]), np.zeros(pad, np.int32)]))
        dst_win.append(np.concatenate(
            [np.asarray(plan.dst_win[i]),
             np.full(pad, plan.n_win, np.int32)]))
        lsrc.append(np.concatenate(
            [np.asarray(plan.lsrc[i]), np.zeros((pad, s), np.int32)]))
        ldst.append(np.concatenate(
            [np.asarray(plan.ldst[i]), np.full((pad, s), WIN, np.int32)]))
    return dataclasses.replace(
        tmpl,
        src_win=tuple(src_win), dst_win=tuple(dst_win),
        lsrc=tuple(lsrc), ldst=tuple(ldst),
    )


def _class_partials(xw, src_win, dst_win, lsrc, ldst, dtype,
                    n_dst_win, chunk_batch=8192, precision=None):
    """One size class -> (n_dst_win, WIN, w) aggregated window partials."""
    n_win = n_dst_win
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, WIN), 2)

    def do_batch(args):
        sw, dw, ls, ld = args
        xs = xw.take(sw, axis=0)                          # (B, WIN, w)
        oh_src = (ls[:, :, None] == iota).astype(dtype)   # (B, S, WIN)
        gathered = jnp.einsum(
            "bcw,bwf->bcf", oh_src, xs,
            preferred_element_type=jnp.float32,
            precision=precision,
        )
        oh_dst = (ld[:, :, None] == iota).astype(dtype)   # (B, S, WIN)
        partial = jnp.einsum(
            "bcd,bcf->bdf", oh_dst, gathered,
            preferred_element_type=jnp.float32,
            precision=precision,
        ).astype(dtype)
        return partial

    c = src_win.shape[0]
    if c <= chunk_batch:
        partial = do_batch((src_win, dst_win, lsrc, ldst))
        dw = dst_win
    else:
        nb = -(-c // chunk_batch)
        pad = nb * chunk_batch - c
        sw = jnp.pad(src_win, (0, pad))
        dw = jnp.pad(dst_win, (0, pad), constant_values=n_win)
        ls = jnp.pad(lsrc, ((0, pad), (0, 0)))
        ld = jnp.pad(ldst, ((0, pad), (0, 0)), constant_values=WIN)
        s = lsrc.shape[1]
        partial = jax.lax.map(
            do_batch,
            (sw.reshape(nb, chunk_batch),
             dw.reshape(nb, chunk_batch),
             ls.reshape(nb, chunk_batch, s),
             ld.reshape(nb, chunk_batch, s)),
        ).reshape(nb * chunk_batch, WIN, xw.shape[2])
    return jax.ops.segment_sum(
        partial, dw, num_segments=n_win + 1, indices_are_sorted=True
    )[:n_win]


def blocked_segment_sum(x: jnp.ndarray, plan: BlockedPlan,
                        n_out: int | None = None,
                        precision=None) -> jnp.ndarray:
    """agg[u] = sum over v in N(u) of x[v], via windowed one-hot matmuls.

    x indexes the source space (n_src_win windows); the output has
    plan.n_win * WIN rows sliced to n_out (defaults to len(x), the
    single-device case where src and dst spaces coincide).

    precision: the one-hot einsums' precision.  None = backend default
    (TF32 on a GPU); HIGHEST keeps full fp32 for activation parity.  The one-hot operands are exact in bf16, so DEFAULT's only error
    is the bf16 rounding of the feature operand (~2^-9 relative).
    """
    w = x.shape[1]
    n_src_win = plan.n_src_win or plan.n_win
    pad_rows = n_src_win * WIN - x.shape[0]
    xw = jnp.pad(x, ((0, pad_rows), (0, 0))).reshape(n_src_win, WIN, w)

    agg = None
    for i in range(len(plan.src_win)):
        part = _class_partials(
            xw, plan.src_win[i], plan.dst_win[i], plan.lsrc[i],
            plan.ldst[i], x.dtype, n_dst_win=plan.n_win,
            precision=precision,
        )
        agg = part if agg is None else agg + part
    if n_out is None:
        n_out = x.shape[0]
    return agg.reshape(plan.n_win * WIN, -1)[:n_out]


def _build_numpy(indptr, indices, n, e, n_win, n_src_win, wrap):
    """Pure-numpy plan construction (no native core available)."""
    from gnn_mwvc.graph import bucket_size

    deg = np.diff(indptr).astype(np.int64)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = np.asarray(indices, dtype=np.int64)
    order = np.argsort((dst // WIN) * n_src_win + (src // WIN),
                       kind="stable")
    dst_s = dst[order]
    src_s = src[order]
    dw_s = dst_s // WIN
    sw_s = src_s // WIN
    new_pair = np.empty(e, dtype=bool)
    new_pair[0] = True
    new_pair[1:] = (dw_s[1:] != dw_s[:-1]) | (sw_s[1:] != sw_s[:-1])
    run_id = np.cumsum(new_pair) - 1
    starts = np.nonzero(new_pair)[0]
    run_len = np.diff(np.append(starts, e))
    within = np.arange(e) - starts[run_id]

    rl = run_len[run_id]
    rem_start = (rl // CHUNK_SIZES[0]) * CHUNK_SIZES[0]
    in_large = within < rem_start
    rem_pos = within - rem_start
    rem_len = rl - rem_start
    use_mid = (rem_len > CHUNK_SIZES[2])
    mid_take = np.where(use_mid, np.minimum(rem_len, CHUNK_SIZES[1]), 0)
    in_mid = (~in_large) & (rem_pos < mid_take)
    in_small = (~in_large) & (~in_mid)

    src_wins, dst_wins, lsrcs, ldsts = [], [], [], []
    total_slots = 0
    for cls, size in enumerate(CHUNK_SIZES):
        if cls == 0:
            sel = in_large
            cpos = within[sel]
        elif cls == 1:
            sel = in_mid
            cpos = rem_pos[sel]
        else:
            sel = in_small
            cpos = (rem_pos - mid_take)[sel]
        d, s_ = dst_s[sel], src_s[sel]
        r = run_id[sel]
        key = r * (e + 1) + cpos // size
        if len(key):
            newc = np.empty(len(key), dtype=bool)
            newc[0] = True
            newc[1:] = key[1:] != key[:-1]
            chunk_of = np.cumsum(newc) - 1
            n_chunks = int(chunk_of[-1]) + 1
        else:
            chunk_of = key.astype(np.int64)
            n_chunks = 0
        n_pad_chunks = bucket_size(max(n_chunks, 1), minimum=8, growth=1.3)
        sw = np.zeros(n_pad_chunks, dtype=np.int32)
        dw = np.full(n_pad_chunks, n_win, dtype=np.int32)
        ls = np.zeros((n_pad_chunks, size), dtype=np.int32)
        ld = np.full((n_pad_chunks, size), WIN, dtype=np.int32)
        if len(d):
            slot = (cpos % size).astype(np.int64)
            sw[chunk_of] = (s_ // WIN).astype(np.int32)
            dw[chunk_of] = (d // WIN).astype(np.int32)
            ls[chunk_of, slot] = (s_ % WIN).astype(np.int32)
            ld[chunk_of, slot] = (d % WIN).astype(np.int32)
        ordc = np.argsort(dw, kind="stable")
        src_wins.append(wrap(sw[ordc]))
        dst_wins.append(wrap(dw[ordc]))
        lsrcs.append(wrap(ls[ordc]))
        ldsts.append(wrap(ld[ordc]))
        total_slots += n_chunks * size
    return src_wins, dst_wins, lsrcs, ldsts, total_slots
