"""Vectorized reduction-rule predicates over a padded graph snapshot.

The reference checks rules one vertex at a time through worklists
(reference: mwvc_reductions.hpp:335-380); on device we evaluate whole-graph
candidate masks in one fused pass — the "reduction rounds on device" half of
the BASELINE.json throughput target.  The host engine stays the source of
truth for exactness (it re-verifies candidates before applying), these masks
are prioritization/bulk-application hints:

* r1 (neighborhood reduction):   exact mask, NW(u) <= W(u).
* r2 (twin):                     candidate groups via neighborhood hashing —
  equal (degree, NW, hash) buckets; exact equality is re-checked host-side.
* r3 (domination) edge filter:   edges (u, v) passing the reference's cheap
  necessary conditions D(u) >= D(v), W(u)+NW(u) >= W(v)+NW(v), W(v) >= W(u).
* isolated-candidate filter:     vertices whose every neighbor passes the
  degree/weight precheck of is_dominating(v, u).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["rule_masks", "twin_hash", "build_ell8", "r5_candidates"]

_H1 = np.uint32(0x9E3779B9)
_H2 = np.uint32(0x85EBCA6B)


def _mix(x):
    x = (x ^ (x >> 16)) * _H2
    x = (x ^ (x >> 13)) * _H1
    return x ^ (x >> 16)


def twin_hash(row, col, n_pad):
    """Order-independent neighborhood hash per vertex: sum of mixed neighbor
    ids (uint32 wrap).  Twins (equal open neighborhoods) collide exactly."""
    h = _mix(col.astype(jnp.uint32) + _H1)
    return jax.ops.segment_sum(
        h, row, num_segments=n_pad, indices_are_sorted=True
    )


@jax.jit
def rule_masks(row, col, weights, degrees, nw, node_mask):
    """Returns dict of per-vertex masks / per-edge filters (all on device).

    row/col: padded directed COO (row sorted); weights/degrees/nw: (n_pad,).
    """
    n_pad = weights.shape[0]
    w = weights
    d = degrees
    r1 = node_mask & (nw <= w) & (d > 0)

    th = twin_hash(row, col, n_pad)
    # candidate twins: same (degree, nw, hash); padded rows excluded
    key = (
        th
        + _mix(d.astype(jnp.uint32) * _H2)
        + _mix(nw.astype(jnp.uint32) * _H1)
    )
    key = jnp.where(node_mask, key, jnp.uint32(0))

    # r3 edge filter: u dominates v possible (cheap necessary conditions)
    du, dv = d.take(row), d.take(col)
    wu, wv = w.take(row), w.take(col)
    nwu, nwv = nw.take(row), nw.take(col)
    dom_edge = (du >= dv) & (wu + nwu >= wv + nwv) & (wv >= wu)

    # isolated candidates: every neighbor v has D(v) >= D(u) and
    # W(v)+NW(v) >= W(u)+NW(u) (necessary for is_dominating(v, u))
    ok_nbr = (dv >= du) & (wv + nwv >= wu + nwu)
    bad = jax.ops.segment_sum(
        (~ok_nbr).astype(jnp.int32), row, num_segments=n_pad,
        indices_are_sorted=True,
    )
    iso_cand = node_mask & (d > 0) & (bad == 0)

    return {
        "r1": r1,
        "twin_key": key,
        "dom_edge": dom_edge,
        "iso_cand": iso_cand,
    }


def build_ell8(indptr: np.ndarray, indices: np.ndarray, deg: np.ndarray):
    """First-8-neighbors ELL table (host numpy, vectorized).

    Returns (ell (n+1, 8) int32, valid (n+1, 8) bool); row n is an
    all-invalid sentinel so device gathers of "no neighbor" slots stay in
    bounds.  Rows of degree > 8 are truncated — see r5_candidates for why
    that stays sound.
    """
    n = len(deg)
    k = 8
    take = indptr[:-1, None] + np.arange(k, dtype=np.int64)[None]
    valid = np.arange(k)[None] < np.minimum(deg, k)[:, None]
    if len(indices):
        cols = indices[np.minimum(take, len(indices) - 1)]
    else:
        cols = np.zeros((n, k), np.int64)
    cols = np.where(valid, cols, n).astype(np.int32)
    ell = np.concatenate([cols, np.full((1, k), n, np.int32)], 0)
    ellv = np.concatenate([valid, np.zeros((1, k), bool)], 0)
    return ell, np.ascontiguousarray(ellv)


@functools.partial(jax.jit, static_argnames="chunk")
def r5_candidates(ell, ellv, weights, nw, deg, node_mask, chunk=4096):
    """Device-batched rule-5 (neighborhood meta-reduction) verdict mask.

    For every vertex u with deg(u) <= 8, exactly solves MWVC on the N(u)
    subgraph by enumerating all 2^8 subsets (the device-batched analog of the
    reference's per-vertex small_mwvc_solver call, reference:
    mwvc_reductions.hpp:235-252) and returns the mask
    W(u) >= NW(u) - VC(N(u)).

    Soundness under truncation: adjacency among N(u) is reconstructed from
    the neighbors' own first-8 ELL rows; a neighbor of degree > 8 may have
    edges omitted.  A missing edge relaxes the instance, so the computed VC
    is a LOWER bound and the returned condition implies the true rule-5
    condition — the mask can only under-fire, never mis-fire.

    Arithmetic is int32: the caller must guarantee max NW < 2^31 (the
    instance cost is bounded by NW(u)); device_reduce_prepass checks this
    host-side before enabling the rule.

    ell/ellv: (n+1, 8) from build_ell8; weights/nw/deg/node_mask: (n,).
    """
    n = weights.shape[0]
    w_pad = jnp.concatenate(
        [weights.astype(jnp.int32), jnp.zeros((1,), jnp.int32)]
    )
    n_pad = ((n + chunk - 1) // chunk) * chunk
    pad = n_pad - n
    cand = node_mask & (deg <= 8)
    lp = jnp.pad(ell[:n], ((0, pad), (0, 0)), constant_values=n)
    lv = jnp.pad(ellv[:n], ((0, pad), (0, 0)))
    wp = jnp.pad(weights.astype(jnp.int32), (0, pad))
    nwp = jnp.pad(nw.astype(jnp.int32), (0, pad))
    mp = jnp.pad(cand, (0, pad))
    nchunks = n_pad // chunk

    def per_chunk(args):
        loc, locv, w_u, nw_u, m_u = args  # (C,8),(C,8),(C,),(C,),(C,)
        c = loc.shape[0]
        nbr_w = w_pad[loc] * locv  # (C,8) int32, invalid slots 0
        nn = ell[loc]  # (C,8,8): ELL rows of each neighbor
        nnv = ellv[loc] & locv[:, :, None]
        # adj[c,i,j]: neighbor i adjacent to neighbor j (either direction)
        hit = (nn[:, :, None, :] == loc[:, None, :, None]) & nnv[:, :, None, :]
        adj = hit.any(-1) & locv[:, :, None] & locv[:, None, :]
        adj = adj | jnp.swapaxes(adj, 1, 2)
        adjmask = (
            adj.astype(jnp.int32) << jnp.arange(8, dtype=jnp.int32)[None, None]
        ).sum(-1)  # (C,8) bitmask over j
        subsets = jnp.arange(256, dtype=jnp.int32)[None]  # (1,256)
        cost = jnp.zeros((c, 256), jnp.int32)
        ok = jnp.ones((c, 256), bool)
        for j in range(8):
            chosen = (subsets >> j) & 1
            aj = adjmask[:, j : j + 1]
            ok = ok & ((chosen == 1) | ((subsets & aj) == aj))
            cost = cost + jnp.where(chosen == 1, nbr_w[:, j : j + 1], 0)
        vc = jnp.where(ok, cost, jnp.int32(2**31 - 1)).min(1)
        return m_u & (w_u >= nw_u - vc)

    out = jax.lax.map(
        per_chunk,
        (
            lp.reshape(nchunks, chunk, 8),
            lv.reshape(nchunks, chunk, 8),
            wp.reshape(nchunks, chunk),
            nwp.reshape(nchunks, chunk),
            mp.reshape(nchunks, chunk),
        ),
    )
    return out.reshape(-1)[:n]


def twin_groups(keys: np.ndarray, node_mask: np.ndarray):
    """Host post-processing: group vertex ids by equal twin key; returns list
    of candidate groups (size >= 2)."""
    keys = np.asarray(keys)
    ids = np.nonzero(np.asarray(node_mask))[0]
    k = keys[ids]
    order = np.argsort(k, kind="stable")
    ids, k = ids[order], k[order]
    groups = []
    start = 0
    for i in range(1, len(k) + 1):
        if i == len(k) or k[i] != k[start]:
            if i - start >= 2:
                groups.append(ids[start:i])
            start = i
    return groups
