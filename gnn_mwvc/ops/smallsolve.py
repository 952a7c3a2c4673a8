"""Batched exact MWVC for small instances (<= 16 or <= 20 vertices).

Two formulations with one contract (smallest cover bitmask among the
minima, padding bits cleared):

* ``batched_small_mwvc`` — the plain reference: all 2^16 subsets as an
  array axis, thousands of instances on the other, one dense int32 tensor
  op (the batched analog of the reference's SSE2 brute-force solver,
  reference: include/small_solve.hpp:44-76).  Used for the r4/r5 meta-rule
  checks and as the oracle the region solver is tested against.
* ``mitm_small_mwvc`` — the region solver of the device-assisted phase 2
  (solver/device_assist.py).  A meet-in-the-middle walk that never holds
  the 2^n subsets in memory: the per-instance tables over 128 low and
  2^(n-7) high patterns are built once, then the high patterns are walked
  in blocks under ``fori_loop`` with a (B, 128) running (cost, pattern)
  carry.  Each block is a compare/select producer feeding a variadic
  min-reduction, which XLA fuses into one kernel, so no (B, block, 128)
  intermediate reaches device memory.  It makes n=20 regions (2^20
  subsets) practical.

Instances are padded to the width with adj = 0, w = 0; padding bits are free
and cost 0, so the minimum over the full enumeration is exact for any
instance size up to the width.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["batched_small_mwvc", "mitm_small_mwvc", "pack_instances"]

_INF = 2**31 - 1  # int32 costs, same as the reference Small16
_N_LOW = 7        # low half of the meet-in-the-middle split: 128 patterns


def pack_instances(instances):
    """instances: list of (weights list, edges list of (i, j) local pairs).

    Returns (adj (B,16) int32 bitmasks, w (B,16) int32).
    """
    b = len(instances)
    adj = np.zeros((b, 16), dtype=np.int32)
    w = np.zeros((b, 16), dtype=np.int32)
    for k, (wts, edges) in enumerate(instances):
        n = len(wts)
        assert n <= 16
        w[k, :n] = wts
        for i, j in edges:
            adj[k, i] |= 1 << j
            adj[k, j] |= 1 << i
    return adj, w


def _used_mask(adj, w):
    """(B,) bitmask of the non-padding vertices (w != 0 or any edge)."""
    n = adj.shape[1]
    used = ((w != 0) | (adj != 0)).astype(jnp.int32)
    return jnp.sum(used << jax.lax.broadcasted_iota(jnp.int32, (1, n), 1),
                   axis=1)


@jax.jit
def batched_small_mwvc(adj: jnp.ndarray, w: jnp.ndarray):
    """adj: (B, 16) int32 neighbor bitmasks; w: (B, 16) int32 weights.

    Returns (best_cost (B,) int32, best_set (B,) int32 subset bitmask with
    padding bits cleared).  Per-instance total weight must stay below 2^31
    (the reference's Small16 shares this int32 cost domain).
    """
    b = adj.shape[0]
    subsets = jax.lax.broadcasted_iota(jnp.int32, (1, 1 << 16), 1)  # (1, S)

    def body(j, carry):
        cost, valid = carry
        aj = adj[:, j].reshape(b, 1)
        wj = w[:, j].reshape(b, 1)
        chosen = (subsets >> j) & 1
        covered = (subsets & aj) == aj
        valid = valid & ((chosen == 1) | covered)
        cost = cost + jnp.where(chosen == 1, wj, 0)
        return cost, valid

    cost0 = jnp.zeros((b, 1 << 16), dtype=jnp.int32)
    valid0 = jnp.ones((b, 1 << 16), dtype=bool)
    cost, valid = jax.lax.fori_loop(0, 16, body, (cost0, valid0))
    cost = jnp.where(valid, cost, _INF)
    best_idx = jnp.argmin(cost, axis=1)
    best_cost = jnp.take_along_axis(cost, best_idx[:, None], axis=1)[:, 0]
    return best_cost, best_idx.astype(jnp.int32) & _used_mask(adj, w)


def _mitm_tables(adj, w, n):
    """Per-instance meet-in-the-middle tables.

    MWVC by complement: a subset ``s`` is a vertex cover iff its complement
    ``c`` is an independent set, and cost(s) = total_w - w(c).  Complements
    split as c = c_high (n-7 bits) | c_low (7 bits); c is independent iff
    ``indep_low[c_low] & indep_high[c_high] & (cross_low[c_low] & c_high)
    == 0``.  Returns (base, indep_low, cross_low, w_high, indep_high):
      base       (B, 128)  total_w - w(c_low)  [cost before the high refund]
      indep_low  (B, 128)  1 if c_low is independent within the low 7
      cross_low  (B, 128)  OR of adj_high over the chosen low vertices
      w_high     (B, NH)   w(c_high)
      indep_high (B, NH)   1 if c_high is independent within the high bits
    A self-loop bit (a vertex forced into the cover) makes every complement
    that holds the vertex dependent.
    """
    b = adj.shape[0]
    n_high = n - _N_LOW
    nh = 1 << n_high
    high_mask = nh - 1
    c_low = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    c_high = jax.lax.broadcasted_iota(jnp.int32, (1, nh), 1)
    total_w = jnp.sum(w, axis=1, dtype=jnp.int32)  # (B,)

    w_low = jnp.zeros((b, 128), jnp.int32)
    viol_low = jnp.zeros((b, 128), jnp.int32)
    cross_low = jnp.zeros((b, 128), jnp.int32)
    for j in range(_N_LOW):
        bit = (c_low >> j) & 1                      # (1, 128)
        aj = adj[:, j:j + 1]                        # (B, 1)
        w_low = w_low + bit * w[:, j:j + 1]
        viol_low = viol_low | (bit & ((aj & 0x7F & c_low) != 0))
        cross_low = cross_low | jnp.where(
            bit == 1, (aj >> _N_LOW) & high_mask, 0)

    w_high = jnp.zeros((b, nh), jnp.int32)
    viol_high = jnp.zeros((b, nh), jnp.int32)
    for j in range(n_high):
        bit = (c_high >> j) & 1
        aj = adj[:, _N_LOW + j:_N_LOW + j + 1]
        w_high = w_high + bit * w[:, _N_LOW + j:_N_LOW + j + 1]
        viol_high = viol_high | (
            bit & (((aj >> _N_LOW) & high_mask & c_high) != 0))

    base = total_w[:, None] - w_low
    return base, 1 - viol_low, cross_low, w_high, 1 - viol_high


def _min_cost_then_high(a, b):
    """Lexicographic min over (cost, -c_high): the larger high pattern wins
    a cost tie, i.e. the smaller cover bitmask."""
    ca, ha = a
    cb, hb = b
    take_a = (ca < cb) | ((ca == cb) & (ha > hb))
    return jnp.where(take_a, ca, cb), jnp.where(take_a, ha, hb)


@functools.partial(jax.jit, static_argnames=("block",))
def mitm_small_mwvc(adj: jnp.ndarray, w: jnp.ndarray, block: int = 2048):
    """Batched exact MWVC over (B, n) bitmask instances, n = 16 or 20.

    adj: (B, n) int32 neighbor bitmasks (bit j of adj[i] = local edge to
    vertex j; a self-loop bit forces the vertex into the cover); w: (B, n)
    int32 weights, per-instance total weight < 2^30.  Returns (best_cost
    (B,) int32, best_set (B,) int32 with padding bits cleared).  For n=16
    this is bitwise equal to ``batched_small_mwvc`` including argmin
    tie-breaks (smallest cover bitmask among minima).

    block: high patterns per loop step (a power of two); the walk takes
    2^(n-7) / block steps.  2048 measured fastest at n=20 on the H100
    (PERF.md); n=16 has 512 high patterns and walks them in one step.
    """
    n = adj.shape[1]
    assert n in (16, 20), n
    nh = 1 << (n - _N_LOW)
    block = min(block, nh)
    base, indep_lo, cross, w_high, indep_hi = _mitm_tables(adj, w, n)
    ok_lo = indep_lo != 0
    # Walk the high patterns from the largest down: for a fixed low
    # pattern the cover bitmask s = ~(c_low | c_high << 7) shrinks as
    # c_high grows, so within each lane the first minimum found (strict <
    # across steps, larger c_high within a step) is the smallest s.
    w_rev = w_high[:, ::-1]
    ok_hi_rev = indep_hi[:, ::-1] != 0
    offs = jax.lax.broadcasted_iota(jnp.int32, (1, block, 1), 1)

    def step(t, carry):
        acc_c, acc_h = carry
        wh = jax.lax.dynamic_slice_in_dim(w_rev, t * block, block, axis=1)
        ih = jax.lax.dynamic_slice_in_dim(ok_hi_rev, t * block, block, axis=1)
        ch = (nh - 1 - t * block) - offs                       # (1, K, 1)
        ok = ok_lo[:, None, :] & ih[:, :, None] & ((cross[:, None, :] & ch)
                                                   == 0)
        cost = jnp.where(ok, base[:, None, :] - wh[:, :, None], _INF)
        blk_c, blk_h = jax.lax.reduce(
            (cost, jnp.broadcast_to(ch, cost.shape)),
            (np.int32(_INF), np.int32(-1)), _min_cost_then_high, (1,))
        better = blk_c < acc_c
        return (jnp.where(better, blk_c, acc_c),
                jnp.where(better, blk_h, acc_h))

    b = adj.shape[0]
    init = (jnp.full((b, 128), _INF, jnp.int32),
            jnp.full((b, 128), -1, jnp.int32))
    acc_c, acc_h = jax.lax.fori_loop(0, nh // block, step, init)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    s = jnp.int32((1 << n) - 1) ^ (lane | (acc_h << _N_LOW))
    best_cost = jnp.min(acc_c, axis=1)
    best_set = jnp.min(jnp.where(acc_c == best_cost[:, None], s, _INF),
                       axis=1)
    return best_cost, best_set & _used_mask(adj, w)
