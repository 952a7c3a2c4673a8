"""The meet-in-the-middle region solver vs the 2^16 enumeration oracle.

The contract is bitwise identity with ops.smallsolve.batched_small_mwvc at
n=16, including argmin tie-breaking (smallest cover bitmask among minima),
and with a numpy brute force at n=20.  Every check runs over several
high-pattern block sizes (the loop's step count changes, the answer must
not).
"""

import functools

import numpy as np
import pytest

from gnn_mwvc.ops.smallsolve import (batched_small_mwvc, mitm_small_mwvc,
                                         pack_instances)

BLOCKS = (16, 128, 512)


def _solvers():
    return [functools.partial(mitm_small_mwvc, block=b) for b in BLOCKS]


def _random_instances(rng, b, nmax=16, wmax=1000):
    out = []
    for _ in range(b):
        n = int(rng.integers(1, nmax + 1))
        wts = rng.integers(1, wmax + 1, size=n).tolist()
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        if pairs:
            k = int(rng.integers(0, len(pairs) + 1))
            sel = rng.choice(len(pairs), size=k, replace=False)
            edges = [pairs[i] for i in sel]
        else:
            edges = []
        out.append((wts, edges))
    return out


def _check(instances):
    adj, w = pack_instances(instances)
    c0, s0 = batched_small_mwvc(adj, w)
    for solve in _solvers():
        c1, s1 = solve(adj, w)
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
        np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))


def test_random_instances():
    rng = np.random.default_rng(7)
    _check(_random_instances(rng, 48))


def test_tie_heavy_unit_weights():
    # every vertex weight 1: many cost ties -> exercises the lexicographic
    # (cost, subset) accumulator tie-break across chunks and lanes
    rng = np.random.default_rng(11)
    inst = _random_instances(rng, 32, wmax=1)
    _check(inst)


def test_structured_cases():
    inst = [
        ([5], []),                                     # isolated vertex
        ([3, 4], [(0, 1)]),                            # single edge
        ([1] * 16, [(i, (i + 1) % 16) for i in range(16)]),   # 16-cycle
        ([10] * 16, [(i, j) for i in range(16) for j in range(i + 1, 16)]),
        ([7, 1, 1, 1, 1, 1], [(0, k) for k in range(1, 6)]),  # star
        ([2, 2, 2], []),                               # no edges: empty cover
    ]
    _check(inst)


@pytest.mark.parametrize("b", [1, 13, 37])
def test_batch_padding(b):
    # odd batch sizes: nothing assumes a multiple of a tile
    rng = np.random.default_rng(13 + b)
    _check(_random_instances(rng, b))


def _brute_force(wts, edges, n_bits):
    """Numpy subset enumeration oracle for any n <= n_bits (first argmin)."""
    n = len(wts)
    s = np.arange(1 << n_bits, dtype=np.int64)
    adj = np.zeros(n_bits, np.int64)
    for i, j in edges:
        adj[i] |= 1 << j
        adj[j] |= 1 << i
    w = np.zeros(n_bits, np.int64)
    w[:n] = wts
    cost = np.zeros(1 << n_bits, np.int64)
    valid = np.ones(1 << n_bits, bool)
    for j in range(n_bits):
        chosen = (s >> j) & 1
        covered = (s & adj[j]) == adj[j]
        valid &= (chosen == 1) | covered
        cost += np.where(chosen == 1, w[j], 0)
    cost = np.where(valid, cost, 2**31 - 1)
    best = int(np.argmin(cost))
    used = 0
    for j in range(n):
        if wts[j] != 0 or adj[j] != 0:
            used |= 1 << j
    return int(cost[best]), best & used


def test_n20_regions():
    # 2^20 enumeration (infeasible for the HBM-bound jnp kernel) vs a
    # numpy brute-force oracle, including 17..20-vertex instances
    rng = np.random.default_rng(23)
    insts = []
    for _ in range(9):
        n = int(rng.integers(15, 21))
        wts = rng.integers(1, 100, size=n).tolist()
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        sel = rng.choice(len(pairs), size=min(2 * n, len(pairs)),
                         replace=False)
        insts.append((wts, [pairs[i] for i in sel]))
    adj = np.zeros((len(insts), 20), np.int32)
    w = np.zeros((len(insts), 20), np.int32)
    for k, (wts, edges) in enumerate(insts):
        w[k, :len(wts)] = wts
        for i, j in edges:
            adj[k, i] |= 1 << j
            adj[k, j] |= 1 << i
    for solve in _solvers():
        c1, s1 = solve(adj, w)
        for k, (wts, edges) in enumerate(insts):
            c0, s0 = _brute_force(wts, edges, 20)
            assert int(c1[k]) == c0, (k, int(c1[k]), c0)
            assert int(s1[k]) == s0, (k, int(s1[k]), s0)


def test_forced_vertices_n20():
    # self-loop bits (boundary-forced vertices) in the 17..20 range
    adj = np.zeros((8, 20), np.int32)
    w = np.zeros((8, 20), np.int32)
    rng = np.random.default_rng(29)
    for k in range(8):
        n = 20
        w[k, :n] = rng.integers(1, 50, size=n)
        for _ in range(15):
            i, j = rng.integers(0, n, size=2)
            if i != j:
                adj[k, i] |= 1 << j
                adj[k, j] |= 1 << i
        f = int(rng.integers(14, 20))
        adj[k, f] |= 1 << f           # forced into the cover
    c1, s1 = mitm_small_mwvc(adj, w)
    for k in range(8):
        edges = [(i, j) for i in range(20) for j in range(i, 20)
                 if (adj[k, i] >> j) & 1]
        wts = w[k].tolist()
        c0, s0 = _brute_force(wts, edges, 20)
        assert int(c1[k]) == c0 and int(s1[k]) == s0


def test_cross_half_edges():
    # edges that span the low-7/high-9 split exercise the crossmask path
    rng = np.random.default_rng(17)
    inst = []
    for _ in range(24):
        wts = rng.integers(1, 50, size=16).tolist()
        edges = [(int(rng.integers(0, 7)), int(rng.integers(7, 16)))
                 for _ in range(12)]
        edges = sorted(set(edges))
        inst.append((wts, edges))
    _check(inst)


def _n20_batch(rng, b, wmax):
    adj = np.zeros((b, 20), np.int32)
    w = np.zeros((b, 20), np.int32)
    insts = []
    for k in range(b):
        n = int(rng.integers(17, 21))
        wts = rng.integers(1, wmax + 1, size=n).tolist()
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        sel = rng.choice(len(pairs), size=2 * n, replace=False)
        edges = [pairs[i] for i in sel]
        w[k, :n] = wts
        for i, j in edges:
            adj[k, i] |= 1 << j
            adj[k, j] |= 1 << i
        insts.append((wts, edges))
    return adj, w, insts


@pytest.mark.parametrize("b", [3, 5])
def test_n20_tie_heavy_odd_batches(b):
    # unit weights at n=20: many optimal covers, the smallest bitmask wins
    rng = np.random.default_rng(40 + b)
    adj, w, insts = _n20_batch(rng, b, wmax=1)
    for solve in _solvers():
        c1, s1 = solve(adj, w)
        for k, (wts, edges) in enumerate(insts):
            assert (int(c1[k]), int(s1[k])) == _brute_force(wts, edges, 20)


@pytest.mark.parametrize("n", [16, 20])
def test_padding_vertices_never_in_cover(n):
    # instances narrower than the width: padding bits stay out of the set
    rng = np.random.default_rng(n)
    adj = np.zeros((6, n), np.int32)
    w = np.zeros((6, n), np.int32)
    for k in range(6):
        m = 3 + k
        w[k, :m] = rng.integers(1, 9, size=m)
        for i in range(m - 1):
            adj[k, i] |= 1 << (i + 1)
            adj[k, i + 1] |= 1 << i
    _c, s = mitm_small_mwvc(adj, w)
    for k in range(6):
        assert int(s[k]) >> (3 + k) == 0


def test_block_larger_than_patterns_is_clamped():
    # block > 2^(n-7) walks the high patterns in one step
    rng = np.random.default_rng(3)
    adj, w = pack_instances(_random_instances(rng, 9))
    c0, s0 = batched_small_mwvc(adj, w)
    c1, s1 = mitm_small_mwvc(adj, w, block=4096)
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
