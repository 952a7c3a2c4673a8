"""ctypes bindings for the native MWVC host core.

The shared library is built on demand (g++ is a baked-in dependency); the
source of truth is gnn_mwvc/core/src/*.hpp + capi.cpp.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src")
_LIB = os.path.join(_HERE, "libmwvc_core.so")
_LOCK = threading.Lock()
_lib = None

u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _build() -> str:
    override = os.environ.get("MWVC_CORE_LIB")
    if override:  # e.g. a sanitizer build (core/sanitize.sh)
        return override
    srcs = [os.path.join(_SRC, "capi.cpp")]
    hdrs = [
        os.path.join(_SRC, h)
        for h in ("revgraph.hpp", "solver.hpp", "localsearch.hpp",
                  "heuristics.hpp", "baselines.hpp", "cpuforward.hpp")
    ]
    if os.path.exists(_LIB):
        lib_mtime = os.path.getmtime(_LIB)
        if all(os.path.getmtime(p) <= lib_mtime for p in srcs + hdrs):
            return _LIB
    # build to a temp file and rename: processes that already mmap the old
    # .so keep their inode; overwriting in place would corrupt them
    tmp = _LIB + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-std=c++17", "-O3", "-march=native", "-DNDEBUG", "-fPIC",
        "-shared", "-o", tmp,
    ] + srcs
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, _LIB)
    return _LIB


def lib_path() -> str:
    return _build()


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ct.CDLL(_build())
            c = ct.c_void_p
            sigs = {
                "mwvc_create": ([ct.c_uint32, u32p, ct.c_uint64, u32p, u32p,
                                 ct.c_uint32], c),
                "mwvc_destroy": ([c], None),
                "mwvc_reduce": ([c, ct.c_int], None),
                "mwvc_n_nodes": ([c], ct.c_uint32),
                "mwvc_n_org": ([c], ct.c_uint32),
                "mwvc_active_count": ([c], ct.c_uint32),
                "mwvc_cost": ([c], ct.c_uint64),
                "mwvc_timestamp": ([c], ct.c_uint64),
                "mwvc_label_count": ([c], ct.c_uint64),
                "mwvc_reset_label_count": ([c], None),
                "mwvc_counters": ([c, u64p], None),
                "mwvc_is_active": ([c, ct.c_uint32], ct.c_int),
                "mwvc_decided": ([c, ct.c_uint32], ct.c_int),
                "mwvc_select_node": ([c, ct.c_uint32], None),
                "mwvc_select_neighborhood": ([c, ct.c_uint32], None),
                "mwvc_snapshot_edges": ([c], ct.c_uint64),
                "mwvc_snapshot": ([c, u32p, u32p, u64p, u32p, u64p, u32p],
                                  ct.c_uint32),
                "mwvc_solve_small_components": ([c, ct.c_uint32], ct.c_uint32),
                "mwvc_bulk_r1": ([c, u32p, ct.c_uint32], ct.c_uint32),
                "mwvc_bfs_order": ([ct.c_uint32, u64p, u32p, u32p], None),
                "mwvc_cluster_order": ([ct.c_uint32, u64p, u32p, ct.c_uint32,
                                        u32p], None),
                "mwvc_pair_order": ([ct.c_uint32, u64p, u32p, ct.c_uint32,
                                     u64p], None),
                "mwvc_relabel_csr": ([ct.c_uint32, u64p, u32p, u32p, u64p,
                                      u32p], None),
                "mwvc_blocked_pack": ([ct.c_uint32, u64p, u32p, u64p,
                                       ct.c_uint32, u64p, ct.c_int]
                                      + [u32p] * 12, None),
                "mwvc_bulk_twins": ([c, u32p, ct.c_uint32], ct.c_uint32),
                "mwvc_bulk_begin": ([c], None),
                "mwvc_bulk_r5": ([c, u32p, ct.c_uint32], ct.c_uint32),
                "mwvc_node_arrays": ([c, u8p, u64p, u64p, u32p], None),
                "mwvc_confidence_order": ([ct.c_uint32, f32p, u64p, u32p,
                                           ct.c_double, u32p], None),
                "mwvc_peel": ([c, u32p, f32p, ct.c_uint64, ct.c_int,
                               ct.c_uint32], ct.c_uint64),
                "mwvc_labels_from_model": ([c], ct.c_uint64),
                "mwvc_mistakes_from_model": ([c], ct.c_uint64),
                "mwvc_improve_cover": ([ct.c_uint32, u32p, ct.c_uint64, u32p,
                                        u32p, u8p], ct.c_uint64),
                "mwvc_approx_construct": ([ct.c_uint32, u32p, ct.c_uint64,
                                           u32p, u32p, u8p], ct.c_uint64),
                "mwvc_greedy_construct": ([ct.c_uint32, u32p, ct.c_uint64,
                                           u32p, u32p, u8p], ct.c_uint64),
                "mwvc_baseline_solve": ([ct.c_int, ct.c_uint32, u32p,
                                         ct.c_uint64, u32p, u32p, ct.c_uint32,
                                         ct.c_double, ct.c_int, u8p,
                                         ct.POINTER(ct.c_double)],
                                        ct.c_uint64),
                "mwvc_hils_solve": ([ct.c_uint32, u32p, ct.c_uint64, u32p,
                                     u32p, ct.c_uint32, ct.c_double,
                                     ct.c_uint64, ct.c_int, ct.c_int,
                                     ct.c_int, ct.c_int, ct.c_uint64, u8p,
                                     ct.POINTER(ct.c_double)],
                                    ct.c_uint64),
                "mwvc_unfold": ([c, ct.c_uint64], None),
                "mwvc_get_solution": ([c, i8p], None),
                "mwvc_preview_solution": ([c, i8p], None),
                "mwvc_apply_cover": ([c, u32p, u8p, ct.c_uint32], None),
                "mwvc_ls_create": ([ct.c_uint32, u32p, ct.c_uint32, u32p, u32p,
                                    u8p], c),
                "mwvc_ls_destroy": ([c], None),
                "mwvc_ls_search": ([c, ct.c_uint32, ct.c_double], ct.c_int),
                "mwvc_ls_cost": ([c], ct.c_uint64),
                "mwvc_ls_best_cost": ([c], ct.c_uint64),
                "mwvc_ls_best_seen": ([c], ct.c_uint64),
                "mwvc_ls_steps": ([c], ct.c_uint64),
                "mwvc_ls_forget": ([c, ct.c_double], None),
                "mwvc_ls_restore_best": ([c], None),
                "mwvc_ls_perturb": ([c, ct.c_uint32, ct.c_uint64], None),
                "mwvc_ls_get_best": ([c, u8p], None),
                "mwvc_ls_get_current": ([c, u8p], None),
                "mwvc_ls_perturb_guided": ([c, ct.c_uint32, ct.c_uint64,
                                            f32p, ct.c_uint32], None),
                "mwvc_ls_extract_regions": ([c, u32p, ct.c_uint32,
                                             ct.c_uint32, ct.c_uint32, u32p,
                                             i32p, i32p, u8p], ct.c_uint32),
                "mwvc_ls_apply_region": ([c, ct.c_uint32, u32p,
                                          ct.c_uint32], ct.c_int),
                "mwvc_ls_commit_patches": ([c], ct.c_int),
                "mwvc_ls_get_dscores": ([c, u32p], None),
                "mwvc_ls_rebuild_scores": ([c], None),
                "mwvc_cpu_forward": ([ct.c_uint32, u64p, u32p, u32p, u64p,
                                      u32p, ct.c_float, ct.c_uint32, i8p,
                                      i32p, f32p, f32p, ct.c_uint32], None),
                "mwvc_sticky_deltas": ([c, ct.c_uint32, u32p, u64p, u64p,
                                        u32p, u8p, i32p, f32p, f32p, f32p,
                                        u8p, ct.c_uint32], ct.c_uint32),
                "mwvc_live_edges": ([c], ct.c_uint64),
                "mwvc_node_range": ([c, ct.c_uint32, ct.c_uint32, u8p,
                                     u64p, u32p], None),
            }
            for name, (argtypes, restype) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


class Snapshot:
    """Compacted active-subgraph CSR (host arrays, ready for DeviceGraph)."""

    __slots__ = ("ids", "weights", "nw", "deg", "indptr", "indices")

    def __init__(self, ids, weights, nw, deg, indptr, indices):
        self.ids = ids
        self.weights = weights
        self.nw = nw
        self.deg = deg
        self.indptr = indptr
        self.indices = indices

    @property
    def n(self):
        return len(self.ids)


class CoreSolver:
    """The kernelization engine over one graph instance."""

    def __init__(self, weights, edges, num_rules=7):
        lib = _load()
        self._lib = lib
        weights = np.ascontiguousarray(weights, dtype=np.uint32)
        edges = np.asarray(edges, dtype=np.uint32).reshape(-1, 2)
        eu = np.ascontiguousarray(edges[:, 0])
        ev = np.ascontiguousarray(edges[:, 1])
        self._h = lib.mwvc_create(len(weights), weights, len(edges), eu, ev,
                                  num_rules)
        self.n_org = int(lib.mwvc_n_org(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mwvc_destroy(self._h)
            self._h = None

    # -- state ----------------------------------------------------------
    @property
    def n_nodes(self):
        """Current node-id space size (grows as folds append gadget nodes)."""
        return int(self._lib.mwvc_n_nodes(self._h))

    @property
    def active_count(self):
        return int(self._lib.mwvc_active_count(self._h))

    @property
    def cost(self):
        return int(self._lib.mwvc_cost(self._h))

    @property
    def timestamp(self):
        return int(self._lib.mwvc_timestamp(self._h))

    @property
    def label_count(self):
        return int(self._lib.mwvc_label_count(self._h))

    def reset_label_count(self):
        self._lib.mwvc_reset_label_count(self._h)

    @property
    def counters(self):
        out = np.zeros(8, dtype=np.uint64)
        self._lib.mwvc_counters(self._h, out)
        return out

    def is_active(self, u):
        return bool(self._lib.mwvc_is_active(self._h, u))

    def decided(self, u):
        return int(self._lib.mwvc_decided(self._h, u))

    # -- ops -------------------------------------------------------------
    def reduce(self, critical=None):
        if critical is None:
            critical = self.active_count < 1000
        self._lib.mwvc_reduce(self._h, int(critical))

    def select_node(self, u):
        self._lib.mwvc_select_node(self._h, u)

    def select_neighborhood(self, u):
        self._lib.mwvc_select_neighborhood(self._h, u)

    def snapshot(self) -> Snapshot:
        n_act = self.active_count
        e = int(self._lib.mwvc_snapshot_edges(self._h))
        ids = np.empty(n_act, dtype=np.uint32)
        wts = np.empty(n_act, dtype=np.uint32)
        nw = np.empty(n_act, dtype=np.uint64)
        deg = np.empty(n_act, dtype=np.uint32)
        indptr = np.empty(n_act + 1, dtype=np.uint64)
        indices = np.empty(e, dtype=np.uint32)
        k = self._lib.mwvc_snapshot(self._h, ids, wts, nw, deg, indptr, indices)
        assert k == n_act
        if n_act == 0:
            indptr[0] = 0
        return Snapshot(ids, wts, nw, deg, indptr, indices)

    def bulk_r1(self, ids):
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        return int(self._lib.mwvc_bulk_r1(self._h, ids, len(ids)))

    def bulk_twins(self, pairs):
        pairs = np.ascontiguousarray(pairs, dtype=np.uint32).reshape(-1)
        return int(self._lib.mwvc_bulk_twins(self._h, pairs, len(pairs) // 2))

    def begin_bulk_pass(self):
        """Start a device bulk-apply pass: from here until the pass ends the
        core tracks which nodes' 1-hop instances drift from the snapshot the
        device masks were computed on (see bulk_r5)."""
        self._lib.mwvc_bulk_begin(self._h)

    def bulk_r5(self, ids):
        """Apply device-proved rule-5 verdicts; clean candidates only (the
        core skips any candidate whose instance was touched since
        begin_bulk_pass)."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        return int(self._lib.mwvc_bulk_r5(self._h, ids, len(ids)))

    def sticky_deltas(self, ids, prev_w, prev_nw, prev_deg, prev_act,
                      out_idx, out_vw, out_vnw, out_vdeg, out_vm):
        """One-pass live-state delta refresh for sticky scoring (capi.cpp
        mwvc_sticky_deltas): updates the raw prev arrays IN PLACE and
        emits up to len(out_idx) changed rows as f32 device deltas.
        Returns the total changed count (> len(out_idx) means the caller
        should full-upload from the updated prev arrays)."""
        return int(self._lib.mwvc_sticky_deltas(
            self._h, len(ids), ids, prev_w, prev_nw, prev_deg, prev_act,
            out_idx, out_vw, out_vnw, out_vdeg, out_vm, len(out_idx)))

    def live_edges(self) -> int:
        """Directed live-edge count (sum of active degrees); O(n), no
        array copies — the scorers' size-routing input."""
        return int(self._lib.mwvc_live_edges(self._h))

    def node_range(self, lo: int, hi: int):
        """Live (active, w, deg) over ids [lo, hi) — the fold-gadget tail
        created after a sticky build; O(hi - lo)."""
        k = max(hi - lo, 0)
        act = np.empty(k, np.uint8)
        w = np.empty(k, np.uint64)
        deg = np.empty(k, np.uint32)
        if k:
            self._lib.mwvc_node_range(self._h, lo, hi, act, w, deg)
        return act, w, deg

    def node_arrays(self):
        """Live (active, w, nw, deg) over the full node-id space [0, size).

        O(n) flat copy — no CSR walk, no compaction; the cheap per-round
        refresh for sticky scoring (node ids are stable in this core)."""
        n = self.n_nodes
        active = np.empty(n, np.uint8)
        w = np.empty(n, np.uint64)  # u64: twin folds sum weights past 2^32
        nw = np.empty(n, np.uint64)
        deg = np.empty(n, np.uint32)
        self._lib.mwvc_node_arrays(self._h, active, w, nw, deg)
        return active, w, nw, deg

    def solve_small_components(self, limit=75):
        return int(self._lib.mwvc_solve_small_components(self._h, limit))

    def peel(self, order, prob, relable_interval=-1, use_gnn=True,
             use_reductions=True):
        order = np.ascontiguousarray(order, dtype=np.uint32)
        prob = np.ascontiguousarray(prob, dtype=np.float32)
        flags = (1 if use_gnn else 0) | (2 if use_reductions else 0)
        return int(
            self._lib.mwvc_peel(self._h, order, prob, len(order),
                                relable_interval, flags)
        )

    @property
    def labels_from_model(self):
        return int(self._lib.mwvc_labels_from_model(self._h))

    @property
    def mistakes_from_model(self):
        return int(self._lib.mwvc_mistakes_from_model(self._h))

    def unfold(self, t=0):
        self._lib.mwvc_unfold(self._h, t)

    def solution(self):
        out = np.empty(self.n_org, dtype=np.int8)
        self._lib.mwvc_get_solution(self._h, out)
        return out

    def preview_solution(self):
        """Full original-vertex solution as if unfolded now (state kept)."""
        out = np.empty(self.n_org, dtype=np.int8)
        self._lib.mwvc_preview_solution(self._h, out)
        return out

    def apply_cover(self, ids, vals):
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        vals = np.ascontiguousarray(vals, dtype=np.uint8)
        self._lib.mwvc_apply_cover(self._h, ids, vals, len(ids))


class CoreLocalSearch:
    """FastWVC-style anytime local search over a flat graph."""

    def __init__(self, weights, edges, initial):
        lib = _load()
        self._lib = lib
        weights = np.ascontiguousarray(weights, dtype=np.uint32)
        edges = np.asarray(edges, dtype=np.uint32).reshape(-1, 2)
        eu = np.ascontiguousarray(edges[:, 0])
        ev = np.ascontiguousarray(edges[:, 1])
        s0 = np.ascontiguousarray(initial, dtype=np.uint8)
        self.n = len(weights)
        self._h = lib.mwvc_ls_create(self.n, weights, len(edges), eu, ev, s0)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mwvc_ls_destroy(self._h)
            self._h = None

    def search(self, iterations, time_budget):
        return bool(self._lib.mwvc_ls_search(self._h, iterations, time_budget))

    def forget(self, scale=0.3):
        """Decay learned edge weights and rebuild dscores/heap — FastWVC's
        ForgetEdgeWeights as an opt-in diversification for the phase-2
        search (the reference phase-2 LS has none)."""
        self._lib.mwvc_ls_forget(self._h, float(scale))

    def restore_best(self):
        """Intensification: jump back to the snapshotted best cover,
        keeping the learned edge weights and ages (ILS pattern; the
        reference phase-2 search has no diversification)."""
        self._lib.mwvc_ls_restore_best(self._h)

    def perturb(self, k, seed):
        """Diversification: remove k random cover vertices + greedy repair
        (HILS force(k) analog, Solution.cpp:383-400); deterministic per
        seed."""
        self._lib.mwvc_ls_perturb(self._h, int(k), int(seed))

    def perturb_guided(self, k, seed, bias):
        """GNN-guided kick: removal targets sampled with acceptance
        probability bias[u] (the device-computed "u should not be in the
        cover" signal); deterministic per seed."""
        bias = np.ascontiguousarray(bias, dtype=np.float32)
        self._lib.mwvc_ls_perturb_guided(self._h, int(k), int(seed), bias,
                                         len(bias))

    def current(self):
        out = np.empty(self.n, dtype=np.uint8)
        self._lib.mwvc_ls_get_current(self._h, out)
        return out

    def extract_regions(self, centers, rmax=14):
        """Disjoint boundary-conditioned exact sub-instances (<= rmax <= 20
        vertices) around the given centers, packed for the device small
        solvers (ops/smallsolve.py: the enumeration at width 16, the
        meet-in-the-middle walk at 16 or 20).  Returns (ids (B,W) u32, adj (B,W) i32 bitmasks,
        w (B,W) i32, k (B,) u8) with W = 16 when rmax <= 16 else 20; rows
        with k == 0 are empty (claimed center)."""
        centers = np.ascontiguousarray(centers, dtype=np.uint32)
        b = len(centers)
        width = 16 if rmax <= 16 else 20
        ids = np.zeros((b, width), np.uint32)
        adj = np.zeros((b, width), np.int32)
        w = np.zeros((b, width), np.int32)
        k = np.zeros(b, np.uint8)
        self._lib.mwvc_ls_extract_regions(
            self._h, centers, b, int(rmax), width, ids.reshape(-1),
            adj.reshape(-1), w.reshape(-1), k)
        return ids, adj, w, k

    def apply_region(self, k, ids, new_mask):
        """Validate + apply a device-proved region assignment; returns True
        if applied.  Leaves dscores stale — call commit_patches() after a
        patch batch."""
        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        return bool(self._lib.mwvc_ls_apply_region(
            self._h, int(k), ids, int(new_mask)))

    def commit_patches(self):
        """Snapshot best after a patch batch (dscores/heap are kept live
        incrementally by apply_region); True if best improved."""
        return bool(self._lib.mwvc_ls_commit_patches(self._h))

    def dscores(self):
        out = np.empty(self.n, dtype=np.uint32)
        self._lib.mwvc_ls_get_dscores(self._h, out)
        return out

    def rebuild_scores(self):
        """From-scratch dscore/CC/heap rebuild (test hook; patching keeps
        them live incrementally)."""
        self._lib.mwvc_ls_rebuild_scores(self._h)

    @property
    def cost(self):
        return int(self._lib.mwvc_ls_cost(self._h))

    @property
    def best_cost(self):
        return int(self._lib.mwvc_ls_best_cost(self._h))

    @property
    def best_seen(self):
        return int(self._lib.mwvc_ls_best_seen(self._h))

    @property
    def steps(self):
        return int(self._lib.mwvc_ls_steps(self._h))

    def best(self):
        out = np.empty(self.n, dtype=np.uint8)
        self._lib.mwvc_ls_get_best(self._h, out)
        return out


def _flat_edges(weights, edges):
    weights = np.ascontiguousarray(weights, dtype=np.uint32)
    edges = np.asarray(edges, dtype=np.uint32).reshape(-1, 2)
    return (weights, np.ascontiguousarray(edges[:, 0]),
            np.ascontiguousarray(edges[:, 1]))


def improve_cover(weights, edges, vc):
    """In-place neighborhood-improvement pass; returns the improved cost."""
    lib = _load()
    w, eu, ev = _flat_edges(weights, edges)
    vc = np.ascontiguousarray(vc, dtype=np.uint8)
    cost = lib.mwvc_improve_cover(len(w), w, len(eu), eu, ev, vc)
    return int(cost), vc


def approx_cover(weights, edges):
    """Primal-dual 2-approximation construction; returns (cost, cover)."""
    lib = _load()
    w, eu, ev = _flat_edges(weights, edges)
    vc = np.zeros(len(w), dtype=np.uint8)
    cost = lib.mwvc_approx_construct(len(w), w, len(eu), eu, ev, vc)
    return int(cost), vc


def greedy_cover(weights, edges):
    """Degree/weight greedy construction; returns (cost, cover)."""
    lib = _load()
    w, eu, ev = _flat_edges(weights, edges)
    vc = np.zeros(len(w), dtype=np.uint8)
    cost = lib.mwvc_greedy_construct(len(w), w, len(eu), eu, ev, vc)
    return int(cost), vc


BASELINE_IDS = {"fastwvc": 0, "dynwvc2": 1, "numwvc": 2, "hils": 3}


def baseline_solve(which, weights, edges, seed=1, cutoff=10.0, cc_mode=3,
                   iterations=None, p=None, target=None):
    """Run a comparison baseline solver; returns (cost, cover, time_to_best).

    which: "fastwvc" | "dynwvc2" | "numwvc" | "hils" (hils solves MWIS and
    returns the complement cover; cost = total weight - IS weight).

    hils only (the reference ArgPack flag surface, HILS/ArgPack.h:25-62):
    iterations (-i, default 2,000,000 = ArgPack.cpp:29), p = 4
    intensification params (-p, default (2,4,4,1)), target = stop once the
    IS weight reaches it (-target).
    """
    import ctypes as _ct

    lib = _load()
    w, eu, ev = _flat_edges(weights, edges)
    vc = np.zeros(len(w), dtype=np.uint8)
    tbest = _ct.c_double(0.0)
    if which == "hils" and (iterations is not None or p is not None
                            or target is not None):
        p = tuple(p) if p is not None else (2, 4, 4, 1)
        cost = lib.mwvc_hils_solve(
            len(w), w, len(eu), eu, ev, seed, cutoff,
            int(iterations if iterations is not None else 2_000_000),
            int(p[0]), int(p[1]), int(p[2]), int(p[3]),
            int(target or 0), vc, _ct.byref(tbest),
        )
        return int(cost), vc, float(tbest.value)
    cost = lib.mwvc_baseline_solve(
        BASELINE_IDS[which], len(w), w, len(eu), eu, ev, seed, cutoff,
        cc_mode, vc, _ct.byref(tbest),
    )
    return int(cost), vc, float(tbest.value)


_KIND_CODES = {"graph": 0, "linear": 1, "relu": 2, "sigmoid": 3}
_packed_params_cache = {}


def _pack_model(model):
    """(kinds i8, dims i32, params f32) blobs for mwvc_cpu_forward; cached
    per model object (params are fixed during solving)."""
    key = id(model)
    hit = _packed_params_cache.get(key)
    if hit is not None:
        return hit
    kinds = np.array([_KIND_CODES[k] for k in model.kinds], np.int8)
    dims, blobs = [], []
    for k, p in zip(model.kinds, model.params):
        if k == "linear":
            wm = np.ascontiguousarray(np.asarray(p["w"], np.float32))
            bm = np.ascontiguousarray(np.asarray(p["b"], np.float32))
            dims.extend(wm.shape)
            blobs.extend([wm.ravel(), bm.ravel()])
    packed = (kinds, np.array(dims, np.int32),
              np.concatenate(blobs).astype(np.float32))
    _packed_params_cache[key] = packed
    return packed


def cpu_forward_native(snap, model, weight_scale, n_threads=2):
    """Native threaded CPU forward over a kernel snapshot (capi.cpp
    mwvc_cpu_forward / cpuforward.hpp): models/gnn.py semantics with
    compat=True + x_is_node_weights=True, zero per-round build cost —
    used for every snapshot below the device size threshold (peel rounds
    and the phase-2 kernel re-score alike)."""
    lib = _load()
    n = int(snap.n)
    out = np.empty(max(n, 1), np.float32)
    if n == 0:
        return out[:0]
    kinds, dims, params = _pack_model(model)
    lib.mwvc_cpu_forward(
        n, np.ascontiguousarray(snap.indptr, np.uint64),
        np.ascontiguousarray(snap.indices, np.uint32),
        np.ascontiguousarray(snap.weights, np.uint32),
        np.ascontiguousarray(snap.nw, np.uint64),
        np.ascontiguousarray(snap.deg, np.uint32),
        float(weight_scale), len(kinds), kinds, dims, params, out,
        int(n_threads))
    return out[:n]


def confidence_order_native(prob, weights, deg, eps):
    """Native confidence sort (see capi.cpp mwvc_confidence_order)."""
    lib = _load()
    prob = np.ascontiguousarray(prob, dtype=np.float32)
    weights = np.ascontiguousarray(weights, dtype=np.uint64)
    deg = np.ascontiguousarray(deg, dtype=np.uint32)
    out = np.empty(len(prob), dtype=np.uint32)
    lib.mwvc_confidence_order(len(prob), prob, weights, deg, float(eps), out)
    return out


def bfs_order(indptr, indices):
    """Pseudo-Cuthill-McKee vertex order; returns perm (old ids, new order)."""
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    perm = np.empty(n, dtype=np.uint32)
    lib.mwvc_bfs_order(n, indptr, indices, perm)
    return perm


def cluster_order(indptr, indices, cluster_size=128):
    """Window-locality vertex order: chained BFS balls of cluster_size."""
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    perm = np.empty(n, dtype=np.uint32)
    lib.mwvc_cluster_order(n, indptr, indices, cluster_size, perm)
    return perm


def pair_order(indptr, indices, win=128):
    """Edge positions stable-sorted by (dst window, src window)."""
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    order = np.empty(int(indptr[-1]), dtype=np.uint64)
    lib.mwvc_pair_order(n, indptr, indices, win, order)
    return order.astype(np.int64)


def blocked_pack(indptr, indices, order, win, fill_arrays=None):
    """One-pass chunk packing for the windowed plan.

    Without fill_arrays: returns chunk counts (3,).  With fill_arrays
    (list of 12 preallocated arrays sw0,dw0,ls0,ld0,...), fills them.
    """
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    order = np.ascontiguousarray(order, dtype=np.uint64)
    counts = np.zeros(3, dtype=np.uint64)
    dummy = np.zeros(1, dtype=np.uint32)
    arrs = fill_arrays if fill_arrays is not None else [dummy] * 12
    flat = [np.ascontiguousarray(a.reshape(-1), dtype=np.uint32)
            if a.ndim > 1 else a for a in arrs]
    lib.mwvc_blocked_pack(n, indptr, indices, order, win, counts,
                          1 if fill_arrays is not None else 0, *flat)
    if fill_arrays is not None:
        for a, f in zip(arrs, flat):
            if a.ndim > 1:
                a[...] = f.reshape(a.shape)
    return counts.astype(np.int64)


def relabel_csr(indptr, indices, perm):
    """CSR under a vertex permutation; returns (indptr2, indices2)."""
    lib = _load()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.uint64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    perm = np.ascontiguousarray(perm, dtype=np.uint32)
    out_indptr = np.empty(n + 1, dtype=np.uint64)
    out_indices = np.empty(len(indices), dtype=np.uint32)
    lib.mwvc_relabel_csr(n, indptr, indices, perm, out_indptr, out_indices)
    return out_indptr.astype(np.int64), out_indices.astype(np.int64)
