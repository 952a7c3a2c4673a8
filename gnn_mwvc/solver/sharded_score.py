"""Multi-chip phase-1 scoring integrated into the solve pipeline.

`ShardedGnnScorer` implements the sticky `score_core` protocol
(solver/pipeline.gnn_peel), so

    solve(g, scorer=ShardedGnnScorer(mesh=make_mesh(P)))

runs every phase-1 scoring round through the edge-partitioned,
halo-exchange forward of `parallel/sharded.py` on an N-device
`jax.sharding.Mesh` (one packed `all_to_all` per graph layer; per-device
bytes proportional to the partition boundary).

The mesh path keeps the single-chip StickyGnnScorer's economics:

* the partition is built ONCE from the post-reduction kernel; gadget-drift
  rebuilds are SHAPE-TEMPLATED into the first build's exact array shapes
  (`partition_device_graph(shape_template=...)`), so the jit program
  traced for the first build serves every rebuild.  If a rebuild outgrows
  the template on an accelerator mesh the scorer exits to the legacy
  per-snapshot path for the rest of phase 1 instead of recompiling.
* per-round updates ship only the changed-slot deltas into DONATED device
  buffers via the fused `make_sticky_sharded_forward` (scatter runs
  inside shard_map with per-shard local indices) — the single-chip sticky
  scorer's ~n/16 delta economics, not a full (4, P*n_loc) re-upload.
* the default aggregation is the per-shard sorted segment-sum: on GPU
  meshes the windowed one-hot plan measured far slower (PERF.md), and on
  CPU meshes segment-sum is the plain choice.

Scoring runs the masked forward (removed nodes' features are zeroed
before every aggregation — exact because node removals only delete edges
incident to the removed node).  Structure-changing folds create gadget
nodes outside the built partition: they are scored neutrally (0.5) and a
rebuild triggers past a drift bound, exactly the single-chip policy.

Reference analog: the reference re-runs its CPU GNN on the live reduced
graph each relabel round (reference: src/GNN_VC.cpp:188-192) without
recompiling anything; this is that loop distributed over a device mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from gnn_mwvc.models import Model, load_pretrained

__all__ = ["ShardedGnnScorer"]


@dataclasses.dataclass
class _SlotGraph:
    """DeviceGraph-shaped view of a snapshot relabeled into PRESERVED
    partition slots (see ShardedGnnScorer._assign_slots): exactly the
    fields partition_device_graph reads."""

    n: int
    n_pad: int
    e: int
    row: np.ndarray
    col: np.ndarray
    weights: np.ndarray
    degrees: np.ndarray
    nw: np.ndarray
    node_mask: np.ndarray


class ShardedGnnScorer:
    """score_core-protocol scorer over an N-device mesh.

    Parameters
    ----------
    mesh: a `jax.sharding.Mesh` with a "graph" axis (parallel.make_mesh);
        defaults to all visible devices on the graph axis.
    aggregation: "scatter" (sorted segment-sum per shard, the default)
        or "blocked" (per-shard windowed one-hot plans, ops/blocked.py).
    min_nodes: below this active count the scorer exits to the legacy
        per-snapshot path (mirrors StickyGnnScorer.device_min_edges; tiny
        kernels are not worth a collective round-trip).  "auto" = 250,000
        on accelerator meshes, 0 on CPU meshes (tests / parity experiments
        want the mesh path exercised at any size).
    """

    def __init__(self, model: Optional[Model] = None, mesh=None,
                 aggregation: str = "scatter",
                 rebuild_gadget_frac: float = 0.02,
                 min_nodes="auto",
                 compat: bool = True):
        from gnn_mwvc.parallel.mesh import make_mesh
        from gnn_mwvc.parallel.sharded import make_sticky_sharded_forward

        self.model = model or load_pretrained()
        self.mesh = mesh if mesh is not None else make_mesh()
        self.parts = int(self.mesh.shape["graph"])
        self._accel = any(
            d.platform != "cpu" for d in np.asarray(self.mesh.devices).flat)
        if aggregation not in ("scatter", "blocked"):
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.aggregation = aggregation
        self.rebuild_gadget_frac = rebuild_gadget_frac
        self.min_nodes = (250_000 if self._accel else 0) \
            if min_nodes == "auto" else int(min_nodes)
        self._fn = make_sticky_sharded_forward(
            self.model.kinds, self.mesh, compat=compat)
        self._state = None  # (sg, ids, built_size, built_active, n_slots)
        self._slots = None  # (k,) snapshot row -> partition slot
        self._tmpl = None   # first-built ShardedGraph: the shape template
        self._dead = False  # template overflow on accel mesh: legacy-only
        self._bufs = None   # donated (P, n_loc) device buffers
        self._prev = None   # host copies for delta detection
        self._k_loc = 0
        self._legacy = None
        self.stats = {"rebuilds": 0, "rounds": 0, "seconds_prep": 0.0,
                      "legacy_rounds": 0, "parts": self.parts,
                      "aggregation": aggregation}

    # -- partition lifecycle ---------------------------------------------
    def _assign_slots(self, snap):
        """Slot-preserving rebuild assignment (the mesh analog of the
        dancing-links core's STABLE ids): every node surviving from the
        previous build keeps its partition slot — so the surviving
        structure's per-pair halo sets are SUBSETS of the built ones and
        the shape template fits by construction — while fold-gadget nodes
        take slots freed by removals, placed in the shard holding the
        most neighbors (minimizes new boundary entries).  Returns the
        (k,) row->slot map, or None if gadgets outnumber free slots."""
        sg, old_ids, _bs, _ba, n_slots = self._state
        n_loc = sg.n_loc
        hi = max(int(old_ids.max()) if len(old_ids) else -1,
                 int(snap.ids.max()) if len(snap.ids) else -1)
        id_slot = np.full(hi + 1, -1, np.int64)
        id_slot[old_ids] = self._slots
        slots = id_slot[snap.ids]
        new_rows = np.nonzero(slots < 0)[0]
        if len(new_rows):
            used = np.zeros(n_slots, bool)
            used[slots[slots >= 0]] = True
            free = np.nonzero(~used)[0]
            if len(new_rows) > len(free):
                return None
            free_shard = free // n_loc
            # per-gadget preferred shard = mode of its neighbors' shards
            take = np.zeros(len(free), bool)
            order_free = np.argsort(free_shard, kind="stable")
            free_sorted = free[order_free]
            fs_sorted = free_shard[order_free]
            starts = np.searchsorted(fs_sorted, np.arange(self.parts))
            ends = np.searchsorted(fs_sorted, np.arange(self.parts) + 1)
            cursor = starts.copy()
            spill = []
            for r in new_rows:
                nbr = snap.indices[snap.indptr[r]: snap.indptr[r + 1]]
                nsl = slots[nbr]
                nsl = nsl[nsl >= 0]
                if len(nsl):
                    p = int(np.bincount(nsl // n_loc,
                                        minlength=self.parts).argmax())
                else:
                    p = 0
                if cursor[p] < ends[p]:
                    slots[r] = free_sorted[cursor[p]]
                    take[cursor[p]] = True
                    cursor[p] += 1
                else:
                    spill.append(r)
            if spill:
                rest = free_sorted[~take]
                slots[np.asarray(spill)] = rest[: len(spill)]
        return slots

    def _rebuild(self, core):
        from gnn_mwvc.graph import DeviceGraph
        from gnn_mwvc.parallel.sharded import partition_device_graph

        t0 = time.perf_counter()
        snap = core.snapshot()
        sg = None
        slots = None
        if self._tmpl is not None and self._state is not None:
            slots = self._assign_slots(snap)
            if slots is not None:
                n_slots = self.parts * self._tmpl.n_loc
                deg = np.diff(snap.indptr).astype(np.int64)
                row_sl = slots[np.repeat(
                    np.arange(len(snap.ids), dtype=np.int64), deg)]
                col_sl = slots[snap.indices]
                # partition_device_graph requires dst-sorted COO (its
                # scatter path aggregates with indices_are_sorted=True);
                # the slot permutation is not monotone in snapshot row
                # order, so re-sort — stable, keeping each row's CSR
                # source order (bitwise-identical summation order)
                order = np.argsort(row_sl, kind="stable")
                row_sl = row_sl[order]
                col_sl = col_sl[order]
                w_s = np.zeros(n_slots, np.float32)
                w_s[slots] = snap.weights
                d_s = np.zeros(n_slots, np.float32)
                d_s[slots] = deg
                nw_s = np.zeros(n_slots, np.float32)
                nw_s[slots] = snap.nw
                m_s = np.zeros(n_slots, bool)
                m_s[slots] = True
                shim = _SlotGraph(
                    n=len(snap.ids), n_pad=n_slots, e=len(col_sl),
                    row=row_sl, col=col_sl, weights=w_s, degrees=d_s,
                    nw=nw_s, node_mask=m_s)
                sg = partition_device_graph(
                    shim, self.parts, aggregation=self.aggregation,
                    halo=True, shape_template=self._tmpl)
            if sg is not None:
                self.stats["templated_rebuilds"] = (
                    self.stats.get("templated_rebuilds", 0) + 1)
        if sg is None:
            if self._tmpl is not None and self._accel:
                # never mint a fresh mesh program mid-phase-1: exit to the
                # legacy per-snapshot path
                self._dead = True
                self._state = None
                self.stats["template_overflow"] = True
                self.stats["seconds_prep"] += time.perf_counter() - t0
                return None
            dg = DeviceGraph.build(
                snap.weights,
                snap.indptr.astype(np.int64),
                snap.indices.astype(np.int64),
                with_ell=False,
                aggregation="scatter",
            )
            # 1.3x headroom on the data-dependent paddings: fold gadgets
            # placed into freed slots add a few boundary entries per
            # rebuild on top of the (subset-only) surviving structure
            sg = partition_device_graph(
                dg, self.parts, aggregation=self.aggregation, halo=True,
                headroom=1.3)
            self._tmpl = sg
            slots = np.arange(len(snap.ids), dtype=np.int64)
        self._state = (sg, snap.ids, core.n_nodes, snap.n,
                       self.parts * sg.n_loc)
        self._slots = slots
        self._rof = np.full(self.parts * sg.n_loc, -1, np.int64)
        self._rof[slots] = np.arange(len(snap.ids), dtype=np.int64)
        # fixed delta capacity per shard (part of the program shape):
        # per-round label churn is ~N/20; n_loc/16 slots leave headroom
        self._k_loc = max(256, sg.n_loc // 16)
        self._bufs = None
        self._prev = None
        self.stats["rebuilds"] += 1
        self.stats["h_max"] = int(sg.h_max)
        self.stats["seconds_prep"] += time.perf_counter() - t0
        return self._state

    def _needs_rebuild(self, core):
        if self._state is None:
            return True
        _sg, _ids, built_size, built_active, _np = self._state
        gadgets = core.n_nodes - built_size
        return gadgets > self.rebuild_gadget_frac * max(built_active, 1)

    def _score_legacy(self, core, weight_scale):
        from gnn_mwvc.solver.pipeline import GnnScorer

        if self._legacy is None:
            # native on accelerator meshes (tail rounds feed only this
            # scorer's own peel); jax-CPU on CPU meshes, where exact cover
            # identity vs the mesh forward is part of the test contract
            # (tools/sharded_solve.py)
            self._legacy = GnnScorer(self.model, device_min_edges=1 << 62,
                                     native=self._accel)
        snap = core.snapshot()
        prob = self._legacy(snap, weight_scale)
        self.stats["legacy_rounds"] += 1
        return snap.ids, prob.astype(np.float32), snap.weights, snap.deg

    # -- per-round scoring ------------------------------------------------
    def score_core(self, core, weight_scale: float):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        t0 = time.perf_counter()
        if self._dead or core.active_count < self.min_nodes:
            if not self._dead:
                self._state = None  # kernel shrank below the mesh regime
            return self._score_legacy(core, weight_scale)

        if self._needs_rebuild(core):
            if self._rebuild(core) is None:  # template overflow
                return self._score_legacy(core, weight_scale)
            t0 = time.perf_counter()
        sg, ids, built_size, _ba, n_slots = self._state
        n_loc, parts = sg.n_loc, self.parts
        slots = self._slots
        k = len(ids)
        k_loc = self._k_loc

        # one-pass native delta refresh against our raw row copies
        # (capi mwvc_sticky_deltas; updated in place); rows map to slots
        # via the slot-stable assignment
        fresh = self._prev is None
        if fresh:
            self._prev = (np.zeros(k, np.uint64), np.zeros(k, np.uint64),
                          np.zeros(k, np.uint32), np.zeros(k, np.uint8))
        cap = parts * k_loc
        ridx = np.zeros(cap, np.int32)
        rvw = np.zeros(cap, np.float32)
        rvnw = np.zeros(cap, np.float32)
        rvdeg = np.zeros(cap, np.float32)
        rvm = np.zeros(cap, np.uint8)
        cnt = core.sticky_deltas(ids, *self._prev, ridx, rvw, rvnw, rvdeg,
                                 rvm)
        w_r, nw_r, deg_r, act8 = self._prev
        act_r = act8.view(bool)

        full_upload = fresh or self._bufs is None or cnt > cap
        ch_slots = pshard = counts = None
        if not full_upload:
            ch_slots = slots[ridx[:cnt]]
            pshard = ch_slots // n_loc
            counts = np.bincount(pshard, minlength=parts)
            if len(counts) and counts.max() > k_loc:
                full_upload = True
        if full_upload:
            # slot-space scatter of the (updated) raw rows, O(k)
            w_s = np.zeros(n_slots, np.float32)
            w_s[slots] = w_r
            nw_s = np.zeros(n_slots, np.float32)
            nw_s[slots] = nw_r
            deg_s = np.zeros(n_slots, np.float32)
            deg_s[slots] = deg_r
            act_s = np.zeros(n_slots, bool)
            act_s[slots] = act_r
            shard = NamedSharding(self.mesh, P("graph", None))
            self._bufs = tuple(
                jax.device_put(a, shard) for a in (
                    w_s.reshape(parts, n_loc),
                    nw_s.reshape(parts, n_loc),
                    deg_s.reshape(parts, n_loc),
                    act_s.reshape(parts, n_loc)))
            self.stats["full_uploads"] = (
                self.stats.get("full_uploads", 0) + 1)
            cnt = 0

        # (P, k_loc) delta arrays; padding slots repeat the CURRENT value
        # of each shard's local slot 0 (identical-duplicate writes are
        # well-defined; a real row-0 update carries the same new value)
        rr = self._rof[np.arange(parts) * n_loc]  # row at slot p*n_loc
        has = rr >= 0
        rr_safe = np.maximum(rr, 0)
        idx = np.zeros((parts, k_loc), np.int32)
        vw = np.empty((parts, k_loc), np.float32)
        vw[:] = np.where(has, w_r[rr_safe].astype(np.float32), 0.0)[:, None]
        vnw = np.empty((parts, k_loc), np.float32)
        vnw[:] = np.where(has, nw_r[rr_safe].astype(np.float32),
                          0.0)[:, None]
        vdeg = np.empty((parts, k_loc), np.float32)
        vdeg[:] = np.where(has, deg_r[rr_safe].astype(np.float32),
                           0.0)[:, None]
        vm = np.empty((parts, k_loc), bool)
        vm[:] = np.where(has, act_r[rr_safe], False)[:, None]
        if cnt:
            order = np.argsort(pshard, kind="stable")
            pc = pshard[order]
            sl = ch_slots[order]
            starts = np.zeros(parts + 1, np.int64)
            np.cumsum(counts, out=starts[1:])
            j = np.arange(cnt) - starts[pc]
            idx[pc, j] = (sl % n_loc).astype(np.int32)
            vw[pc, j] = rvw[:cnt][order]
            vnw[pc, j] = rvnw[:cnt][order]
            vdeg[pc, j] = rvdeg[:cnt][order]
            vm[pc, j] = rvm[:cnt][order].astype(bool)
        self.stats["seconds_prep"] += time.perf_counter() - t0

        prob, *bufs = self._fn(self.model.params, sg, self._bufs,
                               (idx, vw, vnw, vdeg, vm),
                               np.float32(weight_scale))
        self._bufs = tuple(bufs)
        prob = np.asarray(prob).reshape(-1)  # waits for the devices
        rows = np.nonzero(act_r)[0]
        out_ids = ids[rows]
        out_prob = prob[slots[rows]].astype(np.float32)
        out_w = w_r[rows]
        out_deg = deg_r[rows]
        # gadget nodes created by folds after the build: neutral scores
        if core.n_nodes > built_size:
            act_g, w_g, deg_g = core.node_range(built_size, core.n_nodes)
            rows_g = np.nonzero(act_g)[0]
            if len(rows_g):
                gad = (built_size + rows_g).astype(np.uint32)
                out_ids = np.concatenate([out_ids, gad])
                out_prob = np.concatenate(
                    [out_prob, np.full(len(gad), 0.5, np.float32)])
                out_w = np.concatenate([out_w, w_g[rows_g]])
                out_deg = np.concatenate([out_deg, deg_g[rows_g]])
        self.stats["rounds"] += 1
        return out_ids, out_prob, out_w, out_deg
