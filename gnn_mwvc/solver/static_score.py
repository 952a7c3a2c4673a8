"""Sticky scoring: re-score the shrinking kernel over a STATIC device graph.

The reference re-runs the GNN on the live reduced graph each relabel round
(reference: src/GNN_VC.cpp:188-192), which on device would mean a fresh
snapshot + aggregation-plan build per round: host prep that grows with the
kernel's edge count, paid every round.

Device-side alternative exploiting the core's STABLE node ids (the
dancing-links graph never relabels): build the padded DeviceGraph + aggregation
plan ONCE, then each round

  * refresh only the O(n) per-node arrays (active, W, NW, D) from the core —
    a flat memcpy, no CSR walk;
  * run the masked forward (models/gnn.py source_mask): features of removed
    nodes are zeroed before every aggregation, so their stale edge slots
    contribute exactly nothing and every active row aggregates over its live
    neighborhood;
  * the shapes never change -> zero recompiles, zero plan rebuilds.

Exactness of the masked re-score: node removals only ever DELETE edges
incident to the removed node, and those contributions are zeroed.  The two
structural exceptions are folds:

  * fold_twin merges v into u — u's own neighborhood is unchanged (they were
    twins) and v is removed, so masking stays exact; u's grown weight comes
    from the live arrays.
  * fold_neighborhood creates a gadget node with edges absent from the
    static structure.  Gadget nodes (ids >= the built size) are scored with
    a neutral 0.5 (least-confident -> decided last), and their neighbors'
    aggregations miss one contribution until the next rebuild.

Gadget drift is bounded by a rebuild trigger (gadgets > 2% of the built
size).  Rebuilds of a windowed-plan build are SHAPE-TEMPLATED into the first
build's exact array shapes so the already-compiled program serves them;
other plans rebuild at their own shapes and compile once more.  The graph
shrinking by itself never triggers a rebuild.  Once the live kernel drops
below the device threshold (``device_min_edges``) the scorer exits to the
legacy per-snapshot path, which scores with the native C++ forward.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import numpy as np

from gnn_mwvc.graph import DeviceGraph
from gnn_mwvc.models import Model, load_pretrained
from gnn_mwvc.models.gnn import forward

__all__ = ["StickyGnnScorer"]


def _make_sticky_fn(kinds, name, compat, precision="highest"):
    """One fused device call per round: scatter the per-node deltas into the
    persistent (donated) feature buffers, then run the masked forward.

    Keeping update+forward in a single jit means one dispatch and
    ~idx-sized uploads per round instead of 4 full-array device_puts.
    """
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, donate_argnums=(1, 2, 3, 4))
    def fn(params, wts, nws, degs, mask, idx, vw, vnw, vdeg, vm, dg,
           weight_scale):
        wts = wts.at[idx].set(vw)
        nws = nws.at[idx].set(vnw)
        degs = degs.at[idx].set(vdeg)
        mask = mask.at[idx].set(vm)
        dg_live = dataclasses.replace(
            dg, weights=wts, nw=nws, degrees=degs, node_mask=mask
        )
        m = mask.astype(jnp.float32)
        x = (wts / weight_scale).reshape(-1, 1) * m[:, None]
        out = forward(
            Model(kinds=kinds, params=params, name=name),
            x, dg_live, weight_scale, compat=compat, precision=precision,
            x_is_node_weights=True, source_mask=m,
        )
        return out[:, 0], wts, nws, degs, mask

    return fn


class StickyGnnScorer:
    """Drop-in scorer implementing the ``score_core`` protocol used by
    gnn_peel: score_core(core, weight_scale) -> (ids, prob, w, deg) over the
    currently active nodes (gadget nodes included with neutral prob)."""

    def __init__(self, model: Optional[Model] = None,
                 device_min_edges: int = 4_000_000,
                 rebuild_active_frac: float = 0.0,
                 rebuild_gadget_frac: float = 0.02,
                 compat: bool = True,
                 force_sticky: bool = False,
                 precision: str = "highest"):
        # rebuild_active_frac defaults to 0: scoring a non-shrinking static
        # shape costs little on device, while every rebuild mints a new
        # program shape (a compile) and a host plan build.  One program per
        # instance; the kernel exits to the legacy path below
        # device_min_edges anyway.
        from gnn_mwvc.solver.pipeline import pick_devices

        self.model = model or load_pretrained()
        self.device_min_edges = device_min_edges
        self.rebuild_active_frac = rebuild_active_frac
        self.rebuild_gadget_frac = rebuild_gadget_frac
        self._cpu_dev, self._accel_dev = pick_devices()
        self._fn = _make_sticky_fn(self.model.kinds, self.model.name, compat,
                                   precision=precision)
        self._state = None  # (dg, snap_ids, built_size, built_active, device)
        self._bufs = None   # persistent device feature buffers
        self._prev = None   # host copies for delta detection
        self.stats = {"rebuilds": 0, "rounds": 0, "seconds_prep": 0.0,
                      "legacy_rounds": 0}
        # Sticky pays only where device compute is cheap relative to host
        # prep (the accelerator path).  On the CPU backend the forward
        # itself dominates and scoring a non-shrinking static shape loses,
        # so small kernels and CPU-only environments route to the legacy
        # per-snapshot scorer.  force_sticky bypasses the routing (tests /
        # CPU-mesh experiments).
        self.force_sticky = force_sticky
        self._legacy = None

    # -- plan lifecycle --------------------------------------------------
    def _rebuild(self, core):
        import jax

        t0 = time.perf_counter()
        snap = core.snapshot()
        dg = None
        if self._state is not None and self._state[0].blocked is not None:
            # shape-templated rebuild: fit the shrunken kernel into the
            # previous build's exact shapes so the already-compiled
            # program serves it
            dg = DeviceGraph.build(
                snap.weights,
                snap.indptr.astype(np.int64),
                snap.indices.astype(np.int64),
                shape_template=self._state[0],
            )
            if dg is not None:
                self.stats["templated_rebuilds"] = (
                    self.stats.get("templated_rebuilds", 0) + 1
                )
        if dg is None:
            dg = DeviceGraph.build(
                snap.weights,
                snap.indptr.astype(np.int64),
                snap.indices.astype(np.int64),
                with_ell=True,
                aggregation="auto",
            )
        dev = self._accel_dev or self._cpu_dev
        dg = jax.device_put(dg, dev)
        self._state = (dg, snap.ids, core.n_nodes, snap.n, dev)
        self.stats["platform"] = dev.platform
        self._bufs = None
        self._prev = None
        self.stats["rebuilds"] += 1
        self.stats["seconds_prep"] += time.perf_counter() - t0
        return self._state

    def _needs_rebuild(self, core):
        if self._state is None:
            return True
        _dg, ids, built_size, built_active, _dev = self._state
        if (self.rebuild_active_frac > 0.0 and core.active_count
                < self.rebuild_active_frac * max(built_active, 1)):
            return True
        gadgets = core.n_nodes - built_size
        return gadgets > self.rebuild_gadget_frac * max(built_active, 1)

    def _score_legacy(self, core, weight_scale: float):
        from gnn_mwvc.solver.pipeline import GnnScorer

        if self._legacy is None:
            self._legacy = GnnScorer(self.model,
                                     device_min_edges=self.device_min_edges,
                                     native=True)
        snap = core.snapshot()
        prob = self._legacy(snap, weight_scale)
        self.stats["legacy_rounds"] += 1
        return snap.ids, prob.astype(np.float32), snap.weights, snap.deg

    # -- per-round scoring ----------------------------------------------
    def score_core(self, core, weight_scale: float):
        import jax

        t0 = time.perf_counter()
        if not self.force_sticky:
            e_live = core.live_edges()
            if self._accel_dev is None or e_live < self.device_min_edges:
                self._state = None  # kernel shrank below the sticky regime
                return self._score_legacy(core, weight_scale)

        if self._needs_rebuild(core):
            self._rebuild(core)  # accounts its own prep time
            t0 = time.perf_counter()
        dg, ids, built_size, _ba, dev = self._state
        n_pad = dg.n_pad
        k = len(ids)
        sink = np.int32(n_pad - 1)  # padding row: dead by construction
        # per-round label churn is ~N/20 (the relabel trigger); n_pad/16
        # slots leave headroom while keeping the upload small
        k_slots = max(4096, n_pad // 16)

        # one-pass native delta refresh: the core compares its live state
        # against our raw copies (updated in place) and emits the changed
        # rows as the f32 device deltas directly (capi mwvc_sticky_deltas)
        fresh = self._prev is None
        if fresh:
            self._prev = (np.zeros(k, np.uint64), np.zeros(k, np.uint64),
                          np.zeros(k, np.uint32), np.zeros(k, np.uint8))
        idx = np.full(k_slots, sink, np.int32)
        vw = np.zeros(k_slots, np.float32)
        vnw = np.zeros(k_slots, np.float32)
        vdeg = np.zeros(k_slots, np.float32)
        vm = np.zeros(k_slots, np.uint8)
        cnt = core.sticky_deltas(ids, *self._prev, idx, vw, vnw, vdeg, vm)
        w_r, nw_r, deg_r, act8 = self._prev
        act_r = act8.view(bool)
        if fresh or cnt > k_slots or self._bufs is None:
            # full (re)upload: fresh buffers, then a no-op delta call
            wts = np.zeros(n_pad, np.float32)
            wts[:k] = w_r
            nws = np.zeros(n_pad, np.float32)
            nws[:k] = nw_r
            degs = np.zeros(n_pad, np.float32)
            degs[:k] = deg_r
            mask = np.zeros(n_pad, bool)
            mask[:k] = act_r
            self._bufs = tuple(
                jax.device_put(a, dev) for a in (wts, nws, degs, mask)
            )
            idx[:] = sink
            vw[:] = 0.0
            vnw[:] = 0.0
            vdeg[:] = 0.0
            vm[:] = 0
        self.stats["seconds_prep"] += time.perf_counter() - t0

        prob, *bufs = self._fn(self.model.params, *self._bufs, idx, vw, vnw,
                               vdeg, vm.view(bool), dg,
                               np.float32(weight_scale))
        self._bufs = tuple(bufs)
        prob = np.asarray(prob)  # waits for the device
        rows = np.nonzero(act_r)[0]
        out_ids = ids[rows]
        out_prob = prob[rows].astype(np.float32)
        out_w = w_r[rows]
        out_deg = deg_r[rows]

        # gadget nodes created by folds after the build: neutral scores
        # (min(p, 1-p) = 0.5 sorts least-confident -> decided last)
        if core.n_nodes > built_size:
            act_g, w_g, deg_g = core.node_range(built_size, core.n_nodes)
            rows_g = np.nonzero(act_g)[0]
            if len(rows_g):
                gad = (built_size + rows_g).astype(np.uint32)
                out_ids = np.concatenate([out_ids, gad])
                out_prob = np.concatenate(
                    [out_prob, np.full(len(gad), 0.5, np.float32)]
                )
                out_w = np.concatenate([out_w, w_g[rows_g]])
                out_deg = np.concatenate([out_deg, deg_g[rows_g]])
        self.stats["rounds"] += 1
        return out_ids, out_prob, out_w, out_deg
