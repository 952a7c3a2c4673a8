"""Device-guided bulk reduction prepass.

Evaluates whole-graph rule candidate masks on device (ops/rules.py) and
bulk-applies them through the host core.  Soundness differs per rule:

* r1 / twins: the core re-verifies each candidate against live state
  (NW <= W, exact is_twin) before committing — stale masks are harmless.
* r5 (bulk_r5): the device's 2^8-subset proof is exact for the SNAPSHOT
  instance and is applied WITHOUT host re-solving; it transfers to live
  state only because the core tracks instance drift during the pass
  (Solver.begin_bulk_pass / mark_*_dirty in solver.hpp) and skips any
  candidate whose 1-hop instance may have changed.  Every mutation path
  inside a bulk pass MUST mark the affected closed neighborhoods dirty —
  that invariant, not re-verification, carries r5's exactness.

This front-loads the O(E) share of the reduction work (rule 1 removals and
twin folds typically dominate rule fires on large instances) before the
fine-grained worklist engine runs.
"""

from __future__ import annotations

import numpy as np

from gnn_mwvc.core import CoreSolver
from gnn_mwvc.graph import DeviceGraph

__all__ = ["device_reduce_prepass"]


def device_reduce_prepass(core: CoreSolver, max_rounds: int = 4,
                          min_nodes: int = 50_000, device=None,
                          with_r5: bool = True) -> dict:
    """Run mask->bulk-apply rounds until yield drops; returns stats."""
    import jax
    import jax.numpy as jnp

    from gnn_mwvc.ops.rules import (build_ell8, r5_candidates,
                                        rule_masks, twin_groups)

    stats = {"rounds": 0, "r1_applied": 0, "twins_applied": 0,
             "r5_applied": 0}
    for _ in range(max_rounds):
        if core.active_count < min_nodes:
            break
        snap = core.snapshot()
        dg = DeviceGraph.build(
            snap.weights, snap.indptr.astype(np.int64),
            snap.indices.astype(np.int64), with_ell=False,
        )
        with jax.default_device(device) if device else _null():
            masks = rule_masks(
                jnp.asarray(dg.row), jnp.asarray(dg.col),
                jnp.asarray(dg.weights), jnp.asarray(dg.degrees),
                jnp.asarray(dg.nw), jnp.asarray(dg.node_mask),
            )
            r1 = np.asarray(masks["r1"])[: snap.n]
            keys = np.asarray(masks["twin_key"])[: snap.n]
            r5 = None
            # int32 device arithmetic: only sound when every instance cost
            # (bounded by NW) fits
            if with_r5 and (snap.n == 0 or int(snap.nw.max()) < 2**31):
                ell, ellv = build_ell8(
                    snap.indptr.astype(np.int64),
                    snap.indices.astype(np.int64), snap.deg,
                )
                r5 = np.asarray(r5_candidates(
                    jnp.asarray(ell), jnp.asarray(ellv),
                    jnp.asarray(snap.weights.astype(np.int32)),
                    jnp.asarray(snap.nw.astype(np.int32)),
                    jnp.asarray(snap.deg.astype(np.int32)),
                    jnp.ones(snap.n, bool),
                ))

        # the device masks describe THIS snapshot; from here on the core
        # tracks instance drift so r5 verdicts are only applied where the
        # snapshot proof still holds
        core.begin_bulk_pass()
        applied = 0
        r1_ids = snap.ids[np.nonzero(r1)[0]]
        applied += core.bulk_r1(r1_ids)
        stats["r1_applied"] += applied

        groups = twin_groups(keys, np.ones(snap.n, bool))
        pairs = []
        for grp in groups:
            anchor = snap.ids[grp[0]]
            for other in grp[1:]:
                pairs.append((anchor, snap.ids[other]))
        if pairs:
            t = core.bulk_twins(np.asarray(pairs, dtype=np.uint32))
            stats["twins_applied"] += t
            applied += t
        if r5 is not None:
            # r1 already covers nw <= w (which includes every deg-0 node);
            # restrict to the strictly-meta verdicts to keep counters honest
            r5_ids = snap.ids[np.nonzero(r5 & ~r1)[0]]
            if len(r5_ids):
                a5 = core.bulk_r5(r5_ids)
                stats["r5_applied"] += a5
                applied += a5
        stats["rounds"] += 1
        if applied < max(100, core.active_count // 1000):
            break
    return stats


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
