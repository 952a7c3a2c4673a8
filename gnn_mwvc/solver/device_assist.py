"""Device-assisted phase 2: the device works the local-search budget too.

The reference keeps its single CPU busy for the whole 1000 s cutoff
(reference: src/GNN_VC.cpp:338-358 driving local_search.hpp:149-210); the
device would otherwise go idle once peeling ends.  This module puts it to
work in the device->search direction with two mechanisms:

1. **GNN-guided kicks** — the kernel is re-scored once at phase-2 start;
   the ILS kick then removes cover vertices sampled by *model misfit*
   (1 - p(u) for u in the cover) instead of uniformly, aiming
   diversification where the trained prior disagrees with the incumbent.
   (pipeline.solve wires the bias into CoreLocalSearch.perturb_guided.)

2. **Device-batched exact region re-optimization** — between search
   batches the host extracts disjoint boundary-conditioned sub-instances
   (<=16 vertices, <=20 with rmax > 16) around misfit centers (core
   LocalSearch::extract_region: intra-region edges must be covered; a
   region vertex with an outside non-cover neighbor is forced in via a
   self-loop bit), the device exact-solves a batch of them in one call
   (ops/smallsolve.mitm_small_mwvc, the device analog of the reference's
   SSE2 small_solve, include/small_solve.hpp:44-76), and strictly-improving
   assignments are re-validated against the live cover and patched back
   (LocalSearch::apply_region + commit_patches).

The batch runs in the solver's own process on the solver's device: one JAX
process per card.  ``tick`` enqueues a batch and returns at once (JAX
dispatch is asynchronous); later ticks harvest it when ``is_ready()``, so
the C++ local search keeps running while the device works.  All local
search mutations happen in the caller's thread.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["DeviceAssist"]


class DeviceAssist:
    def __init__(self, prob: np.ndarray, device=None, batch: int = 1024,
                 rmax: int = 20, seed: int = 1, misfit_frac: float = 0.75,
                 pool_mult: int = 16):
        """prob: model scores aligned with the LS vertex ids (kernel rows;
        0.5 = neutral).  device: the ``jax.Device`` that solves the
        batches (default: the first device of the default backend).
        batch: regions per device call (one program shape).  misfit_frac:
        fraction of centers sampled by misfit; the rest are uniform over the
        cover (coverage diversity).  pool_mult: centers are sampled
        pool_mult*batch at a time and consumed batch-by-batch, so the O(n)
        misfit sampling is not paid on every dispatch.

        rmax: the largest region; widths above 16 solve at n=20.  On the
        CPU backend rmax is clamped to 16: there the 2^20 walk would take
        the host cores the local search needs."""
        import jax

        self.device = device if device is not None else jax.devices()[0]
        self.prob = np.asarray(prob, np.float32)
        self.batch = int(batch)
        self.rmax = int(rmax)
        if self.device.platform == "cpu":
            self.rmax = min(self.rmax, 16)
        self.pool_mult = int(pool_mult)
        self._pool = None
        self._pool_pos = 0
        self.misfit_frac = float(misfit_frac)
        self._rng = np.random.default_rng(seed)
        self._pending = None  # {"ids", "ks", "out", "t0"}
        self.stats = {"batches": 0, "regions": 0, "patches": 0,
                      "gain": 0, "t_device_s": 0.0, "t_host_s": 0.0,
                      "commits": 0, "platform": self.device.platform}

    # -- caller thread -----------------------------------------------------
    def _refill_pool(self, ls):
        """One O(n) sampling pass yields pool_mult*batch centers; dispatches
        then just slice it.  Misfit drifts slowly (the model scores are
        static; only the cover moves), so a slightly stale pool is fine —
        apply_region re-validates against the live cover anyway."""
        cur = ls.current().astype(bool)
        n = len(cur)
        want = self.batch * self.pool_mult
        p = self.prob[:n] if len(self.prob) >= n else np.full(
            n, 0.5, np.float32)
        misfit = np.where(cur, 1.0 - p, 0.0).astype(np.float64)
        b_mis = int(want * self.misfit_frac)
        picks = []
        if misfit.sum() > 0 and b_mis > 0:
            # Gumbel top-k == sampling w/o replacement proportional to misfit
            g = self._rng.gumbel(size=n)
            key = np.where(misfit > 0, np.log(misfit + 1e-12) + g, -np.inf)
            k = min(b_mis, n - 1)
            picks.append(np.argpartition(-key, k)[:k])
        cover_ids = np.nonzero(cur)[0]
        b_uni = want - (len(picks[0]) if picks else 0)
        if len(cover_ids) and b_uni > 0:
            picks.append(self._rng.choice(
                cover_ids, size=min(b_uni, len(cover_ids)), replace=True))
        if not picks:
            self._pool = np.zeros(0, np.uint32)
        else:
            pool = np.concatenate(picks).astype(np.uint32)
            self._rng.shuffle(pool)
            self._pool = pool
        self._pool_pos = 0

    def _sample_centers(self, ls) -> np.ndarray:
        if self._pool is None or self._pool_pos + self.batch > len(self._pool):
            self._refill_pool(ls)
        if not len(self._pool):
            return self._pool
        c = self._pool[self._pool_pos: self._pool_pos + self.batch]
        self._pool_pos += self.batch
        return c

    def _dispatch(self, ls):
        import jax

        from gnn_mwvc.ops.smallsolve import mitm_small_mwvc

        centers = self._sample_centers(ls)
        if not len(centers):
            return
        ids, adj, w, ks = ls.extract_regions(centers, rmax=self.rmax)
        if len(centers) < self.batch:  # keep one program shape
            pad = self.batch - len(centers)
            adj = np.pad(adj, ((0, pad), (0, 0)))
            w = np.pad(w, ((0, pad), (0, 0)))
            ids = np.pad(ids, ((0, pad), (0, 0)))
            ks = np.pad(ks, (0, pad))
        self.stats["regions"] += int((ks > 0).sum())
        out = mitm_small_mwvc(jax.device_put(adj, self.device),
                              jax.device_put(w, self.device))
        self._pending = {"ids": ids, "ks": ks, "out": out,
                         "t0": time.perf_counter()}

    def _apply(self, ls, p) -> int:
        bc, bs = p["out"]
        bs = np.asarray(bs)  # a failed device batch raises here
        self.stats["t_device_s"] += time.perf_counter() - p["t0"]
        ids, ks = p["ids"], p["ks"]
        applied = 0
        cost_before = ls.cost
        for i in range(len(ks)):
            k = int(ks[i])
            if k and ls.apply_region(k, ids[i, :k], int(bs[i])):
                applied += 1
        if applied:
            ls.commit_patches()
            self.stats["commits"] += 1
            self.stats["gain"] += cost_before - ls.cost
        self.stats["patches"] += applied
        self.stats["batches"] += 1
        return applied

    def tick(self, ls) -> int:
        """Harvest a finished batch and dispatch the next; returns the
        patches applied now.  Never waits on the device: while the batch in
        flight is not ready the caller goes straight back to searching."""
        t0 = time.perf_counter()
        applied = 0
        p = self._pending
        if p is not None:
            if not all(a.is_ready() for a in p["out"]):
                self.stats["t_host_s"] += time.perf_counter() - t0
                return 0
            self._pending = None
            applied = self._apply(ls, p)
        self._dispatch(ls)
        self.stats["t_host_s"] += time.perf_counter() - t0
        return applied

    def stop(self):
        """Drop the batch in flight (its result would be stale)."""
        self._pending = None
