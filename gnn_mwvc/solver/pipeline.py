"""End-to-end GNN-guided MWVC solve.

Orchestration (reference: src/GNN_VC.cpp:156-239, 241-392):

  phase 1 (kernelize + peel):
      reduce to fixed point; loop { exactly solve small components; snapshot
      the active subgraph; score every vertex with the GNN (device); order by
      confidence; peel decisions through the native core until the staleness
      trigger } until the graph is empty.
  phase 2 (local search):
      the peeled decisions over the kernel become the initial cover for the
      anytime weighted local search (native core), run in adaptive batches
      until the time budget.
  finally: unfold all reductions, validate, emit the reference CSV contract.

Device/host split: phase-1 scoring and phase-2 region solves are the device
work; big scoring rounds go to the accelerator, small rounds (below
``device_min_edges``) to the native C++ forward or the in-process CPU backend
— the peel loop shrinks the graph every round, and a fresh device program
per shape bucket would cost more than the round itself.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from gnn_mwvc.core import CoreLocalSearch, CoreSolver
from gnn_mwvc.graph import DeviceGraph, Graph
from gnn_mwvc.models import Model, load_pretrained
from gnn_mwvc.models.gnn import make_scorer

CONF_EPS = 1e-4  # confidence tie width (reference: GNN_VC.cpp:196)


def pick_devices():
    """(cpu_device, accel_device_or_None).

    jax.devices() lists only the default backend, so the CPU backend is
    asked for explicitly.  It hosts the rounds below the device size
    threshold; a process started without it (JAX_PLATFORMS naming only an
    accelerator) is refused rather than handed an accelerator as "cpu".
    """
    import jax

    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError as exc:
        raise RuntimeError(
            "the CPU backend is not available; start with JAX_PLATFORMS "
            "listing cpu beside the accelerator (e.g. cuda,cpu)") from exc
    accel = next((d for d in jax.devices() if d.platform != "cpu"), None)
    return cpu, accel


class GnnScorer:
    """Scores kernel snapshots, routing to the accelerator or the CPU by
    size (device_min_edges)."""

    def __init__(self, model: Optional[Model] = None,
                 device_min_edges=4_000_000,
                 compat=True, native=False):
        """native=True routes CPU-sized snapshots through the threaded C++
        forward (core cpu_forward_native): zero per-round DeviceGraph/plan
        build and no XLA-CPU recompiles across shape buckets.  Off by
        default because its fp rounding differs from the jax forward by
        ~1e-6, which matters to exact cover-identity comparisons (the
        sticky/sharded scorers enable it for their below-threshold rounds;
        requires compat=True semantics)."""
        self.model = model or load_pretrained()
        self.device_min_edges = device_min_edges
        self.native = bool(native) and compat
        self._cpu_dev, self._accel_dev = pick_devices()
        self._fn_accel = make_scorer(self.model, compat=compat)
        self._fn_cpu = make_scorer(self.model, compat=compat)

    def device_for(self, n_edges: int):
        """The device that scores a snapshot of n_edges directed edges."""
        if self._accel_dev is not None and n_edges >= self.device_min_edges:
            return self._accel_dev
        return self._cpu_dev

    def __call__(self, snap, weight_scale: float) -> np.ndarray:
        """snap: core Snapshot; returns scores aligned with snapshot rows."""
        import jax

        e = int(snap.indptr[-1]) if snap.n else 0
        dev = self.device_for(e)
        use_accel = dev.platform != "cpu"
        if not use_accel and self.native and snap.n:
            try:
                from gnn_mwvc.core import cpu_forward_native

                return cpu_forward_native(snap, self.model, weight_scale)
            except ImportError:  # no native core: jax-CPU fallback below
                pass
        dg = DeviceGraph.build(
            snap.weights,
            snap.indptr.astype(np.int64),
            snap.indices.astype(np.int64),
            with_ell=use_accel,
            # accelerator: the measured fastest plan for the graph class
            # (graph.py); CPU: plain scatter segment-sum compiles fast.
            aggregation="auto" if use_accel else "scatter",
        )
        with jax.default_device(dev):
            dg_dev = jax.device_put(dg, dev)
            fn = self._fn_accel if use_accel else self._fn_cpu
            out = fn(self.model.params, dg_dev, np.float32(weight_scale))
            return np.asarray(out)[: snap.n]


def confidence_order(prob: np.ndarray, weights: np.ndarray,
                     deg: np.ndarray) -> np.ndarray:
    """Vectorized analog of the reference's confidence comparator
    (reference: src/GNN_VC.cpp:194-205): primary key = eps-bucketed
    min(p, 1-p) ascending; within a bucket exclusions come first; inclusion
    ties order by weight asc then degree desc, exclusion ties by weight desc
    then degree asc."""
    try:
        from gnn_mwvc.core import confidence_order_native

        return confidence_order_native(prob, weights, deg, CONF_EPS)
    except ImportError:
        pass
    av = np.minimum(prob, 1.0 - prob)
    bucket = np.floor(av / CONF_EPS)
    incl = prob > 0.5
    w = weights.astype(np.int64)
    d = deg.astype(np.int64)
    k_w = np.where(incl, w, -w)
    k_d = np.where(incl, -d, d)
    return np.lexsort((k_d, k_w, incl.astype(np.int8), bucket))


def kernel_state(core: CoreSolver):
    """Phase-2 input after ``core.unfold(t_kernel)``: the kernel snapshot,
    its unique edges (compacted ids, u < v) and the peel decisions over it
    as the initial cover.  The unfolded decisions must cover every kernel
    edge; a fold that broke that would surface here, not in a later
    written cover."""
    snap = core.snapshot()
    rows = np.repeat(
        np.arange(snap.n, dtype=np.int64), np.diff(snap.indptr.astype(np.int64))
    )
    keep = rows < snap.indices
    kedges = np.stack([rows[keep], snap.indices[keep]], axis=1)
    s0 = np.array([core.decided(u) == 1 for u in snap.ids], dtype=np.uint8)
    uncovered = int(((s0[kedges[:, 0]] | s0[kedges[:, 1]]) == 0).sum())
    if uncovered:
        raise RuntimeError(
            f"phase-1 decisions leave {uncovered} kernel edges uncovered")
    return snap, kedges, s0


@dataclasses.dataclass
class SolveResult:
    solution: np.ndarray        # 0/1 per original vertex
    cost: int                   # cover written
    best_seen: int              # cheapest cost observed (may be < cost)
    time_to_best: float
    time_gnn: float
    time_total: float
    kernel_size: int            # nodes left after initial reductions
    initial_cost: int           # cost paid by initial reductions
    counters: np.ndarray        # rule-fire counters r1..r8
    ls_steps: int = 0
    assist_stats: Optional[dict] = None  # device-assisted phase-2 counters


def gnn_peel(
    core: CoreSolver,
    scorer,
    weight_scale: float,
    relable_interval: int = -1,
    component_limit: int = 75,
    verbose: bool = False,
    metrics=None,
):
    """Phase 1; returns (timestamp_of_kernel, kernel_size, initial_cost).

    Scorers come in two shapes: the legacy per-snapshot callable
    ``scorer(snapshot, weight_scale) -> prob`` and the sticky protocol
    ``scorer.score_core(core, weight_scale) -> (ids, prob, w, deg)``
    (solver/static_score.py) which owns its own snapshot/plan lifecycle.
    """
    t0 = time.perf_counter()
    core.reduce()
    t_reduce0 = time.perf_counter() - t0
    t_kernel = None
    kernel_size = 0
    initial_cost = 0
    first = True
    sticky = hasattr(scorer, "score_core")
    t_score_sum = 0.0
    t_peel_sum = 0.0
    while core.active_count > 0:
        core.solve_small_components(component_limit)
        if first:
            first = False
            t_kernel = core.timestamp
            kernel_size = core.active_count
            initial_cost = core.cost
        if core.active_count == 0:
            break
        t0 = time.perf_counter()
        if sticky:
            ids, prob, wts, deg = scorer.score_core(core, weight_scale)
            edges_scored = int(deg.sum())
        else:
            snap = core.snapshot()
            prob = scorer(snap, weight_scale)
            ids, wts, deg = snap.ids, snap.weights, snap.deg
            edges_scored = int(snap.indptr[-1]) if snap.n else 0
        t_score = time.perf_counter() - t0
        order = confidence_order(prob, wts, deg)
        core.reset_label_count()
        if verbose:
            print(f"Remaining nodes: {core.active_count}", end="\r",
                  flush=True)
        n_before = core.active_count
        t0 = time.perf_counter()
        core.peel(ids[order], prob[order].astype(np.float32),
                  relable_interval)
        t_peel = time.perf_counter() - t0
        t_score_sum += t_score
        t_peel_sum += t_peel
        if metrics is not None:
            metrics.record_round(
                nodes_remaining=core.active_count,
                edges_scored=edges_scored,
                decisions=n_before - core.active_count,
                label_count=core.label_count,
                seconds_score=round(t_score, 4),
                seconds_peel=round(t_peel, 4),
            )
    if t_kernel is None:
        t_kernel = core.timestamp
    # phase-1 decomposition lands in the run records via scorer.stats
    # (canonical runs don't pass a metrics object; the road1600 r3c/r3d
    # 600-676 s phase 1s could not be diagnosed post hoc without this)
    if hasattr(scorer, "stats") and isinstance(scorer.stats, dict):
        scorer.stats["t_reduce0_s"] = round(t_reduce0, 1)
        scorer.stats["t_score_s"] = round(t_score_sum, 1)
        scorer.stats["t_peel_s"] = round(t_peel_sum, 1)
    if metrics is not None and sticky and hasattr(metrics, "record_scorer"):
        metrics.record_scorer(dict(scorer.stats))
    return t_kernel, kernel_size, initial_cost


def solve(
    g: Graph,
    model: Optional[Model] = None,
    time_limit: float = 1000.0,
    relable_interval: int = -1,
    verbose: bool = False,
    scorer=None,
    seed_step_size: int = 1 << 16,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: float = 60.0,
    reorder: bool = False,
    metrics=None,
    ls_forget_after: int = 0,
    ls_ils_stall: int = 256,
    ls_ils_k: int = 16,
    ls_seed: int = 1,
    device_assist="auto",
    assist_batch: int = 1024,
    assist_rmax: int = 20,
) -> SolveResult:
    """Phase-2 diversification (beyond the reference's plain search):

    ls_ils_stall > 0 (default 256) enables the ILS schedule: after that many
    consecutive non-improving batches at the step-size floor, restore the
    best cover and kick it with a force-k perturbation (k doubles while
    kicks fail to find a new best, resets on success — the HILS adaptive
    pattern).  Set ls_ils_stall=0 for exact reference phase-2 behavior.

    ls_forget_after > 0 instead decays learned edge weights on stall
    (FastWVC ForgetEdgeWeights; kept for experiments, off by default).

    device_assist puts the otherwise-idle device to work during phase 2
    (solver/device_assist.py): the kernel is re-scored once, ILS kicks
    become model-misfit-guided, and batches of boundary-conditioned
    <=20-vertex regions are exact-solved on the device, their
    strictly-improving assignments patched back between search batches.
    Default "auto" (one default across solve/gnn-vc/tools/canonical.py): ON
    whenever an accelerator is present, OFF on CPU-only hosts, where the
    region solves would contend with the search thread for the same
    cores."""
    t_start = time.perf_counter()
    if g.n == 0:
        return SolveResult(np.zeros(0, np.int8), 0, 0, 0.0, 0.0, 0.0, 0, 0,
                           np.zeros(8, np.uint64))

    g_orig = g
    perm = None
    t_cluster = 0.0
    if reorder:
        # clustered relabel for device-aggregation locality; the solution is
        # mapped back to original ids at the end.
        from gnn_mwvc.core import cluster_order

        t_c0 = time.perf_counter()
        perm = cluster_order(g.indptr, g.indices)
        g = g.reorder(perm)
        t_cluster = time.perf_counter() - t_c0

    weight_scale = float(g.weights.max())
    if scorer is None:
        # sticky scoring by default: static device structure + per-round
        # O(n) feature refresh (solver/static_score.py); pass a GnnScorer
        # for the legacy per-snapshot mode
        from gnn_mwvc.solver.static_score import StickyGnnScorer

        scorer = StickyGnnScorer(model)

    if hasattr(scorer, "stats") and isinstance(scorer.stats, dict):
        scorer.stats["t_cluster_s"] = round(t_cluster, 1)
    core = CoreSolver(g.weights, g.edge_array())
    t_kernel, kernel_size, initial_cost = gnn_peel(
        core, scorer, weight_scale,
        relable_interval, verbose=verbose, metrics=metrics,
    )
    # rewind the peel decisions; they remain in S as the initial cover
    core.unfold(t_kernel)
    time_gnn = time.perf_counter() - t_start
    cost_gnn = core.cost
    if verbose:
        print(f"GNN-VC done in {time_gnn:.3f}s, cost: {cost_gnn}")

    def _unperm(sol):
        if perm is None:
            return sol
        out = np.empty_like(sol)
        out[perm] = sol
        return out

    if core.active_count == 0:
        core.unfold(0)
        sol = core.solution()
        assert (sol >= 0).all()
        total = time.perf_counter() - t_start
        return SolveResult(
            _unperm(sol.astype(np.int8)), core.cost, core.cost, time_gnn,
            time_gnn, total, kernel_size, initial_cost, core.counters,
        )

    # ---- phase 2: local search over the kernel --------------------------
    snap, kedges, s0 = kernel_state(core)
    ls = CoreLocalSearch(snap.weights, kedges, s0)

    assist = None
    kick_bias = None
    kick_bias_pending = None
    cpu_dev, accel_dev = pick_devices()
    if device_assist == "auto":
        device_assist = accel_dev is not None
    if device_assist:
        import threading

        from gnn_mwvc.solver.device_assist import DeviceAssist

        assist = DeviceAssist(np.full(snap.n, 0.5, np.float32),
                              device=accel_dev or cpu_dev,
                              batch=assist_batch, rmax=assist_rmax,
                              seed=ls_seed)
        # Kernel scores guide the kicks and the region-center sampling.
        # The kernel is scored like a peel round (device at or above
        # device_min_edges, native C++ forward below) in a background
        # thread, so the host build and the first-call compile overlap the
        # search; the loop harvests the scores once the thread is done and
        # swaps the model bias in (the search starts with uniform kicks and
        # neutral centers).
        kscorer = GnnScorer(getattr(scorer, "model", None), native=True)
        holder = {}
        assist.stats["kernel_score_platform"] = kscorer.device_for(
            int(snap.indptr[-1])).platform
        assist.stats["t_kernel_score_s"] = None

        def _score_kernel():
            t0 = time.perf_counter()
            try:
                holder["prob"] = kscorer(snap, weight_scale).astype(
                    np.float32)
            except Exception as exc:
                holder["err"] = exc
            holder["seconds"] = time.perf_counter() - t0

        th = threading.Thread(target=_score_kernel, daemon=True,
                              name="assist-kernel-score")
        th.start()
        kick_bias_pending = (th, holder)

    t2 = time.perf_counter()
    t_best = t2
    last_ckpt = t2
    step_size = seed_step_size
    stalled = 0
    kicks = 0
    k_cur = ls_ils_k
    best_at_kick = 1 << 62
    while time_gnn + (time.perf_counter() - t2) < time_limit:
        remaining = time_limit - time_gnn - (time.perf_counter() - t2)
        if ls.search(step_size, remaining):
            stalled = 0
            t_best = time.perf_counter()
            step_size = min(step_size * 2, 1 << 16)
            if verbose:
                print(
                    f"{time_gnn + (t_best - t2):.2f},"
                    f"{ls.best_cost + initial_cost}, step size {step_size}"
                )
            if (checkpoint_path
                    and t_best - last_ckpt >= checkpoint_interval):
                from gnn_mwvc.graphio import cover_cost as _cc
                from gnn_mwvc.solver.checkpoint import save_checkpoint

                core.apply_cover(snap.ids, ls.best())
                full = _unperm((core.preview_solution() == 1).astype(np.int8))
                save_checkpoint(
                    checkpoint_path, g_orig, full, _cc(g_orig, full),
                    time_gnn + (t_best - t2),
                )
                last_ckpt = t_best
        else:
            step_size = max(step_size // 2, 1 << 10)
            if step_size == 1 << 10:
                stalled += 1
                if ls_forget_after and stalled >= ls_forget_after:
                    ls.forget(0.3)
                    stalled = 0
                elif ls_ils_stall and stalled >= ls_ils_stall:
                    # adaptive ILS kick (see docstring)
                    stalled = 0
                    kicks += 1
                    if ls.best_cost < best_at_kick:
                        k_cur = ls_ils_k
                    else:
                        k_cur = min(k_cur * 2, 4096)
                    best_at_kick = ls.best_cost
                    ls.restore_best()
                    if kick_bias is not None:
                        ls.perturb_guided(k_cur, ls_seed + kicks, kick_bias)
                    else:
                        ls.perturb(k_cur, ls_seed + kicks)
                    step_size = 1 << 16
        if kick_bias_pending is not None:
            th, holder = kick_bias_pending
            if not th.is_alive():
                kick_bias_pending = None
                if "err" in holder:
                    raise holder["err"]
                assist.stats["t_kernel_score_s"] = holder["seconds"]
                prob_local = holder["prob"]
                kick_bias = np.clip(1.0 - prob_local, 0.05, 1.0).astype(
                    np.float32)
                assist.prob = prob_local  # picked up at next pool refill
        if assist is not None:
            prev_best = ls.best_cost
            assist.tick(ls)
            if ls.best_cost < prev_best:
                t_best = time.perf_counter()
                if verbose:
                    print(
                        f"{time_gnn + (t_best - t2):.2f},"
                        f"{ls.best_cost + initial_cost}, device patch"
                    )

    if assist is not None:
        assist.stop()
    # write the best cover back into the core solution (cost adjusted with
    # kernel-state weights, as the reference's get_cover does)
    core.apply_cover(snap.ids, ls.best())

    core.unfold(0)
    sol = core.solution()
    assert (sol >= 0).all()
    total = time.perf_counter() - t_start
    return SolveResult(
        _unperm(sol.astype(np.int8)),
        core.cost,
        min(ls.best_seen + initial_cost, core.cost),
        time_gnn + (t_best - t2),
        time_gnn,
        total,
        kernel_size,
        initial_cost,
        core.counters,
        ls_steps=ls.steps,
        assist_stats=dict(assist.stats) if assist is not None else None,
    )
