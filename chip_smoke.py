"""End-to-end check that the GNN-guided solve runs on the GPU.

    python3 chip_smoke.py            # one card: solve, gnn-vc, parity
    python3 chip_smoke.py --four     # four cards: the sharded path only

Set-up generates the road-class bench graph (``bench.build_road_graph``,
side 1200: 1.44 M nodes, ~11.6 M directed edges, seeded), writes it as METIS
and builds the C++ core.  Phases on one card:

* solve  — ``solve(g, time_limit=T)`` with the default sticky scorer and the
  device assist: a valid cover whose recomputed cost equals ``res.cost``,
  device-scored peel rounds > 0, region batches solved on the GPU > 0, the
  phase-2 kernel re-score landed (its device and seconds are printed);
* cli    — the ``gnn-vc`` entry (``gnn_mwvc.solver.cli.main``, as
  ``gnn-vc <graph> <sol> T -1 0 --json``) on the same file, in this process:
  a valid cover of the cost it reports;
* parity — one sticky-scorer forward on the card against the jnp forward on
  the CPU backend at ``Precision.HIGHEST`` (max abs error <= 2e-5), and one
  B=1024 region batch at n=16 and at n=20 on the card, bitwise equal to the
  2^16 enumeration on the CPU (n=16), to the meet-in-the-middle walk on the
  CPU and, for a slice of the batch, to a numpy brute force (n=20).

``--four`` scores the graph with the sharded forward on a 4-card mesh,
compares the scores with the one-card forward (<= 2e-5), checks that the
four partitions sit on four devices, and runs a short sharded solve.

Prints the card line and ``jax.devices()`` first and, when every phase
passed, one JSON line last:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Exits non-zero without that line when a phase fails or no GPU is found.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback

# A CUDA plugin that fails to load must be an error, not a CPU run; the CPU
# backend stays available for the host-side rounds.
os.environ["JAX_PLATFORMS"] = "cuda,cpu"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SCORE_TOL = 2e-5  # the activation-parity gate of tests/test_gnn_forward.py
SIDE = 1200       # bench.build_road_graph side: 1.44 M nodes
CLI_TIME = 5.0    # gnn-vc budget; phase 1 runs to its end regardless


def log(msg):
    print(msg, flush=True)


def setup(side=SIDE):
    import numpy as np

    from bench import build_road_graph
    from gnn_mwvc.core import lib_path
    from gnn_mwvc.graphio import write_metis

    t0 = time.perf_counter()
    lib_path()  # builds the C++ core on first use
    t_core = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_road_graph(side)
    work = os.path.join(HERE, ".smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, f"road{side}.metis")
    write_metis(path, g)
    log(f"setup: road{side} n={g.n} directed_edges={len(g.indices)} "
        f"w_max={int(np.max(g.weights))} core_build_s={t_core:.1f} "
        f"graph_s={time.perf_counter() - t0:.1f}")
    return g, path, work


def check_cover(g, sol, cost):
    from gnn_mwvc.graphio import cover_cost, is_vertex_cover

    assert is_vertex_cover(g, sol), "not a vertex cover"
    got = cover_cost(g, sol)
    assert got == cost, f"recomputed cost {got} != reported {cost}"


def phase_solve(g, time_limit):
    from gnn_mwvc.solver import solve
    from gnn_mwvc.solver.static_score import StickyGnnScorer

    scorer = StickyGnnScorer()
    t0 = time.perf_counter()
    res = solve(g, time_limit=time_limit, scorer=scorer)
    wall = time.perf_counter() - t0
    check_cover(g, res.solution, res.cost)
    st, ast = scorer.stats, res.assist_stats or {}
    log(f"solve: phase1_s={res.time_gnn:.1f} "
        f"phase2_s={res.time_total - res.time_gnn:.1f} wall_s={wall:.1f} "
        f"device_rounds={st['rounds']} legacy_rounds={st['legacy_rounds']} "
        f"scorer_platform={st.get('platform')} "
        f"assist_batches={ast.get('batches', 0)} "
        f"assist_platform={ast.get('platform')} "
        f"assist_regions={ast.get('regions', 0)} "
        f"assist_patches={ast.get('patches', 0)} "
        f"kernel_score_platform={ast.get('kernel_score_platform')} "
        f"kernel_score_s={ast.get('t_kernel_score_s')} cost={res.cost} "
        f"kernel={res.kernel_size} ls_steps={res.ls_steps}")
    log(f"solve: scorer_stats={json.dumps(st)}")
    log(f"solve: assist_stats={json.dumps(ast)}")
    assert st["rounds"] > 0 and st.get("platform") == "gpu", \
        "no device-scored peel round"
    assert ast.get("batches", 0) > 0 and ast.get("platform") == "gpu", \
        "no region batch solved on the GPU"
    assert ast.get("t_kernel_score_s") is not None, \
        "the phase-2 kernel re-score did not land"
    return res


def phase_cli(g, path, work, time_limit):
    """The gnn-vc entry point, called in this process: a second JAX process
    could not open the card this one holds."""
    import contextlib
    import io

    from gnn_mwvc.graphio import read_solution
    from gnn_mwvc.solver.cli import main as gnn_vc

    sol = os.path.join(work, "cli.sol")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = gnn_vc([path, sol, str(time_limit), "-1", "0", "--json"])
    if rc != 0:
        raise RuntimeError(f"gnn-vc returned {rc}: {out.getvalue()[-2000:]}")
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    check_cover(g, read_solution(sol).astype(bool), rec["cost"])
    log(f"cli: wall_s={time.perf_counter() - t0:.1f} "
        f"time_gnn_s={rec['time_gnn']} cost={rec['cost']} "
        f"kernel={rec['kernel_size']}")


def reference_scores(g):
    """The plain reference: jnp forward on the CPU backend at HIGHEST."""
    import jax
    import numpy as np

    from gnn_mwvc.graph import DeviceGraph
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.models.gnn import make_scorer

    model = load_pretrained()
    cpu = jax.devices("cpu")[0]
    dg = DeviceGraph.from_graph(g, aggregation="scatter", with_ell=False)
    with jax.default_device(cpu):
        out = make_scorer(model)(model.params, jax.device_put(dg, cpu),
                                 np.float32(g.weights.max()))
        return np.asarray(out)[: g.n]


def sticky_scores(g, scorer):
    """One sticky-scorer forward on a fresh (unreduced) core of g."""
    import numpy as np

    from gnn_mwvc.core import CoreSolver

    core = CoreSolver(g.weights, g.edge_array(), num_rules=0)
    ids, prob, _w, _d = scorer.score_core(core, float(g.weights.max()))
    out = np.full(g.n, np.nan, np.float32)
    out[ids.astype(np.int64)] = prob
    return out


def phase_parity(g):
    import numpy as np

    from gnn_mwvc.solver.static_score import StickyGnnScorer

    scorer = StickyGnnScorer(force_sticky=True)
    dev = sticky_scores(g, scorer)
    ref = reference_scores(g)
    err = float(np.max(np.abs(dev - ref)))
    log(f"parity: score_max_abs_err={err:.3e} tol={SCORE_TOL:g} "
        f"n={g.n} scorer_platform={scorer.stats.get('platform')}")
    assert scorer.stats.get("platform") == "gpu"
    assert err <= SCORE_TOL, f"score error {err} > {SCORE_TOL}"
    region_parity()


def _region_batch(rng, b, n):
    import numpy as np

    adj = np.zeros((b, n), np.int32)
    w = np.zeros((b, n), np.int32)
    for k in range(b):
        m = int(rng.integers(n // 2, n + 1))
        w[k, :m] = rng.integers(1, 1000, size=m)
        for _ in range(2 * m):
            i, j = rng.integers(0, m, size=2)
            if i != j:
                adj[k, i] |= 1 << j
                adj[k, j] |= 1 << i
        if k % 7 == 0:  # a boundary-forced vertex (self-loop bit)
            f = int(rng.integers(0, m))
            adj[k, f] |= 1 << f
    return adj, w


def _brute_force(adj_row, w_row):
    """numpy 2^n enumeration, first argmin (smallest cover bitmask)."""
    import numpy as np

    n = len(adj_row)
    s = np.arange(1 << n, dtype=np.int64)
    cost = np.zeros(1 << n, np.int64)
    valid = np.ones(1 << n, bool)
    for j in range(n):
        chosen = (s >> j) & 1
        aj = int(adj_row[j])
        valid &= (chosen == 1) | ((s & aj) == aj)
        cost += np.where(chosen == 1, int(w_row[j]), 0)
    cost = np.where(valid, cost, 2**31 - 1)
    best = int(np.argmin(cost))
    used = sum(1 << j for j in range(n) if w_row[j] or adj_row[j])
    return int(cost[best]), best & used


def region_parity(batch=1024, n_brute=16):
    import jax
    import numpy as np

    from gnn_mwvc.ops.smallsolve import batched_small_mwvc, mitm_small_mwvc

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(5)
    for n in (16, 20):
        adj, w = _region_batch(rng, batch, n)
        got = mitm_small_mwvc(jax.device_put(adj, gpu),
                              jax.device_put(w, gpu))
        got = [np.asarray(a) for a in got]
        with jax.default_device(cpu):
            oracle = batched_small_mwvc if n == 16 else mitm_small_mwvc
            want = [np.asarray(a) for a in oracle(jax.device_put(adj, cpu),
                                                  jax.device_put(w, cpu))]
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        brute_ok = True
        if n == 20:
            for k in range(n_brute):
                c0, s0 = _brute_force(adj[k], w[k])
                brute_ok &= (c0 == got[0][k] and s0 == got[1][k])
        log(f"parity: region n={n} B={batch} bitwise_equal_cpu={same} "
            f"brute_force_slice_equal={brute_ok} device={gpu.device_kind}")
        assert same and brute_ok, f"region solver mismatch at n={n}"


def phase_four(g, time_limit):
    import numpy as np

    from gnn_mwvc.parallel import make_mesh
    from gnn_mwvc.solver import ShardedGnnScorer, solve
    from gnn_mwvc.solver.static_score import StickyGnnScorer

    mesh = make_mesh(4)
    sh = ShardedGnnScorer(mesh=mesh)
    t0 = time.perf_counter()
    four = sticky_scores(g, sh)
    t_four = time.perf_counter() - t0
    devs = {d for b in sh._bufs for s in b.addressable_shards
            for d in [s.device]}
    one = sticky_scores(g, StickyGnnScorer(force_sticky=True))
    err = float(np.max(np.abs(four - one)))
    log(f"four: score_max_abs_err_vs_one_card={err:.3e} tol={SCORE_TOL:g} "
        f"partition_devices={sorted(d.id for d in devs)} "
        f"aggregation={sh.aggregation} h_max={sh.stats.get('h_max')} "
        f"first_call_s={t_four:.1f}")
    assert len(devs) == 4, f"partitions on {len(devs)} devices, not 4"
    assert err <= SCORE_TOL, f"four-card score error {err} > {SCORE_TOL}"
    scorer = ShardedGnnScorer(mesh=mesh)
    res = solve(g, time_limit=time_limit, scorer=scorer)
    check_cover(g, res.solution, res.cost)
    log(f"four: solve phase1_s={res.time_gnn:.1f} "
        f"phase2_s={res.time_total - res.time_gnn:.1f} cost={res.cost} "
        f"mesh_rounds={scorer.stats['rounds']} "
        f"legacy_rounds={scorer.stats['legacy_rounds']}")
    assert scorer.stats["rounds"] > 0, "no mesh-scored peel round"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--solve-time", type=float, default=90.0,
                    help="solve() budget in seconds, phase 1 included")
    args = ap.parse_args(argv)

    from gnn_mwvc.utils.device import card_line, device_record, require_gpu

    log(card_line())
    import jax

    log(f"jax.devices(): {jax.devices()}")
    require_gpu()
    if args.four and len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(jax.devices())}")

    g, path, work = setup()
    try:
        phases = ([("four", lambda: phase_four(g, args.solve_time))]
                  if args.four else
                  [("solve", lambda: phase_solve(g, args.solve_time)),
                   ("cli", lambda: phase_cli(g, path, work, CLI_TIME)),
                   ("parity", lambda: phase_parity(g))])
        failed = []
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn()
                log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
            except Exception:
                failed.append(name)
                log(f"phase {name}: FAILED\n{traceback.format_exc()}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    rec = device_record()
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
