"""Training, data pipeline, ablation, and approximation tests."""

import io
import os

import numpy as np
import pytest

from gnn_mwvc.graph import Graph
from gnn_mwvc.graphio import cover_cost, is_vertex_cover, write_edge_graph
from gnn_mwvc.train import (
    TrainConfig,
    gen_reduced_graph,
    load_training_set,
    make_sample,
    train,
    evaluate,
)


def _labeled_samples(k=6, n=60, seed=0):
    """Synthetic task: label = optimal-ish cover membership via weights."""
    from tests.conftest import random_graph
    from gnn_mwvc.solver import solve

    samples = []
    for i in range(k):
        g = random_graph(n, 6, seed=seed + i, wmax=40)
        res = solve(g, time_limit=1.0)
        y = res.solution.astype(np.float32)
        frac = y.mean()
        if 0.2 < frac < 0.8:
            samples.append(make_sample(g, y, name=f"g{i}"))
    return samples


def test_train_reduces_loss():
    samples = _labeled_samples(8)
    assert len(samples) >= 4
    # batch_vertices=1 -> one SGD step per graph (tiny graphs would otherwise
    # accumulate into a single step per epoch, reference-style)
    cfg = TrainConfig(epochs=30, log=False, seed=1, batch_vertices=1)
    model, hist = train(samples, cfg)
    losses = [h["train"]["loss"] for h in hist]
    assert losses[-1] < losses[0] * 0.8
    assert model.num_params() == 6209


def test_train_metrics_fields():
    samples = _labeled_samples(5)
    cfg = TrainConfig(epochs=1, log=False)
    model, hist = train(samples, cfg)
    m = hist[-1]["train"]
    assert set(m) == {"loss", "accuracy", "total", "true_accuracy",
                      "true_total"}
    assert 0 <= m["accuracy"] <= 1


def test_trained_model_serializes(tmp_path):
    from gnn_mwvc.models import dumps_model, loads_model

    samples = _labeled_samples(4)
    model, _ = train(samples, TrainConfig(epochs=0, log=False))
    text = dumps_model(model)
    m2 = loads_model(text)
    assert m2.kinds == model.kinds


def test_gen_reduced_graph():
    from tests.conftest import random_graph

    g = random_graph(300, 6, seed=11, wmax=30)
    kernel, cost_paid, org_ids = gen_reduced_graph(g)
    assert kernel.n <= g.n
    assert cost_paid >= 0
    assert len(org_ids) == kernel.n
    # 3-rule kernelization must not use folds that create gadget nodes
    # beyond... gadgets come from rule independent_fold (index 4) — excluded.
    assert (org_ids < g.n).all()


def test_load_training_set(tmp_path):
    from tests.conftest import random_graph

    gd = tmp_path / "graphs"
    ld = tmp_path / "labels"
    gd.mkdir()
    ld.mkdir()
    for i, frac in enumerate([0.5, 0.05]):  # second is class-imbalanced
        g = random_graph(50, 4, seed=i)
        write_edge_graph(str(gd / f"g{i}.mtx"), g)
        rng = np.random.default_rng(i)
        y = (rng.random(g.n) < frac).astype(int)
        np.savetxt(str(ld / f"g{i}.txt"), y, fmt="%d")
    samples = load_training_set(str(gd), str(ld))
    assert len(samples) == 1  # imbalanced one filtered out
    assert samples[0].name == "g0"


def test_ablation_grid():
    from tests.conftest import random_graph
    from gnn_mwvc.solver.ablation import ablation_csv, run_ablation

    g = random_graph(150, 6, seed=21, wmax=20)
    results = run_ablation(g)
    assert len(results) == 8
    assert [r.config for r in results] == \
        ["GRS", "GR", "GS", "G", "QRS", "QR", "QS", "Q"]
    for r in results:
        assert r.cost <= r.cost_before  # improvement pass never hurts
    csv = ablation_csv("t", g, results)
    assert csv.startswith("t,150,")
    assert len(csv.split(",")) == 3 + 8 * 4 + 10


def test_approximation_solver():
    from tests.conftest import random_graph
    from gnn_mwvc.solver.approximation import approximate_solve

    g = random_graph(500, 8, seed=31, wmax=100)
    vc, cost, dt = approximate_solve(g)
    assert is_vertex_cover(g, vc)
    assert cover_cost(g, vc) == cost
    # 2-approximation bound sanity: not worse than taking everything
    assert cost < g.weights.sum()


def test_greedy_and_constructions():
    from tests.conftest import random_graph
    from gnn_mwvc.core import approx_cover, greedy_cover

    g = random_graph(300, 8, seed=41)
    for fn in (approx_cover, greedy_cover):
        cost, vc = fn(g.weights, g.edge_array())
        assert is_vertex_cover(g, vc)
        assert cover_cost(g, vc) == cost


def test_full_data_prep_to_train_to_solve_chain(tmp_path):
    """The SURVEY §3.5 chain end-to-end through the CLIs: raw edges ->
    gen_weights -> 3-rule kernel -> labels -> gnn-train -> solve with the
    freshly trained checkpoint."""
    import numpy as np

    from gnn_mwvc.graphio import (cover_cost, is_vertex_cover,
                                      write_edge_graph)
    from gnn_mwvc.models import load_model
    from gnn_mwvc.solver import solve
    from gnn_mwvc.solver.pipeline import GnnScorer
    from gnn_mwvc.train.cli import main as train_main
    from gnn_mwvc.train.data import gen_reduced_graph
    from tests.conftest import random_graph

    gdir = tmp_path / "graphs"
    ldir = tmp_path / "labels"
    gdir.mkdir()
    ldir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        g = random_graph(2000, 10, seed=100 + i, wmax=100)
        kernel, _cost, _ids = gen_reduced_graph(g)
        if kernel.n < 200:
            continue
        # labels from a quick solve of the kernel
        res = solve(kernel, time_limit=0.3)
        y = res.solution.astype(int)
        write_edge_graph(gdir / f"k{i}.mtx", kernel)
        np.savetxt(ldir / f"k{i}.txt", y, fmt="%d")

    out = tmp_path / "model.txt"
    rc = train_main([str(gdir), str(ldir), str(out), "3", "0"])
    assert rc == 0
    model = load_model(str(out))
    assert model.num_params() == 6209  # reference architecture

    g = random_graph(1500, 8, seed=999, wmax=100)
    res = solve(g, time_limit=1.0, scorer=GnnScorer(model))
    assert is_vertex_cover(g, res.solution)
    assert cover_cost(g, res.solution) == res.cost
