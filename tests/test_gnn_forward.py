import io
import os
import subprocess

import numpy as np
import pytest

from gnn_mwvc.graph import DeviceGraph
from gnn_mwvc.graphio import read_metis, write_metis
from gnn_mwvc.models import (
    load_pretrained,
    loads_model,
    dumps_model,
    build_reference_arch,
    init_params,
)
from gnn_mwvc.models.gnn import Model, score_graph, forward


def test_pretrained_shape():
    m = load_pretrained()
    assert len(m.kinds) == 21
    assert m.num_params() == 6209
    kinds, dims = build_reference_arch()
    assert m.kinds == kinds
    got_dims = [p["w"].shape for p in m.params if p is not None]
    assert got_dims == [tuple(d) for d in dims]


def test_serialize_roundtrip():
    m = load_pretrained()
    m2 = loads_model(dumps_model(m))
    assert m2.kinds == m.kinds
    for p, q in zip(m.params, m2.params):
        if p is None:
            assert q is None
        else:
            # %g formatting keeps 6 significant digits, same as the reference
            np.testing.assert_allclose(p["w"], q["w"], rtol=2e-5)
            np.testing.assert_allclose(p["b"], q["b"], rtol=2e-5)


def test_graph_layer_quirk_w1(ex3_graph):
    """w=1: layout must be [agg, own, D, W/ws, NW/ws]."""
    import jax.numpy as jnp
    from gnn_mwvc.models.gnn import graph_layer

    dg = DeviceGraph.from_graph(ex3_graph)
    ws = 20.0
    x = (dg.weights / ws).reshape(-1, 1)
    out = np.asarray(
        graph_layer(
            jnp.asarray(x), dg.row, dg.col, dg.degrees, dg.weights, dg.nw, ws
        )
    )[:3]
    exp = np.array(
        [
            [1.0, 0.75, 1, 0.75, 1.0],
            [1.0, 0.75, 1, 0.75, 1.0],
            [1.5, 1.0, 2, 1.0, 1.5],
        ],
        dtype=np.float32,
    )
    np.testing.assert_allclose(out, exp, atol=1e-6)


def test_graph_layer_quirk_w16():
    """w=16: D,W,NW overwrite copied features 1..3; top 3 columns zero."""
    import jax.numpy as jnp
    from gnn_mwvc.models.gnn import graph_layer
    from tests.conftest import random_graph

    g = random_graph(50, 4, seed=9)
    dg = DeviceGraph.from_graph(g)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(dg.n_pad, 16)).astype(np.float32)
    x[g.n :] = 0
    ws = float(g.weights.max())
    out = np.asarray(
        graph_layer(
            jnp.asarray(x), dg.row, dg.col, dg.degrees, dg.weights, dg.nw, ws
        )
    )
    assert out.shape[1] == 35
    n = g.n
    # own copy block, except overwritten cols
    np.testing.assert_allclose(out[:n, 16], x[:n, 0], atol=1e-6)
    np.testing.assert_allclose(out[:n, 20:32], x[:n, 4:16], atol=1e-6)
    np.testing.assert_allclose(out[:n, 17], g.degrees, atol=1e-6)
    np.testing.assert_allclose(out[:n, 18], g.weights / ws, atol=1e-5)
    np.testing.assert_allclose(
        out[:n, 19], g.neighborhood_weights / ws, atol=1e-5
    )
    np.testing.assert_allclose(out[:n, 32:35], 0, atol=0)
    # aggregation block = sum of neighbor features
    for u in [0, 7, 23]:
        np.testing.assert_allclose(
            out[u, :16], x[g.neighbors(u)].sum(axis=0), rtol=1e-5, atol=1e-5
        )


def test_scores_vs_oracle_ex3(ex3_graph, oracle_dir):
    _score_parity(ex3_graph, oracle_dir, ws=20.0)


def test_scores_vs_oracle_random(rnd_graph, oracle_dir):
    g = rnd_graph(500, 12, seed=11)
    _score_parity(g, oracle_dir, ws=float(g.weights.max()))


def _score_parity(g, oracle_dir, ws):
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".metis", delete=False) as f:
        write_metis(f, g)
        path = f.name
    try:
        out = subprocess.run(
            [os.path.join(oracle_dir, "dump_activations"), path, str(ws)],
            capture_output=True,
            text=True,
            cwd="/root/repo",
            check=True,
        )
        ref = np.array(out.stdout.split(), dtype=np.float64)
    finally:
        os.unlink(path)

    m = load_pretrained()
    dg = DeviceGraph.from_graph(g)
    mine = np.asarray(score_graph(m, dg, ws))[: g.n]
    np.testing.assert_allclose(mine, ref, atol=2e-5)


def test_forward_fixed_layout(rnd_graph):
    """compat=False keeps the documented |Agg|Input|D|W|NW| layout."""
    import jax.numpy as jnp

    g = rnd_graph(64, 4, seed=2)
    dg = DeviceGraph.from_graph(g)
    kinds, dims = ("graph",), []
    m = Model(kinds=kinds, params=[None])
    x = np.ones((dg.n_pad, 4), np.float32)
    out = np.asarray(forward(m, jnp.asarray(x), dg, 10.0, compat=False))
    assert out.shape[1] == 11
    np.testing.assert_allclose(out[: g.n, 4:8], 1.0)
    np.testing.assert_allclose(out[: g.n, 8], g.degrees)


def test_init_params_shapes():
    kinds, dims = build_reference_arch()
    params = init_params(kinds, dims, seed=0)
    m = Model(kinds=kinds, params=params)
    assert m.num_params() == 6209
    lim = 1.0 / np.sqrt(5 + 1)
    first = [p for p in params if p is not None][0]
    assert np.abs(np.asarray(first["w"])).max() <= lim


def test_native_cpu_forward_parity(rnd_graph):
    """The threaded C++ forward (core cpu_forward_native, used for the
    rounds below the device size threshold) matches the jax forward on a
    reduced kernel snapshot within fp noise, across thread counts."""
    import bench
    from gnn_mwvc.core import CoreSolver, cpu_forward_native

    m = load_pretrained()
    g = bench.build_road_graph(60)
    ws = float(g.weights.max())
    core = CoreSolver(g.weights, g.edge_array())
    core.reduce()
    snap = core.snapshot()
    assert snap.n > 200
    dg = DeviceGraph.build(snap.weights, snap.indptr.astype(np.int64),
                           snap.indices.astype(np.int64), with_ell=False,
                           aggregation="scatter")
    ref = np.asarray(score_graph(m, dg, ws))[: snap.n]
    for nt in (1, 2):
        native = cpu_forward_native(snap, m, ws, n_threads=nt)
        np.testing.assert_allclose(native, ref, atol=2e-6)


def test_native_cpu_forward_empty():
    from gnn_mwvc.core import CoreSolver, cpu_forward_native

    m = load_pretrained()
    w = np.array([5, 3], np.uint32)
    core = CoreSolver(w, np.array([[0, 1]], np.int64))
    core.reduce()  # tiny instance fully reduces
    snap = core.snapshot()
    out = cpu_forward_native(snap, m, 5.0)
    assert out.shape == (snap.n,)
