import io

import numpy as np
import pytest

from gnn_mwvc.graph import Graph, DeviceGraph, bucket_size
from gnn_mwvc.graphio import (
    read_metis,
    write_metis,
    read_edge_graph,
    write_edge_graph,
    gen_weights,
    is_vertex_cover,
    cover_cost,
    is_independent_set,
    independent_set_to_cover,
)


def test_ex3_parse(ex3_graph):
    g = ex3_graph
    assert g.n == 3 and g.m == 2
    assert list(g.weights) == [15, 15, 20]
    assert list(g.degrees) == [1, 1, 2]
    assert list(g.neighborhood_weights) == [20, 20, 30]
    assert list(g.neighbors(2)) == [0, 1]


def test_metis_roundtrip(rnd_graph):
    g = rnd_graph(200, 8, seed=3)
    buf = io.StringIO()
    write_metis(buf, g)
    g2 = read_metis(io.BytesIO(buf.getvalue().encode()))
    assert g2.n == g.n and g2.m == g.m
    assert np.array_equal(g2.weights, g.weights)
    assert np.array_equal(g2.indices, g.indices)
    assert np.array_equal(g2.indptr, g.indptr)


def test_metis_dedup_and_selfloop():
    # duplicate edge 1-2 listed twice + self loop on 3
    data = b"3 3 10\n5 2 2\n6 1 3\n7 2 3\n"
    g = read_metis(io.BytesIO(data))
    assert g.m == 2  # (0,1) and (1,2); self-loop (2,2) dropped
    assert list(g.neighbors(1)) == [0, 2]


def test_edge_graph_roundtrip(rnd_graph):
    g = rnd_graph(100, 6, seed=4)
    buf = io.StringIO()
    write_edge_graph(buf, g)
    g2 = read_edge_graph(io.BytesIO(buf.getvalue().encode()))
    assert g2.n == g.n and g2.m == g.m
    assert np.array_equal(g2.weights, g.weights)
    assert np.array_equal(g2.indices, g.indices)


def test_gen_weights_dedup():
    edges = np.array([[1, 2], [2, 1], [1, 1], [2, 3]])
    g = gen_weights(3, edges, 20, 120, seed=7)
    assert g.m == 2
    assert g.weights.min() >= 20 and g.weights.max() <= 120


def test_validate(ex3_graph):
    g = ex3_graph
    assert is_vertex_cover(g, [0, 0, 1])
    assert cover_cost(g, [0, 0, 1]) == 20
    assert not is_vertex_cover(g, [1, 0, 0])
    assert is_vertex_cover(g, [1, 1, 0])
    assert cover_cost(g, [1, 1, 0]) == 30


def test_is_vc_conversion(ex3_graph):
    g = ex3_graph
    s = np.array([1, 1, 0])  # independent set {0,1}
    assert is_independent_set(g, s)
    vc = independent_set_to_cover(g, s)
    assert is_vertex_cover(g, vc) and cover_cost(g, vc) == 20
    with pytest.raises(ValueError):
        independent_set_to_cover(g, np.array([1, 0, 1]))


def test_bucketing():
    assert bucket_size(1) == 128
    assert bucket_size(128) == 128
    assert bucket_size(129) > 129
    b = bucket_size(10_000)
    assert b >= 10_000 and b % 128 == 0


def test_device_graph_padding(rnd_graph):
    g = rnd_graph(300, 10, seed=5)
    dg = DeviceGraph.from_graph(g)
    assert dg.n_pad > dg.n and dg.n_pad % 128 == 0
    assert dg.node_mask.sum() == g.n
    assert dg.edge_mask.sum() == dg.e == 2 * g.m
    # padded edges scatter only into the sink row
    assert (dg.row[dg.e :] == dg.n_pad - 1).all()
    np.testing.assert_array_equal(dg.degrees[: g.n], g.degrees)
    np.testing.assert_array_equal(dg.nw[: g.n], g.neighborhood_weights)


# ---- MatrixMarket variants (reference: old_files/src/lib/mtx/mmio.c) -------

def _mtx(banner, body):
    import io
    return io.BytesIO((banner + body).encode())


def test_mtx_pattern_symmetric():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    n, e = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix coordinate pattern symmetric\n",
        "% comment\n4 4 3\n2 1\n3 1\n4 3\n"))
    assert n == 4
    np.testing.assert_array_equal(e, [[2, 1], [3, 1], [4, 3]])


def test_mtx_real_general_values():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    n, e, v = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix coordinate real general\n",
        "3 5 2\n1 2 0.5\n3 5 -2.25\n"), with_values=True)
    assert n == 5
    np.testing.assert_array_equal(e, [[1, 2], [3, 5]])
    np.testing.assert_allclose(v, [0.5, -2.25])


def test_mtx_integer_and_complex():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    n, e, v = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix coordinate integer symmetric\n",
        "2 2 1\n2 1 7\n"), with_values=True)
    np.testing.assert_allclose(v, [7.0])
    n, e, v = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix coordinate complex hermitian\n",
        "2 2 1\n2 1 3.5 -1.0\n"), with_values=True)
    np.testing.assert_allclose(v, [3.5])  # real part kept


def test_mtx_skew_symmetric_rejects_diagonal():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    n, e = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix coordinate pattern skew-symmetric\n",
        "3 3 1\n3 1\n"))
    np.testing.assert_array_equal(e, [[3, 1]])
    with pytest.raises(ValueError, match="diagonal"):
        read_mtx_edges(_mtx(
            "%%MatrixMarket matrix coordinate pattern skew-symmetric\n",
            "3 3 1\n2 2\n"))


def test_mtx_array_real_general():
    """Dense array reading (round 4, closes the last mmio.c gap): nonzero
    entries in column-major order become edges."""
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    # 2x2 column-major [[1,3],[2,0]] -> nonzeros (1,1),(2,1),(1,2)
    n, e, v = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix array real general\n",
        "2 2\n1.0\n2.0\n3.0\n0.0\n"), with_values=True)
    assert n == 2
    np.testing.assert_array_equal(e, [[1, 1], [2, 1], [1, 2]])
    np.testing.assert_allclose(v, [1.0, 2.0, 3.0])


def test_mtx_array_symmetric_lower_triangle():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    # 3x3 symmetric, lower triangle col-major: (1,1),(2,1),(3,1),(2,2),
    # (3,2),(3,3); zero out (1,1),(3,2)
    n, e = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix array real symmetric\n",
        "3 3\n0\n5\n6\n7\n0\n8\n"))
    assert n == 3
    np.testing.assert_array_equal(e, [[2, 1], [3, 1], [2, 2], [3, 3]])


def test_mtx_array_skew_and_complex():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    # skew 3x3: strict lower triangle col-major (2,1),(3,1),(3,2)
    n, e = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix array real skew-symmetric\n",
        "3 3\n4\n0\n-4\n"))
    np.testing.assert_array_equal(e, [[2, 1], [3, 2]])
    # complex hermitian 2x2: (1,1),(2,1),(2,2); entry nonzero if either
    # component is, real part kept as the value
    n, e, v = read_mtx_edges(_mtx(
        "%%MatrixMarket matrix array complex hermitian\n",
        "2 2\n0 0\n3.5 -1\n0 2\n"), with_values=True)
    np.testing.assert_array_equal(e, [[2, 1], [2, 2]])
    np.testing.assert_allclose(v, [3.5, 0.0])


def test_mtx_array_errors():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    with pytest.raises(ValueError, match="pattern"):
        read_mtx_edges(_mtx(
            "%%MatrixMarket matrix array pattern general\n", "2 2\n"))
    with pytest.raises(ValueError, match="entries"):
        read_mtx_edges(_mtx(
            "%%MatrixMarket matrix array real general\n", "2 2\n1\n2\n"))
    with pytest.raises(ValueError, match="square"):
        read_mtx_edges(_mtx(
            "%%MatrixMarket matrix array real symmetric\n",
            "2 3\n1\n2\n3\n"))


def test_mtx_bannerless_pattern_compat():
    """Files without a banner stay readable (the reference pipeline's own
    reader never looks at the banner, gen_weights.cpp:33-37)."""
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    n, e = read_mtx_edges(_mtx("", "% c\n3 3 2\n1 2\n2 3\n"))
    assert n == 3 and len(e) == 2


def test_mtx_malformed_errors():
    from gnn_mwvc.graphio.edgelist import read_mtx_edges
    with pytest.raises(ValueError, match="out of range"):
        read_mtx_edges(_mtx(
            "%%MatrixMarket matrix coordinate pattern general\n",
            "2 2 1\n3 1\n"))
    with pytest.raises(ValueError, match="expected 2 entries"):
        read_mtx_edges(_mtx(
            "%%MatrixMarket matrix coordinate pattern general\n",
            "2 2 2\n1 2\n"))
    with pytest.raises(ValueError, match="field"):
        read_mtx_edges(_mtx(
            "%%MatrixMarket matrix coordinate decimal general\n",
            "2 2 1\n1 2\n"))
