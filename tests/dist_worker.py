"""Worker for the 2-process jax.distributed test (run by test_distributed).

Each process owns 2 virtual CPU devices; the global mesh has 4 devices on
the "graph" axis.  The worker scores a fixed graph through the sharded
forward (halo all_to_all crossing the process boundary), gathers the global
result, and compares against the single-device score computed locally.
Prints DIST_OK on success.

Usage: dist_worker.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from gnn_mwvc.parallel import init_distributed

    init_distributed(coordinator=coord, num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 2 * nproc, devs

    import numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental import multihost_utils

    from gnn_mwvc.graph import DeviceGraph, Graph
    from gnn_mwvc.models import load_pretrained
    from gnn_mwvc.models.gnn import score_graph
    from gnn_mwvc.parallel import (make_mesh, make_sharded_forward,
                                       partition_device_graph)
    from gnn_mwvc.parallel.sharded import _edge_arrays

    # deterministic instance, identical on both processes
    rng = np.random.default_rng(42)
    n, deg = 600, 8
    eu = rng.integers(0, n, size=n * deg // 2)
    ev = rng.integers(0, n, size=n * deg // 2)
    keep = eu != ev
    e = np.unique(
        np.sort(np.stack([eu[keep], ev[keep]], 1), axis=1), axis=0)
    g = Graph(rng.integers(1, 1000, size=n), e)
    dg = DeviceGraph.from_graph(g)
    m = load_pretrained()
    ws = float(g.weights.max())

    # single-device oracle on this process's first local device
    single = np.asarray(score_graph(m, dg, ws))[: g.n]

    parts = 2 * nproc
    mesh = make_mesh(parts)
    sg = partition_device_graph(dg, parts)
    assert sg.halo

    arrs, _ = _edge_arrays(sg)
    arrs.update(weights=sg.weights, degrees=sg.degrees, nw=sg.nw,
                node_mask=sg.node_mask)
    lo, hi = pid * 2, pid * 2 + 2  # this process's shard rows

    def to_global(a):
        return multihost_utils.host_local_array_to_global_array(
            np.asarray(a)[lo:hi], mesh, P("graph"))

    garrs = {k: to_global(v) for k, v in arrs.items()}
    gparams = multihost_utils.host_local_array_to_global_array(
        jax.tree.map(np.asarray, m.params), mesh, P())

    fwd = make_sharded_forward(m.kinds, mesh)

    class SG:  # minimal view the scorer reads
        halo = True
        has_blocked = False
        send_idx = garrs["send_idx"]
        row_int = garrs["row_int"]
        col_int = garrs["col_int"]
        row_bnd = garrs["row_bnd"]
        col_bnd = garrs["col_bnd"]
        weights = garrs["weights"]
        degrees = garrs["degrees"]
        nw = garrs["nw"]
        node_mask = garrs["node_mask"]

    out = fwd(gparams, SG(), ws)
    full = multihost_utils.process_allgather(out, tiled=True).reshape(-1)
    mask = np.asarray(sg.node_mask).reshape(-1)
    got = full[mask][: g.n]
    np.testing.assert_allclose(got, single, atol=1e-5)
    print(f"DIST_OK p{pid}", flush=True)


if __name__ == "__main__":
    main()
