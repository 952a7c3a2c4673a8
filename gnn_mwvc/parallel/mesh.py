"""Device mesh construction and multi-host init.

The reference is single-process/single-thread (SURVEY.md §2.4); scaling here
is a 1-D "graph" axis that partitions nodes+edges of one large graph across
devices (the sequence-parallel analog for graph size), and an optional
leading "data" axis shards batches of graphs for training.  The cards of one
host are joined all to all, so the mesh follows the algorithm alone;
`jax.distributed` extends the same program across hosts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "init_distributed"]


def make_mesh(n_graph: int | None = None, n_data: int = 1, devices=None) -> Mesh:
    """Build a (data, graph) mesh; defaults to all devices on the graph axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_graph is None:
        n_graph = devices.size // n_data
    assert n_graph * n_data == devices.size, (
        f"{devices.size} devices cannot form ({n_data}, {n_graph}) mesh"
    )
    return Mesh(devices.reshape(n_data, n_graph), axis_names=("data", "graph"))


def init_distributed(coordinator: str | None = None, **kw) -> None:
    """Multi-host bring-up (no-op on a single host)."""
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator, **kw)
