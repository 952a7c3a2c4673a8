from gnn_mwvc.parallel.mesh import init_distributed, make_mesh  # noqa: F401
from gnn_mwvc.parallel.sharded import (  # noqa: F401
    ShardedGraph,
    partition_device_graph,
    make_sharded_forward,
    make_sharded_train_step,
)
