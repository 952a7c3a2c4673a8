from gnn_mwvc.graphio.metis import read_metis, write_metis  # noqa: F401
from gnn_mwvc.graphio.edgelist import (  # noqa: F401
    read_edge_graph,
    write_edge_graph,
    read_mtx_edges,
    mtx_to_metis,
    gen_weights,
)
from gnn_mwvc.graphio.validate import (  # noqa: F401
    is_vertex_cover,
    cover_cost,
    read_solution,
    write_solution,
    is_independent_set,
    independent_set_to_cover,
)
