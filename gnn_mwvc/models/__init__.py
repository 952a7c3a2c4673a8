from gnn_mwvc.models.gnn import (  # noqa: F401
    Model,
    graph_layer,
    forward,
    make_forward_fn,
    make_scorer,
    build_reference_arch,
    init_params,
)
from gnn_mwvc.models.serialize import (  # noqa: F401
    loads_model,
    dumps_model,
    load_model,
    save_model,
    load_pretrained,
)
