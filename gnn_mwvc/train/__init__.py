from gnn_mwvc.train.data import (  # noqa: F401
    TrainSample,
    load_training_set,
    make_sample,
    gen_reduced_graph,
)
from gnn_mwvc.train.trainer import train, evaluate, TrainConfig  # noqa: F401
