from gnn_mwvc.core import baseline_solve  # noqa: F401
