from gnn_mwvc.utils.metrics import PhaseTimer, SolveMetrics, trace_span  # noqa: F401
