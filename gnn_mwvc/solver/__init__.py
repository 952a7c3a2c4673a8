from gnn_mwvc.solver.pipeline import solve, SolveResult, GnnScorer  # noqa: F401
from gnn_mwvc.solver.sharded_score import ShardedGnnScorer  # noqa: F401
