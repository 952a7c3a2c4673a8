from gnn_mwvc.ops.aggregate import (  # noqa: F401
    EllPlan,
    build_ell,
    ell_segment_sum,
)
