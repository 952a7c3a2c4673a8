"""Unified solver configuration.

Every tunable the reference hard-codes as a compile-time constant
(SURVEY.md §5 "Config / flag system") lives here with the same default, so a
run can be reproduced or re-tuned from one place (constructor kwargs, a JSON
file, or CLI flags that feed into it).

Reference sources for the defaults:
  critical_limit=1000         GNN_VC.cpp:21
  max_small_solve=8           mwvc_reductions.hpp:20
  degree_skip=20              mwvc_reductions.hpp:344
  component_limit=75          GNN_VC.cpp:143
  relabel_fraction=20 (N/20)  GNN_VC.cpp:171
  step bounds 2^10..2^16      GNN_VC.cpp:346-353
  weight_scale: runtime w_max GNN_VC.cpp:270-278
  train: lr .01, momentum .9, batch 500k vertices, ws 2000
                              gnn_train.cpp:72,12
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class SolverConfig:
    # phase 1 (kernelize + peel)
    critical_limit: int = 1000
    max_small_solve: int = 8
    degree_skip: int = 20
    component_limit: int = 75
    relabel_fraction: int = 20
    relable_interval: int = -1     # <0 = auto (staleness N/relabel_fraction)
    # phase 2 (local search)
    step_size_min: int = 1 << 10
    step_size_max: int = 1 << 16
    time_limit: float = 1000.0
    # device
    device_min_edges: int = 4_000_000
    aggregation: str = "auto"      # auto | blocked | ell | scatter
    blocked_min_quality: float = 0.25
    reorder: bool = False
    compat_graph_layer: bool = True
    # training
    train_lr: float = 0.01
    train_momentum: float = 0.9
    train_weight_decay: float = 0.0
    train_batch_vertices: int = 500_000
    train_weight_scale: float = 2000.0
    # checkpointing
    checkpoint_path: str | None = None
    checkpoint_interval: float = 60.0

    @classmethod
    def from_file(cls, path: str) -> "SolverConfig":
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
