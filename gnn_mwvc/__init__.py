"""GNN-guided Minimum Weight Vertex Cover on an accelerator, in JAX.

A from-scratch JAX/XLA re-design of the capability set of
KennethLangedal/GNN-MWVC (SEA 2022): METIS graph IO, a GraphSAGE-style
vertex-scoring GNN, an exact-reduction (kernelization) engine with undo-able
graph surgery, exact sub-solvers for small components, and an anytime weighted
local search, split between host and device:

* the O(E) work (message passing, rule predicates, batched exact region
  solves) runs on the device over immutable padded CSR snapshots;
* everything sequential (action log, unfold, branch-and-reduce recursion,
  local search) runs on the host in the native C++ core;
* multi-device scaling uses edge-partitioned `shard_map` message passing with
  halo exchange (see `gnn_mwvc.parallel`).

Reference capability map: see SURVEY.md at the repository root.
"""

__version__ = "0.1.0"

import os as _os


def compilation_cache_dir(environ=_os.environ) -> str:
    """Where the persistent XLA compile cache lives: JAX_COMPILATION_CACHE_DIR
    when it is set, else ``.jax_cache/`` at the root of this checkout (a
    fixed path, listed in .gitignore)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


def _setup_compilation_cache():
    """Persistent XLA compile cache: repeat runs skip recompiling the same
    programs.  Opt out with GNN_MWVC_NO_COMPILE_CACHE=1."""
    if _os.environ.get("GNN_MWVC_NO_COMPILE_CACHE"):
        return
    import jax

    path = compilation_cache_dir()
    _os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_setup_compilation_cache()

from gnn_mwvc.graph import Graph  # noqa: F401
