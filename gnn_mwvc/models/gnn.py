"""The vertex-scoring GNN, as functional JAX.

The reference model family (reference: include/gnn_inference.hpp:11-59) is a
sequence drawn from four layer kinds:

* ``graph``   — message passing, out width = 2*w + 3
* ``linear``  — dense y = xW + b
* ``relu`` / ``sigmoid``

The published SEA-2022 network is 21 layers / 3 message-passing rounds / 6,209
params scoring every vertex in [0, 1] (reference: src/GNN_VC.cpp:23).

Device mapping: linear layers are single XLA dots; the graph layer
aggregates over the padded graph with the plan the DeviceGraph carries (see
graph_layer) — the whole network is memory-bound at width <= 35, so fusing
the elementwise chain around the aggregation is what matters, and XLA does
that under one jit.

Column-placement compatibility: the reference writes D, W/WS, NW/WS at output
columns w+1..w+3 *after* copying the input block to columns [w, 2w)
(reference: src/gnn_inference.cpp:27-42).  For w == 1 that matches the
documented layout ``|Agg|Input|D|W|NW|``; for w == 16 it overwrites copied
input features 1..3 and leaves the top 3 columns zero.  The trained weights
bake this in, so ``compat=True`` (default) replicates it exactly;
``compat=False`` gives the documented layout for new models.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gnn_mwvc.graph import DeviceGraph

__all__ = [
    "Model",
    "graph_layer",
    "forward",
    "make_forward_fn",
    "build_reference_arch",
    "init_params",
]

LayerParams = Any  # {"w": (in, out), "b": (out,)} for linear; None otherwise


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Model:
    """kinds is static metadata; params is the trainable pytree."""

    kinds: tuple = dataclasses.field(metadata=dict(static=True))
    params: list = dataclasses.field(default_factory=list)
    name: str = dataclasses.field(default="MWVC_Model", metadata=dict(static=True))

    def num_params(self) -> int:
        return sum(
            int(np.prod(p["w"].shape)) + int(np.prod(p["b"].shape))
            for p in self.params
            if p is not None
        )


def graph_layer(
    x: jnp.ndarray,
    row: jnp.ndarray,
    col: jnp.ndarray,
    degrees: jnp.ndarray,
    weights: jnp.ndarray,
    nw: jnp.ndarray,
    weight_scale: jnp.ndarray | float,
    compat: bool = True,
    ell=None,
    agg: jnp.ndarray | None = None,
    blocked=None,
    precision=None,
) -> jnp.ndarray:
    """One message-passing round over a padded graph.

    Aggregation: a precomputed ``agg`` (the analytic first-layer shortcut —
    when x == W/ws the neighbor sum is exactly NW/ws), else the windowed
    one-hot plan (ops/blocked.py), the multi-level ELL plan (gather + tree
    sums, ops/aggregate.py), or the sorted-COO segment-sum, whichever the
    DeviceGraph carries (graph.py chooses).

    precision only affects the windowed path (its one-hot einsums); the
    ELL/segment-sum paths are gather+add and exact at any setting.
    """
    n_pad, w = x.shape
    if agg is None:
        if blocked is not None:
            from gnn_mwvc.ops.blocked import blocked_segment_sum

            agg = blocked_segment_sum(x, blocked, precision=precision)
        elif ell is not None:
            from gnn_mwvc.ops.aggregate import ell_segment_sum

            agg = ell_segment_sum(x, ell)
        else:
            agg = jax.ops.segment_sum(
                x.take(col, axis=0), row, num_segments=n_pad,
                indices_are_sorted=True,
            )
    stats = jnp.stack(
        [degrees, weights / weight_scale, nw / weight_scale], axis=1
    ).astype(x.dtype)
    if compat:
        out = jnp.concatenate([agg, x, jnp.zeros((n_pad, 3), x.dtype)], axis=1)
        out = jax.lax.dynamic_update_slice(out, stats, (0, w + 1))
    else:
        out = jnp.concatenate([agg, x, stats], axis=1)
    return out


def forward(
    model: Model,
    x: jnp.ndarray,
    dg: DeviceGraph,
    weight_scale: jnp.ndarray | float,
    compat: bool = True,
    precision=jax.lax.Precision.HIGHEST,
    x_is_node_weights: bool = False,
    source_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Run the layer sequence; returns (n_pad, out_width) activations.

    precision: applies to BOTH the linear-layer dots and the windowed
    aggregation einsums.  HIGHEST (default) keeps full fp32 for activation
    parity with the fp32 CPU reference (on a GPU, lower settings run the
    dots in TF32); production and bench.py run the same setting.

    x_is_node_weights: set when x == (W/ws, ) — the standard pipeline input
    (reference: src/GNN_VC.cpp:189-191).  The first message-passing round is
    then analytic: sum over N(u) of W(v)/ws == NW(u)/ws, already a
    precomputed stat, so the first graph layer costs nothing.

    source_mask: (n_pad,) 0/1 — the sticky-scoring mode (solver/
    static_score.py): the graph structure is a SUPERSET of the live graph
    (removed nodes still have edge slots), so features of masked-out nodes
    are zeroed before every aggregation; their contributions vanish and
    active rows aggregate exactly over their live neighborhoods.  Bias terms
    re-introduce nonzeros on dead rows after linear layers, hence the
    re-mask per round, not just at the input.
    """
    h = x
    first_graph = True
    for kind, p in zip(model.kinds, model.params):
        if kind == "linear":
            h = (
                jnp.dot(
                    h, p["w"],
                    preferred_element_type=jnp.float32,
                    precision=precision,
                )
                + p["b"]
            ).astype(h.dtype)
        elif kind == "relu":
            h = jnp.maximum(h, 0)
        elif kind == "sigmoid":
            h = jax.nn.sigmoid(h)
        elif kind == "graph":
            agg = None
            if first_graph and x_is_node_weights:
                agg = (dg.nw / weight_scale).reshape(-1, 1).astype(h.dtype)
            elif source_mask is not None:
                h = h * source_mask[:, None].astype(h.dtype)
            h = graph_layer(
                h, dg.row, dg.col, dg.degrees, dg.weights, dg.nw,
                weight_scale, compat=compat, ell=dg.ell, agg=agg,
                blocked=dg.blocked, precision=precision,
            )
            first_graph = False
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return h


def make_forward_fn(
    model: Model,
    compat: bool = True,
    precision=jax.lax.Precision.HIGHEST,
    x_is_node_weights: bool = False,
):
    """jit-compiled scoring function: (params, x, dg, ws) -> activations.

    The static part of the model (kinds) is closed over; params and graph
    arrays are traced, so re-invocation on a same-bucket-shaped graph reuses
    the compiled executable.
    """

    m = model

    @jax.jit
    def fn(params, x, dg, weight_scale):
        return forward(
            Model(kinds=m.kinds, params=params, name=m.name),
            x, dg, weight_scale, compat=compat, precision=precision,
            x_is_node_weights=x_is_node_weights,
        )

    return fn


def make_scorer(model: Model, compat: bool = True,
                precision=jax.lax.Precision.HIGHEST):
    """jit-compiled standard-pipeline scorer: (params, dg, ws) -> (n_pad,).

    Builds x = W/ws on device and exploits the analytic first round.  The
    masked sticky-mode variant lives in solver/static_score.py
    (_make_sticky_fn), which fuses the per-round delta update with the
    masked forward in one program.
    """
    m = model

    @jax.jit
    def fn(params, dg, weight_scale):
        x = (dg.weights / weight_scale).reshape(-1, 1).astype(jnp.float32)
        out = forward(
            Model(kinds=m.kinds, params=params, name=m.name),
            x, dg, weight_scale, compat=compat, precision=precision,
            x_is_node_weights=True,
        )
        return out[:, 0]

    return fn


def build_reference_arch() -> tuple:
    """The 21-layer SEA-2022 architecture (reference: gnn_train.cpp:129-149).

    Graph -> Lin(5,32) -> ReLU -> Lin(32,32) -> ReLU -> Lin(32,16) -> ReLU ->
    Graph -> Lin(35,32) -> ReLU -> Lin(32,32) -> ReLU -> Lin(32,16) -> ReLU ->
    Graph -> Lin(35,32) -> ReLU -> Lin(32,16) -> ReLU -> Lin(16,1) -> Sigmoid
    """
    k = []
    dims = [
        (5, 32), (32, 32), (32, 16),
        (35, 32), (32, 32), (32, 16),
        (35, 32), (32, 16), (16, 1),
    ]
    k += ["graph", "linear", "relu", "linear", "relu", "linear", "relu"]
    k += ["graph", "linear", "relu", "linear", "relu", "linear", "relu"]
    k += ["graph", "linear", "relu", "linear", "relu", "linear", "sigmoid"]
    return tuple(k), dims


def init_params(
    kinds: Sequence[str],
    dims: Sequence[tuple],
    seed: int = 0,
    dtype=jnp.float32,
) -> list:
    """U(-lim, lim) init with lim = 1/sqrt(dim_in + 1), one seed per linear
    layer chained from *seed* (reference: src/gnn_inference.cpp:7-18)."""
    params: list = []
    it = iter(range(seed, seed + len(dims)))
    d = iter(dims)
    for kind in kinds:
        if kind == "linear":
            din, dout = next(d)
            lim = 1.0 / np.sqrt(din + 1)
            key = jax.random.key(next(it))
            kw, kb = jax.random.split(key)
            params.append(
                {
                    "w": jax.random.uniform(kw, (din, dout), dtype, -lim, lim),
                    "b": jax.random.uniform(kb, (dout,), dtype, -lim, lim),
                }
            )
        else:
            params.append(None)
    return params


def score_graph(model: Model, dg: DeviceGraph, weight_scale: float, compat=True):
    """Convenience one-shot scoring: x(u) = W(u)/ws (reference: GNN_VC.cpp:189-191)."""
    x = (dg.weights / weight_scale).reshape(-1, 1).astype(jnp.float32)
    out = forward(
        model, jnp.asarray(x), dg, weight_scale, compat=compat,
        x_is_node_weights=True,
    )
    return out[:, 0]
