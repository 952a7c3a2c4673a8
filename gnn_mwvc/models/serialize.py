"""Reference-compatible model (de)serialization.

Text format (reference: src/gnn_inference.cpp:92-139)::

    <name>
    <n> Layers
    Graph_Layer
    <blank>
    Linear_Layer
    Weights: <h> <w>
    <h rows of w floats>
    Bias: 1 <w>
    <1 row of w floats>
    <blank>
    ReLU_Activation
    ...
    Sigmoid_Activation

Parsing is token-stream based (like the reference's ``operator>>``), so any
whitespace layout round-trips.  ``load_pretrained`` loads the published
SEA-2022 weights shipped with this package.
"""

from __future__ import annotations

import os

import numpy as np

from gnn_mwvc.models.gnn import Model

__all__ = [
    "loads_model",
    "dumps_model",
    "load_model",
    "save_model",
    "load_pretrained",
    "PRETRAINED_PATH",
]

PRETRAINED_PATH = os.path.join(
    os.path.dirname(__file__), "weights", "gnn_vc_sea2022.txt"
)

_KIND_TO_TOKEN = {
    "linear": "Linear_Layer",
    "graph": "Graph_Layer",
    "relu": "ReLU_Activation",
    "sigmoid": "Sigmoid_Activation",
}
_TOKEN_TO_KIND = {v: k for k, v in _KIND_TO_TOKEN.items()}


def loads_model(text: str, dtype=np.float32) -> Model:
    toks = text.split()
    pos = 0

    def take():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    name = take()
    n = int(take())
    assert take() == "Layers"
    kinds, params = [], []
    for _ in range(n):
        tok = take()
        kind = _TOKEN_TO_KIND[tok]
        kinds.append(kind)
        if kind == "linear":
            assert take() == "Weights:"
            h, w = int(take()), int(take())
            wdat = np.array(toks[pos : pos + h * w], dtype=dtype).reshape(h, w)
            pos += h * w
            assert take() == "Bias:"
            bh, bw = int(take()), int(take())
            assert bh == 1
            bdat = np.array(toks[pos : pos + bw], dtype=dtype)
            pos += bw
            params.append({"w": wdat, "b": bdat})
        else:
            params.append(None)
    return Model(kinds=tuple(kinds), params=params, name=name)


def dumps_model(model: Model) -> str:
    out = [model.name, f"{len(model.kinds)} Layers"]
    for kind, p in zip(model.kinds, model.params):
        out.append(_KIND_TO_TOKEN[kind])
        if kind == "linear":
            w = np.asarray(p["w"])
            b = np.asarray(p["b"]).reshape(1, -1)
            out[-1] = "Linear_Layer"
            out.append(f"Weights: {w.shape[0]} {w.shape[1]}")
            for row in w:
                out.append(" ".join(f"{v:g}" for v in row) + " ")
            out.append(f"Bias: 1 {b.shape[1]}")
            out.append(" ".join(f"{v:g}" for v in b[0]) + " ")
        out.append("")  # blank line between layers
    return "\n".join(out) + "\n"


def load_model(path, dtype=np.float32) -> Model:
    with open(path) as f:
        return loads_model(f.read(), dtype=dtype)


def save_model(path, model: Model) -> None:
    with open(path, "w") as f:
        f.write(dumps_model(model))


def load_pretrained(dtype=np.float32) -> Model:
    """The published 21-layer / 6,209-param SEA-2022 model."""
    return load_model(PRETRAINED_PATH, dtype=dtype)
