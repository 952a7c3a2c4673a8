"""GNN training: jax.grad through the shared forward, replacing the
reference's hand-written backprop (reference:
old_files/src/lib/gnn_training.cpp; training driver gnn_train.cpp:72-111).

Reference-default hyperparameters: MSE loss, SGD lr 0.01 momentum 0.9,
gradient accumulation until ~500k vertices per step, 90/10 shuffled split,
per-epoch CSV metrics with per-class accuracy, WEIGHT_SCALE 2000.

Note on gradients: the reference's manual graph-layer backward ignores the
stat columns AND the w=16 column-overwrite quirk; jax.grad differentiates the
actual forward (quirk included), so gradients here are the exact gradients of
the shared function.  Training curves therefore match in shape, not
bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from gnn_mwvc.models import Model, build_reference_arch, init_params
from gnn_mwvc.train.data import TrainSample

__all__ = ["TrainConfig", "train", "evaluate"]

WEIGHT_SCALE = 2000.0  # reference: gnn_train.cpp:12


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 50
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    batch_vertices: int = 500_000
    weight_scale: float = WEIGHT_SCALE
    seed: int = 0
    compat: bool = True
    log: bool = True


def _make_fns(kinds, compat):
    import jax
    import jax.numpy as jnp

    from gnn_mwvc.models.gnn import forward

    def loss_and_metrics(params, dg, y, mask, ws):
        m = Model(kinds=kinds, params=params)
        x = (dg.weights / ws).reshape(-1, 1).astype(jnp.float32)
        out = forward(m, x, dg, ws, compat=compat, x_is_node_weights=True)[:, 0]
        err = jnp.where(mask, out - y, 0.0)
        sse = jnp.sum(err * err)
        pred_in = out > 0.5
        is_true = mask & (y > 0.5)
        tp = jnp.sum(is_true & pred_in)
        tn = jnp.sum(mask & (y <= 0.5) & (out < 0.5))
        return sse, (tp, tn, jnp.sum(is_true))

    # grad of the UNNORMALIZED sse — accumulated across graphs, divided by
    # total vertex count at step time (reference SGD_step semantics,
    # gnn_training.cpp:209-224)
    grad_fn = jax.jit(jax.grad(lambda p, dg, y, mask, ws:
                               loss_and_metrics(p, dg, y, mask, ws)[0]))
    eval_fn = jax.jit(loss_and_metrics)
    return grad_fn, eval_fn


def _tree_zeros_like(params):
    import jax

    return jax.tree_util.tree_map(lambda p: np.zeros_like(p), params)


def _sgd_apply(params, vel, accum, t, cfg):
    """velocity = momentum*vel + (grad/t [+ 2*wd*param]); param -= lr*vel."""
    import jax

    def upd(p, v, g):
        if p is None:
            return None, None
        g = g / t
        if cfg.weight_decay > 0:
            g = g + 2.0 * cfg.weight_decay * p
        v = cfg.momentum * v + g
        return p - cfg.lr * v, v

    new_params, new_vel = [], []
    for p, v, g in zip(params, vel, accum):
        if p is None:
            new_params.append(None)
            new_vel.append(None)
        else:
            np_, nv = {}, {}
            for k in p:
                nv[k] = cfg.momentum * np.asarray(v[k]) + (
                    np.asarray(g[k]) / t
                    + (2.0 * cfg.weight_decay * np.asarray(p[k])
                       if cfg.weight_decay > 0 else 0.0)
                )
                np_[k] = np.asarray(p[k]) - cfg.lr * nv[k]
            new_params.append(np_)
            new_vel.append(nv)
    return new_params, new_vel


def _accumulate(accum, grads):
    out = []
    for a, g in zip(accum, grads):
        if a is None:
            out.append(None)
        else:
            out.append({k: a[k] + np.asarray(g[k]) for k in a})
    return out


def evaluate(model: Model, samples: Sequence[TrainSample],
             weight_scale=WEIGHT_SCALE, compat=True):
    _, eval_fn = _make_fns(model.kinds, compat)
    tot_sse = tot_n = tot_tp = tot_tn = tot_true = 0.0
    for s in samples:
        sse, (tp, tn, ntrue) = eval_fn(model.params, s.dg, s.y, s.mask,
                                       np.float32(weight_scale))
        tot_sse += float(sse)
        tot_n += s.n
        tot_tp += float(tp)
        tot_tn += float(tn)
        tot_true += float(ntrue)
    return {
        "loss": tot_sse / max(tot_n, 1),
        "accuracy": (tot_tp + tot_tn) / max(tot_n, 1),
        "total": int(tot_n),
        "true_accuracy": tot_tp / max(tot_true, 1),
        "true_total": int(tot_true),
    }


def train(samples: Sequence[TrainSample], cfg: TrainConfig = TrainConfig(),
          model: Optional[Model] = None):
    """Returns (model, history).  history = list of per-epoch metric dicts."""
    rng = np.random.default_rng(cfg.seed)
    kinds, dims = build_reference_arch()
    if model is None:
        params = init_params(kinds, dims, seed=cfg.seed)
        params = [
            None if p is None else {k: np.asarray(v) for k, v in p.items()}
            for p in params
        ]
        model = Model(kinds=kinds, params=params)
    grad_fn, eval_fn = _make_fns(model.kinds, cfg.compat)

    idx = np.arange(len(samples))
    split = int(len(samples) * 0.9)
    rng.shuffle(idx)
    train_idx, test_idx = idx[:split], idx[split:]
    train_set = [samples[i] for i in train_idx]
    test_set = [samples[i] for i in test_idx]

    vel = [
        None if p is None else {k: np.zeros_like(v) for k, v in p.items()}
        for p in model.params
    ]
    history = []
    if cfg.log:
        print("Epoch,Loss,Accuracy,Total,True accuracy,True total,"
              "Test loss,Test accuracy,Test total,Test true acc,"
              "Test true total")
    for epoch in range(cfg.epochs + 1):
        order = rng.permutation(len(train_set))
        accum = [
            None if p is None else {k: np.zeros_like(v) for k, v in p.items()}
            for p in model.params
        ]
        t = 0
        for i in order:
            s = train_set[i]
            grads = grad_fn(model.params, s.dg, s.y, s.mask,
                            np.float32(cfg.weight_scale))
            accum = _accumulate(accum, grads)
            if t > cfg.batch_vertices:
                model.params, vel = _sgd_apply(model.params, vel, accum, t,
                                               cfg)
                accum = [
                    None if p is None
                    else {k: np.zeros_like(v) for k, v in p.items()}
                    for p in model.params
                ]
                t = 0
            else:
                t += s.n
        if t > 0:
            model.params, vel = _sgd_apply(model.params, vel, accum, t, cfg)

        tr = evaluate(model, train_set, cfg.weight_scale, cfg.compat)
        te = evaluate(model, test_set, cfg.weight_scale, cfg.compat) \
            if test_set else dict.fromkeys(tr, 0)
        history.append({"epoch": epoch, "train": tr, "test": te})
        if cfg.log:
            print(
                f"{epoch},{tr['loss']:.4f},{tr['accuracy'] * 100:.4f},"
                f"{tr['total']},{tr['true_accuracy'] * 100:.4f},"
                f"{tr['true_total']},{te['loss']:.4f},"
                f"{te['accuracy'] * 100:.4f},{te['total']},"
                f"{te['true_accuracy'] * 100:.4f},{te['true_total']}"
            )
    return model, history
