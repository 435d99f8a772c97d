"""Optimizers from scratch: SGD, Adam(W), row-wise Adagrad (PyTorch).

The API mirrors the reference (``repro.optim.optimizers``, itself optax's):
``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)``, then ``apply_updates``.  Row-wise Adagrad keeps one f32
accumulator per row of every >=2-D parameter under ``state["acc"]``; the
checkpoint layer saves that array next to each table.

Unlike the reference, ``apply_updates`` adds the updates **in place**
(under ``torch.no_grad()``) and returns the same parameter tree: at full
Criteo width a fresh copy of the 2.16 GB of tables per step would only
cost memory.  ``update`` itself builds new update and state tensors, as
the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    with torch.no_grad():
        for p, u in zip(leaves(params), leaves(updates)):
            p.add_(u.to(p.dtype))
    return params


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params)}
        return {}

    def update(grads, state, params=None):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr * m, mu), {"mu": mu}
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def adam(lr: float, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        dev = leaves(params)[0].device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr * weight_decay * p
            return u

        if weight_decay:
            updates = tree_map(upd, m, v, params)
        else:
            updates = tree_map(lambda m, v: upd(m, v, None), m, v)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def rowwise_adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    """DLRM-style: for >=2-D params keep one accumulator per row (mean of
    squared grads over the row), for 1-D params a per-element accumulator."""

    def _acc_like(p):
        if p.dim() >= 2:
            return torch.zeros(p.shape[:1], dtype=torch.float32,
                               device=p.device)
        return torch.zeros_like(p, dtype=torch.float32)

    def init(params):
        return {"acc": tree_map(_acc_like, params)}

    def update(grads, state, params=None):
        def upd(g, a):
            if g.dim() >= 2:
                a_new = a + torch.mean(torch.square(g),
                                       dim=tuple(range(1, g.dim())))
                scale = torch.rsqrt(a_new + eps)
                u = -lr * g * scale.reshape(scale.shape + (1,) * (g.dim() - 1))
            else:
                a_new = a + torch.square(g)
                u = -lr * g * torch.rsqrt(a_new + eps)
            return u, a_new

        out = [upd(g, a) for g, a in zip(leaves(grads), leaves(state["acc"]))]
        updates = unflatten(grads, [u for u, _ in out])
        acc = unflatten(grads, [a for _, a in out])
        return updates, {"acc": acc}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "adam": adam, "rowwise_adagrad": rowwise_adagrad}[name](lr, **kw)
