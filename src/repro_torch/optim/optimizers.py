"""Optimizers in the functional (init, update) form, over the port's trees.

A port of ``repro.optim.optimizers``: an ``Optimizer`` is a pair of
functions, ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)``, over trees of tensors (``repro_torch.utils.trees``:
dicts, lists and tuples; the LM's are ``models.params.param_tree``).
Nothing is updated in place: each update returns new tensors, and
``apply_updates`` returns the new parameters. The step counter is a 0-d
int32 tensor on the host, as the reference keeps an int32 ``step``;
moments are fp32 on the parameters' device. Call ``update`` under
``torch.no_grad()`` when the parameters require grad.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.trees import tree_leaves, tree_map, tree_structure, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    """``params + updates`` leafwise, added in fp32 and cast to each
    parameter's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def sgd(learning_rate, momentum: float = 0.0) -> Optimizer:
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params) if momentum else None
        return {"step": _step0(), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"], grads)
            updates = tree_map(lambda m: -lr * m, mu)
            return updates, {"step": step, "mu": mu}
        updates = tree_map(lambda g: -lr * g.float(), grads)
        return updates, {"step": step, "mu": None}

    return Optimizer(init, update)


def adamw(
    learning_rate,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with fp32 first/second moments and decoupled weight decay."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        # zeros_like: on a mesh the moments take their parameter's placements
        f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(), "mu": tree_map(f32, params), "nu": tree_map(f32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        # each leaf's mu, nu and update are
        #   b1 * m + (1 - b1) * g,   b2 * v + (1 - b2) * g^2,
        #   -lr * (mu / bc1 / (sqrt(nu / bc2) + eps) + weight_decay * p),
        # op for op, with one scratch tensor for the intermediates: a fresh
        # tensor for each costs its page faults on the host
        def leaf(m, v, g, p):
            g = g.float()
            mu = torch.mul(m, b1)
            tmp = torch.mul(g, 1 - b1)
            mu.add_(tmp)
            nu = torch.mul(v, b2)
            torch.square(g, out=tmp)
            nu.add_(tmp.mul_(1 - b2))
            upd = torch.div(mu, bc1)
            torch.div(nu, bc2, out=tmp)
            upd.div_(tmp.sqrt_().add_(eps))
            upd.add_(torch.mul(p.float(), weight_decay, out=tmp))
            return mu, nu, upd.mul_(-lr)

        trees = (state["mu"], state["nu"], grads, params)
        struct = tree_structure(trees[0])
        if any(tree_structure(t) != struct for t in trees[1:]):
            raise ValueError("adamw: moments, gradients and parameters of different structures")
        out = [leaf(*leaves) for leaves in zip(*map(tree_leaves, trees))]
        mu, nu, updates = (tree_unflatten(struct, [t[i] for t in out]) for i in range(3))
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Gradient transformation: global-norm clipping. Compose via chain().
    As in the reference, the clipped gradients take the type of
    ``gradient * fp32 scale`` (fp32 for bf16 gradients)."""

    def init(params):
        return {}

    def update(grads, state, params=None):
        leaves = tree_leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
        scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
                        grads), state

    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Optimizer(init, update)
