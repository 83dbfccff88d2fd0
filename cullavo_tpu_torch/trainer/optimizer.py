"""The CuLLaVO optimizer and its schedule (counterpart of
``cullavo_tpu/trainer/optimizer.py``): clip by global norm, AdamW, cosine
annealing, optional gradient accumulation.

Plain functions on trees of tensors with an explicit state, following
optax's arithmetic (not ``torch.optim``'s) so that both packages take the
same step from the same state:
  * clip: ``g`` unchanged while ``norm < clip``, else ``(g / norm) * clip``;
  * Adam: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, bias
    corrections at ``count + 1``, ``mu_hat / (sqrt(nu_hat) + eps)``;
  * the schedule is read at the count BEFORE the update;
  * accumulation over ``k`` steps keeps the running mean of the gradients
    and emits a zero update on all but every k-th call.
State without accumulation: ``{"count", "mu", "nu"}`` (optax's
``ScaleByAdamState``; its schedule count is the same number).  With it:
``{"mini_step", "gradient_step", "inner": {count, mu, nu}, "acc_grads"}``
(optax's ``MultiStepsState``).  The update functions return new tensors
and leave their inputs as they were.  ``warmup_*`` schedules and the
X-Decoder optimizer come with the X-Decoder slice.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8


class GradientTransformation(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (updates, new state)


def cosine_annealing(base_lr: float, total_steps: int, eta_min: float = 0.0):
    """torch CosineAnnealingLR semantics: lr(t) = eta_min + (base - eta_min)
    * (1 + cos(pi * t / T)) / 2, t clamped to T."""

    def schedule(step: int) -> float:
        t = min(int(step), total_steps)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps))

    return schedule


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (an f32 scalar tensor)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in leaves))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _adamw(schedule, weight_decay: float, grad_clip: float) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        norm = global_norm(grads)
        # one host read: the step already reads the loss and the norm
        if not float(norm) < grad_clip:
            grads = tree_map(lambda g: (g / norm.to(g.dtype)) * grad_clip, grads)
        mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, state["mu"])
        nu = tree_map(lambda g, n: (1 - B2) * (g * g) + B2 * n, grads, state["nu"])
        count = state["count"] + 1
        c1, c2 = 1 - B1 ** count, 1 - B2 ** count
        lr = schedule(state["count"])

        def step(m, n, p):
            u = (m / c1) / (torch.sqrt(n / c2) + EPS)
            if weight_decay:
                u = u + weight_decay * p
            return -lr * u

        return tree_map(step, mu, nu, params), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def _multi_steps(inner: GradientTransformation, k: int) -> GradientTransformation:
    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner": inner.init(params),
                "acc_grads": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state["acc_grads"])
        if n != k - 1:
            return (tree_map(torch.zeros_like, acc),
                    {**state, "mini_step": n + 1, "acc_grads": acc})
        updates, new_inner = inner.update(acc, state["inner"], params)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner": new_inner, "acc_grads": tree_map(torch.zeros_like, acc)}

    return GradientTransformation(init, update)


def cullavo_optimizer(base_lr: float, total_steps: int, eta_min: float = 0.0,
                      weight_decay: float = 0.0, grad_clip: float = 10.0,
                      grad_accum: int = 1) -> GradientTransformation:
    """AdamW + cosine annealing + total-norm clip (+ accumulation)."""
    tx = _adamw(cosine_annealing(base_lr, total_steps, eta_min), weight_decay, grad_clip)
    return _multi_steps(tx, grad_accum) if grad_accum > 1 else tx
