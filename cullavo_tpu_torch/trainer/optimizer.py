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
and leave their inputs as they were.

On a grid the gradients, parameters and moments are this rank's shards:
Adam is elementwise and runs on them as they are, ``count`` is
replicated, and the clip takes the global norm of the sharded tree
(``norm_fn``: ``parallel.Layout.global_norm``), so that every rank clips by
one factor.

X-Decoder: the ``warmup_cosine`` / ``warmup_multistep`` schedules (computed
in f32, as JAX computes them) and ``xdecoder_optimizer``: one global-norm
clip, then AdamW per parameter group, each leaf's group named by
``xdecoder_param_labels`` from its path string as JAX's ``classify`` names
it ("backbone", "lang", "norm", "embed", "default"), with the backbone and
language learning-rate multipliers and the norm / embedding weight decays.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
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


def _clip(grads, grad_clip: float, norm_fn=global_norm):
    """Clip by global norm (``norm_fn``'s: a sharded tree's is
    ``parallel.Layout.global_norm``): unchanged while norm < grad_clip."""
    norm = norm_fn(grads)
    # one host read: the step already reads the loss and the norm
    if not float(norm) < grad_clip:
        grads = tree_map(lambda g: (g / norm.to(g.dtype)) * grad_clip, grads)
    return grads


def _adam_update(grads, state, params, lr, wd):
    """One AdamW step; ``lr`` and ``wd``: trees like params of per-leaf
    floats (the learning rate already read at the count before the step)."""
    mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, state["mu"])
    nu = tree_map(lambda g, n: (1 - B2) * (g * g) + B2 * n, grads, state["nu"])
    count = state["count"] + 1
    c1, c2 = 1 - B1 ** count, 1 - B2 ** count

    def step(m, n, p, lr_, wd_):
        u = (m / c1) / (torch.sqrt(n / c2) + EPS)
        if wd_:
            u = u + wd_ * p
        return -lr_ * u

    return tree_map(step, mu, nu, params, lr, wd), {"count": count, "mu": mu, "nu": nu}


def _adam_init(params):
    return {"count": 0, "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def _adamw(schedule, weight_decay: float, grad_clip: float,
           norm_fn=global_norm) -> GradientTransformation:
    def update(grads, state, params):
        lr = schedule(state["count"])
        return _adam_update(_clip(grads, grad_clip, norm_fn), state, params,
                            tree_map(lambda _: lr, params),
                            tree_map(lambda _: weight_decay, params))

    return GradientTransformation(_adam_init, update)


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
                      grad_accum: int = 1, norm_fn=global_norm) -> GradientTransformation:
    """AdamW + cosine annealing + total-norm clip (+ accumulation).
    ``norm_fn``: the clip's global norm (a sharded tree's on a grid)."""
    tx = _adamw(cosine_annealing(base_lr, total_steps, eta_min), weight_decay, grad_clip,
                norm_fn)
    return _multi_steps(tx, grad_accum) if grad_accum > 1 else tx


def _warmup(s, warmup_steps: int, warmup_factor: float):
    """The linear warmup's factor at f32 step ``s``: ``warmup_factor`` to 1."""
    f32 = np.float32
    alpha = np.clip(s / f32(max(warmup_steps, 1)), f32(0), f32(1))
    return f32(warmup_factor) * (f32(1) - alpha) + alpha


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int,
                  warmup_factor: float = 1e-3):
    """detectron2's WarmupCosineLR: a linear warmup from ``warmup_factor``,
    then a cosine to 0 over ``total_steps`` (in f32)."""
    f32 = np.float32

    def schedule(step) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(base_lr) * _warmup(s, warmup_steps, warmup_factor))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * s / f32(total_steps)))
        return float(f32(base_lr) * cos)

    return schedule


def warmup_multistep(base_lr: float, milestones, gamma: float, warmup_steps: int,
                     warmup_factor: float = 1e-3):
    """A linear warmup, then ``gamma`` per milestone passed (in f32)."""
    f32 = np.float32

    def schedule(step) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(base_lr) * _warmup(s, warmup_steps, warmup_factor))
        return float(f32(base_lr) * f32(gamma) ** f32(sum(bool(s >= m) for m in milestones)))

    return schedule


def _classify(path: str) -> str:
    names = path.lower()
    if "backbone" in names:
        return "backbone"
    if "lang" in names or "text" in names:
        return "lang"
    if any(t in names for t in ("norm", "ln", "bias", "_b")):
        return "norm"
    if "embed" in names or "query_feat" in names or "pos" in names:
        return "embed"
    return "default"


def _paths(params, path: str = ""):
    """The path string of every leaf: dict keys and list indices ("[i]"),
    joined by "/"."""
    if isinstance(params, dict):
        return {k: _paths(v, f"{path}/{k}" if path else str(k)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_paths(v, f"{path}/[{i}]" if path else f"[{i}]")
                            for i, v in enumerate(params))
    return None if params is None else path


def xdecoder_param_labels(params, path_class=None):
    """The group of every leaf, from its path string, as the JAX
    optimizer's ``classify`` names it (or as ``path_class`` does)."""
    return tree_map(path_class or _classify, _paths(params))


def xdecoder_optimizer(base_lr: float, total_steps: int, weight_decay: float = 0.05,
                       wd_norm: float = 0.0, wd_embed: float = 0.0,
                       backbone_lr_multiplier: float = 0.1, lang_lr_multiplier: float = 0.1,
                       grad_clip: float = 0.01, warmup_steps: int = 10,
                       schedule: str = "cosine", milestones=(), gamma: float = 0.1,
                       path_class=None, norm_fn=global_norm) -> GradientTransformation:
    """Clip by global norm, then AdamW per group: learning rate
    ``schedule(count) * multiplier`` and weight decay by group.
    ``path_class(path string) -> group`` replaces the default labels;
    ``norm_fn``: the clip's global norm (a sharded tree's on a grid)."""
    sched = (warmup_cosine(base_lr, total_steps, warmup_steps) if schedule == "cosine"
             else warmup_multistep(base_lr, milestones, gamma, warmup_steps))
    groups = {"backbone": (backbone_lr_multiplier, weight_decay),
              "lang": (lang_lr_multiplier, weight_decay),
              "norm": (1.0, wd_norm), "embed": (1.0, wd_embed), "default": (1.0, weight_decay)}

    def update(grads, state, params):
        labels = xdecoder_param_labels(params, path_class)
        base = np.float32(sched(state["count"]))
        lr = tree_map(lambda g: float(base * np.float32(groups[g][0])), labels)
        wd = tree_map(lambda g: groups[g][1], labels)
        return _adam_update(_clip(grads, grad_clip, norm_fn), state, params, lr, wd)

    return GradientTransformation(_adam_init, update)
