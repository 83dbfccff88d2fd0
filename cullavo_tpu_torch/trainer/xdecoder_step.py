"""X-Decoder training steps (counterpart of
``cullavo_tpu/trainer/xdecoder_step.py``): the forward's loss dict summed,
the gradient of every parameter, and one step of ``xdecoder_optimizer``.

``compute_dtype=torch.bfloat16`` runs the forward and backward in bf16 over
f32 master parameters (``_cast_compute`` is a differentiable cast, so the
gradients arrive in f32).  ``remat`` checkpoints each backbone block,
text layer and decoder layer.  The metrics are ``loss_total``, the
unclipped ``grad_norm`` and every loss, as f32 scalar tensors.

The joint step with the parameter tree's ``parallel.Layout`` (several
processes; JAX's ``shard_xdecoder_step``): every rank is handed the global
batch, ``forward_joint_train`` runs this rank's images and returns this
rank's share of each loss of the global batch; the losses and the gradient
tree are summed over the ranks that hold other rows (flat buffers), so
every rank takes the one-process step.  With fsdp or tensor axes the
parameters and the moments are this rank's shards: the step gathers the
tree whole at its start (with a gradient; freed after the backward), the
gradients come back as shards and are reduced by the layout, and AdamW
steps on the shards.  K10 runs on the gathered weights as in one process.
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch.models.xdecoder.model import (XDecoderModelConfig, forward_joint_train,
                                                     forward_seg_train)
from cullavo_tpu_torch.trainer.optimizer import (GradientTransformation, apply_updates,
                                                 global_norm)
from cullavo_tpu_torch.trainer.step import TrainState, share_metrics
from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map


def _cast_compute(tree, compute_dtype):
    """f32 leaves to ``compute_dtype`` (differentiable); others unchanged."""
    return tree_map(lambda a: a.to(compute_dtype) if a.dtype == torch.float32 else a, tree)


def _value_and_grad(loss_fn, params, *args):
    """(total, losses, gradient tree like params) of ``loss_fn(params,
    *args) -> (total, losses)``; a leaf the loss does not reach gets zeros."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()), params)
    with torch.enable_grad():
        total, losses = loss_fn(leaves, *args)
    wanted = [t for t in tree_leaves(leaves) if t.requires_grad]
    got = dict(zip(map(id, wanted), torch.autograd.grad(total, wanted, allow_unused=True)))
    grads = tree_map(lambda t: torch.zeros_like(t) if got.get(id(t)) is None else got[id(t)],
                     leaves)
    return total.detach(), {k: v.detach() for k, v in losses.items()}, grads


def _finish(tx: GradientTransformation, state: TrainState, total, losses, grads,
            norm_fn=global_norm):
    with torch.no_grad():
        updates, new_opt = tx.update(grads, state.opt_state, state.trainable)
        new_params = apply_updates(state.trainable, updates)
        metrics = {"loss_total": total.float(), "grad_norm": norm_fn(grads),
                   **{k: v.float() for k, v in losses.items()}}
    return TrainState(new_params, new_opt, state.step + 1), metrics


def make_xdecoder_train_step(cfg: XDecoderModelConfig, tx: GradientTransformation,
                             remat: bool = False, compute_dtype=None):
    """``step_fn(state, batch, text_embeds, generator) -> (state, metrics)``
    over ``forward_seg_train``; ``batch``: "image" [B, H, W, 3] normalized,
    the seg targets, optionally "grounding_tokens", "grounding_masks",
    "grounding_valid" (tensors on the parameters' device)."""

    def loss_fn(params, batch, text_embeds, generator):
        targets = {k: batch[k] for k in ("classes", "masks", "boxes", "valid",
                                          "grounding_masks", "grounding_valid") if k in batch}
        image, gtok = batch["image"], batch.get("grounding_tokens")
        if compute_dtype is not None:
            params = _cast_compute(params, compute_dtype)
            image = image.to(compute_dtype)
            text_embeds = text_embeds.to(compute_dtype)
            gtok = None if gtok is None else gtok.to(compute_dtype)
        losses = forward_seg_train(params, cfg, image, targets, text_embeds, generator,
                                   grounding_tokens=gtok, remat=remat)
        return sum(losses.values()), losses

    def step_fn(state: TrainState, batch, text_embeds, generator):
        return _finish(tx, state, *_value_and_grad(loss_fn, state.trainable, batch, text_embeds,
                                                   generator))

    return step_fn


def make_xdecoder_joint_train_step(cfg: XDecoderModelConfig, tx: GradientTransformation,
                                   remat: bool = False, compute_dtype=None, layout=None):
    """``step_fn(state, batch, generator) -> (state, metrics)`` over
    ``forward_joint_train``; ``batch`` is ``collate_joint``'s plus
    "class_ids" / "class_mask" and the normalized "image" (numpy or
    tensors; integer ids and f32 targets are not cast).  ``layout``: the
    parameter tree's ``Layout`` on a grid of processes (module docstring;
    ``state`` holds this rank's shards, ``tx`` clips by the layout's
    ``global_norm``); the metrics are then the global step's, equal on
    every rank."""
    parallel = None if layout is None else layout.par
    norm = {} if layout is None else {"norm_fn": layout.global_norm}

    def loss_fn(params, batch, generator):
        if layout is not None:
            params = layout.gather(params)
        if compute_dtype is not None:
            params = _cast_compute(params, compute_dtype)
            batch = dict(batch, image=torch.as_tensor(batch["image"]).to(compute_dtype))
        losses = forward_joint_train(params, cfg, batch, generator, data_axis=parallel,
                                     remat=remat)
        return sum(losses.values()), losses

    def step_fn(state: TrainState, batch, generator):
        if parallel is not None:
            parallel.begin_step()
        total, losses, grads = _value_and_grad(loss_fn, state.trainable, batch, generator)
        if parallel is not None:
            names = list(losses)
            summed = share_metrics(parallel, torch.stack([total.float()] + [
                losses[k].float() for k in names]))
            total, losses = summed[0], dict(zip(names, summed[1:]))
            grads = layout.reduce(grads)
        out = _finish(tx, state, total, losses, grads, **norm)
        if parallel is not None:
            parallel.end_step()
        return out

    return step_fn
