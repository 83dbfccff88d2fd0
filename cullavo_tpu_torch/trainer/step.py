"""The CuLLaVO training step: Q-LoRA fine-tuning of LLaVA (counterpart of
``cullavo_tpu/trainer/step.py``): forward, masked cross-entropy, backward,
clip, AdamW step.

Per-sample ``weights`` make an empty-sample batch a no-op.  With a
``parallel.Layout`` of the trainable tree (several processes: its
``ParallelContext`` is the grid) every rank is handed the same global batch
and takes its rows (its part of the batch group's): its loss is its
weighted NLL sum over the global weight sum (summed over the batch group
before the backward, which does not depend on the parameters), its LoRA
dropout masks are its rows of the global batch's, and the gradient tree is
summed over the ranks that hold other rows (``Layout.reduce``), so that the
ranks take the one-process step on the global batch (JAX's
``shard_train_step`` is that step under SPMD).  A DDP wrapper would average
per-rank means, which is another loss when the ranks' token counts differ.

With fsdp or tensor axes the state and the frozen base (a tree of
``parallel.Shard``s) hold this rank's shards: the step gathers the
non-layer leaves whole (the vision tower, the projector, ``embed_tokens``,
``lm_head``, the final norm) and hands ``llama_forward`` its stacked layer
leaves and LLM adapters as ``Shard``s, gathered a layer at a time inside
the checkpointed layer function; the gradients come back as shards (the
gathers' backward), are reduced by the layout, and AdamW steps on the
shards.  On the data axis alone every spec is None: the gathers are the
identity and the reduction is the flat sum over the batch group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from cullavo_tpu_torch.models.llava.config import LlavaConfig
from cullavo_tpu_torch.models.llava.lora import LoraConfig, apply_trainable
from cullavo_tpu_torch.models.llava.modeling import _cast_params, llava_forward
from cullavo_tpu_torch.parallel.mesh import Layout, ParallelContext, gather_tree
from cullavo_tpu_torch.trainer.optimizer import (GradientTransformation, apply_updates,
                                                 global_norm)
from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    """Trainable parameters (LoRA adapters + projector + lm_head +
    embed_tokens), optimizer state and step count."""
    trainable: Any
    opt_state: Any
    step: int


def _shifted_targets(labels, attention_mask, weights, ignore_index):
    """(safe labels, validity, per-token weights) of the shifted targets."""
    lab = labels[:, 1:].long()
    valid = (attention_mask[:, 1:] != 0) & (lab != ignore_index)
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    return safe, valid, valid.float() * weights[:, None].float()


def _weighted_nll(logits, safe, valid, w):
    """(sum of -log p(target) * w over valid positions, sum of w)."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    ll = logprobs.gather(-1, safe[..., None])[..., 0]
    return (torch.where(valid, -ll, torch.zeros_like(ll)) * w).sum(), w.sum()


def loss_weight_sum(labels, attention_mask, weights, parallel=None, ignore_index: int = -100):
    """The loss's denominator: the sum of the per-token weights of the valid
    shifted targets (with ``parallel``, of every part's rows: the batch
    group's sum)."""
    w = _shifted_targets(labels, attention_mask, weights, ignore_index)[2].sum()
    return w if parallel is None else parallel.sum_rows(w)


def weighted_causal_lm_loss(logits, labels, attention_mask, weights,
                            ignore_index: int = -100, denom=None):
    """Shifted CE with per-sample weights; mean over weighted valid tokens
    (``denom``: another denominator, such as the global batch's)."""
    safe, valid, w = _shifted_targets(labels, attention_mask, weights, ignore_index)
    total, own = _weighted_nll(logits[:, :-1], safe, valid, w)
    return total / (own if denom is None else denom).clamp_min(1.0)


def chunked_weighted_causal_lm_loss(hidden, lm_head, labels, attention_mask, weights,
                                    chunk: int = 512, ignore_index: int = -100, denom=None):
    """``weighted_causal_lm_loss(lm_logits(hidden), ...)`` computed in
    sequence chunks, each under ``torch.utils.checkpoint``: a chunk's
    ``hidden @ lm_head`` and softmax are rematerialized in the backward, so
    the [B, T, V] f32 logits never exist."""
    safe, valid, w = _shifted_targets(labels, attention_mask, weights, ignore_index)

    def chunk_fn(h_c, safe_c, valid_c, w_c):
        logits = torch.matmul(h_c.float(), lm_head.float())
        return torch.stack(_weighted_nll(logits, safe_c, valid_c, w_c))

    sums = hidden.new_zeros((2,), dtype=torch.float32)
    for c0 in range(0, hidden.shape[1] - 1, chunk):
        sl = slice(c0, min(c0 + chunk, hidden.shape[1] - 1))
        sums = sums + checkpoint(chunk_fn, hidden[:, sl], safe[:, sl], valid[:, sl], w[:, sl],
                                 use_reentrant=False)
    return sums[0] / (sums[1] if denom is None else denom).clamp_min(1.0)


def share_metrics(parallel: ParallelContext, x: torch.Tensor) -> torch.Tensor:
    """This part's share of a metric -> the global value, equal on every rank:
    summed over the batch group, then taken from the tensor group's first
    rank (its ranks computed the same rows)."""
    x = parallel.sum_rows(x.detach().clone())
    if parallel.tensor > 1:
        root = parallel.process_index - parallel.axis_index("tensor")
        torch.distributed.broadcast(x, root, group=parallel.group("tensor"))
    return x


def make_train_step(cfg: LlavaConfig, lora_cfg: Optional[LoraConfig],
                    tx: GradientTransformation, remat: bool = True, compute_dtype=None,
                    loss_chunk: Optional[int] = None, layout: Optional[Layout] = None):
    """Returns ``step_fn(state, frozen_params, batch, rng) -> (state, metrics)``.

    ``frozen_params`` is the base tree (NF4 / bf16, not updated);
    ``state.trainable`` holds the LoRA adapters, projector, lm_head and
    embed_tokens.  ``compute_dtype=torch.bfloat16`` casts the f32 masters
    (and the other f32 leaves, scales of quantized weights excepted) for
    the forward: mixed precision over f32 masters.  ``rng`` is a CPU
    ``torch.Generator`` for the LoRA dropout (None: no dropout).  ``batch``:
    ``input_ids``, ``attention_mask``, ``labels``, ``weights`` and
    optionally ``pixel_values``.  The returned state is made of new tensors;
    ``metrics`` are ``loss_llm`` and the UNCLIPPED ``grad_norm``, as f32
    scalar tensors.  A vision adapter's ``mask`` is a constant: its
    gradient is zero and it never moves.  ``layout``: the trainable tree's
    ``Layout`` on a grid of processes: this rank's rows of the global
    ``batch`` (module docstring), ``state`` its shards (and
    ``frozen_params`` ``Shard`` leaves); ``tx`` clips by its
    ``global_norm``, and the metrics are the global step's, equal on every
    rank."""
    parallel = None if layout is None else layout.par
    scaling = lora_cfg.scaling if lora_cfg else 0.0
    dropout = lora_cfg.dropout if lora_cfg else 0.0

    def _cast(tree):
        if tree is None or compute_dtype is None:
            return tree
        return _cast_params(tree, compute_dtype)

    def loss_fn(trainable, frozen_params, batch, rng, denom, rows):
        if layout is not None:
            trainable = layout.gather(trainable, stacked=(("lora", "language_model"),))
            frozen_params = gather_tree(frozen_params, stacked=(("language_model", "layers"),))
        full, lora = apply_trainable(frozen_params, trainable)
        full, lora = _cast(full), _cast(lora)
        out, _ = llava_forward(full, cfg, batch["input_ids"], batch.get("pixel_values"),
                               batch["attention_mask"], lora=lora, lora_scaling=scaling,
                               lora_dropout=dropout, dropout_rng=rng, remat=remat,
                               return_hidden=loss_chunk is not None, dropout_rows=rows)
        if loss_chunk is None:
            return weighted_causal_lm_loss(out, batch["labels"], batch["attention_mask"],
                                           batch["weights"], denom=denom)
        lm = full["language_model"]
        head = lm["lm_head"] if "lm_head" in lm else lm["embed_tokens"].T
        return chunked_weighted_causal_lm_loss(out, head, batch["labels"],
                                               batch["attention_mask"], batch["weights"],
                                               chunk=loss_chunk, denom=denom)

    def value_and_grad(trainable, frozen_params, batch, rng, denom, rows):
        """(loss, gradient tree shaped like ``trainable``)."""
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
        for ab in ((leaves.get("lora") or {}).get("vision_tower") or {}).values():
            if "mask" in ab:
                ab["mask"].requires_grad_(False)
        with torch.enable_grad():
            loss = loss_fn(leaves, frozen_params, batch, rng, denom, rows)
        wanted = [t for t in tree_leaves(leaves) if t.requires_grad]
        got = dict(zip(map(id, wanted), torch.autograd.grad(loss, wanted, allow_unused=True)))
        grads = tree_map(lambda t: torch.zeros_like(t) if got.get(id(t)) is None
                         else got[id(t)], leaves)
        return loss.detach(), grads

    norm = global_norm if layout is None else layout.global_norm

    def step_fn(state: TrainState, frozen_params, batch, rng):
        rows = None
        if parallel is not None:
            parallel.begin_step()
            B = batch["input_ids"].shape[0]
            sl = parallel.rows(B)
            batch, rows = {k: v[sl] for k, v in batch.items()}, (sl.start, B)
        denom = loss_weight_sum(batch["labels"], batch["attention_mask"], batch["weights"],
                                parallel)
        loss, grads = value_and_grad(state.trainable, frozen_params, batch, rng, denom, rows)
        if parallel is not None:
            loss = share_metrics(parallel, loss)
            grads = layout.reduce(grads)
        with torch.no_grad():
            updates, new_opt = tx.update(grads, state.opt_state, state.trainable)
            new_trainable = apply_updates(state.trainable, updates)
            gnorm = norm(grads)
        if parallel is not None:
            parallel.end_step()
        return (TrainState(new_trainable, new_opt, state.step + 1),
                {"loss_llm": loss, "grad_norm": gnorm})

    return step_fn
