"""The DETR-style set criterion of the X-Decoder (counterpart of
``cullavo_tpu/models/xdecoder/criterion.py``), on padded targets with
validity masks:

  * ``loss_labels``: CE over the class logits, matched queries labeled with
    their target class and the rest with the background slot (weight
    ``eos_coef``);
  * ``loss_masks``: point-sampled sigmoid BCE and dice on the matched
    (query, target) masks, at importance-sampled points;
  * ``loss_boxes``: L1 and gIoU on normalized cxcywh boxes;
  * ``loss_captionings``: token CE of the captioning head;
  * ``loss_captions``: the noun-hash multi-positive contrastive loss, with
    a second Hungarian match of the captions to the queries the seg match
    left free;
  * ``match_groundings`` / ``loss_groundings`` / ``loss_grounding_ce``: the
    grounding queries matched to the phrases, their BCE + dice, and the
    query-phrase alignment CE;
  * ``set_criterion``: every prediction layer matched and supervised,
    with the per-loss ``top_x_layers`` cutoffs.

Random points come from one ``torch.Generator``, consumed in call order;
``pinned_coords`` (and the ``coords`` hooks) fix them from outside.

``data_axis`` (a ``parallel.BatchPart``; None for one process): the inputs
are this rank's images of a global batch and each loss returns this rank's
share (the ranks' shares sum to the global batch's loss, as JAX's losses
under ``shard_map`` mean over the data axis).  The matching stays per
image; ``num_masks`` and every other denominator are the global batch's;
the random points are drawn for the global batch and this rank's rows
taken; the caption loss, whose positives and negatives span images, takes
the features of every rank, gathered with gradient.
Scatters of matched slots follow the JAX package's CPU semantics: where
several target slots name one query (padded slots name query 0), the last
slot's value wins.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch.models.xdecoder.matcher import (batch_dice_cost, batch_sigmoid_ce_cost,
                                                       compute_match_costs, hungarian_match)
from cullavo_tpu_torch.ops.point_sample import (drawn_rows, drawn_shape, point_sample_batch,
                                                uncertain_point_coords, uniform_points)
from cullavo_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy, generalized_box_iou


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 133
    eos_coef: float = 0.1
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    cost_class: float = 2.0
    cost_mask: float = 5.0
    cost_dice: float = 5.0
    weight_ce: float = 2.0
    weight_mask: float = 5.0
    weight_dice: float = 5.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    weight_caption: float = 1.0
    weight_captioning: float = 2.0
    weight_retrieval_decoder: float = 2.0
    weight_retrieval_backbone: float = 8.0
    weight_grounding_ce: float = 0.4
    weight_grounding_bce: float = 1.0
    weight_grounding_dice: float = 1.0
    # a loss runs on the prediction of reference layer_id r (0 = final,
    # 1 = second-to-last, ...) iff r < its top_x_layers
    top_x_layers_mask: int = 10
    top_x_layers_class: int = 10
    top_x_layers_box: int = 10
    top_x_layers_caption: int = 3
    top_x_layers_captioning: int = 3
    top_x_layers_retrieval: int = 3
    top_x_layers_grounding: int = 3


def _scatter_last(base, idx, values):
    """base [B, Q]; idx, values [B, N]: base with base[b, idx[b, j]] =
    values[b, j], the largest j winning where indices repeat."""
    B, N = idx.shape
    order = torch.arange(N, device=idx.device).expand(B, N)
    last = torch.full(base.shape, -1, dtype=torch.long, device=idx.device).scatter_reduce(
        1, idx, order, reduce="amax")
    picked = torch.gather(values, 1, last.clamp_min(0))
    return torch.where(last >= 0, picked, base)


def _global(data_axis, x):
    """A denominator of this rank's rows -> the global batch's."""
    return x if data_axis is None else data_axis.sum(x)


def _rows(data_axis, per_image=1):
    return None if data_axis is None else data_axis.rows(per_image)


def _take_rows(x, idx):
    """x [B, Q, ...], idx [B, N] -> x[b, idx[b, n]] as [B, N, ...]."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.gather(x, 1, idx.reshape(shape).expand(*idx.shape, *x.shape[2:]))


def loss_labels(pred_logits, tgt_classes, src_idx, valid, cfg: CriterionConfig,
                data_axis=None):
    """Weighted CE: matched queries take their class, the rest background
    (the last class), which weighs ``eos_coef``."""
    B, Q, C1 = pred_logits.shape
    full = torch.full((B, Q), C1 - 1, dtype=torch.long, device=pred_logits.device)
    full = _scatter_last(full, src_idx, torch.where(valid, tgt_classes.long(),
                                                    torch.full_like(src_idx, C1 - 1)))
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, full[..., None])[..., 0]
    w = torch.where(full == C1 - 1, cfg.eos_coef, 1.0)
    return (nll * w).sum() / _global(data_axis, w.sum()).clamp_min(1.0)


def _bce_dice(pred_pts, tgt_pts):
    bce = (pred_pts.clamp_min(0) - pred_pts * tgt_pts
           + torch.nn.functional.softplus(-torch.abs(pred_pts))).mean(dim=-1)
    probs = torch.sigmoid(pred_pts)
    dice = 1.0 - (2.0 * (probs * tgt_pts).sum(-1) + 1.0) / (probs.sum(-1) + tgt_pts.sum(-1) + 1.0)
    return bce, dice


def loss_masks(pred_masks, tgt_masks, src_idx, valid, num_masks, generator,
               cfg: CriterionConfig, coords=None, data_axis=None):
    """Point-sampled BCE + dice on the matched masks; ``coords`` [B*N, P, 2]
    replaces the uncertainty sampling.  ``num_masks``: the global batch's."""
    B, Q, H, W = pred_masks.shape
    N = src_idx.shape[1]
    mp = _take_rows(pred_masks, src_idx).reshape(B * N, 1, H, W)
    mt = tgt_masks.reshape(B * N, 1, *tgt_masks.shape[2:])
    if coords is None:
        coords = uncertain_point_coords(mp, generator, cfg.num_points, cfg.oversample_ratio,
                                        cfg.importance_sample_ratio, _rows(data_axis, N))
    pred_pts = point_sample_batch(mp, coords)[:, 0]
    tgt_pts = point_sample_batch(mt.float(), coords)[:, 0]
    bce, dice = _bce_dice(pred_pts, tgt_pts)
    v = valid.reshape(B * N).float()
    denom = torch.as_tensor(num_masks).clamp_min(1.0)
    return (bce * v).sum() / denom, (dice * v).sum() / denom


def loss_boxes(pred_boxes, tgt_boxes, src_idx, valid, num_masks):
    """L1 + gIoU on the matched boxes (cxcywh in [0, 1])."""
    matched = _take_rows(pred_boxes, src_idx)
    v = valid.float()
    denom = torch.as_tensor(num_masks).clamp_min(1.0)
    l1 = (torch.abs(matched - tgt_boxes).sum(dim=-1) * v).sum() / denom
    a = box_cxcywh_to_xyxy(matched.reshape(-1, 4))
    b = box_cxcywh_to_xyxy(tgt_boxes.reshape(-1, 4))
    giou = torch.diagonal(generalized_box_iou(a, b)).reshape(matched.shape[:2])
    return l1, ((1.0 - giou) * v).sum() / denom


def loss_captionings(pred_captionings, tgt_token_embs, tgt_token_ids, token_mask, vocab_embs,
                     logit_scale, data_axis=None):
    """Token CE of the captioning head against the vocabulary embeddings
    (raw dot products, as the reference), normalized by mask.sum() + 1."""
    logits = torch.einsum("btd,vd->btv", pred_captionings, vocab_embs)[:, :-1]
    labels = tgt_token_ids[:, 1:].long()
    mask = token_mask[:, 1:].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 2, labels[..., None])[..., 0]
    return (nll * mask).sum() / (_global(data_axis, mask.sum()) + 1.0)


def loss_groundings(pred_gmasks, tgt_gmasks, gvalid, generator, cfg: CriterionConfig,
                    data_axis=None):
    """BCE + dice of the grounding masks (already matched to their phrases)."""
    B, G, H, W = pred_gmasks.shape
    mp = pred_gmasks.reshape(B * G, 1, H, W)
    mt = tgt_gmasks.reshape(B * G, 1, *tgt_gmasks.shape[2:])
    coords = uncertain_point_coords(mp, generator, cfg.num_points, cfg.oversample_ratio,
                                    cfg.importance_sample_ratio, _rows(data_axis, G))
    bce, dice = _bce_dice(point_sample_batch(mp, coords)[:, 0],
                          point_sample_batch(mt.float(), coords)[:, 0])
    v = gvalid.reshape(B * G).float()
    denom = _global(data_axis, v.sum()).clamp_min(1.0)
    return (bce * v).sum() / denom, (dice * v).sum() / denom


def _norm(x):
    # sqrt(sum + eps^2), not norm + eps: finite gradients at an all-zero row
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)


def _logit_scale(logit_scale):
    return torch.exp(logit_scale.clamp(max=float(np.log(100.0))))


def loss_captions(pred_captions, src_idx, valid, labels, labels_hash, class_embs, caption_embs,
                  caption_hash, caption_valid, logit_scale, data_axis=None):
    """Noun-hash multi-positive contrastive caption loss: matched queries
    against their class-name embeddings, and the captions / nouns against
    the queries a second Hungarian match (cosine cost) assigns among those
    the seg match left free; hash-equal pairs are positives, across the
    batch (under ``data_axis`` the global batch's, gathered after the
    per-image match)."""
    B, Q, D = pred_captions.shape
    N = src_idx.shape[1]
    P = caption_embs.shape[1]
    v_all = _norm(pred_captions)
    v_cls = _take_rows(v_all, src_idx)
    t_cls = _norm(class_embs)[labels.long().clamp(0, class_embs.shape[0] - 1)]
    t_cap = _norm(caption_embs)
    sim = torch.einsum("bqd,bpd->bqp", v_all, t_cap)
    matched = _scatter_last(torch.zeros((B, Q), dtype=torch.bool, device=valid.device),
                            src_idx, valid)
    cost = -sim + 1e4 * matched[:, :, None].to(sim.dtype)
    cap_src, cap_ok = hungarian_match(cost, caption_valid.sum(dim=1))
    # drop caption pairs that had to land on seg-matched queries
    cap_ok = cap_ok & caption_valid.bool() & ~torch.gather(matched, 1, cap_src)
    v_cap = _take_rows(v_all, cap_src)
    h_cls = torch.where(valid, labels_hash, torch.full_like(labels_hash, -1))
    h_cap = torch.where(cap_ok, caption_hash, torch.full_like(caption_hash, -2))
    parts = [v_cls, v_cap, t_cls, t_cap, h_cls, h_cap, valid.float(), cap_ok.float()]
    if data_axis is not None:
        parts = [data_axis.gather(x) for x in parts]
        B = data_axis.total
    v_cls, v_cap, t_cls, t_cap, h_cls, h_cap, ok_cls, ok_cap = parts
    v = torch.cat([v_cls.reshape(B * N, D), v_cap.reshape(B * P, D)])
    t = torch.cat([t_cls.reshape(B * N, D), t_cap.reshape(B * P, D)])
    h = torch.cat([h_cls.reshape(-1), h_cap.reshape(-1)])
    ok = torch.cat([ok_cls.reshape(-1), ok_cap.reshape(-1)])
    logits = _logit_scale(logit_scale) * (v @ t.t())
    pos = (h[:, None] == h[None, :]).float() * ok[:, None] * ok[None, :]
    neg_inf = -1e9 * (1.0 - ok)

    def soft_ce(lg, p, row_ok):
        target = p / p.sum(-1, keepdim=True).clamp_min(1.0)
        row_loss = -(target * torch.log_softmax(lg, dim=-1)).sum(dim=-1)
        has_pos = (p.sum(-1) > 0).float() * row_ok
        return (row_loss * has_pos).sum() / has_pos.sum().clamp_min(1.0)

    loss = 0.5 * (soft_ce(logits + neg_inf[None], pos, ok)
                  + soft_ce(logits.t() + neg_inf[None], pos.t(), ok))
    return loss if data_axis is None else data_axis.share(loss)


def match_groundings(g_masks_all, g_texts_all, tgt_gmasks, g_class_embs, gvalid, logit_scale,
                     generator, cfg: CriterionConfig, coords=None, data_axis=None):
    """Hungarian assignment of the grounding queries g_masks_all [B, Qg, h,
    w] / g_texts_all [B, Qg, D] to the phrases (tgt_gmasks [B, G, H, W],
    g_class_embs [B, G, D], gvalid [B, G]): cost_class * -softmax over
    queries of the similarity + point BCE + point dice at uniform points.
    Returns (src_idx [B, G], match_valid [B, G], sim [B, Qg, G])."""
    B = g_masks_all.shape[0]
    sim = _logit_scale(logit_scale) * torch.einsum("bqd,bgd->bqg", _norm(g_texts_all),
                                                   _norm(g_class_embs))
    if coords is None:
        rows = _rows(data_axis)
        coords = drawn_rows(uniform_points(drawn_shape((B, cfg.num_points, 2), rows), generator,
                                           g_masks_all.device), rows)
    with torch.no_grad():
        pred_pts = point_sample_batch(g_masks_all.detach(), coords)
        tgt_pts = point_sample_batch(tgt_gmasks.float(), coords)
        cost = (cfg.cost_class * -torch.softmax(sim.detach(), dim=1)
                + cfg.cost_mask * batch_sigmoid_ce_cost(pred_pts, tgt_pts)
                + cfg.cost_dice * batch_dice_cost(pred_pts, tgt_pts))
        cost = torch.where(gvalid.bool()[:, None, :], cost, torch.full_like(cost, 1e8))
    src_idx, match_valid = hungarian_match(cost, gvalid.long().sum(dim=1))
    return src_idx, match_valid & gvalid.bool(), sim


def loss_grounding_ce(sim, src_idx, match_valid, grounding_hash, data_axis=None):
    """Query-phrase alignment CE: target one at each (matched query,
    phrase), smoothed over same-hash phrases; a softmax over the grounding
    queries per phrase."""
    B, Qg, G = sim.shape
    okf = match_valid.float()
    onehot = torch.nn.functional.one_hot(src_idx, Qg).float().transpose(1, 2) * okf[:, None, :]
    same = ((grounding_hash[:, :, None] == grounding_hash[:, None, :]).float()
            * okf[:, :, None] * okf[:, None, :])
    gt = torch.einsum("bqg,bgh->bqh", onehot, same / same.sum(-1, keepdim=True).clamp_min(1.0))
    logp = torch.log_softmax(sim.transpose(1, 2), dim=-1)
    row_loss = -(gt.transpose(1, 2) * logp).sum(dim=-1)
    return (row_loss * okf).sum() / _global(data_axis, okf.sum()).clamp_min(1.0)


def set_criterion(outputs: dict, targets: dict, cfg: CriterionConfig, generator,
                  data_axis=None, return_indices=False,
                  pinned_coords: Optional[dict] = None):
    """The deep-supervised loss dict.  Layer i of [final] + aux is matched
    (match costs at min(num_points, 3136) uniform points) and supervised;
    keys carry the reference layer_id: ``loss_ce`` for the final
    prediction, ``loss_ce_{r}`` for layer_id r.  ``return_indices="all"``
    also returns {layer_id: (src_idx, valid)}; True, the final layer's.
    ``pinned_coords``: {layer_id: {"match": [B, P, 2], "loss": [B*N, P,
    2]}}.  ``data_axis``: the module docstring's (``num_masks`` is the
    global batch's count; JAX's pmean of it and the mean of the devices'
    losses come to the same)."""
    tgt_valid = targets["valid"].bool()
    n_valid = tgt_valid.sum(dim=1)
    num_masks = _global(data_axis, tgt_valid.sum().float()).clamp_min(1.0)
    losses, all_indices = {}, {}
    layers = [outputs] + list(outputs.get("aux_outputs", []))
    L = len(layers)
    for li, out in enumerate(layers):
        ref_id = 0 if li == 0 else L - li
        suffix = "" if li == 0 else f"_{ref_id}"
        pin = (pinned_coords or {}).get(ref_id, {})
        cost = compute_match_costs(out["pred_logits"], out["pred_masks"], targets["classes"],
                                   targets["masks"], tgt_valid, generator,
                                   num_points=min(cfg.num_points, 3136),
                                   cost_class=cfg.cost_class, cost_mask=cfg.cost_mask,
                                   cost_dice=cfg.cost_dice, coords=pin.get("match"),
                                   rows=_rows(data_axis))
        src_idx, valid = hungarian_match(cost, n_valid)
        valid = valid & tgt_valid
        all_indices[ref_id] = (src_idx, valid)
        if ref_id < cfg.top_x_layers_class:
            losses[f"loss_ce{suffix}"] = cfg.weight_ce * loss_labels(
                out["pred_logits"], targets["classes"], src_idx, valid, cfg, data_axis)
        if ref_id < cfg.top_x_layers_mask:
            bce, dice = loss_masks(out["pred_masks"], targets["masks"], src_idx, valid,
                                   num_masks, generator, cfg, coords=pin.get("loss"),
                                   data_axis=data_axis)
            losses[f"loss_mask_bce{suffix}"] = cfg.weight_mask * bce
            losses[f"loss_mask_dice{suffix}"] = cfg.weight_dice * dice
        if (ref_id < cfg.top_x_layers_box and out.get("pred_boxes") is not None
                and "boxes" in targets):
            l1, giou = loss_boxes(torch.sigmoid(out["pred_boxes"]), targets["boxes"], src_idx,
                                  valid, num_masks)
            losses[f"loss_bbox{suffix}"] = cfg.weight_bbox * l1
            losses[f"loss_giou{suffix}"] = cfg.weight_giou * giou
    if return_indices == "all":
        return losses, all_indices
    if return_indices:
        return losses, all_indices[0]
    return losses
