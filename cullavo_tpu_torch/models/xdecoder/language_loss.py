"""Vision-language contrastive losses (counterpart of
``cullavo_tpu/models/xdecoder/language_loss.py``): the scaled similarity,
soft cross-entropy, symmetric InfoNCE, the multi-positive form, the
image-text contrastive loss of the VLP pass and its fine-grained
query-token term.  ``data_axis`` (a ``parallel.BatchPart``; None for one
process): the features are this rank's rows of a global batch; the
batch-coupled losses gather every rank's rows with gradient (JAX's
``all_gather`` inside ``shard_map``) and return this rank's share of the
global batch's loss."""
from __future__ import annotations

import torch

from cullavo_tpu_torch.models.xdecoder.decoder import l2_normalize


def _whole(data_axis, *xs):
    return xs if data_axis is None else tuple(data_axis.gather(x) for x in xs)


def _share(data_axis, loss):
    return loss if data_axis is None else data_axis.share(loss)


def _scale(temperature):
    if isinstance(temperature, float):
        return temperature
    return torch.exp(temperature).clamp(max=100.0)


def vl_similarity(image_feat, text_feat, temperature=1.0):
    """Scaled similarity logits [..., I, J]."""
    return _scale(temperature) * torch.einsum("...id,...jd->...ij", image_feat, text_feat)


def soft_cross_entropy(logits, soft_targets):
    logp = torch.log_softmax(logits, dim=-1)
    return -(soft_targets * logp).sum(dim=-1).mean()


def _ce_diag(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.diagonal(logp).mean()


def vl_contrastive_loss(image_feat, text_feat, temperature=1.0, data_axis=None):
    """Symmetric InfoNCE over normalized [N, D] features."""
    image_feat, text_feat = _whole(data_axis, image_feat, text_feat)
    logits = (image_feat @ text_feat.t()) * _scale(temperature)
    return _share(data_axis, 0.5 * (_ce_diag(logits) + _ce_diag(logits.t())))


def multilabel_contrastive_loss(image_feat, text_feat, positive_mask, temperature=1.0):
    """Multi-positive soft-target contrastive loss; ``positive_mask``
    [N_img, N_txt] marks the positive pairs."""
    logits = vl_similarity(image_feat, text_feat, temperature)
    pos = positive_mask.float()
    row = pos / pos.sum(-1, keepdim=True).clamp_min(1.0)
    col = pos.t() / pos.t().sum(-1, keepdim=True).clamp_min(1.0)
    return 0.5 * (soft_cross_entropy(logits, row) + soft_cross_entropy(logits.t(), col))


def image_text_contrastive_loss(image_emb, text_emb, logit_scale, data_axis=None):
    """The VLP pass's ITC loss: normalize, then symmetric InfoNCE."""
    return vl_contrastive_loss(l2_normalize(image_emb), l2_normalize(text_emb), logit_scale,
                               data_axis)


def fine_grained_itc_loss(query_emb, token_emb, token_mask, logit_scale, data_axis=None):
    """Object queries [B, Q, D] against the batch's caption tokens [B, T, D]
    (mask [B, T]): soft targets weighted by token position (mask *
    cumsum(mask)), image-to-text and text-to-image combined 0.7 / 0.3."""
    query_emb, token_emb, token_mask = _whole(data_axis, query_emb, token_emb, token_mask)
    B, Q, D = query_emb.shape
    T = token_emb.shape[1]
    v, t = l2_normalize(query_emb), l2_normalize(token_emb)
    scale = torch.exp(logit_scale).clamp(max=100.0)
    m = token_mask.float()
    w = m * torch.cumsum(m, dim=1)
    valid = m.reshape(B * T)
    eye = torch.eye(B, device=query_emb.device, dtype=torch.float32)
    gt = (eye[:, :, None] * w[None]).reshape(B, B * T)
    gt = gt / (gt.sum(dim=1, keepdim=True) + 1e-7)
    tt = t.reshape(B * T, D)
    logits_vt = scale * torch.einsum("bqd,kd->bqk", v, tt).mean(dim=1)
    bias = torch.where(valid > 0, 0.0, -1e30)[None]
    loss_vt = -(gt * torch.log_softmax(logits_vt + bias, dim=-1)).sum(dim=-1).mean()
    logits_tv = scale * torch.einsum("kd,bqd->kbq", tt, v).mean(dim=-1)
    ce_rows = -(gt.t() * torch.log_softmax(logits_tv, dim=-1)).sum(dim=-1)
    loss_tv = (ce_rows * valid).sum() / valid.sum().clamp_min(1.0)
    return _share(data_axis, loss_vt * 0.7 + loss_tv * 0.3)
