"""GeneralizedXdecoder (counterpart of
``cullavo_tpu/models/xdecoder/model.py``): backbone (FocalNet or SAM-ViT)
+ pixel decoder (FPN or deformable encoder) + X-Decoder + language encoder,
the dense eval forward, and the semantic / panoptic / instance inferences.

``forward_eval`` takes images ``[B, H, W, 3]`` as JAX does and runs the
trunk channels-first in the parameters' dtype; ``evaluate_grounding``
(referring segmentation) runs the decoder's grounding slots on the same
trunk.  The per-pixel parts of the
inferences (``semantic_inference_argmax``, ``panoptic_inference_device``,
``instance_inference_device``) run on the tensors' device, so only compact
maps and Q-sized vectors reach the host; ``panoptic_assemble_host`` and
``unpack_mask_planes`` are their numpy tails.  ``evaluate_retrieval_embedding``
(the class-token caption embedding and the res5 ``backbone_proj``
ensemble) and ``evaluate_classification`` (the class token's logits) run
on the same trunk; ``evaluate_dispatch`` picks among the eval modes.
Training: the seg forward (``forward_seg_train``) and the joint objective
(``forward_joint_train``) through ``criterion.set_criterion``.  The
VLP-only training forward (``forward_vlp_train``), which no entry point
reaches, waits for the VLP training slice and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch.models.xdecoder import text_encoder as te
from cullavo_tpu_torch.models.xdecoder.criterion import (CriterionConfig, loss_captionings,
                                                         loss_captions, loss_grounding_ce,
                                                         loss_groundings, match_groundings,
                                                         set_criterion)
from cullavo_tpu_torch.models.xdecoder.davit import DaViTConfig, davit_forward, init_davit_params
from cullavo_tpu_torch.models.xdecoder.decoder import (XDecoderConfig, init_xdecoder_params,
                                                       l2_normalize, resize, xdecoder_forward)
from cullavo_tpu_torch.models.xdecoder.deform_encoder import (DeformEncoderConfig,
                                                              deform_encoder_forward,
                                                              init_deform_encoder_params)
from cullavo_tpu_torch.models.xdecoder.focalnet import (FocalNetConfig, focalnet_forward,
                                                        init_focalnet_params)
from cullavo_tpu_torch.models.xdecoder.fpn import FPNConfig, fpn_forward, init_fpn_params
from cullavo_tpu_torch.models.xdecoder.language_loss import (fine_grained_itc_loss,
                                                             image_text_contrastive_loss)
from cullavo_tpu_torch.models.xdecoder.sam_vit import (SamVitConfig, init_sam_vit_params,
                                                       sam_vit_forward)
from cullavo_tpu_torch.models.xdecoder.text_encoder import (TextEncoderConfig,
                                                            init_text_encoder_params)

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class XDecoderModelConfig:
    # ``backbone`` matches ``backbone_name`` (FocalNetConfig | DaViTConfig |
    # SamVitConfig);
    # ``fpn`` matches ``encoder_name`` (FPNConfig | DeformEncoderConfig)
    backbone: object = dataclasses.field(default_factory=FocalNetConfig)
    fpn: object = dataclasses.field(default_factory=FPNConfig)
    decoder: XDecoderConfig = dataclasses.field(default_factory=XDecoderConfig)
    text: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    criterion: CriterionConfig = dataclasses.field(default_factory=CriterionConfig)
    num_classes: int = 133
    object_mask_threshold: float = 0.8
    overlap_threshold: float = 0.8
    test_topk_per_image: int = 100
    backbone_name: str = "focal"
    encoder_name: str = "transformer_encoder_fpn"


def _backbone_apply(params, cfg: XDecoderModelConfig, images, remat: bool = False):
    if cfg.backbone_name in ("focal", "focal_dw"):
        return focalnet_forward(params, cfg.backbone, images, remat=remat)
    if cfg.backbone_name == "davit":
        return davit_forward(params, cfg.backbone, images)
    if cfg.backbone_name == "vit":
        return sam_vit_forward(params, cfg.backbone, images)
    raise KeyError(f"backbone {cfg.backbone_name!r}")


def _encoder_apply(params, cfg: XDecoderModelConfig, feats):
    if cfg.encoder_name == "transformer_encoder_fpn":
        return fpn_forward(params, cfg.fpn, feats)
    if cfg.encoder_name == "transformer_encoder_deform":
        return deform_encoder_forward(params, cfg.fpn, feats)
    raise KeyError(f"encoder {cfg.encoder_name!r}")


def _backbone_last_channels(cfg: XDecoderModelConfig) -> int:
    bb = cfg.backbone
    if isinstance(bb, FocalNetConfig):
        return bb.num_features[-1]
    if isinstance(bb, DaViTConfig):
        return bb.embed_dims[-1]
    if isinstance(bb, SamVitConfig):
        return bb.out_dims[-1]
    raise AttributeError(f"cannot infer channels for {type(bb).__name__}")


def tiny_xdecoder_config() -> XDecoderModelConfig:
    return XDecoderModelConfig(
        backbone=FocalNetConfig(embed_dim=16, depths=(1, 1, 1, 1), focal_levels=(2, 2, 2, 2),
                                focal_windows=(3, 3, 3, 3)),
        fpn=FPNConfig(in_channels=(16, 32, 64, 128), conv_dim=64, mask_dim=32, gn_groups=8,
                      enc_layers=2, enc_heads=4, enc_ffn=128),
        decoder=XDecoderConfig(hidden_dim=64, num_queries=9, nheads=4, dim_feedforward=128,
                               dec_layers=3, mask_dim=32, dim_proj=64, contxt_len=8,
                               in_channels=64),
        text=TextEncoderConfig(vocab_size=64, width=32, heads=4, layers=2, context_length=8,
                               dim_lang=64),
        criterion=CriterionConfig(num_classes=6, num_points=256),
        num_classes=6,
    )


def init_xdecoder_model_params(cfg: XDecoderModelConfig, gen: torch.Generator, device,
                               dtype=torch.float32) -> dict:
    """Random parameters from ``gen`` on ``device`` (the port's layouts)."""
    if cfg.backbone_name in ("focal", "focal_dw"):
        backbone = init_focalnet_params(cfg.backbone, gen, device, dtype)
    elif cfg.backbone_name == "davit":
        backbone = init_davit_params(cfg.backbone, gen, device, dtype)
    elif cfg.backbone_name == "vit":
        backbone = init_sam_vit_params(cfg.backbone, gen, device, dtype)
    else:
        raise KeyError(f"backbone {cfg.backbone_name!r}")
    if cfg.encoder_name == "transformer_encoder_fpn":
        fpn = init_fpn_params(cfg.fpn, gen, device, dtype)
    else:
        fpn = init_deform_encoder_params(cfg.fpn, gen, device, dtype)
    return {
        "backbone": backbone, "fpn": fpn,
        "decoder": init_xdecoder_params(cfg.decoder, gen, device, dtype),
        "text": init_text_encoder_params(cfg.text, gen, device, dtype),
        # res5 -> language space, for the backbone-ensemble retrieval
        "backbone_proj": (torch.randn((_backbone_last_channels(cfg), cfg.text.dim_lang),
                                      generator=gen, device=device) * 0.02).to(dtype),
    }


def normalize_images(images_uint8_nhwc: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images_uint8_nhwc.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images_uint8_nhwc.device)
    return (images_uint8_nhwc.float() - mean) / std


def _param_dtype(params):
    return params["decoder"]["query_feat"].dtype


def _trunk(params, cfg: XDecoderModelConfig, images, remat: bool = False):
    """images [B, H, W, 3] -> (backbone features, mask_features, pyramid)."""
    x = images.permute(0, 3, 1, 2).to(_param_dtype(params))
    feats = _backbone_apply(params["backbone"], cfg, x, remat=remat)
    mask_features, _, pyramid = _encoder_apply(params["fpn"], cfg, feats)
    return feats, mask_features, pyramid


def backbone_and_pixel_decoder(params, cfg: XDecoderModelConfig, images, remat: bool = False):
    """images [B, H, W, 3] -> (mask_features [B, mask_dim, H/4, W/4], the
    pyramid [res5', res4', res3'] channels-first).  ``remat`` checkpoints
    each backbone block."""
    _, mask_features, pyramid = _trunk(params, cfg, images, remat)
    return mask_features, pyramid


def forward_eval(params, cfg: XDecoderModelConfig, images, text_class_embeds,
                 out_size: Optional[tuple] = None):
    """Dense eval forward: (class logits [B, Q, C+1], mask logits [B, Q, h, w]
    resized to ``out_size`` (bicubic) when given, boxes [B, Q, 4])."""
    mask_features, pyramid = backbone_and_pixel_decoder(params, cfg, images)
    out = xdecoder_forward(params["decoder"], cfg.decoder, pyramid, mask_features,
                           text_class_embeds=text_class_embeds,
                           logit_scale=params["text"]["logit_scale"], task="eval")
    mask_pred = out["pred_masks"]
    if out_size is not None:
        mask_pred = resize(mask_pred, out_size, "bicubic")
    return out["pred_logits"], mask_pred, out["pred_boxes"]


def semantic_inference(mask_cls, mask_pred, keep_background=False):
    """[Q, C+1], [Q, H, W] -> [C, H, W]."""
    probs = torch.softmax(mask_cls, dim=-1)
    if not keep_background:
        probs = probs[..., :-1]
    return torch.einsum("qc,qhw->chw", probs, torch.sigmoid(mask_pred))


def semantic_inference_argmax(mask_cls, mask_pred, keep_background=False):
    """``argmax_c semantic_inference(...)`` -> [H, W] int32, as one
    [C, Q] @ [Q, H*W] product in f32."""
    Q, H, W = mask_pred.shape
    probs = torch.softmax(mask_cls.float(), dim=-1)
    if not keep_background:
        probs = probs[..., :-1]
    m = torch.sigmoid(mask_pred.float()).reshape(Q, H * W)
    scores = probs.t() @ m
    return torch.argmax(scores, dim=0).to(torch.int32).reshape(H, W)


def _valid_map(H, W, valid_hw, device):
    if valid_hw is None:
        return torch.ones((H, W), dtype=torch.bool, device=device)
    hw = torch.as_tensor(valid_hw, device=device)
    return ((torch.arange(H, device=device)[:, None] < hw[0])
            & (torch.arange(W, device=device)[None, :] < hw[1]))


def instance_inference(mask_cls, mask_pred, num_classes: int, topk: int, thing_mask=None):
    """Top-k (query, class) detections: binary masks [K, H, W], scores [K],
    classes [K]."""
    Q = mask_cls.shape[0]
    flat = torch.softmax(mask_cls, dim=-1)[:, :-1].reshape(-1)
    if thing_mask is not None:
        flat = flat * thing_mask.to(flat.dtype).repeat(Q)
    top_scores, top_idx = torch.topk(flat, min(topk, flat.shape[0]))
    masks = mask_pred[top_idx // num_classes]
    binary = (masks > 0).to(torch.float32)
    mask_score = (torch.sigmoid(masks) * binary).sum(dim=(1, 2)) / (binary.sum(dim=(1, 2)) + 1e-6)
    return {"masks": binary, "scores": top_scores * mask_score,
            "classes": top_idx % num_classes}


def panoptic_inference_device(mask_cls, mask_pred, object_mask_threshold=0.8, valid_hw=None):
    """The per-pixel part of the stuff-merge panoptic assembly: the winner
    query map, whether the winner's own sigmoid is >= 0.5, per-query counts
    (restricted to ``valid_hw``) and the kept queries' scores and labels."""
    Q, H, W = mask_pred.shape
    C = mask_cls.shape[-1] - 1
    probs = torch.softmax(mask_cls.float(), dim=-1)
    scores = probs.amax(dim=-1)
    labels = torch.argmax(probs, dim=-1)
    keep = (labels != C) & (scores > object_mask_threshold)
    sig = torch.sigmoid(mask_pred.float()).reshape(Q, H * W)
    prob_masks = torch.where(keep[:, None], scores[:, None] * sig, torch.full_like(sig, -1.0))
    mask_ids = torch.argmax(prob_masks, dim=0)
    winner_sig = torch.gather(sig, 0, mask_ids[None])[0]
    valid = _valid_map(H, W, valid_hw, mask_pred.device).reshape(H * W)
    winner_ok = (winner_sig >= 0.5) & valid
    mask_area = torch.zeros((Q,), dtype=torch.int32, device=mask_pred.device).scatter_add_(
        0, mask_ids, winner_ok.to(torch.int32))
    original_area = ((sig >= 0.5) & valid[None]).sum(dim=1).to(torch.int32)
    return {"mask_ids": mask_ids.reshape(H, W).to(torch.int32),
            "winner_ok": winner_ok.reshape(H, W), "mask_area": mask_area,
            "original_area": original_area, "scores": scores,
            "labels": labels.to(torch.int32), "keep": keep}


def panoptic_assemble_host(dev: dict, thing_ids, overlap_threshold=0.8):
    """The host tail: the sequential seg-id / stuff-merge / overlap-filter
    loop over Q scalars, then one lookup over the winner map."""
    mask_ids = np.asarray(dev["mask_ids"], np.int64)
    winner_ok = np.asarray(dev["winner_ok"], bool)
    mask_area = np.asarray(dev["mask_area"])
    original_area = np.asarray(dev["original_area"])
    labels = np.asarray(dev["labels"])
    keep = np.asarray(dev["keep"], bool)
    lut = np.zeros((mask_area.shape[0],), np.int32)
    segments: list = []
    seg_id = 0
    stuff_memory: dict = {}
    for k in np.nonzero(keep)[0]:
        cls = int(labels[k])
        isthing = cls in thing_ids
        ma, oa = int(mask_area[k]), int(original_area[k])
        if ma > 0 and oa > 0:
            if ma / oa < overlap_threshold:
                continue
            if not isthing and cls in stuff_memory:
                lut[k] = stuff_memory[cls]
                continue
            seg_id += 1
            if not isthing:
                stuff_memory[cls] = seg_id
            lut[k] = seg_id
            segments.append({"id": seg_id, "isthing": isthing, "category_id": cls})
    return (lut[mask_ids] * winner_ok).astype(np.int32), segments


def instance_inference_device(mask_cls, mask_pred, num_classes: int, topk: int,
                              thing_mask=None, valid_hw=None):
    """``instance_inference`` with compact outputs: the top-k binary masks
    bit-packed into int32 planes [ceil(K/32), H, W]; the mask scores count
    only the ``valid_hw`` region."""
    Q = mask_cls.shape[0]
    H, W = mask_pred.shape[-2:]
    flat = torch.softmax(mask_cls.float(), dim=-1)[:, :-1].reshape(-1)
    if thing_mask is not None:
        flat = flat * thing_mask.to(flat.dtype).repeat(Q)
    K = min(topk, flat.shape[0])
    top_scores, top_idx = torch.topk(flat, K)
    masks = mask_pred[top_idx // num_classes]
    binary = (masks > 0) & _valid_map(H, W, valid_hw, mask_pred.device)[None]
    binf = binary.to(torch.float32)
    mask_score = (torch.sigmoid(masks.float()) * binf).sum(dim=(1, 2)) / (binf.sum(dim=(1, 2))
                                                                          + 1e-6)
    n_planes = -(-K // 32)
    bits = torch.zeros((n_planes * 32, H, W), dtype=torch.int32, device=mask_pred.device)
    bits[:K] = binary.to(torch.int32)
    shifts = torch.bitwise_left_shift(
        torch.ones((32,), dtype=torch.int32, device=mask_pred.device),
        torch.arange(32, dtype=torch.int32, device=mask_pred.device))
    planes = (bits.reshape(n_planes, 32, H, W) * shifts[None, :, None, None]).sum(
        dim=1).to(torch.int32)
    return {"mask_planes": planes, "scores": top_scores * mask_score,
            "classes": (top_idx % num_classes).to(torch.int32)}


def unpack_mask_planes(planes, k: int) -> np.ndarray:
    """[ceil(K/32), H, W] int32 bit planes -> [K, H, W] bool."""
    planes = np.asarray(planes)
    _, H, W = planes.shape
    out = np.zeros((k, H, W), bool)
    for i in range(k):
        out[i] = (planes[i // 32] >> (i % 32)) & 1
    return out


def _object_queries(out: dict, nq: int) -> dict:
    """The criterion's view of a decoder output: the object queries only
    ([:nq - 1]; the class token and grounding slots left out), every layer."""
    def obj(o):
        return {k: (v[:, :nq - 1] if k in ("pred_logits", "pred_masks", "pred_boxes")
                    and v is not None else v)
                for k, v in o.items() if k != "aux_outputs"}
    crit = obj(out)
    crit["aux_outputs"] = [obj(a) for a in out.get("aux_outputs", [])]
    return crit


def _to_device(batch: dict, device) -> dict:
    return {k: (torch.as_tensor(v).to(device) if isinstance(v, (np.ndarray, torch.Tensor))
                else v) for k, v in batch.items()}


def forward_seg_train(params, cfg: XDecoderModelConfig, images, targets, text_class_embeds,
                      generator, grounding_tokens=None, data_axis=None, remat: bool = False):
    """The seg training forward: the loss dict of ``set_criterion`` over the
    object queries, plus ``loss_grounding_bce_0`` / ``_dice_0`` when
    ``grounding_tokens`` [B, G, D] are given and the targets carry
    ``grounding_masks`` [B, G, H, W] and ``grounding_valid`` [B, G]."""
    mask_features, pyramid = backbone_and_pixel_decoder(params, cfg, images, remat=remat)
    out = xdecoder_forward(params["decoder"], cfg.decoder, pyramid, mask_features,
                           text_class_embeds=text_class_embeds,
                           logit_scale=params["text"]["logit_scale"],
                           grounding_tokens=grounding_tokens, task="seg", is_train=True,
                           remat=remat)
    nq = cfg.decoder.num_queries
    losses = set_criterion(_object_queries(out, nq), targets, cfg.criterion, generator,
                           data_axis)
    if grounding_tokens is not None and "grounding_masks" in targets:
        g_masks_all = out["pred_masks"][:, nq:]
        g_src, g_valid, _ = match_groundings(
            g_masks_all, out["pred_captions"][:, nq:], targets["grounding_masks"],
            grounding_tokens, targets["grounding_valid"], params["text"]["logit_scale"],
            generator, cfg.criterion)
        bce, dice = loss_groundings(torch.gather(
            g_masks_all, 1, g_src[:, :, None, None].expand(-1, -1, *g_masks_all.shape[2:])),
            targets["grounding_masks"], g_valid, generator, cfg.criterion)
        losses["loss_grounding_bce_0"] = cfg.criterion.weight_grounding_bce * bce
        losses["loss_grounding_dice_0"] = cfg.criterion.weight_grounding_dice * dice
    return losses


_RENAME = {"loss_ce": "loss_mask_ce", "loss_mask_bce": "loss_mask_bce",
           "loss_mask_dice": "loss_mask_dice", "loss_bbox": "loss_bbox", "loss_giou": "loss_giou"}


# batch leaves that are per-class tables, not per-image rows: every rank
# holds them whole
REPLICATED_BATCH_KEYS = ("class_ids", "class_mask")


def forward_joint_train(params, cfg: XDecoderModelConfig, batch, generator, data_axis=None,
                        remat: bool = False):
    """The joint objective of one step: mask / class / box losses, caption,
    grounding, captioning and retrieval losses, under the reference's key
    names (``loss_mask_ce_0``, ``loss_caption_{r}``, ...).

    ``batch`` (``collate_joint`` plus the class-name tokens, numpy or
    tensors): ``image`` [B, H, W, 3] normalized; ``classes`` / ``masks`` /
    ``boxes`` / ``valid``; ``labels_hash``; ``class_ids`` / ``class_mask``;
    ``caption_ids`` / ``caption_mask`` [B, P, T] with ``caption_hash`` /
    ``caption_valid``; ``caption_text_ids`` / ``_mask`` [B, T];
    ``grounding_ids`` / ``grounding_token_mask`` [B, G, T] with
    ``grounding_hash`` / ``grounding_valid`` / ``grounding_masks``.  The text
    embeddings are computed here, so the text encoder trains.  The text-side
    losses supervise the top layers: reference layer_id r is prediction
    ``aux[L - 1 - r]`` (0 = final); grounding is re-matched at every one of
    them.  Random points come from ``generator``, in call order.

    ``data_axis``: a ``parallel.ParallelContext`` (several processes), and
    ``batch`` the global batch.  This rank runs the text tower, the trunk,
    the decoder and every loss on its images (``data_axis.part``; the class
    tables whole), and each loss returns this rank's share
    (``criterion``'s module docstring): the matcher per image, the point
    draws and ``num_masks`` as one process's, the contrastive terms over
    the embeddings of every rank.  The ranks' summed losses and gradients
    are the one-process step's."""
    dev = params["text"]["token_embedding"].device
    batch = _to_device(batch, dev)
    part = None if data_axis is None else data_axis.part(batch["caption_ids"].shape[0])
    if part is not None:
        batch = {k: (v if k in REPLICATED_BATCH_KEYS else v[part.offset:part.offset + part.n])
                 for k, v in batch.items()}
    tp, tc = params["text"], cfg.text
    class_embs = te.forward_language(tp, tc, batch["class_ids"], batch["class_mask"], norm=True,
                                     remat=remat)
    B, P, T = batch["caption_ids"].shape
    cap_embs = te.forward_language(tp, tc, batch["caption_ids"].reshape(B * P, T),
                                   batch["caption_mask"].reshape(B * P, T),
                                   remat=remat).reshape(B, P, -1)
    G = batch["grounding_ids"].shape[1]
    _, g_cls = te.forward_language_token(tp, tc, batch["grounding_ids"].reshape(B * G, T),
                                         batch["grounding_token_mask"].reshape(B * G, T),
                                         remat=remat)
    # padded phrase slots zeroed: their embeddings are noise
    grounding_tokens = g_cls.reshape(B, G, -1) * batch["grounding_valid"][:, :, None].to(
        g_cls.dtype)
    cap_tok, cap_sent = te.forward_language_token(tp, tc, batch["caption_text_ids"],
                                                  batch["caption_text_mask"], remat=remat)
    vocab_embs = tp["token_embedding"] @ tp["lang_proj"]
    logit_scale = tp["logit_scale"]

    feats, mask_features, pyramid = _trunk(params, cfg, batch["image"], remat)
    out = xdecoder_forward(params["decoder"], cfg.decoder, pyramid, mask_features,
                           text_class_embeds=class_embs, logit_scale=logit_scale,
                           grounding_tokens=grounding_tokens, task="seg", is_train=True,
                           remat=remat)
    targets = {k: batch[k] for k in ("classes", "masks", "boxes", "valid")}
    nq = cfg.decoder.num_queries
    raw, all_idx = set_criterion(_object_queries(out, nq), targets, cfg.criterion, generator,
                                 part, return_indices="all")
    losses = {}
    for k, v in raw.items():
        for old, new in _RENAME.items():
            if k == old:
                losses[f"{new}_0"] = v
                break
            if k.startswith(old + "_"):
                losses[f"{new}_{int(k[len(old) + 1:])}"] = v
                break
    crit = cfg.criterion
    aux = out.get("aux_outputs", [])
    L = len(aux) + 1

    def seg_pred(r):
        return out if r == 0 else aux[L - 1 - r]

    for r in range(min(crit.top_x_layers_caption, L)):
        losses[f"loss_caption_{r}"] = crit.weight_caption * loss_captions(
            seg_pred(r)["pred_captions"][:, :nq - 1], *all_idx[r], batch["classes"],
            batch["labels_hash"], class_embs, cap_embs, batch["caption_hash"],
            batch["caption_valid"], logit_scale, part)
    for r in range(min(crit.top_x_layers_grounding, L)):
        p = seg_pred(r)
        g_masks_all = p["pred_masks"][:, nq:]
        g_src, g_valid, g_sim = match_groundings(
            g_masks_all, p["pred_captions"][:, nq:], batch["grounding_masks"], grounding_tokens,
            batch["grounding_valid"], logit_scale, generator, crit, data_axis=part)
        g_masks_pred = torch.gather(
            g_masks_all, 1, g_src[:, :, None, None].expand(-1, -1, *g_masks_all.shape[2:]))
        bce, dice = loss_groundings(g_masks_pred, batch["grounding_masks"], g_valid, generator,
                                    crit, part)
        losses[f"loss_grounding_bce_{r}"] = crit.weight_grounding_bce * bce
        losses[f"loss_grounding_dice_{r}"] = crit.weight_grounding_dice * dice
        losses[f"loss_grounding_ce_{r}"] = crit.weight_grounding_ce * loss_grounding_ce(
            g_sim, g_src, g_valid, batch["grounding_hash"], part)

    out_vlp = xdecoder_forward(params["decoder"], cfg.decoder, pyramid, mask_features,
                               caption_tokens=cap_tok, task="vlp", is_train=True, remat=remat)
    aux_vlp = out_vlp.get("aux_outputs", [])
    Lv = len(aux_vlp) + 1

    def vlp_pred(r):
        return out_vlp if r == 0 else aux_vlp[Lv - 1 - r]

    for r in range(min(crit.top_x_layers_captioning, Lv)):
        losses[f"loss_captioning_{r}"] = crit.weight_captioning * loss_captionings(
            vlp_pred(r)["pred_captionings"], cap_tok, batch["caption_text_ids"],
            batch["caption_text_mask"], vocab_embs, logit_scale, part)
    for r in range(min(crit.top_x_layers_retrieval, Lv)):
        pc = vlp_pred(r)["pred_captions"]
        coarse = image_text_contrastive_loss(pc[:, nq - 1], cap_sent, logit_scale, part)
        fine = fine_grained_itc_loss(pc[:, :nq - 1], cap_tok, batch["caption_text_mask"],
                                     logit_scale, part)
        losses[f"loss_retrieval_decoder_{r}"] = crit.weight_retrieval_decoder * (
            coarse + 0.5 * fine)
    if "backbone_proj" in params:
        v5 = feats["res5"].mean(dim=(2, 3)) @ params["backbone_proj"]
        losses["loss_retrieval_backbone_0"] = crit.weight_retrieval_backbone * (
            image_text_contrastive_loss(v5, cap_sent, logit_scale, part))
    return losses


def evaluate_grounding(params, cfg: XDecoderModelConfig, images, text_ids, text_mask,
                       out_size: Optional[tuple] = None):
    """Referring segmentation: one phrase per image (``text_ids`` /
    ``text_mask`` [B, L] or [B, 1, L]); its token embeddings (through
    ``lang_proj``) ride in the decoder's grounding slots, and the answer is
    the grounding query whose caption embedding is closest (cosine) to the
    phrase's sentence embedding.  Returns its mask logits [B, h, w],
    resized (bicubic, antialiased) to ``out_size`` when given."""
    B = images.shape[0]
    dev = params["text"]["token_embedding"].device
    text_ids = torch.as_tensor(text_ids, device=dev)
    text_mask = torch.as_tensor(text_mask, device=dev)
    L = text_ids.shape[-1]
    token_emb, class_emb = te.forward_language_token(params["text"], cfg.text,
                                                     text_ids.reshape(-1, L),
                                                     text_mask.reshape(-1, L), norm=False)
    mask_features, pyramid = backbone_and_pixel_decoder(params, cfg, images)
    out = xdecoder_forward(params["decoder"], cfg.decoder, pyramid, mask_features,
                           grounding_tokens=token_emb.reshape(B, -1, token_emb.shape[-1]),
                           grounding_token_mask=text_mask.reshape(B, -1), task="grounding_eval")
    nq = cfg.decoder.num_queries
    # the grounding queries' outputs sit in slots [nq, 2 nq - 1)
    g_masks = out["pred_masks"][:, nq:]
    v = l2_normalize(out["pred_captions"][:, nq:])
    t = l2_normalize(class_emb.reshape(B, -1, class_emb.shape[-1]))
    best = torch.argmax(torch.einsum("bqd,btd->bqt", v, t)[..., 0], dim=-1)
    picked = torch.gather(g_masks, 1, best[:, None, None, None].expand(
        B, 1, *g_masks.shape[2:]))
    if out_size is not None:
        picked = resize(picked, out_size, "bicubic")
    return picked[:, 0]


def forward_vlp_train(*args, **kwargs):
    raise NotImplementedError("forward_vlp_train (the VLP training forward, which no entry point "
                              "reaches) waits for the VLP training slice")


def evaluate_classification(params, cfg: XDecoderModelConfig, images, text_class_embeds):
    """Zero-shot classification by the class token: its logits [B, C + 1]
    against ``text_class_embeds`` (the background column included, as the
    reference scores them)."""
    mask_features, pyramid = backbone_and_pixel_decoder(params, cfg, images)
    out = xdecoder_forward(params["decoder"], cfg.decoder, pyramid, mask_features,
                           text_class_embeds=text_class_embeds,
                           logit_scale=params["text"]["logit_scale"], task="eval")
    return out["pred_logits"][:, -1]


def evaluate_retrieval_embedding(params, cfg: XDecoderModelConfig, images, ensemble: bool = True):
    """Image embeddings for retrieval: ``(class_token_emb, backbone_emb or
    None)``, each normalized (``+ 1e-7``).  The first is the class token's
    caption embedding (query ``nq - 1``); the second, with ``ensemble`` and
    a ``backbone_proj`` in ``params``, res5 averaged over the map through
    ``backbone_proj`` (the evaluator averages the two score matrices 0.5 /
    0.5)."""
    feats, mask_features, pyramid = _trunk(params, cfg, images)
    out = xdecoder_forward(params["decoder"], cfg.decoder, pyramid, mask_features, task="eval")
    emb = l2_normalize(out["pred_captions"][:, cfg.decoder.num_queries - 1])
    emb2 = None
    if ensemble and "backbone_proj" in params:
        emb2 = l2_normalize(feats["res5"].mean(dim=(2, 3)) @ params["backbone_proj"])
    return emb, emb2


def evaluate_dispatch(params, cfg: XDecoderModelConfig, images, mode: str = "default",
                      text_class_embeds=None, text_ids=None, text_mask=None, out_size=None):
    """The eval modes: retrieval | classification | grounding_refcoco |
    default (the dense forward).  Captioning goes through
    ``decoder.forward_captioning`` with a token-embedding function (see
    ``pipelines.vlp_pipeline``), so ``mode="captioning"`` raises."""
    if mode == "retrieval":
        return evaluate_retrieval_embedding(params, cfg, images)
    if mode == "classification":
        return evaluate_classification(params, cfg, images, text_class_embeds)
    if mode == "grounding_refcoco":
        return evaluate_grounding(params, cfg, images, text_ids, text_mask, out_size)
    if mode == "captioning":
        raise ValueError("mode 'captioning': use decoder.forward_captioning with a "
                         "tokenizer-backed token_embedding_fn (pipelines.vlp_pipeline)")
    return forward_eval(params, cfg, images, text_class_embeds, out_size)
