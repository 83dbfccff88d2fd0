"""X-Decoder mask-transformer decoder (counterpart of
``cullavo_tpu/models/xdecoder/decoder.py``).

Learnable queries (the last slot a class token) over a 3-level pyramid
round-robin; post-norm cross-attention masked by the previous layer's
thresholded mask prediction, structured self-attention, FFN; prediction
heads per layer (class logits by language-embedding similarity, mask
logits against the mask features, boxes).  Layout batch-first ``[B, Q, C]``;
the pyramid and mask features come channels-first ``[B, C, H, W]``.
Attention masks are boolean "allowed" matrices, as in JAX.

Also here: ``sine_position_embedding`` and ``resize``, the port's
counterpart of ``jax.image.resize`` for the methods the X-Decoder uses
(nearest, bilinear, bicubic; antialiased on downscale, weights renormalized
over in-bounds taps, which ``F.interpolate(antialias=True)`` computes).

Training runs the seg task with grounding tokens (duplicated queries) and
the vlp task with caption tokens; ``forward_captioning`` runs the caption
slots greedily, one decoder pass a token.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cullavo_tpu_torch.models.llava.clip_vit import layer_norm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class XDecoderConfig:
    hidden_dim: int = 512
    num_queries: int = 201
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9           # DEC_LAYERS - 1
    pre_norm: bool = False
    mask_dim: int = 512
    dim_proj: int = 512
    contxt_len: int = 77
    num_feature_levels: int = 3
    in_channels: int = 512
    captioning_step: int = 50
    layer_norm_eps: float = 1e-5
    task_mask: bool = True
    task_bbox: bool = True
    task_grounding: bool = True
    task_captioning: bool = True


def init_xdecoder_params(cfg: XDecoderConfig, gen: torch.Generator, device,
                         dtype=torch.float32) -> dict:
    D, Fd = cfg.hidden_dim, cfg.dim_feedforward

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def attn_params():
        return {"q_w": dense(D, D), "q_b": zeros(D), "k_w": dense(D, D), "k_b": zeros(D),
                "v_w": dense(D, D), "v_b": zeros(D), "o_w": dense(D, D), "o_b": zeros(D),
                "ln_s": ones(D), "ln_b": zeros(D)}

    layers = [{"cross": attn_params(), "self": attn_params(),
               "ffn": {"fc1_w": dense(D, Fd), "fc1_b": zeros(Fd), "fc2_w": dense(Fd, D),
                       "fc2_b": zeros(D), "ln_s": ones(D), "ln_b": zeros(D)}}
              for _ in range(cfg.dec_layers)]
    return {
        "layers": layers,
        "decoder_norm": {"scale": ones(D), "bias": zeros(D)},
        "query_feat": dense(cfg.num_queries, D),
        "query_embed": dense(cfg.num_queries, D),
        "level_embed": dense(cfg.num_feature_levels, D),
        "input_proj": [{"w": dense(cfg.in_channels, D), "b": zeros(D)}
                       for _ in range(cfg.num_feature_levels)],
        "class_embed": dense(D, cfg.dim_proj),
        "caping_embed": dense(D, cfg.dim_proj),
        "pos_embed_caping": dense(cfg.contxt_len, D),
        "mask_embed": {"w0": dense(D, D), "b0": zeros(D), "w1": dense(D, D), "b1": zeros(D),
                       "w2": dense(D, cfg.mask_dim), "b2": zeros(cfg.mask_dim)},
        "bbox_embed": {"w0": dense(D, D), "b0": zeros(D), "w1": dense(D, D), "b1": zeros(D),
                       "w2": dense(D, 4), "b2": zeros(4)},
    }


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def resize(x, size, method: str):
    """Resize the last two axes of [B, C, H, W] to ``size`` as
    ``jax.image.resize`` does (computed in f32, returned in x's dtype)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if method == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest-exact")
    y = F.interpolate(x.float(), size=tuple(size), mode=method, align_corners=False,
                      antialias=True)
    return y.to(x.dtype)


def sine_position_embedding(H: int, W: int, dim: int, device=None, temperature: float = 10000.0):
    """2-D sine PE (detectron2 convention, normalized): [H*W, dim] f32."""
    n_steps = dim // 2
    eps = 1e-6
    scale = 2 * math.pi
    f32 = torch.float32
    y = (torch.arange(H, dtype=f32, device=device) + 1.0)[:, None] / (H + eps) * scale
    x = (torch.arange(W, dtype=f32, device=device) + 1.0)[None, :] / (W + eps) * scale
    y, x = y.expand(H, W), x.expand(H, W)
    dim_t = temperature ** (2 * (torch.arange(n_steps, device=device) // 2).to(f32) / n_steps)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])],
                        dim=-1).reshape(H, W, n_steps)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])],
                        dim=-1).reshape(H, W, n_steps)
    return torch.cat([pos_y, pos_x], dim=-1).reshape(H * W, dim)


def _mha(w, q_in, k_in, v_in, heads: int, allowed: Optional[torch.Tensor]):
    """Multi-head attention; allowed: [B, Q, K] or [B, 1, Q, K] bool.  f32
    scores and softmax, probabilities rounded to the input dtype."""
    B, Q, D = q_in.shape
    K = k_in.shape[1]
    hd = D // heads
    q = (q_in @ w["q_w"] + w["q_b"]).reshape(B, Q, heads, hd).transpose(1, 2)
    k = (k_in @ w["k_w"] + w["k_b"]).reshape(B, K, heads, hd).transpose(1, 2)
    v = (v_in @ w["v_w"] + w["v_b"]).reshape(B, K, heads, hd).transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    if allowed is not None:
        if allowed.dim() == 3:
            allowed = allowed[:, None]
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(q_in.dtype).float(), v.float()).to(q_in.dtype)
    out = out.transpose(1, 2).reshape(B, Q, D)
    return out @ w["o_w"] + w["o_b"]


def _post_norm_attn(w, x, key_val, heads, allowed, q_pos, k_pos, eps):
    """Post-norm residual attention."""
    q_in = x + q_pos if q_pos is not None else x
    k_in = key_val + k_pos if k_pos is not None else key_val
    attn = _mha(w, q_in, k_in, key_val, heads, allowed)
    return layer_norm(x + attn, w["ln_s"], w["ln_b"], eps)


def _ffn(w, x, eps):
    y = torch.relu(x @ w["fc1_w"] + w["fc1_b"]) @ w["fc2_w"] + w["fc2_b"]
    return layer_norm(x + y, w["ln_s"], w["ln_b"], eps)


def _mlp3(w, x):
    y = torch.relu(x @ w["w0"] + w["b0"])
    y = torch.relu(y @ w["w1"] + w["b1"])
    return y @ w["w2"] + w["b2"]


def structured_self_attn_allowed(cfg: XDecoderConfig, with_caption: bool, device=None):
    """The structured self-attention mask as an "allowed" matrix: object
    queries and the class token blocked from each other both ways; caption
    tokens (when present) see the queries and causally each other."""
    nq, cl = cfg.num_queries, cfg.contxt_len
    n = nq + cl if with_caption else nq
    allowed = torch.ones((n, n), dtype=torch.bool, device=device)
    if with_caption:
        allowed[:nq, nq:] = False
        allowed[nq:, nq:] = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=device))
    allowed[:nq - 1, nq - 1] = False
    allowed[nq - 1, :nq - 1] = False
    return allowed


def l2_normalize(x):
    """x / (||x|| + 1e-7) over the last axis."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-7)


def _prepare_memories(params, cfg, features: list):
    """features: 3 maps [B, C, H, W] (coarse to fine) -> per level
    (src [B, HW, D], pos [B, HW, D], (H, W))."""
    mems = []
    for i, f in enumerate(features):
        B, C, H, W = f.shape
        pos = sine_position_embedding(H, W, cfg.hidden_dim, f.device)[None]
        proj = params["input_proj"][i]
        src = f.reshape(B, C, H * W).transpose(1, 2) @ proj["w"] + proj["b"] \
            + params["level_embed"][i]
        mems.append((src, pos.to(src.dtype).expand(src.shape), (H, W)))
    return mems


def forward_prediction_heads(params, cfg: XDecoderConfig, output, mask_features,
                             target_size, text_class_embeds=None, logit_scale=None,
                             num_grounding: int = 0):
    """output [B, N, D]; mask_features [B, mask_dim, Hm, Wm].  Returns the
    class/mask/box/caption(ing) predictions and the next layer's
    cross-attention "allowed" mask [B, N, Ht * Wt].  With ``num_grounding``
    the decoder output is the object queries, the class token and the nq - 1
    grounding queries; rows past nq (caption or grounding slots) give the
    captioning embeddings."""
    nq = cfg.num_queries
    x = layer_norm(output, params["decoder_norm"]["scale"], params["decoder_norm"]["bias"],
                   cfg.layer_norm_eps)
    outputs_captioning = x[:, nq:] @ params["caping_embed"] if x.shape[1] > nq else None
    # class-token recomputation: similarity-weighted mix of the object tokens
    normed = l2_normalize(x)
    obj, cls = normed[:, :nq - 1], normed[:, nq - 1:nq]
    sim = torch.softmax(torch.einsum("bod,bcd->bco", obj, cls), dim=-1)[:, 0, :, None]
    cls_tok = torch.sum(sim * x[:, :nq - 1], dim=1, keepdim=True)
    parts = [x[:, :nq - 1], cls_tok]
    if num_grounding > 0:
        parts.append(x[:, nq:2 * nq - 1])
    decoder_output = torch.cat(parts, dim=1)

    class_embed = decoder_output @ params["class_embed"]
    outputs_class = None
    if text_class_embeds is not None:
        scale = torch.exp(logit_scale) if logit_scale is not None else 1.0
        outputs_class = scale * torch.einsum("bqd,cd->bqc", l2_normalize(class_embed),
                                             text_class_embeds.to(class_embed.dtype))
    mask_embed = _mlp3(params["mask_embed"], decoder_output)
    outputs_mask = torch.einsum("bqc,bchw->bqhw", mask_embed, mask_features)

    # next layer's cross-attention mask: bicubic (antialiased) resize,
    # sigmoid >= 0.5; row nq (the first grounding query, when there) sees
    # everything; a fully masked row attends everywhere
    B, N = decoder_output.shape[:2]
    Ht, Wt = target_size
    with torch.no_grad():
        resized = resize(outputs_mask, (Ht, Wt), "bicubic")
        allowed = (torch.sigmoid(resized) >= 0.5).reshape(B, N, Ht * Wt)
        if N > nq:
            allowed[:, nq:nq + 1] = True
        allowed = allowed | ~allowed.any(dim=-1, keepdim=True)
    return {"outputs_class": outputs_class, "outputs_mask": outputs_mask,
            "outputs_bbox": _mlp3(params["bbox_embed"], decoder_output),
            "outputs_caption": class_embed, "outputs_captioning": outputs_captioning,
            "attn_allowed": allowed}


def grounding_self_attn_allowed(cfg: XDecoderConfig, num_extra: int, device=None):
    """The grounding-mode self-attention mask: the structured mask on the
    first nq slots, the extra block (duplicated queries + grounding tokens)
    fully self-attending, nothing between the two blocks."""
    nq = cfg.num_queries
    n = nq + num_extra
    allowed = torch.zeros((n, n), dtype=torch.bool, device=device)
    allowed[:nq, :nq] = structured_self_attn_allowed(cfg, False, device)
    allowed[nq:, nq:] = True
    return allowed


def xdecoder_forward(params, cfg: XDecoderConfig, features: list, mask_features,
                     text_class_embeds=None, logit_scale=None, grounding_tokens=None,
                     grounding_token_mask=None, caption_tokens=None,
                     captioning_spatial_mask=None, task: str = "seg", is_train: bool = False,
                     remat: bool = False):
    """The decoder loop: pred_logits / pred_masks / pred_boxes /
    pred_captions (+ aux_outputs); for ``task="vlp"`` pred_captionings /
    pred_captions (+ aux_outputs).

    ``grounding_tokens`` [B, G, D] (seg training, grounding eval): the
    object queries are duplicated as grounding queries and the tokens ride
    along in self-attention.  ``caption_tokens`` [B, contxt_len, D] (vlp
    training): caption slots after the queries, causal among themselves.
    ``remat`` checkpoints each decoder layer
    (``torch.utils.checkpoint``, recomputed in the backward)."""
    mems = _prepare_memories(params, cfg, features)
    B = features[0].shape[0]
    nq = cfg.num_queries
    eps = cfg.layer_norm_eps
    dev = mask_features.device
    output = params["query_feat"][None].expand(B, nq, cfg.hidden_dim)
    query_pos = params["query_embed"][None].expand(B, nq, cfg.hidden_dim)
    use_grounding = (grounding_tokens is not None and cfg.task_grounding
                     and ((is_train and task == "seg") or task == "grounding_eval"))
    use_caption = (caption_tokens is not None and cfg.task_captioning and is_train
                   and task == "vlp")
    num_grounding = 0
    g_tokens = None
    if use_caption:
        output = torch.cat([output, caption_tokens.detach()], dim=1)
        query_pos = torch.cat([query_pos, caption_tokens + params["pos_embed_caping"][None]],
                              dim=1)
        self_allowed = structured_self_attn_allowed(cfg, True, dev)[None]
    elif use_grounding:
        num_grounding = G = grounding_tokens.shape[1]
        output = torch.cat([output, output[:, :-1]], dim=1)
        query_pos = torch.cat([query_pos, query_pos[:, :-1]], dim=1)
        self_allowed = grounding_self_attn_allowed(cfg, (nq - 1) + G, dev)[None]
        if grounding_token_mask is not None:
            # padded phrase slots are invisible to every query
            col = torch.cat([torch.ones((B, 2 * nq - 1), dtype=torch.bool, device=dev),
                             grounding_token_mask.to(dev).bool()], dim=1)
            self_allowed = self_allowed & col[:, None, :]
        g_tokens = grounding_tokens.detach()
    else:
        self_allowed = structured_self_attn_allowed(cfg, False, dev)[None]

    def layer_step(i, lw, output, g_tokens, attn_allowed):
        src, pos, size = mems[i % cfg.num_feature_levels]
        ca_allowed = attn_allowed
        if use_caption:
            # caption tokens attend the whole memory, but an excluded region
            extra = torch.ones((B, cfg.contxt_len, ca_allowed.shape[-1]), dtype=torch.bool,
                               device=dev)
            if captioning_spatial_mask is not None:
                m = resize(captioning_spatial_mask.float()[:, None], size, "nearest") > 0.5
                extra = extra & ~m.reshape(B, 1, -1)
            ca_allowed = torch.cat([ca_allowed, extra], dim=1)
        output = _post_norm_attn(lw["cross"], output, src, cfg.nheads, ca_allowed, query_pos,
                                 pos, eps)
        query_pos_g = query_pos
        if use_grounding:
            output = torch.cat([output, g_tokens], dim=1)
            query_pos_g = torch.cat([query_pos, grounding_tokens], dim=1)
        output = _post_norm_attn(lw["self"], output, output, cfg.nheads, self_allowed,
                                 query_pos_g, query_pos_g, eps)
        output = _ffn(lw["ffn"], output, eps)
        if use_grounding:
            g_tokens = output[:, -num_grounding:]
            output = output[:, :-num_grounding]
        results = forward_prediction_heads(
            params, cfg, output, mask_features, mems[(i + 1) % cfg.num_feature_levels][2],
            text_class_embeds, logit_scale, num_grounding)
        return output, g_tokens, results

    preds = [forward_prediction_heads(params, cfg, output, mask_features, mems[0][2],
                                      text_class_embeds, logit_scale, num_grounding)]
    for i, lw in enumerate(params["layers"]):
        if remat:
            output, g_tokens, results = checkpoint(
                layer_step, i, lw, output, g_tokens, preds[-1]["attn_allowed"],
                use_reentrant=False, preserve_rng_state=False)
        else:
            output, g_tokens, results = layer_step(i, lw, output, g_tokens,
                                                   preds[-1]["attn_allowed"])
        preds.append(results)

    if task == "vlp":
        return {"pred_captionings": preds[-1]["outputs_captioning"],
                "pred_captions": preds[-1]["outputs_caption"],
                "aux_outputs": [{"pred_captionings": p["outputs_captioning"],
                                 "pred_captions": p["outputs_caption"]} for p in preds[:-1]]}
    return {
        "pred_logits": preds[-1]["outputs_class"],
        "pred_masks": preds[-1]["outputs_mask"],
        "pred_boxes": preds[-1]["outputs_bbox"],
        "pred_captions": preds[-1]["outputs_caption"],
        "pred_gtext": preds[-1]["outputs_caption"],
        "aux_outputs": [{"pred_logits": p["outputs_class"], "pred_masks": p["outputs_mask"],
                         "pred_boxes": p["outputs_bbox"],
                         "pred_captions": p["outputs_caption"]} for p in preds[:-1]],
    }


def forward_captioning(params, cfg: XDecoderConfig, features: list, mask_features,
                       token_embedding_fn, vocab_embs, token_ids_start: int,
                       captioning_mask=None):
    """Greedy captioning: ``min(captioning_step, contxt_len - 1)`` steps,
    each re-encoding the partial caption (``token_embedding_fn(ids) -> [B,
    contxt_len, hidden_dim]``), running the decoder with the caption slots
    (and, when given, ``captioning_mask`` [B, H, W] bool, True = a region
    the caption tokens may not attend), and writing at ``t + 1`` the
    argmax of slot ``t``'s raw dot with the vocabulary table ``vocab_embs``
    [V, dim_proj].  Returns the ids [B, contxt_len] int32 (the start id at
    0), kept on the device: no step reads anything back to the host."""
    cl = cfg.contxt_len
    B = features[0].shape[0]
    ids = torch.zeros((B, cl), dtype=torch.int32, device=mask_features.device)
    ids[:, 0] = token_ids_start
    for t in range(min(cfg.captioning_step, cl - 1)):
        out = xdecoder_forward(params, cfg, features, mask_features,
                               caption_tokens=token_embedding_fn(ids),
                               captioning_spatial_mask=captioning_mask, task="vlp", is_train=True)
        logits = out["pred_captionings"][:, t] @ vocab_embs.t()
        ids[:, t + 1] = torch.argmax(logits, dim=-1).to(torch.int32)
    return ids
