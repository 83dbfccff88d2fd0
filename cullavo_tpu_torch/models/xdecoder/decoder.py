"""X-Decoder mask-transformer decoder, eval task (counterpart of
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

Captioning, grounding and caption tokens wait for their slice and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

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
                             target_size, text_class_embeds=None, logit_scale=None):
    """output [B, N, D]; mask_features [B, mask_dim, Hm, Wm].  Returns the
    class/mask/box/caption predictions and the next layer's cross-attention
    "allowed" mask [B, N, Ht * Wt]."""
    nq = cfg.num_queries
    x = layer_norm(output, params["decoder_norm"]["scale"], params["decoder_norm"]["bias"],
                   cfg.layer_norm_eps)
    # class-token recomputation: similarity-weighted mix of the object tokens
    normed = l2_normalize(x)
    obj, cls = normed[:, :nq - 1], normed[:, nq - 1:nq]
    sim = torch.softmax(torch.einsum("bod,bcd->bco", obj, cls), dim=-1)[:, 0, :, None]
    cls_tok = torch.sum(sim * x[:, :nq - 1], dim=1, keepdim=True)
    decoder_output = torch.cat([x[:, :nq - 1], cls_tok], dim=1)

    class_embed = decoder_output @ params["class_embed"]
    outputs_class = None
    if text_class_embeds is not None:
        scale = torch.exp(logit_scale) if logit_scale is not None else 1.0
        outputs_class = scale * torch.einsum("bqd,cd->bqc", l2_normalize(class_embed),
                                             text_class_embeds.to(class_embed.dtype))
    mask_embed = _mlp3(params["mask_embed"], decoder_output)
    outputs_mask = torch.einsum("bqc,bchw->bqhw", mask_embed, mask_features)

    # next layer's cross-attention mask: bicubic (antialiased) resize,
    # sigmoid >= 0.5; a fully masked row attends everywhere
    B, N = decoder_output.shape[:2]
    Ht, Wt = target_size
    resized = resize(outputs_mask, (Ht, Wt), "bicubic")
    allowed = (torch.sigmoid(resized) >= 0.5).reshape(B, N, Ht * Wt)
    dead = ~allowed.any(dim=-1, keepdim=True)
    allowed = allowed | dead
    return {"outputs_class": outputs_class, "outputs_mask": outputs_mask,
            "outputs_bbox": _mlp3(params["bbox_embed"], decoder_output),
            "outputs_caption": class_embed, "attn_allowed": allowed}


def xdecoder_forward(params, cfg: XDecoderConfig, features: list, mask_features,
                     text_class_embeds=None, logit_scale=None, grounding_tokens=None,
                     caption_tokens=None, task: str = "seg", is_train: bool = False):
    """The decoder loop, for the eval task: pred_logits / pred_masks /
    pred_boxes / pred_captions (+ aux_outputs).  Grounding and caption
    tokens (train, grounding eval, captioning) wait for their slice."""
    if grounding_tokens is not None or caption_tokens is not None or is_train:
        raise NotImplementedError("grounding, captioning and training in the X-Decoder "
                                  "wait for the captioning/grounding slice")
    mems = _prepare_memories(params, cfg, features)
    B = features[0].shape[0]
    nq = cfg.num_queries
    eps = cfg.layer_norm_eps
    output = params["query_feat"][None].expand(B, nq, cfg.hidden_dim)
    query_pos = params["query_embed"][None].expand(B, nq, cfg.hidden_dim)
    self_allowed = structured_self_attn_allowed(cfg, False, output.device)[None]

    preds = [forward_prediction_heads(params, cfg, output, mask_features, mems[0][2],
                                      text_class_embeds, logit_scale)]
    for i, lw in enumerate(params["layers"]):
        src, pos, _ = mems[i % cfg.num_feature_levels]
        output = _post_norm_attn(lw["cross"], output, src, cfg.nheads,
                                 preds[-1]["attn_allowed"], query_pos, pos, eps)
        output = _post_norm_attn(lw["self"], output, output, cfg.nheads, self_allowed,
                                 query_pos, query_pos, eps)
        output = _ffn(lw["ffn"], output, eps)
        next_size = mems[(i + 1) % cfg.num_feature_levels][2]
        preds.append(forward_prediction_heads(params, cfg, output, mask_features, next_size,
                                              text_class_embeds, logit_scale))
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


def forward_captioning(*args, **kwargs):
    raise NotImplementedError("forward_captioning waits for the captioning/grounding slice")


def grounding_self_attn_allowed(*args, **kwargs):
    raise NotImplementedError("grounding waits for the captioning/grounding slice")
