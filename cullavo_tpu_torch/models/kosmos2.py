"""KOSMOS-2, the grounded VL decoder (counterpart of
``cullavo_tpu/models/kosmos2.py``): the CLIP-L/14-224 tower the LLaVA stack
uses (``clip_vit.py``), image features pooled by a 64-latent-query
cross-attention projection, and a 24-layer text decoder.

Decoder notes (against LLaMA): sinusoidal positions with the M2M100 offset
(the pad id 1 plus a cumulative count), a sqrt(D) embedding scale,
pre-norm blocks with an extra LayerNorm on the attention output
(inner_attn_ln) and inside the FFN (over ffn_dim), exact GELU, lm_head tied
to the embeddings.

Decoding keeps a head-major cache ``[L, B, H, S, hd]``.  The prompt is a
cached forward: every layer writes its k/v at ``cache_index`` in place and
attends the whole cache under the key-validity and logical-position mask.
A one-token step (``stale_cache``) reads the cache without the current
token through ``sdpa_decode_stale`` (K12 on the card), then writes the
token's k/v in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.llava.clip_vit import (clip_vision_forward,
                                                     init_clip_vision_params, layer_norm)
from cullavo_tpu_torch.models.llava.config import ClipVisionConfig
from cullavo_tpu_torch.models.llava.llama import sdpa_decode_stale

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class Kosmos2TextConfig:
    vocab_size: int = 65037
    embed_dim: int = 2048
    layers: int = 24
    ffn_dim: int = 8192
    attention_heads: int = 32
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    scale_embedding: bool = True

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.attention_heads


@dataclasses.dataclass(frozen=True)
class Kosmos2Config:
    vision: ClipVisionConfig = dataclasses.field(
        default_factory=lambda: ClipVisionConfig(image_size=224))
    text: Kosmos2TextConfig = dataclasses.field(default_factory=Kosmos2TextConfig)
    latent_query_num: int = 64


def tiny_kosmos2_config() -> Kosmos2Config:
    return Kosmos2Config(
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                image_size=28, patch_size=14),
        text=Kosmos2TextConfig(vocab_size=130, embed_dim=32, layers=2,
                               ffn_dim=64, attention_heads=4,
                               max_position_embeddings=128),
        latent_query_num=3,
    )


def init_kosmos2_params(cfg: Kosmos2Config, gen: torch.Generator, device,
                        dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout (the CLIP tower as the LLaVA
    initializer draws it, N(0, 0.02) elsewhere, zero biases, unit norms),
    from a seeded ``torch.Generator`` on ``device``."""
    tc = cfg.text
    D, Fd, L = tc.embed_dim, tc.ffn_dim, tc.layers

    def nrm(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    def dense(d_in, d_out):
        return {"w": nrm(d_in, d_out), "b": full(0.0, d_out)}

    vision = init_clip_vision_params(cfg.vision, gen, device, dtype)
    return {
        "vision": vision,
        "projection": {
            "dense": dense(cfg.vision.hidden_size, D),
            "latent_query": nrm(cfg.latent_query_num, D),
            "x_attn": {n: dense(D, D) for n in ("q", "k", "v", "o")},
        },
        "embed_tokens": nrm(tc.vocab_size, D),
        "final_ln": full(1.0, D), "final_ln_b": full(0.0, D),
        "layers": {
            "q": nrm(L, D, D), "q_b": full(0.0, L, D),
            "k": nrm(L, D, D), "k_b": full(0.0, L, D),
            "v": nrm(L, D, D), "v_b": full(0.0, L, D),
            "o": nrm(L, D, D), "o_b": full(0.0, L, D),
            "attn_ln": full(1.0, L, D), "attn_ln_b": full(0.0, L, D),
            "inner_ln": full(1.0, L, D), "inner_ln_b": full(0.0, L, D),
            "final_ln": full(1.0, L, D), "final_ln_b": full(0.0, L, D),
            "fc1": nrm(L, D, Fd), "fc1_b": full(0.0, L, Fd),
            "fc2": nrm(L, Fd, D), "fc2_b": full(0.0, L, D),
            "ffn_ln": full(1.0, L, Fd), "ffn_ln_b": full(0.0, L, Fd),
        },
    }


def sinusoid_positions(position_ids: torch.Tensor, dim: int, padding_idx: int) -> torch.Tensor:
    """M2M100-convention sinusoid rows for raw table indices ``position_ids``
    (the offset already folded in); the padding row is zero.  f32."""
    half = dim // 2
    factor = math.log(10000.0) / (half - 1)
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=position_ids.device)
                     * -factor)
    ang = position_ids.float()[..., None] * freq
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return torch.where((position_ids == padding_idx)[..., None], torch.zeros_like(emb), emb)


def kosmos2_position_ids(attention_mask: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """HF create_position_ids_from_input_ids: cumsum over non-pad + pad_idx."""
    return torch.cumsum(attention_mask, dim=1) * attention_mask + pad_idx


def kosmos2_text_forward(params: dict, cfg: Kosmos2TextConfig, inputs_embeds: torch.Tensor,
                         attention_mask: torch.Tensor, position_ids: torch.Tensor,
                         cache: Optional[dict] = None, cache_index: Optional[int] = None,
                         key_position_ids: Optional[torch.Tensor] = None,
                         stale_cache: bool = False):
    """Decoder forward -> (final hidden [B, T, D], cache).

    ``inputs_embeds`` [B, T, D] unscaled; ``attention_mask`` [B, S] key
    validity (S = T without a cache, the cache length with one);
    ``position_ids`` [B, T] raw table indices.  With ``cache``: the T new
    tokens' k/v are written at ``cache_index`` in place, keys are at
    ``key_position_ids`` [B, S]; ``stale_cache`` (T = 1) reads the cache
    before the write and folds the current token in out of band."""
    B, T, D = inputs_embeds.shape
    H, hd, eps = cfg.attention_heads, cfg.head_dim, cfg.layer_norm_eps
    dtype = inputs_embeds.dtype
    scale = math.sqrt(D) if cfg.scale_embedding else 1.0
    h = inputs_embeds * scale + sinusoid_positions(position_ids, D, cfg.pad_token_id).to(dtype)

    key_pos = position_ids if cache is None else key_position_ids
    ok = (position_ids[:, :, None] >= key_pos[:, None, :]) & (attention_mask[:, None, :] != 0)
    bias = torch.where(ok[:, None], 0.0, NEG_INF).float()            # [B, 1, T, S]

    def heads(x):
        return x.reshape(B, T, H, hd).transpose(1, 2)

    layers = params["layers"]
    for li in range(cfg.layers):
        w = {k: a[li] for k, a in layers.items()}
        residual = h
        x = layer_norm(h, w["attn_ln"], w["attn_ln_b"], eps)
        q, k, v = (heads(x @ w[n] + w[n + "_b"]) for n in ("q", "k", "v"))
        if cache is not None and stale_cache:
            kc, vc = cache["k"][li], cache["v"][li]
            o = sdpa_decode_stale(q, kc.to(dtype), vc.to(dtype), k, v, bias)
            kc[:, :, cache_index] = k[:, :, 0].to(kc.dtype)
            vc[:, :, cache_index] = v[:, :, 0].to(vc.dtype)
        else:
            if cache is not None:
                kc, vc = cache["k"][li], cache["v"][li]
                kc[:, :, cache_index:cache_index + T] = k.to(kc.dtype)
                vc[:, :, cache_index:cache_index + T] = v.to(vc.dtype)
                k, v = kc.to(dtype), vc.to(dtype)
            att = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
            o = torch.matmul(torch.softmax(att + bias, dim=-1).to(dtype), v)
        o = layer_norm(o.transpose(1, 2).reshape(B, T, D), w["inner_ln"], w["inner_ln_b"], eps)
        h = residual + (o @ w["o"] + w["o_b"])
        residual = h
        x = layer_norm(h, w["final_ln"], w["final_ln_b"], eps)
        x = F.gelu((x @ w["fc1"] + w["fc1_b"]).float()).to(dtype)
        x = layer_norm(x, w["ffn_ln"], w["ffn_ln_b"], eps)
        h = residual + (x @ w["fc2"] + w["fc2_b"])
    return layer_norm(h, params["final_ln"], params["final_ln_b"], eps), cache


def kosmos2_image_features(params: dict, cfg: Kosmos2Config, pixel_values: torch.Tensor,
                           compute_dtype=None) -> torch.Tensor:
    """pixel_values -> [B, latent_query_num, D]: the full CLIP stack, its
    post-LayerNorm, L2 normalisation, the dense projection and the
    latent-query cross-attention pooling."""
    vp = params["vision"]
    h = clip_vision_forward(vp, cfg.vision, pixel_values, feature_layer=-1)
    h = layer_norm(h, vp["post_ln"]["scale"], vp["post_ln"]["bias"], cfg.vision.layer_norm_eps)
    h = h / torch.linalg.vector_norm(h.float(), dim=-1, keepdim=True).to(h.dtype)
    pj = params["projection"]
    h = h @ pj["dense"]["w"] + pj["dense"]["b"]
    B, D = h.shape[0], h.shape[-1]
    H, hd = cfg.text.attention_heads, cfg.text.head_dim
    lat = pj["latent_query"].expand(B, *pj["latent_query"].shape)
    kv = torch.cat([h, lat], dim=1)
    w = pj["x_attn"]
    Q, S = lat.shape[1], kv.shape[1]
    q = (lat @ w["q"]["w"] + w["q"]["b"]).reshape(B, Q, H, hd).transpose(1, 2)
    k = (kv @ w["k"]["w"] + w["k"]["b"]).reshape(B, S, H, hd).transpose(1, 2)
    v = (kv @ w["v"]["w"] + w["v"]["b"]).reshape(B, S, H, hd).transpose(1, 2)
    att = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
    att = torch.softmax(att, dim=-1).to(lat.dtype)
    o = torch.matmul(att, v).transpose(1, 2).reshape(B, Q, D)
    return o @ w["o"]["w"] + w["o"]["b"]


def _scatter_image_embeds(inputs_embeds: torch.Tensor, image_embeds: torch.Tensor,
                          img_mask: torch.Tensor) -> torch.Tensor:
    """Put image_embeds [B, N, D] at the True positions of img_mask [B, T]
    (each row has N of them), by the rank of each position among them."""
    rank = (torch.cumsum(img_mask.to(torch.int32), dim=1) - 1).clamp(0, image_embeds.shape[1] - 1)
    gathered = torch.gather(image_embeds, 1,
                            rank[..., None].long().expand(-1, -1, image_embeds.shape[-1]))
    return torch.where(img_mask[..., None], gathered.to(inputs_embeds.dtype), inputs_embeds)


def kosmos2_forward(params: dict, cfg: Kosmos2Config, pixel_values, input_ids,
                    image_embeds_position_mask, attention_mask,
                    compute_dtype=None) -> torch.Tensor:
    """Logits [B, T, V] (lm_head tied to embed_tokens)."""
    feats = kosmos2_image_features(params, cfg, pixel_values, compute_dtype)
    emb = _scatter_image_embeds(params["embed_tokens"][input_ids], feats,
                                image_embeds_position_mask != 0)
    pos = kosmos2_position_ids(attention_mask, cfg.text.pad_token_id)
    h, _ = kosmos2_text_forward(params, cfg.text, emb, attention_mask, pos)
    return h @ params["embed_tokens"].T


def kosmos2_init_cache(cfg: Kosmos2TextConfig, batch: int, max_len: int,
                       dtype=torch.float32, device=None) -> dict:
    shape = (cfg.layers, batch, cfg.attention_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kosmos2_generate(params: dict, cfg: Kosmos2Config, pixel_values, input_ids,
                     image_embeds_position_mask, attention_mask, max_new_tokens: int,
                     eos_token_id: int = -1, compute_dtype=None) -> torch.Tensor:
    """Greedy decode over the cache, stopping when every row has emitted
    eos; returns [B, max_new_tokens] (zeros after a row's eos).  Rows may be
    right-padded: each starts from its last valid position."""
    tc = cfg.text
    feats = kosmos2_image_features(params, cfg, pixel_values, compute_dtype)
    emb = _scatter_image_embeds(params["embed_tokens"][input_ids], feats,
                                image_embeds_position_mask != 0)
    B, T = input_ids.shape
    dev = emb.device
    pos0 = kosmos2_position_ids(attention_mask, tc.pad_token_id)
    cache = kosmos2_init_cache(tc, B, T + max_new_tokens, emb.dtype, dev)
    pad = torch.zeros((B, max_new_tokens), dtype=attention_mask.dtype, device=dev)
    full_mask = torch.cat([attention_mask, pad], dim=1)
    key_pos = torch.cat([pos0, pad.to(pos0.dtype)], dim=1)
    h, cache = kosmos2_text_forward(params, tc, emb, full_mask, pos0, cache, 0, key_pos)
    rows = torch.arange(B, device=dev)
    last_idx = attention_mask.sum(dim=1).long() - 1
    last_pos = pos0[rows, last_idx]
    tok = torch.argmax(h[rows, last_idx] @ params["embed_tokens"].T, dim=-1)
    out = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    i = 0
    while i < max_new_tokens and not bool(done.all()):
        out[:, i] = torch.where(done, out[:, i], tok.to(torch.int32))
        done = done | (tok == eos_token_id)
        idx = T + i
        last_pos = last_pos + 1
        h, cache = kosmos2_text_forward(params, tc, params["embed_tokens"][tok[:, None]],
                                        full_mask, last_pos[:, None], cache, idx, key_pos,
                                        stale_cache=True)
        full_mask[:, idx] = 1
        key_pos[:, idx] = last_pos
        tok = torch.argmax(h[:, -1] @ params["embed_tokens"].T, dim=-1)
        i += 1
    return out
