"""The OPT decoder, BLIP-2's ``blip2-opt-*`` language tower (counterpart of
``cullavo_tpu/models/blip2/opt.py``): learned positions with HF's +2 offset
indexed by the mask's cumsum, pre-norm LayerNorm blocks, a ReLU FFN
computed in f32, biases everywhere, the head tied to the embedding (in
``modeling._lm_logits``).  Stacked ``[L, ...]`` layer leaves; the cache is
head-major ``[L, B, H, S, hd]``.

Attention: without ``stale_cache`` (the prefill, and a forward without a
cache) a plain matmul with JAX's f32 additive bias and f32 softmax, as JAX
leaves it to XLA; a cache is first written at ``cache_index`` (clamped so
the tokens fit, as ``dynamic_update_slice`` clamps).  With ``stale_cache``
(one token a row) ``llama.sdpa_decode_stale`` reads the layer's slice of
the cache in place (K12 on CUDA tensors, at OPT-2.7b's head dim 80), and
the fresh k / v are written into the cache in place after it.
"""
from __future__ import annotations

from typing import Optional

import torch

from cullavo_tpu_torch.models.blip2.config import OptConfig
from cullavo_tpu_torch.models.blip2.vision import normal
from cullavo_tpu_torch.models.llava.clip_vit import layer_norm
from cullavo_tpu_torch.models.llava.llama import sdpa_decode_stale

NEG_INF = -1e9


def init_opt_params(cfg: OptConfig, gen: torch.Generator, device, dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout and scales (N(0, 0.02) weights
    and tables, zero biases, unit LayerNorm gains) drawn from ``gen``: the
    token table, the position table, then q, k, v, o, fc1 and fc2."""
    D, F, L, V = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers, cfg.vocab_size

    def nrm(*shape):
        return normal(gen, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    embed = nrm(V, D)
    positions = nrm(cfg.max_position_embeddings + 2, D)
    q, k, v, o = (nrm(L, D, D) for _ in range(4))
    fc1, fc2 = nrm(L, D, F), nrm(L, F, D)
    return {
        "embed_tokens": embed, "embed_positions": positions,
        "final_ln": full(1.0, D), "final_ln_b": full(0.0, D),
        "layers": {
            "q": q, "q_b": full(0.0, L, D), "k": k, "k_b": full(0.0, L, D),
            "v": v, "v_b": full(0.0, L, D), "o": o, "o_b": full(0.0, L, D),
            "attn_ln": full(1.0, L, D), "attn_ln_b": full(0.0, L, D),
            "fc1": fc1, "fc1_b": full(0.0, L, F), "fc2": fc2, "fc2_b": full(0.0, L, D),
            "final_ln": full(1.0, L, D), "final_ln_b": full(0.0, L, D),
        },
    }


def opt_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF's OPTLearnedPositionalEmbedding: cumsum(mask) * mask - 1, at least
    0 (the +2 offset is applied at lookup)."""
    return (torch.cumsum(attention_mask, dim=1) * attention_mask - 1).clamp_min(0)


def opt_forward(params: dict, cfg: OptConfig, inputs_embeds: torch.Tensor,
                attention_mask: torch.Tensor, position_ids: torch.Tensor,
                cache: Optional[dict] = None, cache_index: Optional[int] = None,
                key_position_ids: Optional[torch.Tensor] = None, stale_cache: bool = False):
    """-> (hidden [B, T, D] after the final LayerNorm, cache).

    inputs_embeds [B, T, D]; attention_mask [B, S] (S = T without a cache,
    the cache's slots with one); position_ids [B, T] logical;
    key_position_ids [B, S] the slots' positions (default: their indices).
    ``stale_cache``: the mask must not include the current slot, whose k / v
    join the softmax out of band and are then written at ``cache_index``.
    The cache is updated in place and returned."""
    B, T, D = inputs_embeds.shape
    H, hd, eps = cfg.num_attention_heads, cfg.head_dim, cfg.layer_norm_eps
    dtype, dev = inputs_embeds.dtype, inputs_embeds.device
    position_ids = position_ids.to(dev).long()
    h = inputs_embeds + params["embed_positions"].to(dtype)[position_ids + 2]

    if cache is None:
        key_pos = torch.arange(T, device=dev)[None]
    elif key_position_ids is not None:
        key_pos = key_position_ids.to(dev)
    else:
        key_pos = torch.arange(cache["k"].shape[3], device=dev)[None]
    ok = ((position_ids[:, :, None] >= key_pos[:, None, :])
          & attention_mask.to(dev)[:, None, :].bool())
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(ok[:, None], zero, torch.full_like(zero, NEG_INF))       # [B, 1, T, S]
    if cache is not None:
        S = cache["k"].shape[3]
        slot = min(max(int(cache_index), 0), S - T)

    def heads(x, w, b):
        return (x @ w.to(dtype) + b.to(dtype)).reshape(B, T, H, hd).transpose(1, 2)

    layers = params["layers"]
    for li in range(cfg.num_hidden_layers):
        w = {k: a[li] for k, a in layers.items()}
        residual = h
        x = layer_norm(h, w["attn_ln"], w["attn_ln_b"], eps)
        q, k, v = heads(x, w["q"], w["q_b"]), heads(x, w["k"], w["k_b"]), heads(x, w["v"],
                                                                                 w["v_b"])
        if cache is not None and stale_cache:
            kc, vc = cache["k"][li], cache["v"][li]                            # [B, H, S, hd]
            o = sdpa_decode_stale(q, kc.to(dtype), vc.to(dtype), k, v, bias)
            kc[:, :, slot:slot + T] = k.to(kc.dtype)
            vc[:, :, slot:slot + T] = v.to(vc.dtype)
        else:
            if cache is not None:
                kc, vc = cache["k"][li], cache["v"][li]
                kc[:, :, slot:slot + T] = k.to(kc.dtype)
                vc[:, :, slot:slot + T] = v.to(vc.dtype)
                k, v = kc.to(dtype), vc.to(dtype)
            att = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
            o = torch.matmul(torch.softmax(att + bias, dim=-1).to(dtype), v)
        o = o.transpose(1, 2).reshape(B, T, D)
        h = residual + (o @ w["o"].to(dtype) + w["o_b"].to(dtype))
        residual = h
        x = layer_norm(h, w["final_ln"], w["final_ln_b"], eps)
        x = torch.relu((x @ w["fc1"].to(dtype) + w["fc1_b"].to(dtype)).float()).to(dtype)
        h = residual + (x @ w["fc2"].to(dtype) + w["fc2_b"].to(dtype))
    return layer_norm(h, params["final_ln"], params["final_ln_b"], eps), cache


def opt_init_cache(cfg: OptConfig, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> dict:
    """A zeroed head-major cache {"k", "v"} of [L, B, H, max_len, hd]."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_attention_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
